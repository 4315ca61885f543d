"""The port's binary encoding (core/binary.py) against ``repro.core.binary``
on the same numpy inputs: Hamming distance and similarity exactly, the
numpy bit packing byte for byte, and the two-codes-per-word layout."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binary as jax_binary
from repro_torch.core import binary
from tests._torch_parity import to_torch


@pytest.mark.parametrize("k", [2, 3, 128, 256, 257, 512, 65536])
def test_bits_for_k_matches_jax(k):
    assert binary.bits_for_k(k) == jax_binary.bits_for_k(k)


@pytest.mark.parametrize("bits", [1, 4, 8, 9, 16])
def test_hamming_distance_and_sim_matrix_match_jax(bits):
    rng = np.random.default_rng(bits)
    # codes beyond 2^bits too: only the low `bits` bits count
    a = rng.integers(0, 2 ** 16, (3, 7)).astype(np.uint16)
    b = rng.integers(0, 2 ** 16, (3, 5)).astype(np.uint16)
    want = jax_binary.hamming_distance(jnp.asarray(a[:, :, None]),
                                       jnp.asarray(b[:, None, :]), bits)
    got = binary.hamming_distance(*to_torch(a[:, :, None], b[:, None, :]),
                                  bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax_binary.hamming_sim_matrix(jnp.asarray(a), jnp.asarray(b), bits)
    got = binary.hamming_sim_matrix(*to_torch(a, b), bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_popcount16_counts_every_16_bit_value():
    x = torch.arange(2 ** 16, dtype=torch.int32)
    want = np.array([bin(i).count("1") for i in range(2 ** 16)])
    np.testing.assert_array_equal(binary.popcount16(x).numpy(), want)


@pytest.mark.parametrize("bits,n", [(8, 1000), (9, 333), (4, 7), (16, 50)])
def test_pack_codes_matches_jax_and_round_trips(bits, n):
    codes = np.random.default_rng(n).integers(0, 2 ** bits, n)
    packed = binary.pack_codes(codes, bits)
    np.testing.assert_array_equal(packed, jax_binary.pack_codes(codes, bits))
    assert packed.nbytes == binary.packed_nbytes(n, bits) == \
        jax_binary.packed_nbytes(n, bits)
    np.testing.assert_array_equal(binary.unpack_codes(packed, bits, n),
                                  codes.astype(np.uint32))


def test_u16_pairs_match_jax_and_round_trip():
    codes = np.random.default_rng(1).integers(0, 2 ** 16, (3, 10)).astype(
        np.uint16)
    want = jax_binary.pack_u16_pairs(jnp.asarray(codes))
    got = binary.pack_u16_pairs(torch.from_numpy(codes))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        binary.unpack_u16_pairs(got).numpy(),
        np.asarray(jax_binary.unpack_u16_pairs(want)))
    np.testing.assert_array_equal(binary.unpack_u16_pairs(got).numpy(), codes)
    with pytest.raises(ValueError):
        binary.pack_u16_pairs(torch.zeros((2, 3), dtype=torch.int32))
