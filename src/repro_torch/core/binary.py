"""Binary encoding and Hamming similarity (HPC-ColPali §III-D), in PyTorch.

The counterpart of ``repro.core.binary``. Each centroid index is its own
b-bit binary string (b = ceil(log2 K)), so the Hamming distance between
two codes is ``popcount(a XOR b)`` over the low b bits. On the card the
scan is the CUDA kernel in kernels/hamming.py; here the torch forms.

For storage accounting, code streams bit-pack to ceil(N*b/8) bytes
(``pack_codes``, numpy, host side). ``pack_u16_pairs`` is the reference
kernel's two-codes-per-32-bit-word layout.
"""
from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor


def bits_for_k(k: int) -> int:
    """b = ceil(log2 K)."""
    return max(1, int(math.ceil(math.log2(k))))


def popcount16(x: Tensor) -> Tensor:
    """Population count of non-negative integers below 2**16 (torch has no
    popcount op): SWAR bit sums in int32."""
    x = x.to(torch.int32)
    x = x - ((x >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    return (x & 0xFF) + (x >> 8)


def hamming_distance(a: Tensor, b: Tensor, bits: int) -> Tensor:
    """Elementwise Hamming distance between integer codes (broadcasting),
    int32. Only the low ``bits`` bits count; inputs are masked to them."""
    if not 1 <= bits <= 16:
        raise ValueError(f"bits must be in [1, 16], got {bits}")
    mask = (1 << bits) - 1
    ax = a.to(torch.int32) & mask
    bx = b.to(torch.int32) & mask
    return popcount16(ax ^ bx)


def hamming_sim_matrix(q_codes: Tensor, d_codes: Tensor, bits: int) -> Tensor:
    """Similarity ``bits - hamming`` for q (..., Mq) x d (..., Md) ->
    (..., Mq, Md) int32 (higher = closer)."""
    h = hamming_distance(q_codes[..., :, None], d_codes[..., None, :], bits)
    return bits - h


# ---------------------------------------------------------------------------
# Bit packing (storage layer), numpy, host side
# ---------------------------------------------------------------------------

def pack_codes(codes: np.ndarray, bits: int) -> np.ndarray:
    """Pack integer codes (N,) into a uint8 buffer of ceil(N*bits/8) bytes."""
    codes = np.asarray(codes, dtype=np.uint32).ravel()
    n = codes.shape[0]
    out = np.zeros((n * bits + 7) // 8, dtype=np.uint8)
    bitpos = np.arange(n, dtype=np.int64) * bits
    for b in range(bits):
        pos = bitpos + b
        bit_vals = ((codes >> b) & 1).astype(np.uint8)
        np.bitwise_or.at(out, pos >> 3, bit_vals << (pos & 7).astype(np.uint8))
    return out


def unpack_codes(packed: np.ndarray, bits: int, n: int) -> np.ndarray:
    """Inverse of pack_codes -> uint32 codes (n,)."""
    packed = np.asarray(packed, dtype=np.uint8)
    out = np.zeros(n, dtype=np.uint32)
    bitpos = np.arange(n, dtype=np.int64) * bits
    for b in range(bits):
        pos = bitpos + b
        bit = (packed[pos >> 3] >> (pos & 7).astype(np.uint8)) & 1
        out |= bit.astype(np.uint32) << b
    return out


def packed_nbytes(n_codes: int, bits: int) -> int:
    """Storage bytes for n_codes b-bit codes (paper Table III arithmetic)."""
    return (n_codes * bits + 7) // 8


# ---------------------------------------------------------------------------
# Two 16-bit code lanes per 32-bit word (the reference kernel's layout).
# torch has no shifts on uint32, so the words are formed in int64 and
# returned as uint32.
# ---------------------------------------------------------------------------

def pack_u16_pairs(codes: Tensor) -> Tensor:
    """codes (..., M) -> uint32 (..., M/2): two 16-bit lanes per word.
    M must be even (pad with zeros and mask upstream)."""
    if codes.shape[-1] % 2:
        raise ValueError("pad the code count to even before packing")
    c = codes.to(torch.int64)
    return (c[..., 0::2] | (c[..., 1::2] << 16)).to(torch.uint32)


def unpack_u16_pairs(packed: Tensor) -> Tensor:
    """Inverse of pack_u16_pairs -> uint32 (..., 2 * M/2)."""
    p = packed.to(torch.int64)
    out = torch.stack([p & 0xFFFF, p >> 16], dim=-1)
    return out.reshape(*packed.shape[:-1], -1).to(torch.uint32)
