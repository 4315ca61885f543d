"""The frozen cost arithmetic against hand counts at both cells' shapes,
and the kernel launches each search is expected to make."""
from __future__ import annotations

import types

import pytest

from portbench import kinds, roofline
from portbench.harness import load_spec
from portbench.kinds import cascade, flat

HBM, F32, TF32 = 3.35e12, 67e12, 495e12
SMS = 132


def test_bound_and_gemm_bounds():
    assert roofline.bound(3.35e12, 1.0) == (1e3, "bytes")
    assert roofline.bound(1.0, 67e12) == (1e3, "operations")
    ms, by, f32, x3 = roofline.gemm_bounds(3.35e9, 67e12)
    assert (f32, x3, by) == (1e3, pytest.approx(3 * 67e12 / TF32 * 1e3),
                             "operations")
    assert ms == pytest.approx(x3)


def test_flat_cell_batch_of_8():
    cfg = load_spec("flat4m-backlog").cfg
    inp = types.SimpleNamespace(n_docs=4_194_304)
    sweep, rerank = flat.costs(cfg, inp, 8, [32] * 8)["quantized_maxsim"]
    # chip_smoke.py's count: a lookup per valid query patch and doc slot
    assert sweep.slot_ops == 8 * 32 * 4_194_304 * 615 == pytest.approx(
        6.60e11, rel=2e-3)
    assert sweep.ops == 8 * 32 * 4_194_304
    assert sweep.n_bytes == (8 * 32 * 256 * 4 + 8 * 32 * 4
                             + 4_194_304 * 616 * 2 + 8 * 32 * 8)
    assert sweep.least_ms() == pytest.approx(sweep.n_bytes / HBM * 1e3)
    assert sweep.least_ms() == pytest.approx(1.543, abs=1e-3)
    assert rerank.ops == 8 * 32 * 32 and rerank.slot_ops == 8 * 32 * 32 * 1024
    assert rerank.n_bytes == (8 * 32 * 256 * 4 + 8 * 32 * 4 + 32 * 1024 * 2
                              + 8 * 10 * 8)


def test_padded_rows_add_no_operations():
    cfg = load_spec("flat4m-backlog").cfg
    inp = types.SimpleNamespace(n_docs=4_194_304)
    full = flat.costs(cfg, inp, 8, [32] * 8)["quantized_maxsim"][0]
    half = flat.costs(cfg, inp, 8, [32] * 5 + [0] * 3)["quantized_maxsim"][0]
    assert half.ops == full.ops * 5 / 8 and half.n_bytes == full.n_bytes


def test_cascade_cell_batch_of_64():
    cfg = load_spec("cascade131k-backlog").cfg
    inp = types.SimpleNamespace(n_docs=131_072)
    c = cascade.costs(cfg, inp, 64, [32] * 64)
    (ham,), (adc,), (fl,), (asg,) = (c["hamming_maxsim"],
                                     c["quantized_maxsim"], c["maxsim"],
                                     c["kmeans_assign"])
    assert ham.ops == 64 * 32 * 131_072
    assert ham.slot_ops == 64 * 32 * 131_072 * 615
    assert ham.n_bytes == 2 * 64 * 32 * 4 + 131_072 * 615 * 2 + 64 * 1024 * 8
    assert ham.least_ms() == pytest.approx(ham.n_bytes / HBM * 1e3)
    assert adc.ops == 64 * 32 * 1024
    assert fl.ops == 2 * 128 * 64 * 32 * 64 * 615 == pytest.approx(2.06e10,
                                                                    rel=2e-3)
    # float products bounded by the faster of f32 FMAs and 3xTF32
    assert fl.least_ms() == pytest.approx(3 * fl.ops / TF32 * 1e3)
    assert asg.ops == 2 * 128 * 256 * 64 * 32
    total = sum(x.least_ms() for x in (ham, adc, fl, asg))
    assert 0.15 < total < 0.3


def test_expected_launches():
    fcfg = load_spec("flat4m-backlog").cfg
    ccfg = load_spec("cascade131k-backlog").cfg
    # one sweep launch holds the whole 4.19M pages at every rung, + rerank
    assert [flat.launches(fcfg, b, SMS)["quantized_maxsim"]
            for b in (1, 2, 4, 8)] == [2, 2, 2, 2]
    # stage 1 over 131,072 pages needs two launches at 64, one below
    assert [cascade.launches(ccfg, b, SMS)["hamming_maxsim"]
            for b in (1, 2, 4, 8, 16, 32, 64)] == [1, 1, 1, 1, 1, 1, 2]
    assert cascade.launches(ccfg, 64, SMS) == {
        "kmeans_assign": 1, "hamming_maxsim": 2, "quantized_maxsim": 1,
        "maxsim": 1}
    # ranges shorten when a launch would leave SMs idle
    assert kinds.range_len(8, 32, SMS) == 2
    assert kinds.range_len(1, 4_194_304, SMS) == 256
