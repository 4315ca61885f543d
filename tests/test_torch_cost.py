"""The port's cost model (``repro_torch.analysis.cost_model``).

  * Ground truth: at the reference's closed-form cases
    (``tests/test_cost_model.py``, the same parameters) the recorded cost
    of the port's scoring functions equals a closed form derived term by
    term from the port's op sequence, and the ADC property holds exactly
    as in the reference: the only product is the 2*B*Mq*K*D table.
  * Against the reference: every manifest's product FLOPs equal the
    reference's ``cost_report`` ``prim_flops["dot_general"]`` at the same
    geometry (N = 2^20).
  * Gates: the flat ADC scan is memory-bound on the h100 roofline; the
    unblocked flat search breaks its CostContract and drifts from the
    committed ``COST_baseline_torch.json``, naming the op; the baseline's
    round trip and the 10% drift band.
  * Kernel launches: a CUDA kernel's recorded FLOPs are counted once —
    ``FlopCounterMode`` does not see them and the recorder adds them.

Tolerance: every comparison is exact (integer counts), except the drift
band, which is the gate's own 10%.
"""
import importlib
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analysis.cost_model import (PRODUCTS, RESIDENT_BYTES,
                                             ROOFLINES, CostContract,
                                             RooflineSpec,
                                             check_against_baseline,
                                             classify_bound, cost_report,
                                             load_baseline, trace_cost,
                                             write_baseline)
from repro_torch.analysis.jaxpr_budget import Recorder, Trace
from repro_torch.analysis.manifests import (BudgetManifest, get_manifest,
                                            manifests)
from repro_torch.core import late_interaction as li


def _cost(fn, make_args):
    with FakeTensorMode():
        rec = Recorder(compress_loops=True)
        with rec:
            args = make_args()
            rec.mark()
            out = fn(*args)
        outs = [out] if isinstance(out, torch.Tensor) else list(out)
        tr = Trace(0, rec.ops, tuple(t.dtype for t in outs),
                   sum(t.numel() * t.element_size() for t in outs),
                   rec.input_bytes, rec.peak_above_inputs, rec.peak_op,
                   False)
    return trace_cost(tr)


# --- ground truth: quantized (ADC) scoring ---------------------------------

CASES = [(2, 3, 4, 5, 7, 2), (1, 4, 8, 16, 5, 3), (3, 2, 16, 32, 9, 4)]


def _qmaxsim_cost(B, Mq, D, K, N, Md):
    return _cost(li.quantized_maxsim, lambda: (
        torch.empty(B, Mq, D), torch.empty(B, Mq, dtype=torch.bool),
        torch.empty(N, Md, dtype=torch.uint8),
        torch.empty(N, Md, dtype=torch.bool), torch.empty(K, D)))


@pytest.mark.parametrize("B,Mq,D,K,N,Md", CASES)
def test_quantized_maxsim_flops_match_closed_form(B, Mq, D, K, N, Md):
    cost = _qmaxsim_cost(B, Mq, D, K, N, Md)
    # recorded op sequence (one term per FLOP-bearing op):
    #   bmm        table = q @ cb.T            2*B*Mq*K*D
    #   index      table[:, :, codes]          0 (a gather)
    #   where + amax over (B, N, Mq, Md)       2*B*N*Mq*Md
    #   mul (q_mask) + sum over (B, N, Mq)     2*B*N*Mq
    # (the reference adds 3*N*Md for its int32 wraparound; the port
    # widens the codes to int64 instead, a convert: 0 FLOPs)
    want = 2 * B * Mq * K * D + 2 * B * N * Mq * Md + 2 * B * N * Mq
    assert cost.flops == want
    # the ADC defining property, as the reference's: the only product is
    # the table, and no product FLOP scales with N
    assert cost.prim_flops["bmm"] == 2 * B * Mq * K * D
    assert sum(v for k, v in cost.prim_flops.items() if k in PRODUCTS) \
        == 2 * B * Mq * K * D


@pytest.mark.parametrize("B,Mq,D,K,N,Md", CASES)
def test_quantized_maxsim_bytes_match_closed_form(B, Mq, D, K, N, Md):
    cost = _qmaxsim_cost(B, Mq, D, K, N, Md)
    # materializing: the bmm table (B, Mq, K) f32; the converts codes ->
    # int64 (N, Md) and q_mask -> f32 (B, 1, Mq). The (B, Mq, N, Md)
    # gather is not charged below resident_bytes.
    inter = 4 * B * Mq * K + (8 * N * Md + 4 * B * Mq)
    inputs = 4 * B * Mq * D + B * Mq + N * Md + N * Md + 4 * K * D
    outputs = 4 * B * N
    assert cost.bytes == inter + inputs + outputs
    assert cost.prim_bytes["<inputs>"] == inputs
    assert cost.prim_bytes["<outputs>"] == outputs
    assert "index" not in cost.prim_bytes


# --- ground truth: binary (hamming) scoring ----------------------------------

@pytest.mark.parametrize("B,Mq,N,Md", [(2, 3, 7, 2), (1, 4, 5, 3),
                                       (3, 2, 9, 4)])
def test_binary_maxsim_cost_matches_closed_form(B, Mq, N, Md):
    cost = _cost(lambda qc, qm, dc, dm: li.binary_maxsim(qc, qm, dc, dm, 8),
                 lambda: (torch.empty(B, Mq, dtype=torch.int32),
                          torch.empty(B, Mq, dtype=torch.bool),
                          torch.empty(N, Md, dtype=torch.int32),
                          torch.empty(N, Md, dtype=torch.bool)))
    # FLOPs: the byte mask on each side (B*Mq + N*Md); over the full
    # (B, N, Mq, Md) sim: xor, the SWAR popcount (4 shifts, 5 ands, a
    # sub and 3 adds), bits - popcount, the mask select and the max: 17
    # ops; then mul + sum over (B, N, Mq)
    sim = B * N * Mq * Md
    assert cost.flops == (B * Mq + N * Md) + 17 * sim + 2 * B * N * Mq
    assert cost.prim_flops["bitwise_xor"] == sim
    # bytes: the q_mask -> int32 convert, the inputs, the (B, N) output
    inputs = 5 * B * Mq + 5 * N * Md
    assert cost.bytes == 4 * B * Mq + inputs + 4 * B * N


# --- roofline classification ---------------------------------------------------

def test_classify_bound_straddles_ridge():
    spec = RooflineSpec("toy", peak_flops=100.0, hbm_bw=10.0)  # ridge 10
    assert spec.ridge == 10.0
    assert classify_bound(5.0, (spec,)) == {"toy": "memory"}
    assert classify_bound(50.0, (spec,)) == {"toy": "compute"}


def test_rooflines_are_the_h100_and_cpu_ci():
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    assert [r.name for r in ROOFLINES] == ["h100", "cpu_ci"]
    assert (ROOFLINES[0].peak_flops, ROOFLINES[0].hbm_bw) == \
        (PEAK_FLOPS_BF16, HBM_BW)


def test_adc_flat_scan_is_memory_bound_on_h100():
    """The paper's premise on this card: the quantized scan sits far below
    the ridge intensity; the committed baseline agrees."""
    base = load_baseline()
    assert base is not None, "COST_baseline_torch.json must be committed"
    entry = base["entries"]["search_flat"]
    assert entry["bound"]["h100"] == "memory"
    assert entry["intensity"] < base["rooflines"]["h100"]["ridge"] / 10
    assert "tpu_v5e" not in base["rooflines"]


# --- the acceptance gate: the unblocked flat scan is rejected -----------------

def _unblocked_manifest(contract=None):
    """search_flat with the streaming scan swapped for the one-shot ADC
    path: the (B, Mq, N, Md) gather at full corpus width."""
    def trace(n, device="cpu"):
        qe = torch.empty((8, 8, 16), device=device)
        qm = torch.empty((8, 8), dtype=torch.bool, device=device)
        codes = torch.empty((n, 16), dtype=torch.uint8, device=device)
        mask = torch.empty((n, 16), dtype=torch.bool, device=device)
        cb = torch.empty((256, 16), device=device)

        def fn(qe, qm, codes, mask, cb):
            scores = li.quantized_maxsim(qe, qm, codes, mask, cb)
            return torch.topk(scores, 16)  # noqa: TORCH04 - fixture trace
        return fn, (qe, qm, codes, mask, cb)

    return BudgetManifest(name="search_flat", trace=trace, out_dtypes=None,
                          n=1 << 15, n_alt=1 << 14, cost=contract)


def test_unblocked_search_flat_breaks_cost_contract():
    contract = get_manifest("search_flat").cost
    assert contract is not None and contract.max_bytes_per_doc is not None
    report = cost_report(_unblocked_manifest(contract))
    assert not report["ok"]
    byte_v = [v for v in report["violations"]
              if "bytes_per_doc" in v["detail"]]
    assert byte_v, report["violations"]
    assert "index" in byte_v[0]["detail"]        # the gather, named
    # at n = 2**15 the (8, 8, n, 16) f32 gather is 128 MiB > the 64 MiB
    # residency envelope: charged in full
    assert report["prim_bytes"]["index"] >= 8 * 8 * (1 << 15) * 16 * 4


def test_unblocked_search_flat_drifts_from_committed_baseline():
    baseline = load_baseline()
    assert baseline is not None
    report = cost_report(_unblocked_manifest())
    drift = check_against_baseline([report], baseline)
    drifted = {v.detail.split()[0] for v in drift if v.kind == "drift"}
    # per document the gather moves ~16 KB against the blocked scan's
    # ~310 B (the total at n = 2^15 stays under the 2^20 baseline's)
    assert "bytes_per_doc" in drifted, drift
    assert [v for v in drift if "index" in v.detail], \
        "drift must name the gather as the offending op"


def test_registered_search_flat_matches_committed_baseline():
    baseline = load_baseline()
    report = cost_report(get_manifest("search_flat"))
    assert report["ok"], report["violations"]
    only = {"entries": {"search_flat": baseline["entries"]["search_flat"]}}
    assert check_against_baseline([report], only) == []


# --- baseline artifact I/O and drift mechanics ------------------------------------

def test_baseline_roundtrip_and_missing_entries(tmp_path):
    report = cost_report(_unblocked_manifest())
    p = write_baseline([report], tmp_path / "COST_baseline_torch.json")
    base = load_baseline(p)
    assert base["schema"] == 1
    assert base["resident_bytes"] == RESIDENT_BYTES
    assert check_against_baseline([report], base) == []
    other = dict(report, manifest="brand_new_path")
    kinds = {(v.manifest, v.kind)
             for v in check_against_baseline([other], base)}
    assert ("brand_new_path", "baseline") in kinds
    assert ("search_flat", "baseline") in kinds


def test_drift_tolerance_band():
    report = cost_report(_unblocked_manifest())
    base = {"entries": {"search_flat": {
        k: report[k] for k in ("flops", "hbm_bytes", "flops_per_doc",
                               "bytes_per_doc", "prim_flops", "prim_bytes")
    }}}
    assert check_against_baseline(
        [dict(report, flops=report["flops"] * 1.08)], base) == []
    viol = check_against_baseline(
        [dict(report, flops=report["flops"] * 1.12)], base)
    assert [v.kind for v in viol] == ["drift"]
    improved = dict(report, flops=report["flops"] * 0.5,
                    hbm_bytes=report["hbm_bytes"] * 0.5)
    assert check_against_baseline([improved], base) == []


def test_contract_is_optional_per_axis():
    report = cost_report(_unblocked_manifest(
        CostContract(max_flops_per_doc=1e12)))
    assert report["ok"]  # byte axis undeclared -> not gated


def test_baseline_file_is_committed_at_repo_root():
    from repro_torch.analysis.cost_model import BASELINE_PATH
    assert BASELINE_PATH.name == "COST_baseline_torch.json"
    assert BASELINE_PATH.exists()
    assert (Path(__file__).resolve().parents[1] / "COST_baseline_torch.json"
            == BASELINE_PATH)


def test_every_manifest_matches_committed_baseline():
    baseline = load_baseline()
    reports = [cost_report(m) for m in manifests()]
    assert check_against_baseline(reports, baseline) == []
    assert all(r["ok"] for r in reports), \
        [r["violations"] for r in reports if not r["ok"]]


# --- against the reference's cost reports ---------------------------------------

@pytest.mark.parametrize("name", [m.name for m in manifests()])
def test_product_flops_equal_reference_dot_general(name):
    ref_cm = importlib.import_module("repro.analysis.cost_model")
    ref_mf = importlib.import_module("repro.analysis.manifests")
    want = ref_cm.cost_report(ref_mf.get_manifest(name))["prim_flops"].get(
        "dot_general", 0)
    got = cost_report(get_manifest(name))["prim_flops"]
    assert sum(v for k, v in got.items() if k in PRODUCTS) == want


# --- kernel launches are counted once -----------------------------------------------

def test_kernel_flops_are_not_counted_twice():
    """A fake CUDA launch: FlopCounterMode sees no product (the wrapper
    allocates only its outputs), the recorder adds the launch's own
    operations, and a cell's total is their sum."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import maxsim as ms
    b, mq, n, md, d = 8, 32, 100, 64, 128
    with FakeTensorMode():
        rec = Recorder()
        with rec:
            q = torch.empty(b, mq, d, device="cuda")
            qm = torch.empty(b, mq, device="cuda")
            docs = torch.empty(n, md, d, device="cuda")
            dm = torch.empty(n, md, dtype=torch.bool, device="cuda")
            rec.mark()
            fc = FlopCounterMode(display=False)
            with fc:
                out = ms.maxsim_cuda(q, qm, docs, dm)
    assert tuple(out.shape) == (b, n) and out.dtype == torch.float32
    assert fc.get_total_flops() == 0
    launches = [r for r in rec.ops if r.name == "kernel:maxsim"]
    assert len(launches) == 1
    assert launches[0].flops == 2.0 * d * mq * md * n * b
    assert ms.launches == 0                 # nothing was launched
