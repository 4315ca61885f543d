"""Whole runs of tiny cells on the CPU: a sound run is correct, and the
control (the reference one precision lower in the port's place) and each
fault of the served path are not."""
from __future__ import annotations

import time

import pytest

from portbench import check, faults, harness
from portbench.tests import _tiny

SEED = 3_000_000_017          # above 2**31: seeds may pass 32 bits


@pytest.fixture(scope="module")
def pb(tmp_path_factory):
    return _tiny.tree(tmp_path_factory.mktemp("pbtree"))


def _run(pb, cell, **kw):
    return harness.run(cell, seed=SEED, seconds=0.8, traced=False,
                       device="cpu", pb=pb, **kw)


@pytest.mark.parametrize("cell", sorted(_tiny.CELLS))
def test_sound_run_is_correct(pb, cell):
    res = _run(pb, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    # the CPU has no device memory to read: peak_gib is left out
    assert set(res["metrics"]) == {"qps", "p50_ms", "p95_ms", "setup_s"}
    assert list(res)[-1] == "checks"
    assert res["checks"]["lost"]["value"] == 0
    # a cell with an encoder stage judges the encoder too, after the rest
    enc = check.ENCODER_NUMBERS if _kind(cell) == "encoded_flat" else ()
    assert tuple(res["checks"]) == ("lost", "bad_answers", "score_err",
                                    "rank_miss") + enc


@pytest.mark.parametrize("cell", sorted(_tiny.CELLS))
def test_control_is_not_correct(pb, cell):
    res = _run(pb, cell, control=True)
    assert not res["correct"]
    checks = res["checks"]
    assert checks["score_err"]["value"] > 3 * checks["score_err"]["limit"]


def _kind(cell):
    return _tiny.TINY_CONFIGS[_tiny.CELLS[cell]]["kind"]


@pytest.mark.parametrize("fault", ["stale", "half"])
@pytest.mark.parametrize("cell", sorted(_tiny.CELLS))
def test_broken_path_is_not_correct(pb, cell, fault):
    """A state served unchanged; half of the batch given the other half's
    answers."""
    with faults.planted(fault, _kind(cell)):
        assert not _run(pb, cell)["correct"]


@pytest.mark.parametrize("cell", sorted(_tiny.CELLS))
def test_answer_altered_where_produced_is_not_correct(pb, cell):
    """The scores leave the kernel that produces the served answer 1e-4
    high (relative): the flat path's ADC kernel, the cascade's float
    stage."""
    with faults.planted("altered", _kind(cell)):
        assert not _run(pb, cell)["correct"]


def test_encoder_fault_is_not_correct(pb):
    """Each batch's first query given the batch before's first query's
    embeddings: the search on them is sound, the encoder check is not."""
    with faults.planted("stale_row", "encoded_flat"):
        res = _run(pb, "tiny-qenc-cell")
    checks = res["checks"]
    assert not res["correct"]
    assert checks["enc_miss"]["value"] > checks["enc_miss"]["limit"]
    assert checks["score_err"]["value"] <= checks["score_err"]["limit"]


def test_encoder_control_fails_the_encoder_check(pb):
    """The control's encoder (TF32 products for this float32 encoder) reads
    past both encoder limits, apart from its search."""
    checks = _run(pb, "tiny-qenc-cell", control=True)["checks"]
    for name in check.ENCODER_NUMBERS:
        assert checks[name]["value"] > 3 * checks[name]["limit"], name


@pytest.mark.parametrize("fault", faults.NAMES)
def test_planted_fault_is_undone(fault):
    owner, attr, _ = faults._site(fault, "flat")
    orig = getattr(owner, attr)
    with faults.planted(fault, "flat"):
        assert getattr(owner, attr) is not orig
    assert getattr(owner, attr) is orig


def test_traced_run_reports_per_layer_metrics(pb):
    res = harness.run("tiny-cascade-cell", seed=SEED, seconds=0.8,
                      traced=True, device="cpu", pb=pb)
    assert res["correct"]
    # no device on the CPU: the device metrics are left out, not zeroed
    # index_gib counts the state's tensors wherever they are
    assert set(res["metrics"]) == {"mean_batch", "search_ms", "index_gib"}
    assert res["metrics"]["mean_batch"]["value"] > 1


def test_traced_encoder_run_reports_the_encoder_metrics(pb):
    res = harness.run("tiny-qenc-cell", seed=SEED, seconds=0.8,
                      traced=True, device="cpu", pb=pb)
    assert res["correct"]
    # the encoder's weights are counted wherever they are
    assert set(res["metrics"]) == {"mean_batch", "search_ms", "index_gib",
                                   "encoder_gib"}
    # the smoke encoder's float32 parameters: two layers of q, k, v, o
    # (one kv head of 16), their biases, the FFN and two norms; the
    # embedding, the last norm, the two projections
    assert res["metrics"]["encoder_gib"]["value"] * 2 ** 30 == 4 * (
        2 * (48 * (48 + 16 + 16 + 48) + (48 + 16 + 16) + 3 * 48 * 96
             + 2 * 48) + 128 * 48 + 48 + 24 * 48 + 48 * 16)


def test_encoding_searcher_keeps_a_ring_of_calls(monkeypatch):
    """The last KEEP_CALLS calls are kept; ``covered_from`` is the latest
    start of a call the ring dropped."""
    import contextlib

    import torch
    monkeypatch.setattr(harness, "KEEP_CALLS", 2)
    s = harness.EncodingSearcher(
        lambda t, m: (t.float(), m, None), lambda e, m, sal: e.sum(),
        lambda name: contextlib.nullcontext(), sync=False)
    starts = []
    for i in range(5):
        starts.append(time.perf_counter())
        s(torch.full((1, 2), i), torch.ones(1, 2, dtype=torch.bool), None)
    assert [int(c[2][0, 0]) for c in s.kept] == [3, 4]
    assert starts[2] <= s.covered_from < starts[3]


def test_encoder_run_with_a_short_ring_samples_what_it_kept(pb, monkeypatch):
    """With a ring of 4 calls the sample is drawn from the requests those
    calls served, and every sampled query is found there."""
    monkeypatch.setattr(harness, "KEEP_CALLS", 4)
    res = _run(pb, "tiny-qenc-cell")
    assert res["correct"], res["checks"]
    assert res["checks"]["enc_miss"]["value"] == 0


def test_state_bytes_counts_each_storage_once():
    import dataclasses

    import torch

    @dataclasses.dataclass
    class Member:
        rows: torch.Tensor
        n: int

    a = torch.zeros(10, 4)                 # 160 B
    b = torch.zeros(3, dtype=torch.uint8)  # 3 B
    state = (a, [a[2:], Member(b, 3)], {"x": a.view(40), "y": None})
    assert harness.state_bytes(state) == 163
