"""Whole runs of tiny cells on the CPU: a sound run is correct, and the
control (the reference one precision lower in the port's place) and each
fault of the served path are not."""
from __future__ import annotations

import pytest

from portbench import faults, harness
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
