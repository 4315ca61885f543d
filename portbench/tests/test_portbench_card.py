"""On the card: the cells' paths at a few thousand pages through the real
kernels. Run there with

    python -m pytest -m gpu -p no:cacheprovider portbench/tests

Each test skips without a CUDA device."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import faults, harness
from portbench.tests import _tiny

pytestmark = pytest.mark.gpu
SEED = 4_000_000_007


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def pb(tmp_path_factory):
    return _tiny.tree(tmp_path_factory.mktemp("pbcard"), _tiny.CARD_CONFIGS)


@pytest.mark.parametrize("cell", sorted(_tiny.CELLS))
def test_cell_on_card(pb, cell):
    _card()
    res = harness.run(cell, seed=SEED, seconds=2.0, traced=False,
                      device="cuda", pb=pb)
    assert res["correct"], res["checks"]
    assert res["launches"]["counted"] == res["launches"]["expected"]
    assert set(res["metrics"]) == {"qps", "p50_ms", "p95_ms", "peak_gib",
                                   "setup_s"}
    assert res["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", sorted(_tiny.CELLS))
def test_traced_cell_on_card(pb, cell):
    _card()
    res = harness.run(cell, seed=SEED + 1, seconds=2.0, traced=True,
                      device="cuda", pb=pb)
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    want = {"mean_batch", "search_ms", "idle_pct", "search_mfu_pct",
            "quantized_maxsim_roofline", "index_gib", "search_scratch_gib"}
    if cell == "tiny-cascade-cell":
        want.add("hamming_maxsim_roofline")
    if cell == "tiny-qenc-cell":
        want.add("encoder_gib")
    assert set(m) == want
    for name in want:
        if name in ("idle_pct", "search_mfu_pct") or name.endswith(
                "_roofline"):
            assert 0 < m[name] <= 100, (name, m[name])
    assert 0 < m["search_scratch_gib"] < m["index_gib"]
    if cell == "tiny-qenc-cell":
        # qwen2-1.5b's float32 weights: 1.546e9 parameters
        assert m["encoder_gib"] * 2 ** 30 == pytest.approx(4 * 1.546e9,
                                                            rel=1e-3)
    dev = res["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert m["index_gib"] * 2 ** 30 < dev["memory_peak_bytes"]
    assert res["breakdown"]["device_ops"]
    assert len(res["breakdown"]["device_ops"]) <= 10


@pytest.mark.parametrize("cell", sorted(_tiny.CELLS))
def test_control_on_card_is_not_correct(pb, cell):
    _card()
    res = harness.run(cell, seed=SEED + 2, seconds=2.0, traced=False,
                      device="cuda", pb=pb, control=True)
    assert not res["correct"]


@pytest.mark.parametrize("fault", faults.NAMES[:2])
@pytest.mark.parametrize("cell", sorted(_tiny.CELLS))
def test_broken_path_on_card_is_not_correct(pb, cell, fault):
    _card()
    kind = _tiny.CARD_CONFIGS[_tiny.CELLS[cell]]["kind"]
    with faults.planted(fault, kind):
        res = harness.run(cell, seed=SEED + 3, seconds=2.0, traced=False,
                          device="cuda", pb=pb)
    assert not res["correct"]


def test_encoder_fault_on_card_is_not_correct(pb):
    _card()
    with faults.planted("stale_row", "encoded_flat"):
        res = harness.run("tiny-qenc-cell", seed=SEED + 4, seconds=2.0,
                          traced=False, device="cuda", pb=pb)
    assert not res["correct"]
    assert res["checks"]["enc_miss"]["value"] > res["checks"]["enc_miss"][
        "limit"]


def test_run_without_the_program_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, the
    command fails and prints no result line."""
    _card()
    shutil.copytree(_tiny.PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(_tiny.ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "flat4m-backlog",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == "", out.stderr
    with pytest.raises(json.JSONDecodeError):
        json.loads(out.stdout or "x")
