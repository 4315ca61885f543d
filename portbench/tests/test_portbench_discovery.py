"""The harness finds a new cell, traffic mix and per-layer metric by name,
added as files with no edit to a file already there; and BENCHMARK.json
keeps to the contract the checks hold it to."""
from __future__ import annotations

import hashlib
import json
import math
import re

import pytest

from portbench import harness
from portbench.tests import _tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_mix_and_metric_are_found(tmp_path):
    pb = _tiny.tree(tmp_path)
    before = _digests(tmp_path)
    # a new mix, a new cell on it and a new per-layer metric, as files
    _tiny.write_json(pb / "traffic" / "tiny-closed-3.json",
                     {**_tiny.TINY_TRAFFIC, "clients": 3, "max_batch": 2})
    _tiny.write_json(pb / "cells" / "tiny-new.json",
                     {"config": "tiny-flat", "traffic": "tiny-closed-3",
                      "chips": 1, "sample": 4, "limits": _tiny.TINY_LIMITS})
    (pb / "metrics" / "answered.py").write_text(
        'UNIT, LAYER, SOURCE = "queries", "end to end", '
        '"program_counter"\n\n\n'
        "def read(run):\n    return len(run.in_window)\n")
    bench_path = tmp_path / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["workloads"].append({"name": "tiny-new", "config": "tiny-flat",
                               "traffic": "tiny-closed-3", "chips": 1,
                               "why": "tiny"})
    bench["per_layer"].append({"name": "answered", "unit": "queries",
                               "better": "higher", "source": "program_counter",
                               "layer": "end to end", "moves": "qps",
                               "workloads": ["tiny-new"]})
    bench_path.write_text(json.dumps(bench))
    # every file that was there is unchanged but BENCHMARK.json's entries
    after = _digests(tmp_path)
    assert {p: d for p, d in after.items() if p in before
            and p != bench_path} == {p: d for p, d in before.items()
                                     if p != bench_path}
    res = harness.run("tiny-new", seed=7, seconds=0.6, traced=True,
                      device="cpu", pb=pb)
    assert res["correct"]
    assert res["metrics"]["answered"]["value"] > 0
    # a per-layer metric whose workloads leave the new cell out stays out
    assert "mean_batch" not in res["metrics"]


def _bench():
    return json.loads((_tiny.ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keys_and_names():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert len((_tiny.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [c["name"] for c in b["configs"]] + [
        w["name"] for w in b["workloads"]] + [
        m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        assert c["file"].startswith("portbench/")
        cfg = json.loads((_tiny.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200
        cell = json.loads((_tiny.PB / "cells" / f"{w['name']}.json")
                          .read_text())
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert w["config"] in {c["name"] for c in b["configs"]}
        assert (_tiny.PB / "traffic" / f"{w['traffic']}.json").exists()
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics_have_readers_that_agree():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25
               for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 1 <= len(m.get("layer", "x")) <= 200
        assert m["source"] in SOURCES
        mod = harness.metric_module(m["name"])
        assert (mod.UNIT, mod.SOURCE) == (m["unit"], m["source"])
        if "layer" in m:
            assert mod.LAYER == m["layer"] and m["moves"] in e2e
            assert set(m["workloads"]) <= cells
            # each cell it lists reports the end-to-end metric it moves
            moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
            assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    # every reader is whole, listed or not yet (the cascade cell's Hamming
    # roofline waits for that cell)
    for path in (_tiny.PB / "metrics").glob("*.py"):
        mod = harness.metric_module(path.stem)
        assert callable(mod.read) and UNIT.match(mod.UNIT)
        assert mod.SOURCE in SOURCES and mod.LAYER


def test_run_seconds_fits_the_full_check():
    rs = _bench()["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", ["flat4m-backlog", "cascade131k-backlog",
                                  "qenc-flat4m-backlog"])
def test_cells_name_their_files(cell):
    spec = harness.load_spec(cell)
    assert spec.cfg["kind"] in ("flat", "cascade", "encoded_flat")
    assert spec.traffic["generator"] in ("closed_loop", "poisson")
    want = {"score_err", "rank_miss"}
    if spec.cfg["kind"] == "encoded_flat":
        # the encoder judged apart, with the per-query tolerance beside
        want |= {"enc_err", "enc_miss"}
        assert math.isfinite(spec.cell["enc_tol"]) and spec.cell["enc_tol"] > 0
    assert set(spec.cell["limits"]) == want
    assert all(math.isfinite(v) and v > 0
               for v in spec.cell["limits"].values())
