"""The port's own spans in a traced window, on the CPU: the idle gaps split
by program span (by hand, and unchanged without program spans), the
spans joined to the trace's clock, and a tiny traced run with the
program's tracer on reporting the metrics that read them."""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from portbench import harness, program_run, program_trace, trace
from portbench.tests import _tiny
from repro_torch import tracing
from repro_torch.tracing import Span

SEED = 3_000_000_019

DEVICE = [("void qmaxsim_kernel<unsigned char, 2, true>(Params, int)",
           0.0, 10.0),
          ("void maxsim_kernel(Params)", 90.0, 100.0)]
HOST = [("pb.search", 10.0, 90.0), ("pb.client", 20.0, 25.0),
        ("pb.sync", 85.0, 88.0)]
# (label, start_us, end_us, depth): two threads' spans over the idle
# [10, 90]; the queue wait covers it all and takes nothing
PROGRAM = [("serve.search", 10.0, 60.0, 0),
           ("serve.search/retrieval.search", 12.0, 58.0, 1),
           ("retrieval.backend/cascade.stage1", 14.0, 45.0, 2),
           ("cascade.stage1/scan.merge", 30.0, 40.0, 3),
           ("serve.d2h", 50.0, 70.0, 0),
           ("serve.coalesce", 75.0, 80.0, 0),
           ("serve.queue", 10.0, 90.0, 0)]


def test_idle_gaps_by_program_span_by_hand():
    s = program_trace.summarize(DEVICE, HOST, (0.0, 100.0), PROGRAM)
    gaps = {k: v * 1e6 for k, v in s.idle_gaps}
    want = {
        # the benchmark's own spans keep their gaps
        "pb.sync": 3.0, "pb.client": 5.0,
        # the deepest span that launches device work wins, on any thread
        "cascade.stage1/scan.merge": 10.0,
        "retrieval.backend/cascade.stage1": 6.0 + 5.0 + 5.0,
        # over the other thread's device-to-host wait too (50-58)
        "serve.search/retrieval.search": 2.0 + 13.0,
        # other host work wins over a wait (58-60)
        "serve.search": 2.0 + 2.0,
        "serve.d2h": 10.0, "serve.coalesce": 5.0,
        # what no program span covers falls back to the benchmark's span
        "pb.search": 5.0 + 5.0 + 2.0}
    assert gaps.keys() == want.keys()
    for k, v in want.items():
        assert gaps[k] == pytest.approx(v), k
    assert [k for k, _ in s.idle_gaps][0] == \
        "retrieval.backend/cascade.stage1"
    # each gap only splits: the idle total is today's
    today = trace.summarize(DEVICE, HOST, (0.0, 100.0))
    assert sum(v for _, v in s.idle_gaps) == pytest.approx(
        sum(v for _, v in today.idle_gaps)) == pytest.approx(80e-6)
    assert (s.window_s, s.busy_s, s.kernel_s, s.device_ops) == (
        today.window_s, today.busy_s, today.kernel_s, today.device_ops)


def test_idle_no_span_covers_stays_unnamed():
    s = program_trace.summarize(DEVICE, [], (0.0, 100.0),
                                [("scan.lists", 20.0, 30.0, 2)])
    gaps = dict(s.idle_gaps)
    assert gaps["scan.lists"] == pytest.approx(10e-6)
    assert gaps[trace.IDLE_NONE] == pytest.approx(70e-6)


def test_without_program_spans_the_summary_is_todays():
    window = (0.0, 100.0)
    assert program_trace.summarize(DEVICE, HOST, window) == \
        trace.summarize(DEVICE, HOST, window)
    assert program_trace.summarize([], HOST, window, PROGRAM) is None


def _span(name, sid, parent, batch, start, end):
    return Span(name, sid, parent, batch, "t", start, end)


def test_depths_labels_totals_and_serving_split_by_hand():
    spans = [_span("serve.queue", 1, None, 5, 0.0, 2.0),
             _span("serve.queue", 2, None, 5, 1.0, 2.0),
             _span("serve.stage", 3, None, 5, 2.0, 2.5),
             _span("serve.h2d", 4, 3, 5, 2.2, 2.4),
             _span("serve.search", 5, None, 5, 3.0, 7.0),
             _span("retrieval.search", 6, 5, 5, 3.5, 6.0),
             _span("serve.d2h", 7, None, 5, 7.0, 8.0),
             _span("serve.fanout", 8, None, 5, 8.5, 9.0)]
    assert program_trace.depths(spans) == {1: 0, 2: 0, 3: 0, 4: 1, 5: 0,
                                           6: 1, 7: 0, 8: 0}
    lab = program_trace.labels(spans)
    assert (lab[4], lab[6], lab[7]) == ("serve.stage/serve.h2d",
                                        "serve.search/retrieval.search",
                                        "serve.d2h")
    # a parent left out of the list leaves the name alone
    assert program_trace.labels(spans[3:4]) == {4: "serve.h2d"}
    named = program_trace.by_label(spans)
    assert named["serve.search/retrieval.search"]["n"] == 1
    assert named["serve.search"]["n"] == 1
    assert named["serve.search"]["wall_s"] == pytest.approx(4.0)
    assert named["serve.search"]["self_s"] == pytest.approx(1.5)
    assert named["serve.queue"]["n"] == 2
    split = program_trace.serving_split(spans)
    assert split["requests"] == 2
    # enqueue -> answer: 9 and 8 s; the hand-off (0.5) and the return
    # (0.5) are all the serving spans leave out
    assert split["total_ms"] == pytest.approx(8.5e3)
    assert split["mean_ms"]["queue"] == pytest.approx(1.5e3)
    assert split["mean_ms"]["handoff"] == pytest.approx(0.5e3)
    assert split["mean_ms"]["return"] == pytest.approx(0.5e3)
    assert split["covered_pct"] == pytest.approx(100 * 7.5 / 8.5)
    assert program_trace.serving_split(spans[:4]) is None


def test_program_spans_join_the_trace_on_the_cpu():
    p = trace.Profiler()
    tracing.reset()
    p.start()
    tracing.enable()
    try:
        def work():
            with tracing.span("retrieval.search", batch=2):
                with tracing.span("scan.merge"):
                    return torch.ones(10).sum()

        # spans on another thread, as the server's executor threads open
        with ThreadPoolExecutor(1) as pool:
            pool.submit(work).result()
    finally:
        tracing.disable()
        p.stop()
        spans = tracing.spans()
        tracing.reset()
    device, window = p.events()
    assert device == [] and window is not None
    mapped = program_trace.in_trace(spans, p.t_open, window[0])
    assert sorted((n, d) for n, _, _, d in mapped) == [
        ("retrieval.search", 0), ("retrieval.search/scan.merge", 1)]
    for _, a, b, _ in mapped:
        assert window[0] <= a <= b <= window[1]


def test_readers_find_nothing_without_program_spans():
    run = harness.Run(traced=True, t0=0.0, t1=1.0)
    for name in program_run.METRICS:
        assert harness.metric_module(name).read(run) is None


@pytest.fixture(scope="module")
def pb(tmp_path_factory):
    return _tiny.tree(tmp_path_factory.mktemp("pbtree"))


@pytest.mark.parametrize("cell", sorted(_tiny.CELLS))
def test_tiny_run_with_the_program_tracer(pb, cell):
    out = program_run.traced_run(cell, seed=SEED, seconds=0.8, device="cpu",
                                 pb=pb)
    res, prog = out["result"], out["program"]
    assert res["correct"] and res["failed"] == 0
    # the metrics the benchmark lists are those of a traced run
    assert {"mean_batch", "search_ms", "index_gib"} <= set(res["metrics"])
    assert set(prog["metrics"]) == set(program_run.METRICS)
    assert all(v > 0 for v in prog["metrics"].values())
    assert prog["searches"] > 0 and prog["answered"] > 0
    c = prog["server"]
    assert 0 < c["requests"] <= c["slots"]
    assert c["batches"] <= prog["searches"] + 2
    spans = prog["spans"]
    assert spans["serve.stage"]["n"] >= c["batches"] - 2
    assert spans["serve.search/retrieval.search"]["n"] >= \
        prog["searches"] - 2
    assert spans["serve.queue"]["n"] >= prog["answered"] - 8
    # the idle split names labels; on the CPU no op runs on a device
    assert "breakdown" not in res
    names = {label.rsplit("/", 1)[-1] for label in spans}
    stages = ("cascade.stage1", "cascade.stage2", "cascade.stage3",
              "hamming.query_codes")
    if _tiny.TINY_CONFIGS[_tiny.CELLS[cell]]["kind"] == "cascade":
        assert all(s in names for s in stages)
        assert "cascade.stage1/scan.merge" in spans
    else:
        assert "retrieval.search/retrieval.rerank" in spans
        assert not any(s in names for s in stages)
    split = prog["serving"]
    assert split["requests"] > 0 and 0 < split["covered_pct"] <= 100
    assert not tracing.enabled() and tracing.spans() == []


def test_the_harness_patch_takes_hold_and_is_undone(pb):
    """The run reaches the tracer's ``Run`` and ``summarize`` once each, and
    the harness is as it was once the run is over."""
    import gc
    with program_run.program_tracer() as runs:
        harness.run("tiny-flat-cell", seed=SEED, seconds=0.6, traced=True,
                    device="cpu", pb=pb)
    assert len(runs) == 1 and runs[0].summarized == 1
    assert runs[0].spans and runs[0].gc_s >= 0
    assert not any(getattr(cb, "__name__", "") == "timed"
                   for cb in gc.callbacks)
    assert harness.Run.__name__ == "Run"
    assert trace.Profiler.start.__name__ == "start"
    assert trace.summarize.__name__ == "summarize"
    assert not tracing.enabled() and tracing.spans() == []


def test_a_harness_that_binds_its_own_summarize_fails_the_run(
        pb, monkeypatch):
    """A harness that no longer reaches ``summarize`` through the module
    it patches would leave the spans out: the run says so."""
    import types
    own = types.SimpleNamespace(**vars(trace))
    monkeypatch.setattr(harness, "trace_mod", own)
    with pytest.raises(RuntimeError, match="summarize"):
        program_run.traced_run("tiny-flat-cell", seed=SEED, seconds=0.3,
                               device="cpu", pb=pb)
    assert not tracing.enabled()
