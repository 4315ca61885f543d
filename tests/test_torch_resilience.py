"""Fault-tolerant serving: the port's controllers and server against
``repro.serving``.

The controllers (token bucket, admission, degradation, fault injector)
must decide as the reference's do on identical input sequences. The
server tests are the port's counterparts of tests/test_resilience.py's
deadline, shedding, degradation, chaos, watchdog, guarded-ladder and
overload-drill tests and of tests/test_async_serving.py's facade tests,
over fake searches that return CPU tensors. Every test that waits on a
thread or a deadline runs under its own short time limit.
"""
import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from repro.serving import resilience as jres
from repro_torch.serving import resilience as tres
from repro_torch.serving.resilience import (AdmissionController,
                                            DeadlineExceeded,
                                            DegradationController,
                                            DispatcherFailed, FaultInjected,
                                            FaultInjector, Overloaded,
                                            ResilienceConfig, TokenBucket)
from repro_torch.serving.server import (AsyncRetrievalServer,
                                        RetrievalServer, ServeConfig,
                                        ServerClosed, Served)

chaos = pytest.mark.chaos

Q = (np.zeros((4, 16), np.float32), np.ones(4, bool),
     np.zeros(4, np.float32))
LIMIT_S = 20.0          # each waiting test's own time limit


def _fake_search(q, qm, qs):
    b = q.shape[0]
    return (torch.zeros((b, 5)),
            torch.arange(5, dtype=torch.int32).repeat(b, 1))


def _fake_degraded(q, qm, qs):
    b = q.shape[0]
    return (torch.full((b, 5), -1.0),
            torch.arange(5, dtype=torch.int32).repeat(b, 1))


def _server(search, cfg, degraded=()):
    return AsyncRetrievalServer(search, cfg, degraded, device="cpu")


def _run(coro, timeout=LIMIT_S):
    """asyncio.run under a time limit: a hang fails the test."""
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _poll(predicate, timeout=5.0, msg="condition"):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if predicate():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


# ---------------------------------------------------------------------------
# The controllers decide as the reference's do
# ---------------------------------------------------------------------------

def test_resilience_config_matches_jax():
    assert tres.SLO_CLASSES == jres.SLO_CLASSES
    assert tres.ResilienceConfig() == tres.ResilienceConfig(**{
        f: getattr(jres.ResilienceConfig(), f)
        for f in jres.ResilienceConfig.__dataclass_fields__})
    for bad in (dict(max_queue=0), dict(degrade_low_frac=0.9,
                                        degrade_high_frac=0.5)):
        with pytest.raises(ValueError):
            tres.ResilienceConfig(**bad)
        with pytest.raises(ValueError):
            jres.ResilienceConfig(**bad)


@pytest.mark.parametrize("seed", range(3))
def test_token_bucket_and_admission_match_jax(seed):
    rng = np.random.default_rng(seed)
    kw = dict(max_queue=int(rng.integers(4, 40)),
              shed_batch_frac=float(rng.uniform(0.2, 0.9)),
              interactive_rate=float(rng.choice([0.0, 5.0, 50.0])),
              interactive_burst=float(rng.integers(1, 8)),
              batch_rate=float(rng.choice([0.0, 3.0, 20.0])),
              batch_burst=float(rng.integers(1, 8)))
    tadm = tres.AdmissionController(tres.ResilienceConfig(**kw))
    jadm = jres.AdmissionController(jres.ResilienceConfig(**kw))
    tb, jb = tres.TokenBucket(7.0, 3.0), jres.TokenBucket(7.0, 3.0)
    now = 100.0
    for _ in range(400):
        now += float(rng.exponential(0.05))
        slo = str(rng.choice(tres.SLO_CLASSES))
        depth = int(rng.integers(0, kw["max_queue"] + 3))
        assert tadm.admit(slo, depth, now=now) == jadm.admit(slo, depth,
                                                             now=now)
        assert tb.try_take(now=now) == jb.try_take(now=now)
    assert tadm.stats() == jadm.stats()
    tadm.reset()
    jadm.reset()
    assert tadm.stats() == jadm.stats() == {"interactive": 0, "batch": 0}


@pytest.mark.parametrize("seed", range(3))
def test_degradation_controller_matches_jax(seed):
    rng = np.random.default_rng(seed)
    lo = float(rng.uniform(0.0, 0.4))
    kw = dict(degrade_high_frac=float(rng.uniform(lo, 1.0)),
              degrade_low_frac=lo, degrade_hold=int(rng.integers(1, 5)),
              degrade_p99_ms=float(rng.choice([0.0, 40.0])))
    n_levels = int(rng.integers(1, 5))
    tdc = tres.DegradationController(n_levels, tres.ResilienceConfig(**kw))
    jdc = jres.DegradationController(n_levels, jres.ResilienceConfig(**kw))
    for _ in range(300):
        frac, p99 = float(rng.uniform(0, 1)), float(rng.uniform(0, 80))
        assert tdc.observe(frac, p99) == jdc.observe(frac, p99)
    assert [t[1:] for t in tdc.transitions] == \
        [t[1:] for t in jdc.transitions]
    assert tdc.stats() == jdc.stats()


def test_fault_injector_matches_jax():
    for mod in (tres, jres):
        fi = mod.FaultInjector()
        fi.arm("stage", times=2)
        fired = 0
        for _ in range(4):
            try:
                fi.fire("stage")
            except mod.FaultInjected:
                fired += 1
        assert fired == 2 and fi.fired == {"stage": 2}


# ---------------------------------------------------------------------------
# Controller units (tests/test_resilience.py:57-134)
# ---------------------------------------------------------------------------

def test_token_bucket_rate_and_burst():
    tb = TokenBucket(rate=10.0, burst=2.0)
    assert tb.try_take(now=0.0) and tb.try_take(now=0.0)
    assert not tb.try_take(now=0.0)
    assert tb.try_take(now=0.1)
    assert not tb.try_take(now=0.1)
    unlimited = TokenBucket(rate=0.0, burst=1.0)
    assert all(unlimited.try_take(now=0.0) for _ in range(100))


def test_admission_queue_bound_and_batch_sheds_first():
    adm = AdmissionController(ResilienceConfig(max_queue=10,
                                               shed_batch_frac=0.5))
    assert adm.admit("interactive", depth=0) is None
    assert adm.admit("batch", depth=0) is None
    assert adm.admit("batch", depth=5) is not None
    assert adm.admit("interactive", depth=5) is None
    assert "queue full" in adm.admit("interactive", depth=10)
    assert adm.stats() == {"interactive": 1, "batch": 1}
    adm.reset()
    assert adm.stats() == {"interactive": 0, "batch": 0}
    with pytest.raises(ValueError, match="unknown SLO class"):
        adm.admit("bulk", depth=0)


def test_admission_token_bucket_per_class():
    adm = AdmissionController(ResilienceConfig(
        max_queue=100, interactive_rate=1.0, interactive_burst=2.0))
    t = 100.0
    assert adm.admit("interactive", 0, now=t) is None
    assert adm.admit("interactive", 0, now=t) is None
    assert "token bucket" in adm.admit("interactive", 0, now=t)
    assert adm.admit("batch", 0, now=t) is None


def test_degradation_hysteresis():
    dc = DegradationController(n_levels=3, cfg=ResilienceConfig(
        degrade_high_frac=0.75, degrade_low_frac=0.25, degrade_hold=3))
    seq = [(0.1, 0), (0.8, 1), (0.9, 2), (0.9, 2), (0.5, 2), (0.1, 2),
           (0.1, 2), (0.5, 2), (0.1, 2), (0.1, 2), (0.1, 1)]
    for frac, level in seq:
        assert dc.observe(frac) == level
    assert len(dc.transitions) == 3
    dc2 = DegradationController(n_levels=2, cfg=ResilienceConfig(
        degrade_p99_ms=50.0))
    assert dc2.observe(0.0, p99_ms=80.0) == 1


def test_fault_injector_arm_fire_clear():
    fi = FaultInjector()
    fi.fire("stage")
    fi.arm("stage", times=2)
    with pytest.raises(FaultInjected):
        fi.fire("stage")
    with pytest.raises(FaultInjected):
        fi.fire("stage")
    fi.fire("stage")
    assert fi.fired["stage"] == 2
    fi.arm("compute", latency_s=0.05)
    t0 = time.perf_counter()
    fi.fire("compute")
    assert time.perf_counter() - t0 >= 0.05
    fi.arm("fanout", exc=RuntimeError("boom"))
    fi.clear("fanout")
    fi.fire("fanout")


# ---------------------------------------------------------------------------
# The sync facade (tests/test_resilience.py:140-236)
# ---------------------------------------------------------------------------

def test_sync_timeout_cancels_queued_item():
    gate = threading.Event()

    def stalled_search(q, qm, qs):
        gate.wait(10.0)
        return _fake_search(q, qm, qs)

    server = RetrievalServer(stalled_search, ServeConfig(
        max_batch=1, max_wait_ms=0.5, max_inflight=1), device="cpu")
    try:
        req_a = server.submit(*Q)
        with pytest.raises(TimeoutError, match="timed out"):
            server.query(*Q, timeout=0.3)
        gate.set()
        assert req_a.event.wait(5.0) and req_a.error is None
        s, ids = server.query(*Q, timeout=5.0)
        assert s.shape == (5,)
        _poll(lambda: server.stats()["timeouts"] == 1, msg="timeout count")
        assert server.stats()["n"] == 2       # A + the probe, never B
    finally:
        gate.set()
        server.close()


def test_close_raises_when_thread_fails_to_join():
    server = RetrievalServer(_fake_search, ServeConfig(max_batch=1),
                             device="cpu")
    real_thread = server._thread

    class StuckThread:
        name = "serve-loop"
        daemon = True

        def join(self, timeout=None):
            pass

        def is_alive(self):
            return True

    server._thread = StuckThread()
    with pytest.raises(RuntimeError, match="failed to join"):
        server.close()
    real_thread.join(timeout=5.0)
    assert not real_thread.is_alive()
    server._loop.close()


def test_qps_span_from_timestamps_only():
    server = RetrievalServer(_fake_search, ServeConfig(
        max_batch=4, max_wait_ms=1.0), device="cpu")
    try:
        for _ in range(4):
            server.query(*Q, timeout=5.0)
        st = server.stats()
        assert st["n"] == 4 and st["qps"] > 0.0
        assert st["n"] / st["qps"] <= 60.0
        srv = server._async
        with srv._lock:
            srv._t_first_enqueue = None
            srv._t_last_done = None
        st = server.stats()
        assert st["n"] == 4 and st["qps"] == 0.0
    finally:
        server.close()


def test_reset_stats_race_restores_window():
    gate = threading.Event()

    def slow_search(q, qm, qs):
        gate.wait(5.0)
        return _fake_search(q, qm, qs)

    server = RetrievalServer(slow_search, ServeConfig(
        max_batch=1, max_wait_ms=0.2), device="cpu")
    try:
        req = server.submit(*Q)
        time.sleep(0.05)
        server.reset_stats()
        gate.set()
        assert req.event.wait(5.0) and req.error is None
        st = server.stats()
        assert st["n"] == 1 and 0.0 < st["qps"] < float("inf")
    finally:
        gate.set()
        server.close()


# ---------------------------------------------------------------------------
# tests/test_async_serving.py:159-245, where the port lacked them
# ---------------------------------------------------------------------------

def test_close_drains_queued_requests_with_terminal_error():
    def slow_search(q, qm, qs):
        time.sleep(0.1)
        return _fake_search(q, qm, qs)

    server = RetrievalServer(slow_search, ServeConfig(
        max_batch=1, max_wait_ms=0.5), device="cpu")
    reqs = [server.submit(*Q) for _ in range(6)]
    time.sleep(0.05)
    t0 = time.perf_counter()
    server.close()
    assert time.perf_counter() - t0 < 10.0
    served = errored = 0
    for r in reqs:
        assert r.event.wait(5.0)
        if r.error is not None:
            assert isinstance(r.error, ServerClosed)
            errored += 1
        else:
            assert r.result is not None
            served += 1
    assert served + errored == 6 and errored >= 1 and served >= 1
    r = server.submit(*Q)
    assert r.event.wait(1.0) and isinstance(r.error, ServerClosed)
    server.close()                      # idempotent


def test_staging_error_fails_batch_but_not_server():
    async def go():
        srv = _server(_fake_search, ServeConfig(max_batch=4,
                                                max_wait_ms=50.0))
        bad = await asyncio.gather(
            srv.query(np.zeros((4, 16), np.float32), np.ones(4, bool),
                      np.zeros(4, np.float32)),
            srv.query(np.zeros((8, 16), np.float32), np.ones(8, bool),
                      np.zeros(8, np.float32)),
            return_exceptions=True)
        assert any(isinstance(r, Exception) for r in bad)
        s, ids = await srv.query(*Q)
        assert s.shape == (5,) and ids.shape == (5,)
        await srv.aclose()

    _run(go())


def test_async_query_after_aclose_raises():
    async def go():
        srv = _server(_fake_search, ServeConfig(max_batch=2))
        await srv.query(*Q)
        await srv.aclose()
        with pytest.raises(ServerClosed):
            await srv.query(*Q)

    _run(go())


def test_warm_shapes_runs_every_rung_and_level():
    calls = []

    def search(q, qm, qs):
        calls.append((q.shape[0], 0))
        return _fake_search(q, qm, qs)

    def degraded(q, qm, qs):
        calls.append((q.shape[0], 1))
        return _fake_degraded(q, qm, qs)

    srv = _server(search, ServeConfig(max_batch=8), (degraded,))
    srv.warm_shapes(*Q)
    assert {(b, 4) for b in (1, 2, 4, 8)} <= srv.compiled_shapes
    assert sorted(calls) == sorted((b, lv) for b in (1, 2, 4, 8)
                                   for lv in (0, 1))
    calls.clear()
    srv.warm_shapes(*Q, rungs=(2,), levels=(1,))
    assert calls == [(2, 1)]


def test_single_shape_config_pads_every_batch():
    server = RetrievalServer(_fake_search, ServeConfig(
        max_batch=8, max_wait_ms=2.0, ladder=(8,)), device="cpu")
    try:
        reqs = [server.submit(*Q) for _ in range(3)]
        for r in reqs:
            assert r.event.wait(10.0) and r.error is None
            assert isinstance(r.result, Served) and r.result.level == 0
        assert list(server.stats()["rungs"]) == [8]
    finally:
        server.close()


# ---------------------------------------------------------------------------
# Deadlines, shedding, degradation (tests/test_resilience.py:242-357)
# ---------------------------------------------------------------------------

def test_deadline_expired_before_staging():
    async def go():
        srv = _server(_fake_search, ServeConfig(
            max_batch=2, max_wait_ms=0.5, resilience=ResilienceConfig()))
        srv.fault_injector.arm("dispatch", latency_s=0.08)
        with pytest.raises(DeadlineExceeded, match="before staging"):
            await srv.query(*Q, deadline_ms=20.0)
        st = srv.stats()
        assert st["deadline_expired"] == 1 and st["n"] == 0
        out = await srv.query(*Q, deadline_ms=5000.0)
        assert isinstance(out, Served) and out.level == 0
        await srv.aclose()

    _run(go())


def test_deadline_expired_during_compute():
    async def go():
        srv = _server(_fake_search, ServeConfig(
            max_batch=1, max_wait_ms=0.2, resilience=ResilienceConfig()))
        srv.fault_injector.arm("compute", latency_s=0.08)
        with pytest.raises(DeadlineExceeded, match="during compute"):
            await srv.query(*Q, deadline_ms=20.0)
        assert srv.stats()["deadline_expired"] == 1
        await srv.aclose()

    _run(go())


def test_overload_sheds_with_explicit_rejection():
    gate = threading.Event()

    def stalled(q, qm, qs):
        gate.wait(10.0)
        return _fake_search(q, qm, qs)

    async def go():
        srv = _server(stalled, ServeConfig(
            max_batch=1, max_wait_ms=0.2, max_inflight=1,
            resilience=ResilienceConfig(max_queue=4, shed_batch_frac=0.5)))
        tasks = [asyncio.ensure_future(srv.query(*Q)) for _ in range(12)]
        await asyncio.sleep(0.1)
        batch_rej = None
        try:
            await srv.query(*Q, slo="batch")
        except Overloaded as e:
            batch_rej = str(e)
        gate.set()
        outs = await asyncio.gather(*tasks, return_exceptions=True)
        st = srv.stats()
        await srv.aclose()
        return outs, st, batch_rej

    try:
        outs, st, batch_rej = _run(go())
    finally:
        gate.set()
    shed = [o for o in outs if isinstance(o, Overloaded)]
    served = [o for o in outs if isinstance(o, Served)]
    assert len(shed) + len(served) == 12
    assert len(shed) >= 1 and len(served) >= 1
    assert st["shed"] == len(shed) + 1
    assert batch_rej is not None and "batch class shed" in batch_rej


def test_degradation_ladder_serves_and_recovers():
    async def go():
        res = ResilienceConfig(max_queue=64, degrade_high_frac=0.05,
                               degrade_low_frac=0.01, degrade_hold=2,
                               watchdog_interval_s=0.02)
        srv = _server(_fake_search, ServeConfig(
            max_batch=2, max_wait_ms=0.2, max_inflight=1, resilience=res),
            (_fake_degraded,))
        srv.fault_injector.arm("compute", latency_s=0.01, times=1000)
        burst = await asyncio.gather(*[srv.query(*Q) for _ in range(40)],
                                     return_exceptions=True)
        st_hot = srv.stats()
        srv.fault_injector.clear()
        for _ in range(30):
            out = await srv.query(*Q)
            if out.level == 0 and srv.stats()["degrade_level"] == 0:
                break
            await asyncio.sleep(0.02)
        st_calm = srv.stats()
        await srv.aclose()
        return burst, st_hot, st_calm

    burst, st_hot, st_calm = _run(go())
    served = [o for o in burst if isinstance(o, Served)]
    assert len(served) == 40
    degraded = [o for o in served if o.level == 1]
    assert degraded and st_hot["level_served"].get(1, 0) == len(degraded)
    assert all(np.all(np.asarray(o[0]) == -1.0) for o in degraded)
    assert st_calm["degrade_level"] == 0


def test_stats_keys_match_jax_with_resilience():
    from repro.serving import server as jax_server
    jsrv = jax_server.AsyncRetrievalServer(
        lambda q, qm, qs: (np.zeros((q.shape[0], 5), np.float32),
                           np.zeros((q.shape[0], 5), np.int32)),
        jax_server.ServeConfig(max_batch=2,
                               resilience=jres.ResilienceConfig()))
    tsrv = _server(_fake_search, ServeConfig(
        max_batch=2, resilience=ResilienceConfig()))
    assert tsrv.stats().keys() == jsrv.stats().keys()


# ---------------------------------------------------------------------------
# Chaos: fault injection at each site, watchdog (tests/test_resilience.py
# :363-469 and :637)
# ---------------------------------------------------------------------------

@chaos
def test_chaos_stage_fault_isolated_sentry_unchanged():
    async def go():
        srv = _server(_fake_search, ServeConfig(
            max_batch=2, max_wait_ms=0.5, guard_recompiles=True,
            resilience=ResilienceConfig()))
        srv.warm_shapes(*Q)
        sigs_before = set(srv.recompile_sentry.signatures)
        srv.fault_injector.arm("stage")
        with pytest.raises(FaultInjected):
            await srv.query(*Q)
        assert srv.stats()["watchdog_restarts"] == 0
        out = await srv.query(*Q)
        assert isinstance(out, Served)
        assert set(srv.recompile_sentry.signatures) == sigs_before
        await srv.aclose()

    _run(go())


@chaos
@pytest.mark.parametrize("site", ["compute", "fanout"])
def test_chaos_compute_and_fanout_faults_contained(site):
    async def go():
        srv = _server(_fake_search, ServeConfig(
            max_batch=2, max_wait_ms=0.5, resilience=ResilienceConfig()))
        srv.fault_injector.arm(site)
        with pytest.raises(FaultInjected):
            await srv.query(*Q)
        out = await srv.query(*Q)
        assert isinstance(out, Served)
        assert srv.stats()["watchdog_restarts"] == 0
        await srv.aclose()

    _run(go())


@chaos
def test_chaos_dispatcher_death_watchdog_restarts():
    async def go():
        srv = _server(_fake_search, ServeConfig(
            max_batch=2, max_wait_ms=0.5,
            resilience=ResilienceConfig(watchdog_interval_s=0.02)))
        srv.fault_injector.arm("dispatch")
        with pytest.raises(DispatcherFailed, match="restarted by watchdog"):
            await srv.query(*Q)
        out = await srv.query(*Q)
        assert isinstance(out, Served)
        assert srv.stats()["watchdog_restarts"] == 1
        await srv.aclose()

    _run(go())


@chaos
def test_chaos_dispatcher_hang_watchdog_restarts():
    gate = threading.Event()

    def stalled(q, qm, qs):
        gate.wait(10.0)
        return _fake_search(q, qm, qs)

    async def go():
        srv = _server(stalled, ServeConfig(
            max_batch=1, max_wait_ms=0.2, max_inflight=1,
            resilience=ResilienceConfig(watchdog_interval_s=0.05,
                                        stall_timeout_s=0.3)))
        task_a = asyncio.ensure_future(srv.query(*Q))
        await asyncio.sleep(0.05)
        task_b = asyncio.ensure_future(srv.query(*Q))
        with pytest.raises(DispatcherFailed, match="hung"):
            await task_b
        gate.set()
        out_a = await task_a
        assert isinstance(out_a, Served)
        assert srv.stats()["watchdog_restarts"] >= 1
        out = await srv.query(*Q)
        assert isinstance(out, Served)
        await srv.aclose()

    try:
        _run(go())
    finally:
        gate.set()


@chaos
def test_chaos_guarded_degraded_serving_stays_on_ladder():
    """The degraded levels are part of the sentry's declared set: a full
    warm-up and an overload burst run exactly ladder x levels."""
    async def go():
        res = ResilienceConfig(max_queue=64, degrade_high_frac=0.05,
                               degrade_low_frac=0.01, degrade_hold=2)
        srv = _server(_fake_search, ServeConfig(
            max_batch=4, max_wait_ms=0.2, max_inflight=1,
            guard_recompiles=True, resilience=res), (_fake_degraded,))
        srv.warm_shapes(*Q)
        srv.fault_injector.arm("compute", latency_s=0.01, times=1000)
        outs = await asyncio.gather(*[srv.query(*Q) for _ in range(30)],
                                    return_exceptions=True)
        await srv.aclose()
        return srv, outs

    srv, outs = _run(go())
    assert all(isinstance(o, Served) for o in outs)
    assert {o.level for o in outs} >= {1}
    sigs = set(srv.recompile_sentry.signatures)
    assert {s[0] for s in sigs} == set(srv.ladder)
    assert {s[-1] for s in sigs} == {0, 1}
    assert len(sigs) == len(srv.ladder) * 2
    srv.recompile_sentry.assert_signatures(
        {(b, 4, "torch.float32", "torch.bool", "torch.float32", lv)
         for b in srv.ladder for lv in (0, 1)})


@chaos
def test_chaos_overload_drill_every_request_resolves():
    async def go():
        res = ResilienceConfig(max_queue=16, shed_batch_frac=0.5,
                               degrade_high_frac=0.25,
                               degrade_low_frac=0.05, degrade_hold=2,
                               default_deadline_ms=2000.0,
                               watchdog_interval_s=0.02)
        srv = _server(_fake_search, ServeConfig(
            max_batch=4, max_wait_ms=0.2, max_inflight=1, resilience=res),
            (_fake_degraded,))
        srv.fault_injector.arm("compute", latency_s=0.02, times=10_000)
        tasks = []
        for _ in range(120):
            tasks.append(asyncio.ensure_future(srv.query(*Q)))
            await asyncio.sleep(0.0005)
        outs = await asyncio.gather(*tasks, return_exceptions=True)
        srv.fault_injector.clear()
        level = None
        for _ in range(50):
            out = await srv.query(*Q, deadline_ms=5000.0)
            level = srv.stats()["degrade_level"]
            if out.level == 0 and level == 0:
                break
            await asyncio.sleep(0.02)
        st = srv.stats()
        await srv.aclose()
        return outs, st, level

    outs, st, level = _run(go(), timeout=40.0)
    served = [o for o in outs if isinstance(o, Served)]
    shed = [o for o in outs if isinstance(o, Overloaded)]
    expired = [o for o in outs if isinstance(o, DeadlineExceeded)]
    assert len(served) + len(shed) + len(expired) == 120
    assert served and shed
    assert level == 0
    assert st["watchdog_restarts"] == 0


def test_guard_rejects_off_ladder_batches_before_any_launch():
    calls = []

    def search(q, qm, qs):
        calls.append(q.shape[0])
        return _fake_search(q, qm, qs)

    from repro_torch.analysis import RecompileGuardError
    srv = _server(search, ServeConfig(max_batch=4, guard_recompiles=True))
    q = torch.zeros((3, 4, 16))
    qm = torch.ones((3, 4), dtype=torch.bool)
    with pytest.raises(RecompileGuardError, match="off-ladder"):
        srv._call_search(0, q, qm, q[:, :, 0])
    with pytest.raises(RecompileGuardError):
        srv._call_search(1, q[:2], qm[:2], q[:2, :, 0])   # no level 1
    assert calls == [] and not srv.recompile_sentry.signatures


# ---------------------------------------------------------------------------
# The recompile sentry (repro.analysis.recompile's counterpart)
# ---------------------------------------------------------------------------

def test_sentry_signatures_and_gates_match_jax():
    from repro.analysis import recompile as jrc
    from repro_torch.analysis import recompile as trc
    assert trc.ladder_signatures((1, 2, 4), 32) == \
        jrc.ladder_signatures((1, 2, 4), 32)
    assert trc.ladder_signatures((8,), (4, 32)) == \
        jrc.ladder_signatures((8,), (4, 32))
    sig = trc.abstract_signature
    a = torch.zeros((2, 4, 16))
    assert sig(a, level=1) == sig(torch.ones((2, 4, 16)), level=1)
    assert sig(a) != sig(a[:1]) and sig(a) != sig(a.double())
    assert sig((a, [a]), k=3) != sig((a, (a,)), k=3)
    assert sig(a, k=3) != sig(a, k=3.0)
    assert sig(np.zeros((2, 4), np.float32)) == sig(np.ones((2, 4),
                                                            np.float32))
    calls = []
    sentry = trc.RecompileSentry(lambda x: calls.append(x.shape) or x,
                                 expected={sig(a)}, max_signatures=1)
    sentry(a)
    with pytest.raises(trc.RecompileGuardError, match="unexpected"):
        sentry(a[:1])
    assert calls == [a.shape] and sentry.calls == 1
    sentry.assert_signatures({sig(a)})
    with pytest.raises(trc.RecompileGuardError, match="missing"):
        sentry.assert_signatures({sig(a), sig(a[:1])})
    capped = trc.RecompileSentry(lambda x: x, max_signatures=1)
    capped(a)
    with pytest.raises(trc.RecompileGuardError, match="max_signatures"):
        capped(a[:1])
    rep = capped.report()
    assert rep["n_signatures"] == 2 and rep["calls"] == 2
    assert rep.keys() == jrc.RecompileSentry(lambda x: x).report().keys()
