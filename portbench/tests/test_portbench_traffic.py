"""The traffic generators, driven against a stand-in server: schedules
from the seed, a true closed loop, an open loop on its due times."""
from __future__ import annotations

import asyncio
import contextlib
import itertools

import numpy as np
import pytest

from portbench.traffic import QueryOrder, closed_loop, poisson


def _nospan(name):
    return contextlib.nullcontext()


def _drive(mod, params, seconds, seed=11, delay=lambda i: 0.002):
    out = {"records": [], "inflight": 0, "most": 0, "sent": []}

    async def send(i):
        out["inflight"] += 1
        out["most"] = max(out["most"], out["inflight"])
        out["sent"].append(i)
        await asyncio.sleep(delay(i))
        out["inflight"] -= 1
        return ("answer", i)

    def record(i, t_ref, t_done, result, error, late=0.0):
        out["records"].append((i, t_ref, t_done, result, error, late))

    async def main():
        stop = asyncio.Event()
        task = asyncio.ensure_future(mod.drive(
            send, params, seed=seed, n_pool=50, stop=stop, record=record,
            span=_nospan))
        await asyncio.sleep(seconds)
        stop.set()
        await asyncio.wait_for(task, 5)

    asyncio.run(main())
    return out


def test_query_order_is_the_seeds():
    a = [QueryOrder(50, 3).next() for _ in range(1)]
    o1, o2, o3 = QueryOrder(50, 3), QueryOrder(50, 3), QueryOrder(50, 4)
    s1 = [o1.next() for _ in range(120)]
    assert s1 == [o2.next() for _ in range(120)]
    assert s1 != [o3.next() for _ in range(120)]
    assert sorted(s1[:50]) == list(range(50)) == sorted(s1[50:100])
    assert a == s1[:1]


def test_closed_loop_keeps_one_request_per_client():
    out = _drive(closed_loop, {"clients": 5}, 0.3)
    assert out["most"] == 5 and out["inflight"] == 0
    assert len(out["records"]) == len(out["sent"]) > 20
    assert all(r[3] == ("answer", r[0]) and r[4] is None
               for r in out["records"])
    assert all(r[2] >= r[1] for r in out["records"])


def test_closed_loop_offers_less_load_to_a_slower_system():
    fast = _drive(closed_loop, {"clients": 4}, 0.3)
    slow = _drive(closed_loop, {"clients": 4}, 0.3,
                  delay=lambda i: 0.02)
    assert len(slow["records"]) < len(fast["records"]) / 3


def test_closed_loop_records_a_failed_request():
    async def send(i):
        raise RuntimeError("down")

    records = []

    async def main():
        stop = asyncio.Event()
        task = asyncio.ensure_future(closed_loop.drive(
            send, {"clients": 2}, seed=1, n_pool=5, stop=stop,
            record=lambda *r: records.append(r), span=_nospan))
        await asyncio.sleep(0.01)
        stop.set()
        await task

    asyncio.run(main())
    assert records and all(isinstance(r[4], RuntimeError) for r in records)


def test_poisson_schedule_is_the_seeds():
    p = {"rates": [[1e9, 200.0]]}
    a = list(itertools.islice(poisson.arrivals(p, 5), 500))
    assert a == list(itertools.islice(poisson.arrivals(p, 5), 500))
    assert a != list(itertools.islice(poisson.arrivals(p, 6), 500))
    assert all(x < y for x, y in zip(a, a[1:]))


def test_poisson_rate_and_gaps():
    t = np.array(list(itertools.islice(
        poisson.arrivals({"rates": [[1e9, 500.0]]}, 9), 20000)))
    gaps = np.diff(t)
    assert abs(gaps.mean() * 500.0 - 1.0) < 0.03
    # exponential gaps: the coefficient of variation is 1
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.05


def test_poisson_rate_schedule_cycles():
    p = {"rates": [[2.0, 300.0], [2.0, 50.0]]}
    t = np.array(list(itertools.takewhile(
        lambda x: x < 400.0, poisson.arrivals(p, 13))))
    on = ((t % 4.0) < 2.0).sum()
    off = ((t % 4.0) >= 2.0).sum()
    assert abs(on / (100 * 2.0 * 300.0) - 1.0) < 0.03
    assert abs(off / (100 * 2.0 * 50.0) - 1.0) < 0.05


def test_poisson_drive_sends_on_due_times():
    out = _drive(poisson, {"rates": [[1e9, 400.0]]}, 0.5)
    recs = out["records"]
    assert 100 < len(recs) < 320
    due = [r[1] for r in recs]
    # every request was timed from its due time, and none was sent early
    assert all(r[5] >= 0 for r in recs)
    assert np.median([r[5] for r in recs]) < 0.005
    assert sorted(due) == sorted(set(due))


@pytest.mark.parametrize("mod", [closed_loop, poisson])
def test_no_request_after_stop(mod):
    out = _drive(mod, {"clients": 3, "rates": [[1e9, 300.0]]}, 0.2)
    assert out["inflight"] == 0
    assert len(out["sent"]) == len(out["records"])
