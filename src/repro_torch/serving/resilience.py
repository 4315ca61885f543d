"""Fault-tolerant serving substrate: the policy objects behind
`AsyncRetrievalServer`'s overload and failure behaviour.

The counterpart of ``repro.serving.resilience``, copied nearly verbatim:
the controllers are host-side Python and decide exactly as the
reference's do on the same inputs.

Under overload a serving stack without admission control silently builds
backlog until client timeouts fire — every request is eventually "served"
into a void. This module makes the failure modes explicit and *cheap*:

  * **Deadlines** — every request may carry one; expired requests are
    dropped before staging (never burn device compute) and cancelled at
    fan-out (never deliver a result the client stopped waiting for).
    `DeadlineExceeded` is the terminal error.
  * **Bounded admission + load shedding** — a bounded queue with explicit
    `Overloaded` rejection and per-SLO-class token buckets
    (`interactive` / `batch`). Shedding is cost-aware: the `batch` class
    sheds first (at `shed_batch_frac` of the queue bound), `interactive`
    only at the hard bound.
  * **Graceful degradation** — `DegradationController` watches queue
    depth (and optionally p99) and steps the active *degradation level*
    up/down under hysteresis. Levels index a pre-warmed ladder of
    search functions (full cascade budgets -> halved budgets -> ...
    -> hamming-only prefilter), so stepping down trades quality for
    latency without a single off-ladder batch shape.
  * **Fault injection** — `FaultInjector` arms exceptions / latency
    spikes at named sites inside the serving loop (stage / compute /
    fanout / dispatch); the chaos suite (tests/test_torch_resilience.py)
    drives it to prove each failure stays contained.
  * **Watchdog** — the server's watchdog task (see server.py) detects a
    dead or hung coalescing loop, restarts it, and fails the requests
    the dead loop had claimed with `DispatcherFailed` instead of
    letting them hang.

All controllers here are plain host-side Python: no device work,
O(1) per decision. See docs/design.md §11 for the full policy writeup.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "AdmissionController",
    "DeadlineExceeded",
    "DegradationController",
    "DispatcherFailed",
    "FaultInjector",
    "FaultInjected",
    "Overloaded",
    "ResilienceConfig",
    "SLO_CLASSES",
    "TokenBucket",
]

SLO_CLASSES = ("interactive", "batch")


class Overloaded(RuntimeError):
    """Request rejected at admission: queue bound or SLO-class budget.

    The explicit alternative to silent backlog — a client that sees
    `Overloaded` can back off / retry elsewhere instead of waiting out a
    timeout behind an unbounded queue.
    """


class DeadlineExceeded(TimeoutError):
    """Request deadline passed before (or while) it was served."""


class DispatcherFailed(RuntimeError):
    """Terminal error for requests claimed by a dead/hung dispatcher.

    Set by the watchdog when it restarts the coalescing loop: requests
    the dead loop had already dequeued cannot be recovered (their batch
    state died with it), so their waiters are released with this error
    instead of hanging forever.
    """


class FaultInjected(RuntimeError):
    """Default exception raised by an armed `FaultInjector` site."""


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Knobs of the fault-tolerant serving layer (docs/design.md §11).

    Attach via ``ServeConfig(resilience=ResilienceConfig(...))``; None
    keeps the pre-resilience behaviour (unbounded queue, no deadlines,
    no degradation, no watchdog) for existing call sites.
    """

    # -- bounded admission + shedding --------------------------------------
    # Hard queue bound; a request arriving with `max_queue` already
    # waiting is rejected with `Overloaded` regardless of class.
    max_queue: int = 128
    # Queue-depth fraction beyond which the `batch` class sheds
    # (cost-aware: batch work is deferrable, interactive is not).
    shed_batch_frac: float = 0.5
    # Per-class token buckets (requests/s + burst); rate 0 = unlimited.
    interactive_rate: float = 0.0
    interactive_burst: float = 32.0
    batch_rate: float = 0.0
    batch_burst: float = 32.0

    # -- deadlines ----------------------------------------------------------
    # Applied to requests that carry no explicit deadline; 0 = none.
    default_deadline_ms: float = 0.0

    # -- degradation ladder -------------------------------------------------
    # Step one level DOWN the quality ladder when queue depth crosses
    # `degrade_high_frac` of max_queue (or p99 crosses degrade_p99_ms,
    # when set); step back UP one level only after `degrade_hold`
    # consecutive calm observations below `degrade_low_frac` — the
    # hysteresis band between the two fractions holds the level.
    degrade_high_frac: float = 0.75
    degrade_low_frac: float = 0.25
    degrade_p99_ms: float = 0.0
    degrade_hold: int = 4

    # -- watchdog -----------------------------------------------------------
    watchdog_interval_s: float = 0.05
    # A claimed-but-unresolved request older than this is failed with
    # `DispatcherFailed`; a dispatcher whose heartbeat is older than this
    # while work is pending is cancelled and restarted.
    stall_timeout_s: float = 30.0

    def __post_init__(self):
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if not 0.0 <= self.degrade_low_frac <= self.degrade_high_frac:
            raise ValueError(
                "need 0 <= degrade_low_frac <= degrade_high_frac, got "
                f"({self.degrade_low_frac}, {self.degrade_high_frac})")


class TokenBucket:
    """Classic token bucket: `rate` tokens/s, capacity `burst`.

    `rate <= 0` means unlimited (every take succeeds). Host-clock based
    (time.perf_counter), O(1) per take, no background refill task.
    """

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self.tokens = self.burst
        self._t_last: Optional[float] = None

    def try_take(self, now: Optional[float] = None) -> bool:
        if self.rate <= 0:
            return True
        if now is None:
            now = time.perf_counter()
        if self._t_last is not None:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._t_last) * self.rate)
        self._t_last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class AdmissionController:
    """Bounded queue + per-SLO-class token buckets + cost-aware shedding.

    `admit(slo, depth)` returns None to admit, or a short reason string
    when the request must be shed (the server raises `Overloaded` with
    it). Rejections are counted per class in `shed_counts`.
    """

    def __init__(self, cfg: ResilienceConfig):
        self.cfg = cfg
        self.buckets = {
            "interactive": TokenBucket(cfg.interactive_rate,
                                       cfg.interactive_burst),
            "batch": TokenBucket(cfg.batch_rate, cfg.batch_burst),
        }
        self.shed_counts: Dict[str, int] = {c: 0 for c in SLO_CLASSES}
        self._lock = threading.Lock()

    def admit(self, slo: str, depth: int,
              now: Optional[float] = None) -> Optional[str]:
        if slo not in SLO_CLASSES:
            raise ValueError(
                f"unknown SLO class {slo!r}; expected one of {SLO_CLASSES}")
        cfg = self.cfg
        with self._lock:
            if depth >= cfg.max_queue:
                self.shed_counts[slo] += 1
                return (f"queue full ({depth}/{cfg.max_queue})")
            if (slo == "batch"
                    and depth >= cfg.shed_batch_frac * cfg.max_queue):
                self.shed_counts[slo] += 1
                return (f"batch class shed at depth {depth} "
                        f">= {cfg.shed_batch_frac:.0%} of {cfg.max_queue}")
            if not self.buckets[slo].try_take(now):
                self.shed_counts[slo] += 1
                return f"{slo} token bucket empty"
        return None

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.shed_counts)

    def reset(self) -> None:
        """Zero the shed counters (token-bucket fill is left alone)."""
        with self._lock:
            self.shed_counts = {c: 0 for c in SLO_CLASSES}


class DegradationController:
    """Queue-depth/p99-driven quality-for-latency ladder with hysteresis.

    `observe(depth_frac, p99_ms)` is called once per dispatcher
    iteration and returns the level every batch of that iteration is
    served at. Level 0 is full quality; higher levels select cheaper
    pre-warmed search functions (smaller cascade budgets, ultimately
    the hamming-only prefilter). Stepping down is immediate (overload is
    now); stepping back up requires `hold` consecutive calm
    observations, so a bursty arrival process does not flap the level.
    """

    def __init__(self, n_levels: int, cfg: Optional[ResilienceConfig] = None):
        if n_levels < 1:
            raise ValueError(f"n_levels must be >= 1, got {n_levels}")
        self.n_levels = n_levels
        self.cfg = cfg if cfg is not None else ResilienceConfig()
        self._level = 0
        self._calm = 0
        # (t_monotonic, from_level, to_level) — bounded history
        self.transitions: List[Tuple[float, int, int]] = []
        self._lock = threading.Lock()

    @property
    def level(self) -> int:
        return self._level

    def _move(self, to: int) -> None:
        if to != self._level:
            self.transitions.append((time.perf_counter(), self._level, to))
            del self.transitions[:-256]
            self._level = to

    def observe(self, depth_frac: float, p99_ms: float = 0.0) -> int:
        cfg = self.cfg
        hot = depth_frac >= cfg.degrade_high_frac or (
            cfg.degrade_p99_ms > 0 and p99_ms >= cfg.degrade_p99_ms)
        calm = depth_frac <= cfg.degrade_low_frac and not hot
        with self._lock:
            if hot:
                self._calm = 0
                self._move(min(self._level + 1, self.n_levels - 1))
            elif calm and self._level > 0:
                self._calm += 1
                if self._calm >= cfg.degrade_hold:
                    self._calm = 0
                    self._move(self._level - 1)
            elif not calm:
                self._calm = 0          # hysteresis band: hold the level
            return self._level

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {"level": float(self._level),
                    "n_levels": float(self.n_levels),
                    "transitions": float(len(self.transitions))}


class FaultInjector:
    """Named-site fault injection for the chaos suite.

    The serving loop calls `fire(site)` at its instrumented sites
    ("stage", "compute", "fanout", "dispatch"); an unarmed site is a
    no-op costing one dict lookup. `arm` installs an exception and/or a
    latency spike that fires on the next `times` calls. Thread-safe:
    sites fire from both the event loop and executor threads.
    """

    def __init__(self):
        self._armed: Dict[str, Dict] = {}
        self.fired: Dict[str, int] = {}
        self._lock = threading.Lock()

    def arm(self, site: str, *, exc: Optional[BaseException] = None,
            latency_s: float = 0.0, times: int = 1) -> None:
        """Arm `site` to raise `exc` (default `FaultInjected`) and/or
        sleep `latency_s` on its next `times` firings."""
        if exc is None and latency_s <= 0.0:
            exc = FaultInjected(f"injected fault at site {site!r}")
        with self._lock:
            self._armed[site] = {"exc": exc, "latency_s": float(latency_s),
                                 "times": int(times)}

    def clear(self, site: Optional[str] = None) -> None:
        with self._lock:
            if site is None:
                self._armed.clear()
            else:
                self._armed.pop(site, None)

    def fire(self, site: str) -> None:
        with self._lock:
            spec = self._armed.get(site)
            if spec is None:
                return
            spec["times"] -= 1
            if spec["times"] <= 0:
                del self._armed[site]
            self.fired[site] = self.fired.get(site, 0) + 1
            exc, latency = spec["exc"], spec["latency_s"]
        if latency > 0.0:
            # deliberately a blocking sleep: the injector simulates a
            # stalled device/host exactly where the real stall would be
            time.sleep(latency)
        if exc is not None:
            raise exc
