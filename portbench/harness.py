"""One run of one cell: set-up, the measured window, the check.

Everything is found by name: the cell ``cells/<cell>.json`` names its
configuration (``configs/<config>.json``, whose ``"kind"`` is a module of
``kinds``) and its traffic mix (``traffic/<mix>.json``, whose
``"generator"`` is a module of ``traffic``); ``BENCHMARK.json`` at the
checkout's root lists the metrics, each read by ``metrics/<metric>.py``.

A run:

  1. set-up: the inputs drawn on the device from the seed, the port's
     index built from them, an ``AsyncRetrievalServer`` over a search
     callable that calls ``Retriever.search``, every ladder rung warmed
     once (the kernel launches of each counted against the expected), and
     ``warm_s`` seconds of the mix's own traffic;
  2. the window: ``seconds`` of the mix, timed on the host's clock; with
     ``trace`` under ``torch.profiler`` and host spans, without it bare;
  3. the check, once the window has closed and the port's state is
     freed: a sample of the window's answers, drawn from the seed, against
     the plain reference run on the same inputs (``check``).

A kind with an encoder stage (``kinds.encoded_flat``) serves token
queries: the search callable chains the port's encoder and its search,
``Retriever.search(state, Query(*encoder(tokens, mask)))``, and keeps, by
reference, the last ``KEEP_CALLS`` batches' device token rows and the
embeddings they served (``EncodingSearcher``); the sample is drawn from
the requests those batches served, and the check judges the encoder on
their embeddings and the search on them, apart (``Encoded``).
"""
from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable, Deque, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from portbench import check
from portbench import trace as trace_mod

PB = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the port's kernel modules and the CUDA function each launches
KERNELS = {"quantized_maxsim": ("quantized_maxsim", "qmaxsim_kernel"),
           "hamming_maxsim": ("hamming", "hamming_kernel"),
           "maxsim": ("maxsim", "maxsim_kernel"),
           "kmeans_assign": ("kmeans_assign", "kmeans_assign_kernel")}
# seconds past the window's close to wait for the requests in flight
DRAIN_S = 60.0
# sampled queries the reference takes at a time
REF_ROWS = 16
# search calls whose token rows and served embeddings a kind with an
# encoder stage keeps for the check: about 17 MB at the cells' batches of
# 8 x 32 x 128 float32 embeddings, under 0.1% of the qenc cell's peak
KEEP_CALLS = 128


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Spec:
    name: str
    bench: dict
    cell: dict
    cfg: dict
    traffic: dict


def load_spec(cell: str, pb: Path = PB) -> Spec:
    c = load_json(pb / "cells" / f"{cell}.json")
    return Spec(cell, load_json(pb.parent / "BENCHMARK.json"), c,
                load_json(pb / "configs" / f"{c['config']}.json"),
                load_json(pb / "traffic" / f"{c['traffic']}.json"))


def metric_entries(spec: Spec, traced: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer
    ones: an entry with ``workloads`` where it lists the cell, one without
    wherever the end-to-end metric it moves is reported."""
    e2e = [m for m in spec.bench["end_to_end"]
           if spec.name in m.get("workloads", [spec.name])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec.bench["per_layer"]
            if (spec.name in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def metric_module(name: str, pb: Path = PB):
    path = pb / "metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Request(NamedTuple):
    """One request: its pool query, when it was sent (or due) and when its
    answer came, the answer or the error, and how late it was sent. A
    tuple, so that the collector stops tracking it once it is full."""

    i: int
    t_ref: float
    t_done: float
    result: Any
    error: Optional[BaseException]
    late: float = 0.0


class Searcher:
    """The search callable handed to the server: the port's search, with
    its span; in a traced run it also waits for its work (``pb.sync``)."""

    def __init__(self, impl: Callable, span, sync: bool):
        self.impl, self.span, self.sync = impl, span, sync
        self.calls: List[tuple] = []
        # requests sent after this have every serving call kept (a kind
        # with an encoder stage keeps a ring of them; others keep none)
        self.covered_from = float("-inf")

    def serve(self, q, qm, qs):
        return self.impl(q, qm, qs)

    def __call__(self, q, qm, qs):
        t = time.perf_counter()
        with self.span("pb.search"):
            out = self.serve(q, qm, qs)
        if self.sync:
            with self.span("pb.sync"):
                ev = torch.cuda.Event()
                ev.record()
                ev.synchronize()
        self.calls.append((t, time.perf_counter(), int(q.shape[0]), qm))
        return out


class EncodingSearcher(Searcher):
    """The search callable of a kind with an encoder stage: ``encode``
    (tokens, mask) -> (embeddings, mask, salience), then ``impl`` over
    them. Each call keeps, by reference (no copy, no wait), its start and
    end on the host's clock, the device token rows and mask it was given
    and the embeddings it served, in a ring of the last ``KEEP_CALLS``
    calls to end (``kept``): a fixed amount of memory, whatever the rate.
    ``covered_from`` is the latest start of a call the ring dropped: a
    request sent after it was served by calls that are all kept."""

    def __init__(self, encode: Callable, impl: Callable, span, sync: bool):
        super().__init__(impl, span, sync)
        self.encode = encode
        self.kept: Deque[tuple] = collections.deque(maxlen=KEEP_CALLS)
        self._lock = threading.Lock()

    def serve(self, q, qm, qs):
        t = time.perf_counter()
        e, m, s = self.encode(q, qm)
        out = self.impl(e, m, s)
        with self._lock:
            if len(self.kept) == KEEP_CALLS:
                self.covered_from = max(self.covered_from, self.kept[0][0])
            self.kept.append((t, time.perf_counter(), q, qm, e))
        return out


class Run:
    """What the metric readers read: the window's requests, searches,
    server stats, peak memory and trace."""

    def __init__(self, **kw):
        self.__dict__.update(kw)
        self._costs = None

    @property
    def latencies_ms(self) -> np.ndarray:
        return np.array([(r.t_done - r.t_ref) * 1e3 for r in self.in_window
                         if r.error is None])

    def window_searches(self) -> List[tuple]:
        return [c for c in self.searches
                if c[0] >= self.t0 and c[1] <= self.t1]

    def search_costs(self) -> List[dict]:
        """{kernel: [Cost]} of each search inside the window."""
        if self._costs is None:
            self._costs = [
                self.costs(b, qm.sum(dim=1).tolist())
                for _, _, b, qm in self.window_searches()]
        return self._costs

    def least_s(self, kernel: Optional[str] = None) -> float:
        return sum(c.least_ms() for per in self.search_costs()
                   for name, cs in per.items()
                   if kernel is None or name == kernel for c in cs) * 1e-3

    def kernel_roofline_pct(self, kernel: str) -> Optional[float]:
        """The kernel's least time over the window's searches against its
        device time in the trace, in percent; None without both."""
        if self.trace is None:
            return None
        device_s = self.trace.kernel_s.get(KERNELS[kernel][1], 0.0)
        least = self.least_s(kernel)
        if device_s <= 0 or least <= 0:
            return None
        return 100.0 * least / device_s


def state_bytes(obj) -> int:
    """Bytes of the distinct tensor storages reachable from ``obj``
    through tuples, lists, dicts and dataclasses: what an index state
    holds."""
    seen: Dict[tuple, int] = {}
    stack = [obj]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            seen[(str(x.device), st.data_ptr())] = st.nbytes()
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
    return sum(seen.values())


def _launch_modules():
    from repro_torch.kernels import hamming, kmeans_assign, maxsim
    from repro_torch.kernels import quantized_maxsim
    mods = {"quantized_maxsim": quantized_maxsim, "hamming": hamming,
            "maxsim": maxsim, "kmeans_assign": kmeans_assign}
    return {k: mods[v[0]] for k, v in KERNELS.items()}


async def _window(server, gen_mod, traffic, pool, seed, seconds, profiler,
                  span, cuda: bool, log):
    q, qm, qs = pool
    sent = [0]

    async def send(i):
        sent[0] += 1
        return await server.query(q[i], qm[i], qs[i])

    stop = asyncio.Event()
    reqs: List[Request] = []

    def record(i, t_ref, t_done, result, error, late=0.0):
        reqs.append(Request(i, t_ref, t_done, result, error, late))

    drive = asyncio.ensure_future(gen_mod.drive(
        send, traffic, seed=seed, n_pool=len(q), stop=stop, record=record,
        span=span))
    await asyncio.sleep(float(traffic["warm_s"]))
    if drive.done():
        drive.result()                   # the mix ended early: raise why
    server.reset_stats()
    if profiler is not None:
        profiler.start()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    await asyncio.sleep(seconds)
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    stats = server.stats()
    if profiler is not None:
        profiler.stop()
    stop.set()
    try:
        await asyncio.wait_for(asyncio.shield(drive), DRAIN_S)
    except asyncio.TimeoutError:
        log(f"requests still out {DRAIN_S:.0f} s after the window closed")
        drive.cancel()
        await asyncio.gather(drive, return_exceptions=True)
    await server.aclose()
    return reqs, sent[0], t0, t1, peak, stats


def run(cell: str, *, seed: int, seconds: float, traced: bool,
        device: str = "cuda", t_process: Optional[float] = None,
        control: bool = False, pb: Path = PB, log=None) -> dict:
    """One run of ``cell``; returns the result line's object. ``control``
    puts the reference, one precision lower, in the port's place."""
    t_process = time.perf_counter() if t_process is None else t_process
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    from repro_torch.retrieval import Query
    from repro_torch.serving import AsyncRetrievalServer, ServeConfig

    spec = load_spec(cell, pb)
    cfg, traffic = spec.cfg, spec.traffic
    kind = importlib.import_module(f"portbench.kinds.{cfg['kind']}")
    gen_mod = importlib.import_module(
        f"portbench.traffic.{traffic['generator']}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    steps = [("imports", time.perf_counter())]
    inp = kind.inputs(cfg, seed, dev)
    steps.append(("inputs", time.perf_counter()))
    encoded = hasattr(kind, "encoder")
    encoder = None
    if control:
        impl_ref = kind.reference(cfg, inp, dev, tf32=True)
        impl = lambda q, qm, qs: impl_ref.search(q, qm)  # noqa: E731
        if encoded:
            encoder = lambda t, tm: (impl_ref.encode(t, tm), tm,  # noqa: E731
                                     None)
    else:
        retriever, state = kind.system(cfg, inp)
        impl = lambda q, qm, qs: retriever.search(  # noqa: E731
            state, Query(q, qm, qs), k=cfg["top_k"])
        if encoded:
            encoder = kind.encoder(cfg, inp)
    index_bytes = None if control else state_bytes(state)
    encoder_bytes = (state_bytes(encoder.weights) if encoded and not control
                     else None)
    steps.append(("index" if not control else "control", time.perf_counter()))
    span = (trace_mod.HostSpans() if traced
            else lambda name: contextlib.nullcontext())
    if encoded:
        searcher = EncodingSearcher(encoder, impl, span,
                                    sync=traced and cuda)
    else:
        searcher = Searcher(impl, span, sync=traced and cuda)
    server = AsyncRetrievalServer(
        searcher, ServeConfig(max_batch=traffic["max_batch"],
                              max_wait_ms=traffic["max_wait_ms"],
                              top_k=cfg["top_k"],
                              max_inflight=traffic["max_inflight"]),
        device=dev)
    if traced:
        stage = server._stage

        def staged(batch):
            with span("pb.stage"):
                return stage(batch)
        server._stage = staged

    launch_mods = _launch_modules()
    before = {k: m.launches for k, m in launch_mods.items()}
    server.warm_shapes(*(a[0] for a in inp.pool))
    launches = {"counted": {k: m.launches - before[k]
                            for k, m in launch_mods.items()}}
    held = 0
    if cuda:
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
    steps.append(("rungs warmed", time.perf_counter()))
    if cuda and not control:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        want: Dict[str, int] = {}
        for b in server.ladder:
            for k, n in kind.launches(cfg, b, sms).items():
                want[k] = want.get(k, 0) + n
        launches["expected"] = {k: want.get(k, 0) for k in launch_mods}
    log(f"kernel launches over one search at each rung {server.ladder}: "
        f"{json.dumps(launches)}")
    top = server.ladder[-1]
    for k, cs in kind.costs(cfg, inp, top, [cfg["query_len"]] * top).items():
        log(f"least time of a search of {top}: {k} "
            + ", ".join(f"{c.least_ms():.6g} ms ({c.n_bytes:.6g} B, "
                        f"{c.ops:.6g} ops, per-slot {c.slot_ops:.6g})"
                        for c in cs))

    profiler = trace_mod.Profiler() if traced else None
    reqs, sent, t0, t1, peak, stats = asyncio.run(_window(
        server, gen_mod, traffic, inp.pool, seed, seconds, profiler, span,
        cuda, log))
    in_window = [r for r in reqs if t0 <= r.t_done <= t1]
    steps.append(("warm traffic", t0))
    log("set-up: " + ", ".join(
        f"{name} {b - a:.3f} s" for (_, a), (name, b) in
        zip([("process", t_process)] + steps, steps)))
    summary = None
    if profiler is not None:
        device_ev, window = profiler.events()
        host_ev = span.in_trace(profiler.t_open, window[0]) if window else []
        if window is not None:
            summary = trace_mod.summarize(device_ev, host_ev, window)
        log(f"trace: {len(device_ev)} device ops, {len(host_ev)} host "
            f"spans, window {window}")
    lost = (sent - len(reqs)) + sum(r.error is not None for r in reqs)
    if lost:
        errs = [repr(r.error) for r in reqs if r.error is not None][:3]
        log(f"{lost} requests failed or never came back: {errs}")
    runrec = Run(traced=traced, t0=t0, t1=t1, window_s=t1 - t0,
                 setup_s=t0 - t_process, in_window=in_window, stats=stats,
                 searches=searcher.calls, peak_bytes=peak, held_bytes=held,
                 index_bytes=index_bytes, encoder_bytes=encoder_bytes,
                 trace=summary,
                 costs=lambda b, qv: kind.costs(cfg, inp, b, qv))
    metrics = {}
    for entry in metric_entries(spec, traced):
        value = metric_module(entry["name"], pb).read(runrec)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value),
                                      "unit": entry["unit"]}

    # the check: the port's state freed first, then the reference
    done = [r for r in in_window
            if r.error is None and r.t_ref > searcher.covered_from]
    rng = np.random.default_rng([int(seed), 3])
    n_sample = min(int(spec.cell["sample"]), len(done))
    sample = [done[j] for j in
              sorted(rng.choice(len(done), size=n_sample, replace=False))]
    searcher.impl = impl = None
    server = retriever = state = impl_ref = None  # noqa: F841
    if encoded:
        searcher.encode = encoder = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    served = None
    if encoded:
        served = Encoded(searcher.kept, inp, sample, cfg["top_k"],
                         float(spec.cell["enc_tol"]), dev)
        searcher.kept = None
    values = _check(kind, cfg, inp, dev, sample, lost, log, served)
    log(f"check of {n_sample} answers took "
        f"{time.perf_counter() - t_check:.3f} s")
    limits = {"lost": 0.0, "bad_answers": 0.0, **spec.cell["limits"]}
    correct = n_sample > 0 and check.verdict(values, limits)

    if cuda:
        dev_block = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                     "count": 1, "memory_peak_bytes": int(peak)}
    else:
        dev_block = {"platform": "cpu", "kind": "cpu", "count": 1,
                     "memory_peak_bytes": 0}
    result = {"correct": bool(correct), "attempted": len(in_window)
              + (sent - len(reqs)),
              "failed": sum(r.error is not None for r in in_window)
              + (sent - len(reqs)),
              "metrics": metrics, "device": dev_block}
    if traced and summary is not None:
        dev_block["busy_s"] = summary.busy_s
        dev_block["window_s"] = summary.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in summary.device_ops],
            "idle_gaps": [[n, s] for n, s in summary.idle_gaps]}
    result["launches"] = launches
    result["checks"] = {name: {"value": values[name], "limit": limits[name]}
                        for name in ("lost", "bad_answers", "score_err",
                                     "rank_miss")
                        + (check.ENCODER_NUMBERS if encoded else ())}
    return result


def _pool_rows(inp, dev):
    """A chunk's query rows for a kind without an encoder stage: the
    pool's, as the port was given them."""
    pq, pm, _ = inp.pool

    def rows(ref, s, part, ids):
        idx = [r.i for r in part]
        return (torch.from_numpy(pq[idx]).to(dev),
                torch.from_numpy(pm[idx]).to(dev))
    return rows


def _check(kind, cfg, inp, dev, sample: List[Request], lost: int, log,
           served=None):
    """The sampled answers against the reference's search and exact scores
    on each chunk's query rows: the pool's, or with ``served`` (an
    ``Encoded``) the embeddings the port served, the encoder judged on the
    way."""
    k = cfg["top_k"]
    ref = kind.reference(cfg, inp, dev, tf32=False)
    rows = served.rows if served is not None else _pool_rows(inp, dev)
    ref_scores = np.zeros((len(sample), k))
    ref_ids = np.zeros((len(sample), k), dtype=np.int64)
    exact = np.zeros((len(sample), k))
    answers = [r.result for r in sample]
    for s in range(0, len(sample), REF_ROWS):
        part = sample[s:s + REF_ROWS]
        ids = np.zeros((len(part), k), dtype=np.int64)
        for j, r in enumerate(part):
            if check.well_formed(r.result, k, inp.n_docs):
                ids[j] = np.asarray(r.result[1])
        ids = torch.from_numpy(ids).to(dev)
        q, qm = rows(ref, s, part, ids)
        sc, ids_r = ref.search(q, qm)
        ex = ref.exact(q, qm, ids)
        ref_scores[s:s + len(part)] = sc.double().cpu().numpy()
        ref_ids[s:s + len(part)] = ids_r.cpu().numpy()
        exact[s:s + len(part)] = ex.double().cpu().numpy()
    del ref
    values, errs = check.numbers(answers, ref_scores, exact, lost, k,
                                 inp.n_docs)
    if served is not None:
        values.update(served.numbers(log))
    scored = [j for j, e in enumerate(errs) if e is not None]
    if scored:
        j = max(scored, key=lambda j: errs[j][1])
        log(f"widest rank gap {errs[j][1]:.6g} (score error "
            f"{errs[j][0]:.6g}) on pool query {sample[j].i}: served "
            f"{np.asarray(answers[j][1]).tolist()} "
            f"{np.asarray(answers[j][0]).tolist()}, reference "
            f"{ref_ids[j].tolist()} {ref_scores[j].tolist()}")
    return values


class Encoded:
    """The check's query rows for a kind with an encoder stage, with the
    encoder judged on the way. Every kept instance of each sampled query
    is found by its token row and mask. The encoder: each query's served
    embeddings, at every instance, against the reference's encoding of its
    tokens (``check.encoder_numbers``). The search: each answer on the
    embeddings served to it, those of an instance whose call ran between
    the request's send and its answer (of several, the one its answer's
    scores match best: batches of other sizes round otherwise); a query
    with no such instance is searched on the reference's encoding."""

    def __init__(self, kept, inp, sample: List[Request], k: int,
                 enc_tol: float, dev):
        self.pq, self.pm, _ = inp.pool
        self.sample, self.k, self.n_docs = sample, k, inp.n_docs
        self.enc_tol, self.dev = enc_tol, dev
        self.errs: List[float] = []
        want: Dict[bytes, List[int]] = {}
        for s, r in enumerate(sample):
            want.setdefault(self.pq[r.i].tobytes() + self.pm[r.i].tobytes(),
                            []).append(s)
        self.found: List[list] = [[] for _ in sample]
        for t_a, t_b, q, qm, e in kept:
            qh, mh = q.cpu().numpy(), qm.cpu().numpy()
            for row in range(qh.shape[0]):
                for s in want.get(qh[row].tobytes() + mh[row].tobytes(), ()):
                    self.found[s].append((t_a, t_b, e[row]))

    def rows(self, ref, s, part, ids):
        idx = [r.i for r in part]
        tok = torch.from_numpy(self.pq[idx]).to(self.dev)
        qm = torch.from_numpy(self.pm[idx]).to(self.dev)
        ref_e = ref.encode(tok, qm)
        served = []
        for j, r in enumerate(part):
            inst = self.found[s + j]
            self.errs.append(max((check.rel_error(e, ref_e[j], qm[j])
                                  for _, _, e in inst),
                                 default=check.NOT_SERVED))
            cands = [e for a, b, e in inst
                     if a >= r.t_ref and b <= r.t_done]
            if len(cands) > 1 and check.well_formed(r.result, self.k,
                                                    self.n_docs):
                got = torch.as_tensor(np.asarray(r.result[0]),
                                      dtype=torch.float64)
                gaps = [float((ref.exact(e[None], qm[j:j + 1],
                                         ids[j:j + 1])[0].double().cpu()
                               - got).abs().max()) for e in cands]
                cands = [cands[int(np.argmin(gaps))]]
            served.append(cands[0] if cands else ref_e[j])
        return torch.stack(served), qm

    def numbers(self, log) -> Dict[str, float]:
        errs, n_inst = self.errs, [len(f) for f in self.found]
        self.found = []
        if errs:
            j = int(np.argmax(errs))
            r = self.sample[j]
            log(f"encoder errors: widest {errs[j]:.6g} (enc_tol "
                f"{self.enc_tol:.6g}) on pool query {r.i} "
                f"({int(self.pm[r.i].sum())} tokens, {n_inst[j]} "
                f"instances), least {min(errs):.6g}; {sum(n_inst)} "
                f"instances of {len(self.sample)} queries")
        return check.encoder_numbers(errs, self.enc_tol)


def main(argv_args, t_process: float) -> int:
    """The command's body once the arguments are read: refuse to run
    without enough cards, run, refuse to print if the run loaded JAX or
    the JAX package, then print the checks and the result line."""
    spec = load_spec(argv_args.workload)
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run(argv_args.workload, seed=argv_args.seed,
                 seconds=float(argv_args.seconds),
                 traced=bool(argv_args.trace), device="cuda",
                 t_process=t_process)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']:.6g} (limit {c['limit']:.6g})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
