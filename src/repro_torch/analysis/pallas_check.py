"""Static checks of the CUDA kernels' launch geometry: PAL01-PAL04.

The counterpart of ``repro.analysis.pallas_check``, which captures every
``pl.pallas_call`` and checks its VMEM footprint, tiling, grid coverage and
output dtypes. The port's four kernels are hand-written CUDA C++
(``kernels/csrc``); what a launch asks of the card is its launch geometry
(``kernels.vmem``: grid, threads per block, dynamic shared bytes, the
launcher's configuration, the outputs), which this module checks for every
registered site (``kernel_sites``) — no card, no build:

  PAL01  budget: dynamic shared memory per block above the budget
         (``vmem.MAX_SMEM``, or the card's ``shared_memory_per_block_optin``),
         a block's threads x registers per thread above an SM's registers,
         registers per thread above 255, or threads above 1024. Registers
         come from the ``-Xptxas -v`` lines of the last build
         (``_build.last_build``), or, on a host without a build, from
         ``csrc/registers.json``, which the card holds equal to a fresh
         build (``chip_smoke.py`` phase 14).
  PAL02  divisibility: an axis a launcher needs to tile exactly does not.
         None of the four needs one — each masks its own ragged edge:
         ``kmeans_assign`` rows >= N (and pads D to 16 with zeros),
         ``maxsim`` walks docs < n_out and masks patches >= Md,
         ``quantized_maxsim`` and ``hamming_maxsim`` take a last range of
         N - r0 positions and pad a list shorter than k.
  PAL03  coverage: enumerating the grid, an output element written by no
         block or by more than one (for the per-range top-k: each
         (query, range) list written once, the lists one merge combines).
  PAL04  dtype: an output dtype differs from the site's contract (f32
         scores, int32 Hamming scores, int32 codes, f32 + int32 lists,
         int32 + int32 Hamming lists).

Findings anchor at the launcher's line in its ``csrc`` source.
``python -m repro_torch.analysis --pallas`` runs every registered site.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.lintcore import Finding
from repro_torch.kernels import vmem

__all__ = [
    "KernelSite",
    "check_all",
    "check_geometry",
    "check_site",
    "coverage_counts",
    "kernel_sites",
    "register_table",
]

CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"
REGISTERS_JSON = CSRC / "registers.json"
# grids above this many blocks are not enumerated for PAL03
_MAX_GRID_ENUM = 1 << 16

# kernel -> (source stem, launcher line in it)
_SOURCES = {
    "quantized_maxsim": "quantized_maxsim",
    "quantized_maxsim_topk": "quantized_maxsim",
    "maxsim": "maxsim",
    "hamming_maxsim": "hamming_maxsim",
    "hamming_maxsim_topk": "hamming_maxsim",
    "kmeans_assign": "kmeans_assign",
}
_LAUNCHERS = {"quantized_maxsim": "int launch(const Params& p",
              "maxsim": "cudaError_t launch(const Params& prm",
              "hamming_maxsim": "int launch(const Params& p, size_t smem",
              "kmeans_assign": "cudaError_t launch(const float* x"}


@dataclasses.dataclass(frozen=True)
class KernelSite:
    """One registered kernel geometry: ``geometry(budget)`` builds the
    launch as the wrapper would (the launchers choose with their own
    227 KB constant; the budget gives the SM count), ``c_call`` is the ``hpc_*_geometry``
    export and its arguments (the card holds the two equal), and
    ``out_dtypes`` is the declared output contract."""

    name: str
    geometry: Callable[[vmem.Budget], Optional[vmem.LaunchGeometry]]
    c_call: Tuple[str, tuple]
    out_dtypes: Tuple[torch.dtype, ...]
    notes: str = ""
    dims: Tuple[Tuple[str, int], ...] = ()     # the launch's shapes


def _anchor(kernel: str) -> Tuple[str, int]:
    stem = _SOURCES.get(kernel, kernel)
    path = CSRC / f"{stem}.cu"
    try:
        lines = path.read_text().splitlines()
        pat = _LAUNCHERS.get(stem, "")
        line = next((i + 1 for i, ln in enumerate(lines) if pat and pat in ln),
                    1)
    except OSError:
        line = 1
    try:
        rel = str(path.relative_to(Path.cwd()))
    except ValueError:
        rel = str(path)
    return rel, line


def register_table() -> Dict[str, int]:
    """Registers per thread of each source's kernels: from the last
    build's ptxas lines in this process, else the checked-in
    ``csrc/registers.json``."""
    from repro_torch.kernels import _build
    return _build.registers() or \
        json.loads(REGISTERS_JSON.read_text())["registers"]


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

def _check_budget(g: vmem.LaunchGeometry, site: str, budget: vmem.Budget,
                  regs: Optional[int]) -> List[Finding]:
    path, line = _anchor(g.kernel)
    out = []
    if g.smem > budget.smem:
        out.append(Finding(path, line, "PAL01",
                           f"[{site}] {g.kernel}: {g.smem} B of dynamic "
                           f"shared memory per block exceeds the "
                           f"{budget.smem} B a block may use"))
    if g.threads > budget.max_threads:
        out.append(Finding(path, line, "PAL01",
                           f"[{site}] {g.kernel}: {g.threads} threads per "
                           f"block exceed {budget.max_threads}"))
    if regs is not None:
        if regs > budget.max_regs_per_thread:
            out.append(Finding(path, line, "PAL01",
                               f"[{site}] {g.kernel}: {regs} registers per "
                               f"thread exceed {budget.max_regs_per_thread}"))
        if regs * g.threads > budget.regs_per_sm:
            out.append(Finding(
                path, line, "PAL01",
                f"[{site}] {g.kernel}: {g.threads} threads x {regs} "
                f"registers = {regs * g.threads} exceed an SM's "
                f"{budget.regs_per_sm}: the block cannot launch"))
    return out


def _check_divisibility(g: vmem.LaunchGeometry, site: str) -> List[Finding]:
    path, line = _anchor(g.kernel)
    return [Finding(path, line, "PAL02",
                    f"[{site}] {g.kernel}: {axis}={size} is not divisible by "
                    f"its block {block}: the grid drops the trailing "
                    f"{size % block} row(s)")
            for axis, size, block in g.divisible if block and size % block]


def coverage_counts(g: vmem.LaunchGeometry) -> np.ndarray:
    """How many blocks write each (query, position) of the output's last
    axis, enumerating the grid as the kernel walks it."""
    counts = np.zeros((g.queries, g.extent), dtype=np.int32)
    gx, gy = g.grid
    span = np.arange(g.unit)
    for y in range(gy):
        q0 = y * g.queries_per_block
        q1 = min(g.queries, q0 + g.queries_per_block)
        if q0 >= q1:
            continue
        for x in range(gx):
            units = (np.arange(x, g.n_units, g.step) if g.step
                     else np.arange(x, min(x + 1, g.n_units)))
            if not units.size:
                continue
            pos = (units[:, None] * g.unit + span[None]).ravel()
            pos = pos[pos < g.extent]
            np.add.at(counts[q0:q1], (slice(None), pos), 1)
    return counts


def _check_coverage(g: vmem.LaunchGeometry, site: str) -> List[Finding]:
    if g.grid[0] * g.grid[1] > _MAX_GRID_ENUM:
        return []
    path, line = _anchor(g.kernel)
    counts = coverage_counts(g)
    what = "list" if g.kernel.endswith("_topk") else "element"
    out = []
    missing = np.argwhere(counts == 0)
    if missing.size:
        out.append(Finding(
            path, line, "PAL03",
            f"[{site}] {g.kernel}: {len(missing)} output {what}(s) never "
            f"written (e.g. {[tuple(int(v) for v in m) for m in missing[:3]]})"
            f" — those hold uninitialized memory"))
    multi = np.argwhere(counts > 1)
    if multi.size:
        c = tuple(int(v) for v in multi[0])
        out.append(Finding(
            path, line, "PAL03",
            f"[{site}] {g.kernel}: output {what} {c} written "
            f"{int(counts[c])} times ({len(multi)} multi-written) — "
            f"last-write-wins is order-dependent"))
    return out


def _check_dtypes(g: vmem.LaunchGeometry, site: str,
                  want: Tuple[torch.dtype, ...]) -> List[Finding]:
    got = tuple(dt for _, dt in g.outputs)
    if got == tuple(want):
        return []
    path, line = _anchor(g.kernel)
    name = lambda ds: tuple(str(d).replace("torch.", "") for d in ds)  # noqa: E731
    return [Finding(path, line, "PAL04",
                    f"[{site}] {g.kernel}: output dtypes {name(got)} != "
                    f"declared contract {name(want)}")]


def check_geometry(g: vmem.LaunchGeometry, site: str,
                   out_dtypes: Tuple[torch.dtype, ...], *,
                   budget: Optional[vmem.Budget] = None,
                   registers: Optional[Dict[str, int]] = None
                   ) -> List[Finding]:
    """PAL01-PAL04 for one launch geometry."""
    budget = budget or vmem.Budget()
    regs = (registers or {}).get(_SOURCES.get(g.kernel, g.kernel))
    return (_check_budget(g, site, budget, regs)
            + _check_divisibility(g, site)
            + _check_coverage(g, site)
            + _check_dtypes(g, site, out_dtypes))


def check_site(site: KernelSite, *, budget: Optional[vmem.Budget] = None,
               registers: Optional[Dict[str, int]] = None) -> List[Finding]:
    """All findings for one registered kernel geometry; a geometry its
    launcher refuses (ValueError) is a PAL01 finding."""
    budget = budget or vmem.Budget()
    try:
        g = site.geometry(budget)
    except ValueError as e:
        kernel = site.c_call[0].replace("hpc_", "").replace("_geometry", "")
        path, line = _anchor({"qmaxsim": "quantized_maxsim",
                              "hamming": "hamming_maxsim"}.get(kernel,
                                                               kernel))
        return [Finding(path, line, "PAL01", f"[{site.name}] {e}")]
    if g is None:
        return []
    return check_geometry(g, site.name, site.out_dtypes, budget=budget,
                          registers=registers)


def check_all(sites: Optional[Sequence[KernelSite]] = None, *,
              budget: Optional[vmem.Budget] = None,
              registers: Optional[Dict[str, int]] = None) -> List[Finding]:
    if registers is None:
        registers = register_table()
    out: List[Finding] = []
    for site in (sites if sites is not None else kernel_sites()):
        out += check_site(site, budget=budget, registers=registers)
    return out


# ---------------------------------------------------------------------------
# The registry: every kernel at the reference's sites and the main path's
# ---------------------------------------------------------------------------

_F32, _I32 = torch.float32, torch.int32


def _range_len(b: int, n: int, sms: int) -> int:
    from repro_torch.kernels.quantized_maxsim import (BLOCKS_PER_SM,
                                                      MAX_RANGE, MIN_RANGE)
    r = MAX_RANGE
    while r > MIN_RANGE and b * -(-n // r) < BLOCKS_PER_SM * sms:
        r //= 2
    return r


def qmaxsim_site(name: str, *, b: int, mq: int, k: int, n: int, md: int,
                 top_k: int = 0, per_query: bool = False,
                 notes: str = "") -> KernelSite:
    """An ADC launch: the per-range top-k of a sweep (``top_k`` > 0, range
    length as ``launch_range_len`` picks it) or the scores entry."""
    cb = 1 if k <= 256 else 2

    def args(budget):
        r = _range_len(b, n, budget.sm_count)
        kk = min(top_k, r)
        return (cb, b, mq, k, n, md, int(per_query), r, kk, 4,
                budget.sm_count)

    def geometry(budget):
        a = args(budget)
        return vmem.qmaxsim_geometry(*a[:6], per_query, *a[7:])
    return KernelSite(name, geometry,
                      ("hpc_qmaxsim_geometry", args(vmem.Budget())),
                      (_F32, _I32) if top_k else (_F32,), notes,
                      (("kernel", "quantized_maxsim"), ("b", b), ("mq", mq),
                       ("k", k), ("n", n), ("md", md), ("top_k", top_k),
                       ("per_query", int(per_query))))


def maxsim_site(name: str, *, layout: int, b: int, mq: int, n_out: int,
                md: int, d: int, notes: str = "") -> KernelSite:
    def args(budget):
        return (layout, b, mq, n_out, md, d, 8, budget.sm_count)

    return KernelSite(
        name, lambda budget: vmem.maxsim_geometry(*args(budget)),
        ("hpc_maxsim_geometry", args(vmem.Budget())), (_F32,), notes,
        (("kernel", "maxsim"), ("layout", layout), ("b", b), ("mq", mq),
         ("n_out", n_out), ("md", md), ("d", d)))


def hamming_site(name: str, *, b: int, n: int, mq: int, md: int,
                 bits: int = 8, top_k: int = 0, per_query: bool = False,
                 notes: str = "") -> KernelSite:
    """A Hamming launch: the per-range top-k of a sweep (``top_k`` > 0,
    range length as ``launch_range_len`` picks it) or the scores entry."""
    from repro_torch.kernels.hamming import BLOCKS_PER_SM, MAX_RANGE, MIN_RANGE

    def args(budget):
        qpb = max(1, vmem.hamming_queries_per_block(b, mq, bits, per_query))
        r = MAX_RANGE
        while r > MIN_RANGE and -(-b // qpb) * -(-n // r) < \
                BLOCKS_PER_SM * budget.sm_count:
            r //= 2
        return (b, mq, n, md, bits, int(per_query), r, min(top_k, r))

    return KernelSite(name, lambda budget: vmem.hamming_geometry(
        *args(budget)), ("hpc_hamming_geometry", args(vmem.Budget())),
        (_I32, _I32) if top_k else (_I32,), notes,
        (("kernel", "hamming_maxsim"), ("b", b), ("n", n), ("mq", mq),
         ("md", md), ("bits", bits), ("top_k", top_k),
         ("per_query", int(per_query))))


def kmeans_site(name: str, *, n: int, k: int, d: int,
                notes: str = "") -> KernelSite:
    return KernelSite(
        name, lambda budget: vmem.kmeans_assign_geometry(
            n, d, k, budget.sm_count),
        ("hpc_kmeans_assign_geometry", (n, d, k, vmem.SM_COUNT_DATASHEET)),
        (_I32,), notes, (("kernel", "kmeans_assign"), ("n", n), ("k", k),
                         ("d", d)))


_SITES: Tuple[KernelSite, ...] = (
    # the reference's sites (pallas_check.py), at this kernel's parameters
    qmaxsim_site("qmaxsim_manifest", b=8, mq=8, k=256, n=1 << 20, md=16,
                 top_k=16, notes="the budget manifests' trace geometry: "
                 "one launch for the sweep"),
    qmaxsim_site("qmaxsim_serving", b=8, mq=32, k=256, n=256, md=128,
                 notes="serving-scale geometry (ladder max batch), one "
                       "256-doc block of scores"),
    qmaxsim_site("qmaxsim_k512", b=8, mq=32, k=512, n=256, md=128,
                 notes="the K <= 512 envelope (uint16 codes)"),
    maxsim_site("maxsim_manifest", layout=0, b=8, mq=8, n_out=256, md=16,
                d=16),
    maxsim_site("maxsim_serving", layout=0, b=8, mq=32, n_out=256, md=64,
                d=128),
    hamming_site("hamming_manifest", b=8, n=256, mq=8, md=16),
    hamming_site("hamming_serving", b=8, n=256, mq=32, md=128),
    kmeans_site("kmeans_assign_default", n=1024, k=256, d=128),
    kmeans_site("kmeans_assign_k512", n=1024, k=512, d=128,
                notes="codebook at its documented 512 x 128 ceiling"),
    # chip_smoke.py's main path (PERF.md §6's kernel table)
    qmaxsim_site("qmaxsim_flat_sweep", b=8, mq=32, k=256, n=16384, md=615,
                 top_k=32, notes="flat sweep of 16384 docs"),
    qmaxsim_site("qmaxsim_cascade_stage2", b=8, mq=32, k=256, n=1024,
                 md=1024, top_k=64, per_query=True,
                 notes="cascade stage 2: per-query pools of p1 docs"),
    qmaxsim_site("qmaxsim_serve_cell", b=64, mq=32, k=256, n=131072,
                 md=616, top_k=128, notes="serve_query: one of the "
                 "sweep's 32 launches"),
    maxsim_site("maxsim_stage3_rows", layout=2, b=8, mq=32, n_out=64,
                md=1024, d=128, notes="cascade stage 3 by id"),
    maxsim_site("maxsim_float_flat_block", layout=0, b=8, mq=32, n_out=256,
                md=1024, d=128, notes="one float_flat block"),
    hamming_site("hamming_stage1_sweep", b=8, n=16384, mq=32, md=615,
                 top_k=1024, notes="the cascade's stage 1: one launch for "
                 "the sweep of 16384 docs, k = p1"),
    kmeans_site("kmeans_assign_build", n=16_777_216, k=256, d=128,
                notes="quantizing the main path's corpus"),
    kmeans_site("kmeans_assign_query_rows", n=256, k=256, d=128,
                notes="a cascade batch's query rows (32-row tiles)"),
)


def kernel_sites() -> Tuple[KernelSite, ...]:
    """Every registered kernel geometry (stable order)."""
    return _SITES


# ---------------------------------------------------------------------------
# PAL03 on the card: outputs filled with a sentinel, one launch
# ---------------------------------------------------------------------------

def sentinel_of(dtype: torch.dtype):
    """NaN for floats, the type's minimum for ints: no kernel writes it."""
    return float("nan") if dtype.is_floating_point else \
        torch.iinfo(dtype).min


@contextlib.contextmanager
def sentinel_outputs():
    """Inside the block every ``torch.empty`` is filled with its dtype's
    sentinel (the wrappers allocate their outputs so); yields the list of
    the tensors made."""
    real = torch.empty
    made: List[torch.Tensor] = []

    def filled(*size, **kw):
        t = real(*size, **kw)
        t.fill_(sentinel_of(t.dtype))
        made.append(t)
        return t

    torch.empty = filled
    try:
        yield made
    finally:
        torch.empty = real


def launch_site(site: KernelSite, device="cuda", seed: int = 0) -> dict:
    """Launch the site's kernel once through its wrapper on random inputs
    on the card, its outputs pre-filled with the sentinel; returns the
    output elements and how many still hold the sentinel (PAL03 on the
    card: 0 when every element was written)."""
    from repro_torch.kernels import hamming, kmeans_assign, maxsim
    from repro_torch.kernels import quantized_maxsim as qm
    dims = dict(site.dims)
    dev = torch.device(device)
    g = torch.Generator(dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def ints(high, *shape, dtype=torch.int64):
        return torch.randint(0, high, shape, generator=g, device=dev,
                             dtype=dtype)

    def valid(*shape):
        return torch.rand(shape, generator=g, device=dev) < 0.8

    kernel = dims["kernel"]
    if kernel == "quantized_maxsim":
        b, mq, k, n, md = (dims[x] for x in ("b", "mq", "k", "n", "md"))
        shape = (b, n, md) if dims["per_query"] else (n, md)
        codes = ints(k, *shape).to(torch.uint8 if k <= 256 else torch.uint16)
        args = (rand(b, mq, k), torch.ones(b, mq, device=dev), codes,
                valid(*shape))
        call = (lambda: qm.quantized_maxsim_topk_cuda(*args, None,
                                                      k=dims["top_k"])
                ) if dims["top_k"] else (lambda: qm.quantized_maxsim_cuda(
                    *args))
    elif kernel == "maxsim":
        b, mq, n_out, md, d = (dims[x] for x in ("b", "mq", "n_out", "md",
                                                 "d"))
        q, qmask = rand(b, mq, d), torch.ones(b, mq, device=dev)
        if dims["layout"] == 2:
            corpus = 2 * n_out
            docs, dm = rand(corpus, md, d), valid(corpus, md)
            rows = ints(corpus, b, n_out, dtype=torch.int32)
            call = (lambda: maxsim.maxsim_cuda(q, qmask, docs, dm,
                                               rows=rows))
        else:
            shape = (b, n_out, md) if dims["layout"] == 1 else (n_out, md)
            docs, dm = rand(*shape, d), valid(*shape)
            call = (lambda: maxsim.maxsim_cuda(q, qmask, docs, dm))
    elif kernel == "hamming_maxsim":
        b, n, mq, md, bits = (dims[x] for x in ("b", "n", "mq", "md",
                                                "bits"))
        shape = (b, n, md) if dims["per_query"] else (n, md)
        qc = ints(1 << bits, b, mq, dtype=torch.int32)
        args = (qc, torch.ones(b, mq, dtype=torch.int32, device=dev),
                ints(1 << bits, *shape).to(torch.uint16), valid(*shape))
        call = (lambda: hamming.hamming_maxsim_topk_cuda(
            *args, None, bits=bits, k=dims["top_k"])) if dims["top_k"] \
            else (lambda: hamming.hamming_maxsim_cuda(*args, bits))
    else:
        x, c = rand(dims["n"], dims["d"]), rand(dims["k"], dims["d"])
        call = (lambda: kmeans_assign.kmeans_assign_cuda(x, c))
    with sentinel_outputs() as made:
        out = call()
    outs = out if isinstance(out, tuple) else (out,)
    ours = [t for t in made if any(t is o for o in outs)]
    left = 0
    for t in ours:
        s = sentinel_of(t.dtype)
        left += int(torch.isnan(t).sum()) if t.dtype.is_floating_point \
            else int((t == s).sum())
    return {"site": site.name, "outputs": len(ours),
            "elements": sum(t.numel() for t in ours), "unwritten": left}
