"""The Hopper launch budget and the four CUDA kernels' launch geometry.

The counterpart of ``repro.kernels.vmem`` (the TPU kernels' VMEM budget).
On an sm_90 card the per-block budget is what one block may hold:

  * ``MAX_SMEM`` bytes of dynamic shared memory (the opt-in limit, 227 KB,
    that every launcher raises its cap to);
  * ``REGS_PER_SM`` registers shared by the threads of the blocks on one
    SM, at most ``MAX_REGS_PER_THREAD`` per thread;
  * ``MAX_THREADS_PER_BLOCK`` threads.

``device_budget`` reads the present card's own figures from
``torch.cuda.get_device_properties`` and falls back to these.

Each kernel has one launch-geometry function that mirrors its launcher in
``csrc/*.cu`` line for line: from the shapes (and the SM count of the
persistent grids) it gives the grid, the threads per block, the dynamic
shared bytes, the kernel's configuration and the output shapes and
dtypes. The wrappers call it before each launch, so the shared-memory
checks they make go through it; each ``csrc`` source exports an
``hpc_*_geometry`` C function giving the same numbers from the launcher's
own helpers, and the card holds the two equal (``chip_smoke.py`` phase 14,
``tests/test_torch_cuda.py``). ``analysis.pallas_check`` checks the
geometry against the budget, the grid's coverage of the outputs and the
output dtypes.

Under an active ``FakeTensorMode`` (tensors without data) a wrapper does
not launch: ``fake_launch`` records the launch (kernel, geometry, shapes,
FLOPs and bytes) with the active recorders of ``analysis.jaxpr_budget``
and returns empty outputs of the declared shapes. The counterpart of
``repro.analysis.pallas_check.capture_calls``' shim, which records each
``pallas_call`` and returns zeros of its ``out_shape``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Tuple

import torch

MiB = 2 ** 20

# sm_90 (NVIDIA H100): what one block may use (CUDA C++ Programming Guide,
# compute capability 9.0 technical specifications)
MAX_SMEM = 232448            # opt-in dynamic shared memory per block (227 KB)
REGS_PER_SM = 65536
MAX_REGS_PER_THREAD = 255
MAX_THREADS_PER_BLOCK = 1024
SM_COUNT_DATASHEET = 132     # H100 SXM

__all__ = ["Budget", "LaunchGeometry", "MAX_SMEM", "MiB", "REGS_PER_SM",
           "check_divisible", "check_smem", "device_budget", "fake_launch",
           "fits", "hamming_geometry", "hamming_queries_per_block",
           "hamming_smem_bytes", "hamming_table_regs", "is_fake",
           "kmeans_assign_geometry",
           "kmeans_assign_smem_bytes", "maxsim_geometry",
           "maxsim_smem_bytes", "qmaxsim_body", "qmaxsim_geometry",
           "qmaxsim_smem_bytes", "record_launch", "sm_count", "sweep"]


@dataclasses.dataclass(frozen=True)
class Budget:
    """One card's per-block launch limits."""

    smem: int = MAX_SMEM
    regs_per_sm: int = REGS_PER_SM
    max_regs_per_thread: int = MAX_REGS_PER_THREAD
    max_threads: int = MAX_THREADS_PER_BLOCK
    sm_count: int = SM_COUNT_DATASHEET
    source: str = "sm_90 data sheet"


def device_budget(device=None) -> Budget:
    """The card's own limits when one is present, else the sm_90 figures."""
    if not torch.cuda.is_available():
        return Budget()
    index = torch.device(device).index if device is not None else None
    props = torch.cuda.get_device_properties(
        index if index is not None else torch.cuda.current_device())
    return Budget(
        smem=int(getattr(props, "shared_memory_per_block_optin", MAX_SMEM)),
        regs_per_sm=int(getattr(props, "regs_per_multiprocessor",
                                REGS_PER_SM)),
        max_regs_per_thread=MAX_REGS_PER_THREAD,
        max_threads=MAX_THREADS_PER_BLOCK,
        sm_count=int(props.multi_processor_count),
        source=props.name)


_sm_counts: dict = {}


def sm_count(device) -> int:
    """SMs of a CUDA device (the persistent grids' cap), or the data
    sheet's count where no card is present (fake CUDA tensors on a host
    without one)."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return SM_COUNT_DATASHEET
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


def fits(smem_bytes: int, budget: int = MAX_SMEM) -> bool:
    return 0 <= smem_bytes <= budget


def check_divisible(n: int, block: int, *, kernel: str,
                    axis: str = "N") -> None:
    """The grid contract of a launcher that does not mask its ragged edge:
    the axis must tile exactly."""
    if block <= 0:
        raise ValueError(f"{kernel}: the {axis} block must be positive, got "
                         f"{block}")
    if n % block:
        raise ValueError(
            f"{kernel}: {axis}={n} is not divisible by the block {block}: "
            f"the grid would drop the last {n % block} row(s)")


def check_smem(smem_bytes: int, *, kernel: str, detail: str,
               budget: int = MAX_SMEM) -> None:
    """Raise if a launch needs more dynamic shared memory than a block may
    use (or no configuration of the kernel fits: ``smem_bytes`` < 0)."""
    if not fits(smem_bytes, budget):
        need = "no configuration fits" if smem_bytes < 0 else \
            f"{smem_bytes} B of shared memory"
        raise ValueError(f"{kernel}: {need} ({detail}); a block may use "
                         f"{budget} B")


# ---------------------------------------------------------------------------
# Launch geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LaunchGeometry:
    """One launch as its launcher makes it.

    ``config`` is the launcher's own choice (the four numbers after grid,
    threads and shared bytes in the C export's out array). Coverage: block
    (x, y) serves the queries [y * queries_per_block, ...) and the units
    u = x, x + step, ... < n_units (``step`` = 0: u = x only), unit u
    writing positions [u * unit, (u + 1) * unit) of the output's last
    axis, masked to ``extent``. ``divisible`` lists (axis, size, block)
    the launcher needs to tile exactly (none of the four kernels: each
    masks its own ragged edge).
    """

    kernel: str
    grid: Tuple[int, int]
    threads: int
    smem: int
    config: Tuple[int, int, int, int]
    outputs: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]
    queries: int                 # rows of the output's leading axis
    queries_per_block: int
    unit: int                    # output positions per unit
    n_units: int
    extent: int                  # positions of the output's last axis
    step: int = 0                # persistent walk stride (0: one unit)
    divisible: Tuple[Tuple[str, int, int], ...] = ()

    def as_c(self) -> Tuple[int, ...]:
        """The numbers the C export writes: grid.x, grid.y, threads,
        shared bytes, config."""
        return (*self.grid, self.threads, self.smem, *self.config)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pad16(d: int) -> int:          # tf32x3::padded_width
    return (d + 15) & ~15


# csrc/hamming_maxsim.cu: warps a block, the longest range, the queries of
# the shared corpus a block takes, the largest bits of the table body
_HAMMING_WARPS = 8
HAMMING_MAX_RANGE = 256
_HAMMING_MAX_QUERIES = 32
HAMMING_TABLE_MAX_BITS = 10


def hamming_table_regs(bits: int) -> int:
    """``table_regs``: the distance table's registers a lane (2^bits codes
    over 32 lanes), 0 for the popcount body (bits above 10)."""
    if bits > HAMMING_TABLE_MAX_BITS:
        return 0
    return 1 if bits <= 5 else 1 << (bits - 5)


def hamming_smem_bytes(mq: int, bits: int, range_len: int, qpb: int,
                       top_k: bool) -> int:
    """``smem_bytes``: staged query codes and weights, the range's scores
    (top-k), two byte tables a warp (the table body)."""
    return (qpb * mq * 8 + (qpb * range_len * 4 if top_k else 0)
            + _HAMMING_WARPS * 2 * 32 * hamming_table_regs(bits))


def hamming_queries_per_block(b: int, mq: int, bits: int,
                              per_query: bool) -> int:
    """``queries_per_block``: 1 for per-query pools, else up to 32 queries
    whose codes, weights and scores fit at the longest range (0: none)."""
    if per_query:
        return int(hamming_smem_bytes(mq, bits, HAMMING_MAX_RANGE, 1, True)
                   <= MAX_SMEM)
    q = min(b, _HAMMING_MAX_QUERIES)
    while q > 0 and hamming_smem_bytes(mq, bits, HAMMING_MAX_RANGE, q,
                                       True) > MAX_SMEM:
        q -= 1
    return q


def hamming_geometry(b: int, mq: int, n: int, md: int, bits: int,
                     per_query: int, range_len: int, top_k: int
                     ) -> Optional[LaunchGeometry]:
    """``hpc_hamming_maxsim`` (``top_k`` = 0: scores) and
    ``hpc_hamming_maxsim_topk``'s launch (csrc/hamming_maxsim.cu, ``plan``
    and ``launch``): grid (ceil(N / R), ceil(B / q)), q queries a block (1
    for per-query pools), 8 warps; block (x, y) scores positions [x R,
    (x + 1) R) masked to N for its queries and writes their scores, or
    each query's one top-k list of range x. None when nothing is launched;
    ValueError for shapes the launcher refuses."""
    if b <= 0 or n <= 0:
        return None
    qpb = 0
    if (b <= 65535 and mq > 0 and md >= 0 and 1 <= bits <= 16
            and 0 < range_len <= HAMMING_MAX_RANGE
            and 0 <= top_k <= range_len):
        qpb = hamming_queries_per_block(b, mq, bits, bool(per_query))
    if qpb <= 0:
        raise ValueError(
            f"hamming_maxsim: B={b}, Mq={mq}, Md={md}, bits={bits}, "
            f"R={range_len}, k={top_k} outside the launcher's range")
    s = hamming_smem_bytes(mq, bits, range_len, qpb, top_k > 0)
    check_smem(s, kernel="hamming_maxsim",
               detail=f"Mq={mq}, bits={bits}, R={range_len}, {qpb} "
                      f"quer{'ies' if qpb > 1 else 'y'} a block")
    ranges = _cdiv(n, range_len)
    if top_k:
        outs = (((b, ranges, top_k), torch.int32),
                ((b, ranges, top_k), torch.int32))
        unit, extent = 1, ranges
    else:
        outs = (((b, n), torch.int32),)
        unit, extent = range_len, n
    return LaunchGeometry(
        "hamming_maxsim_topk" if top_k else "hamming_maxsim",
        (ranges, _cdiv(b, qpb)), _HAMMING_WARPS * 32, s,
        (qpb, hamming_table_regs(bits), 0, 0), outs, b, qpb, unit, ranges,
        extent)


# csrc/kmeans_assign.cu: (n tiles per warp, warps along the rows, ring
# slots), in the order ``choose`` tries them
_KMEANS_SHAPES = ((4, 1, 2), (8, 2, 2), (1, 2, 2), (1, 2, 1))
_KMEANS_THREADS = 256


def _kmeans_smem(d: int, kc: int, stages: int, wm: int) -> int:
    dp = _pad16(d)
    return (kc * dp + kc + stages * wm * 32 * dp + 2 * _KMEANS_THREADS) * 4


@functools.lru_cache(maxsize=256)
def _kmeans_choose(d: int, k: int, n: int, sm_count: int, smem: int):
    warps = _KMEANS_THREADS // 32
    for nt, wm, stages in _KMEANS_SHAPES:
        pas = warps // wm * nt * 8
        if nt > 1 and k <= 32:
            continue
        if wm == 1 and _cdiv(n, 64) >= sm_count:
            continue
        full = _cdiv(k, pas) * pas
        for kc in range(full, pas - 1, -pas):
            s = _kmeans_smem(d, kc, stages, wm)
            if s <= smem:
                return nt, wm, kc, stages, s
    return None


def kmeans_assign_smem_bytes(d: int, k: int) -> int:
    """``hpc_kmeans_assign_smem_bytes``: the build-sized launch's shared
    bytes at (D, K), -1 if no configuration fits."""
    if d <= 0 or k <= 0:
        return -1
    cfg = _kmeans_choose(d, k, 1 << 40, 1, MAX_SMEM)
    return -1 if cfg is None else cfg[-1]


def kmeans_assign_geometry(n: int, d: int, k: int, sm_count: int, *,
                           smem: int = MAX_SMEM
                           ) -> Optional[LaunchGeometry]:
    """``hpc_kmeans_assign``'s launch (csrc/kmeans_assign.cu, ``choose``
    and ``launch``): the first configuration whose codebook chunk fits,
    a persistent grid of min(tiles, SMs) blocks of 256 threads, block x
    walking row tiles x, x + grid, ...; rows >= N are masked. None for
    N = 0; ValueError when no configuration fits."""
    if n <= 0:
        return None
    if d <= 0 or k <= 0 or sm_count <= 0:
        raise ValueError(f"kmeans_assign: D={d}, K={k}, {sm_count} SMs")
    cfg = _kmeans_choose(d, k, n, sm_count, smem)
    if cfg is None:
        check_smem(-1, kernel="kmeans_assign",
                   detail=f"D={d} leaves no room for a row tile and a "
                          f"codebook chunk", budget=smem)
    nt, wm, kc, stages, s = cfg
    rows = wm * 32
    tiles = _cdiv(n, rows)
    grid = min(tiles, sm_count)
    return LaunchGeometry(
        "kmeans_assign", (grid, 1), _KMEANS_THREADS, s, (rows, nt, kc, stages),
        (((n,), torch.int32),), 1, 1, rows, tiles, n, step=grid)


# csrc/maxsim.cu
_SHARED, _PER_QUERY, _ROWS = 0, 1, 2
_MAXSIM_WARPS = 8


def _maxsim_m_tiles(mg: int) -> int:
    return 1 if mg >= 4 else 4 // mg


def _maxsim_smem(d: int, qpb: int, qcn: int, mg: int, stages: int,
                 pre: bool) -> int:
    dp = _pad16(d)
    qrows = qpb * qcn * 32
    cr = mg * _maxsim_m_tiles(mg) * 16
    return ((2 if pre else 1) * qrows * dp + stages * cr * dp + mg * qrows
            + qrows) * 4


@functools.lru_cache(maxsize=256)
def _maxsim_choose(layout: int, b: int, mq: int, d: int, max_qpb: int,
                   smem: int):
    qcn = _cdiv(mq, 32)
    if qcn > _MAXSIM_WARPS or max_qpb < 1:
        return None
    top = min(_MAXSIM_WARPS // qcn, b) if layout == _SHARED else 1
    top = min(top, max_qpb)
    for q in range(top, 0, -1):
        mg = _MAXSIM_WARPS // (q * qcn)
        for pre in (True, False):
            for stages in (2, 1):
                s = _maxsim_smem(d, q, qcn, mg, stages, pre)
                if s <= smem:
                    return q, mg, stages, int(pre), s
    return None


def maxsim_smem_bytes(layout: int, b: int, mq: int, d: int, *,
                      smem: int = MAX_SMEM) -> int:
    """``hpc_maxsim_smem_bytes``: the launch's shared bytes, -1 if none
    fits."""
    if b <= 0 or mq <= 0 or d <= 0:
        return -1
    cfg = _maxsim_choose(layout, b, mq, d, _MAXSIM_WARPS, smem)
    return -1 if cfg is None else cfg[-1]


def maxsim_geometry(layout: int, b: int, mq: int, n_out: int, md: int,
                    d: int, max_qpb: int, sm_count: int, *,
                    smem: int = MAX_SMEM) -> Optional[LaunchGeometry]:
    """``hpc_maxsim``'s launch (csrc/maxsim.cu, ``choose`` and the grid at
    its end): queries per block, the query split and the ring depth that
    fit, then a persistent grid (min(n_out, SMs / groups), groups), block
    (x, y) walking documents x, x + grid.x, ... for its group of queries.
    layout 0 shared corpus, 1 per-query pools, 2 candidate rows. None
    when nothing is launched (B or n_out = 0); ValueError for shapes the
    launcher refuses."""
    if b <= 0 or n_out <= 0:
        return None
    if mq <= 0 or md <= 0 or sm_count <= 0 or layout not in (0, 1, 2):
        raise ValueError(f"maxsim: Mq={mq}, Md={md}, layout {layout}")
    cfg = _maxsim_choose(layout, b, mq, d, max_qpb, smem)
    if cfg is None:
        check_smem(-1, kernel="maxsim", detail=f"Mq={mq}, D={d}: Mq <= 256 "
                   f"and the query rows must fit", budget=smem)
    qpb, mg, stages, pre, s = cfg
    groups = _cdiv(b, qpb)
    per_group = max(1, sm_count // groups)
    grid = (min(n_out, per_group), groups)
    if grid[1] > 65535:
        raise ValueError(f"maxsim: {groups} query groups exceed grid.y")
    return LaunchGeometry(
        "maxsim", grid, _MAXSIM_WARPS * 32, s, (qpb, mg, stages, pre),
        (((b, n_out), torch.float32),), b, qpb, 1, n_out, n_out,
        step=grid[0])


# csrc/quantized_maxsim.cu
QMAXSIM_MAX_RANGE = 256
# the code-set body for K <= 256: 16 warps, up to 4 queries a block on the
# shared corpus, a half-warp's 256 flags and list of 256 offsets (in ints);
# the per-slot body: 8 warps, up to 2 queries, a half-warp's code row
QMAXSIM_SET_MAX_K = 256
_QMAXSIM_SET_ROW_INTS = QMAXSIM_SET_MAX_K // 4 + QMAXSIM_SET_MAX_K
_QMAXSIM_WARPS = {1: 16, 0: 8}
_QMAXSIM_MAX_Q = {1: 4, 0: 2}


def qmaxsim_body(k: int) -> int:
    """The body ``quantized_maxsim`` runs at codebook size K: 1 the code
    set (K <= 256), 0 per slot."""
    return int(k <= QMAXSIM_SET_MAX_K)


def _qmaxsim_row_ints(code_bytes: int, md: int) -> int:
    per = 16 // code_bytes
    w = (md + 2 * per - 2) // per
    return per * (w + (w & 1))


def qmaxsim_smem_bytes(code_bytes: int, mq: int, k: int, md: int,
                       range_len: int, q: int = 1) -> int:
    """``smem_for``: a block's shared bytes for ``q`` queries, -1 for a bad
    code width (``hpc_qmaxsim_smem_bytes`` is this with q = 1)."""
    if code_bytes not in (1, 2):
        return -1
    chunks = _cdiv(mq, 32)
    body = qmaxsim_body(k)
    row = _QMAXSIM_SET_ROW_INTS if body else _qmaxsim_row_ints(code_bytes, md)
    rows = 2 * _QMAXSIM_WARPS[body] * row
    return (q * chunks * (k + 1) * 32 + q * chunks * 32 + rows
            + q * ((range_len + 3) & ~3)) * 4


def qmaxsim_geometry(code_bytes: int, b: int, mq: int, k: int, n: int,
                     md: int, per_query: bool, range_len: int, top_k: int,
                     max_q: int, sm_count: int = SM_COUNT_DATASHEET, *,
                     smem: int = MAX_SMEM) -> Optional[LaunchGeometry]:
    """``hpc_qmaxsim`` (``top_k`` = 0: scores, max_q 4) and
    ``hpc_qmaxsim_topk``'s launch (csrc/quantized_maxsim.cu, ``dispatch``)
    on a card of ``sm_count`` SMs: the code-set body for K <= 256 (16 warps,
    up to 4 queries a block on the shared corpus), else the per-slot body
    (8 warps, up to 2), ``config`` (queries a block, body 1 or 0, ranges a
    block walks at most, 0); the most queries a block the body, B, max_q
    and the shared memory allow, one on per-query pools. Grid (ceil(N / R),
    ceil(B / q)), block (x, y) scoring positions [x R, (x + 1) R) masked to
    N and writing each query's scores, or its one top-k list of range x;
    a code-set launch of more (range, group) pairs than SMs takes
    max(1, SMs // groups) blocks a group, each walking the ranges x, x +
    grid.x, ... (``step``). None
    when nothing is launched; ValueError for shapes the launcher
    refuses."""
    if b <= 0 or n <= 0:
        return None
    if (b > 65535 or mq <= 0 or k <= 0 or md <= 0 or range_len <= 0
            or range_len > QMAXSIM_MAX_RANGE
            or (top_k and top_k > range_len) or top_k < 0):
        raise ValueError(
            f"quantized_maxsim: B={b}, Mq={mq}, K={k}, Md={md}, "
            f"R={range_len}, k={top_k} outside the launcher's range")
    body = qmaxsim_body(k)
    q = 1 if per_query else _QMAXSIM_MAX_Q[body]
    while q > 1 and (q > max_q or q // 2 >= b or qmaxsim_smem_bytes(
            code_bytes, mq, k, md, range_len, q) > smem):
        q //= 2
    s = qmaxsim_smem_bytes(code_bytes, mq, k, md, range_len, q)
    check_smem(s, kernel="quantized_maxsim",
               detail=f"Mq={mq}, K={k}, Md={md}, R={range_len}, {q} "
                      f"quer{'ies' if q > 1 else 'y'} a block", budget=smem)
    ranges = _cdiv(n, range_len)
    groups = _cdiv(b, q)
    gx = ranges
    if body and 0 < sm_count < ranges * groups:
        gx = max(1, sm_count // groups)
    if top_k:
        outs = (((b, ranges, top_k), torch.float32),
                ((b, ranges, top_k), torch.int32))
        unit, extent = 1, ranges
    else:
        outs = (((b, n), torch.float32),)
        unit, extent = range_len, n
    return LaunchGeometry(
        "quantized_maxsim_topk" if top_k else "quantized_maxsim",
        (gx, groups), 32 * _QMAXSIM_WARPS[body], s,
        (q, body, _cdiv(ranges, gx), 0), outs, b, q, unit, ranges, extent,
        step=gx if gx < ranges else 0)


# ---------------------------------------------------------------------------
# The shape contract under fake tensors
# ---------------------------------------------------------------------------

# active launch recorders (analysis.jaxpr_budget.Recorder): each takes
# (geometry, shapes, flops, bytes)
_recorders: List[Callable] = []
# active sweep hooks of those recorders: (starts, n) -> the starts to run
_sweeps: List[Callable] = []


def sweep(starts: range, n: int):
    """The block starts of a Python sweep over ``n`` positions (``starts``
    is range(0, n, block)): all of them, unless an analysis recorder over
    tensors without data compresses the sweep to one weighted full block
    and the ragged tail (``analysis.jaxpr_budget.Recorder.sweep``)."""
    return _sweeps[-1](starts, n) if _sweeps else starts


def is_fake(t) -> bool:
    """True for a tensor without data (a FakeTensor of an active
    ``FakeTensorMode``)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def record_launch(geometry: LaunchGeometry, shapes: dict, flops: float,
                  nbytes: float) -> None:
    """Tell the active recorders of one launch (real or fake)."""
    for rec in list(_recorders):
        rec(geometry, shapes, flops, nbytes)


def fake_launch(geometry: Optional[LaunchGeometry], device, shapes: dict,
                flops: float, nbytes: float, outputs=None):
    """The wrapper's launch on tensors without data: record it and return
    empty outputs of the geometry's shapes and dtypes (``outputs``: the
    wrapper's own shapes when nothing is launched)."""
    if geometry is not None:
        record_launch(geometry, shapes, flops, nbytes)
        outputs = geometry.outputs
    outs = tuple(torch.empty(shape, dtype=dtype, device=device)
                 for shape, dtype in outputs)
    return outs if len(outs) > 1 else outs[0]
