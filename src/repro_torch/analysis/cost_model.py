"""Cost model: per-path FLOP / HBM-traffic roofline contracts, over recorded
ops.

The counterpart of ``repro.analysis.cost_model``, with its documented
rules applied to the aten ops a ``jaxpr_budget.Recorder`` records (the
manifests' entry points at their two corpus sizes, on fake tensors):

  * **FLOPs**: a product (``mm``, ``bmm``, ``addmm``, ``baddbmm``: the
    products einsum and matmul decompose into) costs 2*M*N*K per batch
    element; an elementwise op one FLOP per output element; a reduction
    one per *input* element; ``topk``/``sort`` n*ceil(log2 n) over the
    input's n elements; structural ops (views, copies, gathers, factories)
    nothing. A CUDA kernel's recorded launch carries its own operations
    (``kernels.*.launch_cost``: the formulas PERF.md's bounds use).
  * **HBM bytes**: the traced inputs (read once), the outputs, and the
    *materializing* intermediates: products, sorts, concatenations, dtype
    converts, scatters and in-place writes always count; any other new
    allocation counts only above ``resident_bytes`` (64 MiB, the budget
    analyzer's block envelope) — smaller ones are assumed fused into
    their consumer. Views move nothing. A kernel launch counts its own
    bytes.
  * **loops**: a compressed sweep's block counts times the blocks it
    stands for (``Recorder.sweep``), as the reference prices a ``scan``
    body times its length.

Two-size tracing splits every metric into a static part and a per-doc
marginal (``flops_per_doc``, ``bytes_per_doc``). Arithmetic intensity is
classified against the ``RooflineSpec`` table: the H100's dense BF16 peak
and HBM3 bandwidth (``launch/mesh.py``, the data sheet's) and a CI-class
CPU core. The report is gated two ways (``python -m repro_torch.analysis
--cost``): a manifest's ``CostContract`` (its design envelope) and drift
against the committed ``COST_baseline_torch.json``.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Cost",
    "CostContract",
    "CostViolation",
    "RooflineSpec",
    "ROOFLINES",
    "RESIDENT_BYTES",
    "check_against_baseline",
    "classify_bound",
    "cost_report",
    "op_flops",
    "trace_cost",
    "load_baseline",
    "write_baseline",
]

MiB = 2 ** 20

# intermediates at or below this stay resident (cache / shared memory at
# block scale) and move no HBM bytes; the budget analyzer's block envelope
RESIDENT_BYTES = 64 * MiB

PRODUCTS = {"mm", "bmm", "addmm", "baddbmm"}
ATTENTION = {"_scaled_dot_product_flash_attention",
             "_scaled_dot_product_efficient_attention",
             "_scaled_dot_product_cudnn_attention",
             "_scaled_dot_product_flash_attention_for_cpu"}
# one FLOP per output element
ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sign", "floor", "ceil",
    "round", "trunc", "exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
    "sigmoid", "sqrt", "rsqrt", "reciprocal", "pow", "maximum", "minimum",
    "fmax", "fmin", "clamp", "clamp_min", "clamp_max", "where", "eq", "ne",
    "lt", "le", "gt", "ge", "logical_and", "logical_or", "logical_not",
    "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift", "__and__", "__or__",
    "__xor__", "__lshift__", "__rshift__", "__ilshift__", "__irshift__",
    "remainder", "fmod", "erf", "sin", "cos", "relu", "gelu", "silu",
    "softplus", "masked_fill", "lerp", "addcmul", "addcdiv", "isfinite",
    "isnan", "isinf", "square", "hardtanh", "leaky_relu", "mish",
    "threshold_backward", "gelu_backward", "silu_backward",
    "sigmoid_backward", "tanh_backward", "xlogy", "copysign",
    "add_", "sub_", "mul_", "div_", "clamp_", "masked_fill_", "lerp_",
    "addcmul_", "addcdiv_", "sqrt_", "neg_", "exp_",
}
# one FLOP per input element
REDUCERS = {
    "sum", "mean", "amax", "amin", "argmax", "argmin", "prod", "any", "all",
    "cumsum", "cumprod", "logsumexp", "var", "std", "var_mean",
    "linalg_vector_norm", "norm", "_softmax", "_log_softmax",
    "count_nonzero", "cummax", "cummin", "logcumsumexp",
    "_softmax_backward_data", "_log_softmax_backward_data",
}
SORTS = {"topk", "sort", "argsort"}
# ops that write a new buffer whatever its size
MATERIALIZING = PRODUCTS | ATTENTION | SORTS | {
    "cat", "_to_copy", "copy_", "clone", "index_put", "index_put_",
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "scatter_reduce_", "index_add", "index_add_", "index_copy",
    "index_copy_", "constant_pad_nd", "_unsafe_index_put",
}


@dataclasses.dataclass(frozen=True)
class RooflineSpec:
    """One platform's roofline: peak FLOP/s and memory bandwidth; ``ridge``
    is the intensity (FLOP/byte) where it turns compute-bound."""

    name: str
    peak_flops: float       # FLOP/s
    hbm_bw: float           # bytes/s

    @property
    def ridge(self) -> float:
        return self.peak_flops / self.hbm_bw


def _default_rooflines() -> Tuple[RooflineSpec, ...]:
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    return (
        # NVIDIA H100 SXM data sheet: dense BF16, HBM3
        RooflineSpec("h100", PEAK_FLOPS_BF16, HBM_BW),
        # a CI-class x86 core: ~100 GFLOP/s f32, ~40 GB/s DRAM
        RooflineSpec("cpu_ci", 100e9, 40e9),
    )


ROOFLINES: Tuple[RooflineSpec, ...] = _default_rooflines()


@dataclasses.dataclass(frozen=True)
class CostContract:
    """Absolute per-path design envelope (declared on a manifest): from the
    entry point's design, not from what it costs today."""

    max_flops_per_doc: Optional[float] = None
    max_bytes_per_doc: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class CostViolation:
    """One cost-contract / baseline-drift violation."""

    manifest: str
    kind: str        # "contract" | "drift" | "baseline"
    detail: str

    def __str__(self) -> str:
        return f"[{self.manifest}] {self.kind}: {self.detail}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class Cost:
    """Accumulated FLOPs / HBM bytes with a per-op breakdown."""

    __slots__ = ("flops", "bytes", "prim_flops", "prim_bytes")

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.prim_flops: Dict[str, float] = {}
        self.prim_bytes: Dict[str, float] = {}

    def add_flops(self, prim: str, n: float) -> None:
        if n:
            self.flops += n
            self.prim_flops[prim] = self.prim_flops.get(prim, 0) + n

    def add_bytes(self, prim: str, n: float) -> None:
        if n:
            self.bytes += n
            self.prim_bytes[prim] = self.prim_bytes.get(prim, 0) + n


def _product_flops(name: str, ins) -> int:
    if name in ("addmm", "baddbmm"):
        ins = ins[1:]
    a, b = ins[0], ins[1]
    batch = math.prod(a[:-2]) if len(a) > 2 else 1
    return 2 * batch * a[-2] * a[-1] * b[-1]


def op_flops(rec) -> float:
    """FLOPs of one recorded op by the rules above (unweighted)."""
    name = rec.name
    if rec.flops is not None:
        return rec.flops
    if name in PRODUCTS and len(rec.ins) >= 2:
        return _product_flops(name, rec.ins)
    if name in ATTENTION and len(rec.ins) >= 2:
        q, k = rec.ins[0], rec.ins[1]
        return 4 * math.prod(q[:-1]) * k[-2] * q[-1]
    if name in ("max", "min") and len(rec.ins) >= 2:
        name = "maximum"                       # the binary overload
    if name in ELEMENTWISE:
        return sum(math.prod(s) for s, *_ in rec.outs[:1])
    if name in REDUCERS or name in ("max", "min"):
        return rec.in_numel
    if name in SORTS:
        n = rec.in_numel
        return n * max(1, math.ceil(math.log2(max(n, 2))))
    return 0


def trace_cost(trace, *, resident_bytes: int = RESIDENT_BYTES) -> Cost:
    """Price one ``jaxpr_budget.Trace``: inputs + outputs + ops."""
    cost = Cost()
    for rec in trace.ops:
        w = rec.weight
        cost.add_flops(rec.name, op_flops(rec) * w)
        if rec.nbytes is not None:                     # a kernel launch
            cost.add_bytes(rec.name, rec.nbytes * w)
            continue
        for _shape, dt, nbytes, alias, _v in rec.outs:
            if rec.name in MATERIALIZING and rec.name.endswith("_") \
                    and rec.name != "copy_" and len(rec.ins) > 1:
                # an in-place scatter writes its source's (or index's)
                # elements, not the whole destination
                nbytes = math.prod(rec.ins[-1]) * dt.itemsize
            if rec.name in MATERIALIZING or (not alias
                                             and nbytes > resident_bytes):
                cost.add_bytes(rec.name, nbytes * w)
    cost.add_bytes("<inputs>", trace.input_bytes)
    cost.add_bytes("<outputs>", trace.out_bytes)
    return cost


def classify_bound(intensity: float,
                   rooflines: Tuple[RooflineSpec, ...] = ROOFLINES
                   ) -> Dict[str, str]:
    """'memory' below each platform's ridge intensity, 'compute' above."""
    return {r.name: ("compute" if intensity >= r.ridge else "memory")
            for r in rooflines}


def cost_report(manifest, *, device="cpu",
                resident_bytes: int = RESIDENT_BYTES) -> dict:
    """Trace one manifest at (n, n_alt) and price both; returns the entry
    ``COST_baseline_torch.json`` pins."""
    from repro_torch.analysis.jaxpr_budget import trace_manifest
    big = trace_cost(trace_manifest(manifest, manifest.n, device=device),
                     resident_bytes=resident_bytes)
    small = trace_cost(trace_manifest(manifest, manifest.n_alt,
                                      device=device),
                       resident_bytes=resident_bytes)
    dn = manifest.n - manifest.n_alt
    flops_per_doc = (big.flops - small.flops) / dn
    bytes_per_doc = (big.bytes - small.bytes) / dn
    intensity = big.flops / big.bytes if big.bytes else float("inf")
    report = {
        "manifest": manifest.name,
        "n": manifest.n,
        "flops": big.flops,
        "hbm_bytes": big.bytes,
        "flops_per_doc": flops_per_doc,
        "bytes_per_doc": bytes_per_doc,
        "intensity": intensity,
        "bound": classify_bound(intensity),
        "roofline_s": {r.name: max(big.flops / r.peak_flops,
                                   big.bytes / r.hbm_bw)
                       for r in ROOFLINES},
        "prim_flops": dict(sorted(big.prim_flops.items(),
                                  key=lambda kv: -kv[1])),
        "prim_bytes": dict(sorted(big.prim_bytes.items(),
                                  key=lambda kv: -kv[1])),
    }
    contract = getattr(manifest, "cost", None)
    violations: List[CostViolation] = []
    if contract is not None:
        if (contract.max_flops_per_doc is not None
                and flops_per_doc > contract.max_flops_per_doc):
            violations.append(CostViolation(
                manifest.name, "contract",
                f"flops_per_doc {flops_per_doc:.1f} exceeds the declared "
                f"envelope {contract.max_flops_per_doc:.1f} "
                f"(top FLOP ops: {_top(big.prim_flops)})"))
        if (contract.max_bytes_per_doc is not None
                and bytes_per_doc > contract.max_bytes_per_doc):
            violations.append(CostViolation(
                manifest.name, "contract",
                f"bytes_per_doc {bytes_per_doc:.1f} exceeds the declared "
                f"envelope {contract.max_bytes_per_doc:.1f} "
                f"(top traffic ops: {_top(big.prim_bytes)})"))
    report["violations"] = [v.to_json() for v in violations]
    report["ok"] = not violations
    return report


def _top(prim_map: Dict[str, float], k: int = 3) -> str:
    items = sorted(prim_map.items(), key=lambda kv: -kv[1])[:k]
    return ", ".join(f"{p}={v:.3g}" for p, v in items)


def _prim_deltas(cur: Dict[str, float], base: Dict[str, float],
                 k: int = 3) -> str:
    """Name the ops responsible for an inflation."""
    deltas = {p: cur.get(p, 0) - base.get(p, 0)
              for p in set(cur) | set(base)}
    worst = [(p, d) for p, d in sorted(deltas.items(),
                                       key=lambda kv: -kv[1])[:k] if d > 0]
    if not worst:
        return "no single op dominates"
    return ", ".join(f"{p} +{d:.3g}" for p, d in worst)


# metrics gated against the committed baseline (all "lower is better")
_GATED_METRICS = ("flops", "hbm_bytes", "flops_per_doc", "bytes_per_doc")


def check_against_baseline(reports: List[dict], baseline: dict,
                           tolerance: float = 0.10) -> List[CostViolation]:
    """Drift gate: each report's gated metrics against the committed
    entry. Fails on a metric rising beyond ``tolerance`` (improvements
    pass; refresh the baseline to bank them), on entry points missing from
    the baseline, and on baseline entries with no manifest; the message
    names the ops behind an inflation."""
    out: List[CostViolation] = []
    entries = baseline.get("entries", {})
    for r in reports:
        name = r["manifest"]
        base = entries.get(name)
        if base is None:
            out.append(CostViolation(
                name, "baseline",
                "no entry in COST_baseline_torch.json — regenerate with "
                "`python -m repro_torch.analysis --cost "
                "--write-cost-baseline`"))
            continue
        for metric in _GATED_METRICS:
            cur_v, base_v = float(r[metric]), float(base[metric])
            # the band is relative to the baseline's magnitude (a real
            # trace's per-doc marginal can sit just below zero)
            if cur_v > base_v + tolerance * abs(base_v) + 1e-9:
                which = "prim_flops" if "flops" in metric else "prim_bytes"
                out.append(CostViolation(
                    name, "drift",
                    f"{metric} {base_v:.6g} -> {cur_v:.6g} "
                    f"(+{(cur_v - base_v) / max(base_v, 1e-30):.0%} > tol "
                    f"{tolerance:.0%}); offending ops: "
                    f"{_prim_deltas(r.get(which, {}), base.get(which, {}))}"
                ))
    known = {r["manifest"] for r in reports}
    for name in entries:
        if name not in known:
            out.append(CostViolation(
                name, "baseline",
                "baseline entry has no registered manifest — regenerate "
                "the baseline after removing/renaming entry points"))
    return out


# ---------------------------------------------------------------------------
# Baseline artifact I/O
# ---------------------------------------------------------------------------

BASELINE_PATH = (Path(__file__).resolve().parents[3]
                 / "COST_baseline_torch.json")


def load_baseline(path=None) -> Optional[dict]:
    p = Path(path) if path is not None else BASELINE_PATH
    if not p.exists():
        return None
    with open(p) as f:
        return json.load(f)


def write_baseline(reports: List[dict], path=None) -> Path:
    p = Path(path) if path is not None else BASELINE_PATH
    entries = {}
    for r in reports:
        entries[r["manifest"]] = {
            key: r[key] for key in (
                "flops", "hbm_bytes", "flops_per_doc", "bytes_per_doc",
                "intensity", "bound", "prim_flops", "prim_bytes")}
    payload = {
        "schema": 1,
        "resident_bytes": RESIDENT_BYTES,
        "rooflines": {r.name: {"peak_flops": r.peak_flops,
                               "hbm_bw": r.hbm_bw, "ridge": r.ridge}
                      for r in ROOFLINES},
        "entries": dict(sorted(entries.items())),
    }
    with open(p, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return p
