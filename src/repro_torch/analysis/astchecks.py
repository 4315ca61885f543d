"""PyTorch-aware AST lint rules (TORCH01-TORCH05) on the lintcore framework.

The counterparts of ``repro.analysis.astchecks``' JAX01-JAX05 for the
port's eager PyTorch code:

  TORCH01  one seed value seeds two generators in one scope
           (``torch.Generator(...).manual_seed(s)`` / ``g.manual_seed(s)``
           / ``torch.manual_seed(s)`` at two call sites with the same seed
           expression): the two streams are the same stream, or correlated
           ones — the counterpart of JAX01's key reuse. Derive the second
           seed (``s + 1``) or draw both from one generator.
  TORCH02  a host sync inside a function the port declares sync-free —
           the bodies a CUDA graph captures and the serving path's sweeps,
           named in ``SYNC_FREE_FUNCTIONS`` (the counterpart of JAX03's
           ``KNOWN_STATIC_PARAMS`` naming what a rule covers): ``.item()``,
           ``.cpu()``, ``.tolist()``, ``.numpy()``, ``float``/``int``/
           ``bool`` of a parameter annotated as a tensor, and
           ``torch.cuda.synchronize``. A sync inside a graph capture
           fails the capture; on the serving path it stalls the host on
           the card once per call.
  TORCH04  bare ``torch.topk`` / ``Tensor.topk`` outside the streaming
           scan engine (``core/scan.py``): ``topk`` raises when k exceeds
           the input length and promises no order among equal values, so
           call sites route through the scan's stable merge or carry a
           ``# noqa: TORCH04`` with the k <= n argument.
  TORCH05  a blocking host sync inside an ``async def`` body (``.item()``,
           ``.cpu()``, ``.tolist()``, ``.numpy()``, ``torch.cuda.
           synchronize``, ``np.asarray``/``np.array``): it stalls the event
           loop for the device round trip, head-of-line blocking every
           coalesced request. Move it into the executor-side compute.

JAX03 (a jitted function's known-static parameter missing from
``static_argnames``) has no counterpart: eager PyTorch has no jit cache
that an undeclared static argument could bloat (ROADMAP.md §C).

All rules are heuristic (AST only, nothing imported): a false positive is
suppressed with a code-specific ``# noqa: TORCHxx`` and a justification.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.lintcore import Finding, Rule

# functions the port declares free of host syncs: the scan engine's sweeps
# and merge (every search's hot path), the segmented sweeps of core/index.py
# ("no search function here syncs"), and the MoE router (captured in a CUDA
# graph, models/layers.py)
SYNC_FREE_FUNCTIONS = frozenset({
    "quantized_maxsim_topk", "maxsim_topk", "hamming_maxsim_topk",
    "_streaming_topk", "_merge", "_init_buffer",
    "search_flat", "search_float_flat", "search_hamming",
    "search_flat_candidates", "search_float_flat_candidates",
    "search_hamming_candidates", "search_flat_segmented",
    "search_float_flat_segmented", "search_hamming_segmented",
    "moe_route",
})
# the one module whose merge owns the k <= N guarantee
SCAN_ENGINE_SUFFIX = "core/scan.py"
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")
_TENSOR_ANNOTATIONS = ("Tensor", "torch.Tensor")


def _call_root(func: ast.AST) -> Optional[str]:
    """Leftmost name of a call target: torch.cuda.synchronize -> torch."""
    n = func
    while isinstance(n, ast.Attribute):
        n = n.value
    return n.id if isinstance(n, ast.Name) else None


def _call_attr(func: ast.AST) -> Optional[str]:
    """Final attribute of a call target: torch.cuda.synchronize ->
    synchronize."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _dotted(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _scopes(tree: ast.AST):
    """Yield (scope_node, own_nodes) for the module and each function;
    nested function bodies belong to their own scope."""
    def own_nodes(scope) -> List[ast.AST]:
        out: List[ast.AST] = []
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            node = stack.pop(0)
            out.append(node)
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                stack.extend(ast.iter_child_nodes(node))
        return out

    yield tree, own_nodes(tree)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, own_nodes(node)


def _numpy_aliases(tree: ast.AST) -> Set[str]:
    aliases = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    aliases.add(a.asname or "numpy")
    return aliases


class SeedReuseRule(Rule):
    """TORCH01: one seed expression seeds two generators in one scope."""

    code = "TORCH01"

    def check(self, tree, source, path) -> Iterable[Finding]:
        for _scope, nodes in _scopes(tree):
            seen: Dict[str, int] = {}
            calls: List[Tuple[int, int, ast.Call]] = sorted(
                ((n.lineno, n.col_offset, n) for n in nodes
                 if isinstance(n, ast.Call)
                 and _call_attr(n.func) == "manual_seed" and n.args),
                key=lambda t: t[:2])
            for line, _col, call in calls:
                key = ast.dump(call.args[0])
                if key in seen:
                    yield Finding(
                        path, line, "TORCH01",
                        f"seed {ast.unparse(call.args[0])!r} already seeds "
                        f"a generator at line {seen[key]}: two generators "
                        "on one seed draw the same (or correlated) streams; "
                        "derive a distinct seed")
                else:
                    seen[key] = line


def _tensor_params(fn: ast.AST) -> Set[str]:
    args = fn.args
    out = set()
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        ann = a.annotation
        if ann is None:
            continue
        text = ast.unparse(ann)
        if any(text == t or text.endswith(f"[{t}]") for t in
               _TENSOR_ANNOTATIONS):
            out.add(a.arg)
    return out


def _host_sync(node: ast.Call, params: Set[str],
               np_names: Set[str]) -> Optional[str]:
    """What host sync the call is, or None."""
    attr = _call_attr(node.func)
    if isinstance(node.func, ast.Attribute) and attr in _SYNC_METHODS \
            and not node.args:
        return f".{attr}()"
    if _dotted(node.func) in ("torch.cuda.synchronize",
                              "cuda.synchronize"):
        return "torch.cuda.synchronize()"
    if (isinstance(node.func, ast.Name)
            and node.func.id in ("float", "int", "bool")
            and len(node.args) == 1 and isinstance(node.args[0], ast.Name)
            and node.args[0].id in params):
        return f"{node.func.id}({node.args[0].id})"
    if _call_root(node.func) in np_names and attr in ("asarray", "array"):
        return f"np.{attr}()"
    return None


class SyncFreeRule(Rule):
    """TORCH02: a host sync inside a function declared sync-free."""

    code = "TORCH02"

    def check(self, tree, source, path) -> Iterable[Finding]:
        for scope, nodes in _scopes(tree):
            if not isinstance(scope, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                continue
            if scope.name not in SYNC_FREE_FUNCTIONS:
                continue
            params = _tensor_params(scope)
            for node in nodes:
                if not isinstance(node, ast.Call):
                    continue
                what = _host_sync(node, params, set())
                if what is not None:
                    yield Finding(
                        path, node.lineno, "TORCH02",
                        f"{what} inside {scope.name!r}, which the port "
                        "declares sync-free (a CUDA graph captures it or "
                        "the serving path runs it): keep the value on the "
                        "card")


class BareTopKRule(Rule):
    """TORCH04: torch.topk outside the scan engine's stable merge."""

    code = "TORCH04"

    def check(self, tree, source, path) -> Iterable[Finding]:
        if path.replace("\\", "/").endswith(SCAN_ENGINE_SUFFIX):
            return
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "topk":
                yield Finding(
                    path, node.lineno, "TORCH04",
                    "bare topk raises when k > input length and orders "
                    "equal values arbitrarily; route through core/scan.py's "
                    "stable merge, or add `# noqa: TORCH04` with the k <= n "
                    "argument")


class AsyncHostSyncRule(Rule):
    """TORCH05: a blocking host sync on the event loop (async def body).

    Only a function's own statements are checked: a sync helper defined
    inside an ``async def`` and handed to ``run_in_executor`` is the right
    place for these calls, and ``_scopes`` gives it its own scope.
    """

    code = "TORCH05"

    def check(self, tree, source, path) -> Iterable[Finding]:
        np_names = _numpy_aliases(tree)
        for scope, nodes in _scopes(tree):
            if not isinstance(scope, ast.AsyncFunctionDef):
                continue
            params = _tensor_params(scope)
            for node in nodes:
                if not isinstance(node, ast.Call):
                    continue
                what = _host_sync(node, params, np_names)
                if what is not None:
                    yield Finding(
                        path, node.lineno, "TORCH05",
                        f"{what} in async {scope.name!r} blocks the event "
                        "loop on a device->host transfer; move it into the "
                        "executor-side compute, or `# noqa: TORCH05` if the "
                        "value is host data")


TORCH_RULES = (SeedReuseRule(), SyncFreeRule(), BareTopKRule(),
               AsyncHostSyncRule())
