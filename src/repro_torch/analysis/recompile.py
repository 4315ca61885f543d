"""Recompile sentry: a closed set of call shapes as a checked contract.

The counterpart of ``repro.analysis.recompile``. The serving ladder's
point is a *closed* set of batch shapes: B in the power-of-two ladder
times the query geometries served, times the degradation levels. Eager
PyTorch compiles nothing per shape, but the contract matters all the
same: a batch that skipped the ladder padding runs kernels at a shape
nobody warmed, and a later capture of each rung's search as a CUDA graph
keys on exactly this set.

``RecompileSentry`` wraps an entry point and keeps the set of distinct
call signatures it has seen (by default: the nesting structure of the
arguments plus each leaf's (shape, dtype)). Three enforcement modes
compose:

  * ``allowed``  — a predicate over the signature; a violating call raises
    ``RecompileGuardError`` before the wrapped function runs, so no kernel
    launches at an off-ladder shape.
  * ``expected`` — a closed signature set; ``assert_signatures`` checks
    exact equality after a warm-up or serving run.
  * ``max_signatures`` — a hard cardinality cap for soak runs.

The reference's ``check_cache_consistent`` cross-checks a jitted
function's compile cache against the sentry; PyTorch has no such cache,
so it has no counterpart here.

Serving integration: ``ServeConfig(guard_recompiles=True)`` wraps the
server's search functions in a sentry keyed on (B, Mq, arg dtypes, level)
and allows only ladder rungs as batch sizes and existing levels.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

__all__ = [
    "RecompileGuardError",
    "RecompileSentry",
    "abstract_signature",
    "ladder_signatures",
]


class RecompileGuardError(RuntimeError):
    """An entry point was called outside its declared signature set."""


def _leaf_spec(leaf: Any) -> Tuple:
    if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
        # tensors and numpy arrays; neither carries a weak type
        return (tuple(leaf.shape), str(leaf.dtype), False)
    if isinstance(leaf, (bool, int, float, str, bytes, type(None))):
        # keep the value's type visible so an int/float flip shows up as a
        # distinct signature
        return ("py", type(leaf).__name__, leaf)
    return ("py", type(leaf).__name__, repr(leaf))


def _flatten(x: Any, leaves: List[Any]) -> str:
    """Append ``x``'s leaves to ``leaves``; return its structure as a
    string (tuples, lists, named tuples, dicts and dataclasses nest)."""
    if isinstance(x, (tuple, list)):
        inner = ",".join(_flatten(v, leaves) for v in x)
        name = type(x).__name__ if hasattr(x, "_fields") else \
            ("T" if isinstance(x, tuple) else "L")
        return f"{name}({inner})"
    if isinstance(x, dict):
        keys = sorted(x)
        inner = ",".join(f"{k!r}:{_flatten(x[k], leaves)}" for k in keys)
        return "{" + inner + "}"
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        inner = ",".join(f"{f.name}={_flatten(getattr(x, f.name), leaves)}"
                         for f in dataclasses.fields(x))
        return f"{type(x).__name__}({inner})"
    leaves.append(x)
    return "*"


def abstract_signature(*args, **kwargs) -> Tuple:
    """Hashable structural signature of a call: the arguments' nesting
    structure + per-leaf (shape, dtype) specs."""
    leaves: List[Any] = []
    structure = _flatten((args, kwargs), leaves)
    return (structure, tuple(_leaf_spec(x) for x in leaves))


def ladder_signatures(ladder: Iterable[int],
                      mq: Union[int, Iterable[int]]) -> frozenset:
    """The closed (B, Mq) signature set a serving ladder may run."""
    mqs = (mq,) if isinstance(mq, int) else tuple(mq)
    return frozenset((int(b), int(m)) for b in ladder for m in mqs)


class RecompileSentry:
    """Wrap a callable; count and gate its distinct call signatures."""

    def __init__(self, fn: Callable, *, name: Optional[str] = None,
                 key_fn: Optional[Callable[..., Tuple]] = None,
                 expected: Optional[Iterable] = None,
                 allowed: Optional[Callable[[Tuple], bool]] = None,
                 max_signatures: Optional[int] = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", repr(fn))
        self.key_fn = key_fn or abstract_signature
        self.expected = frozenset(expected) if expected is not None else None
        self.allowed = allowed
        self.max_signatures = max_signatures
        self.calls = 0
        self.signatures: Dict[Tuple, int] = {}  # signature -> call count

    def __call__(self, *args, **kwargs):
        key = self.key_fn(*args, **kwargs)
        # gate BEFORE recording: a rejected call never runs, so it must not
        # count as a seen signature either
        if self.allowed is not None and not self.allowed(key):
            raise RecompileGuardError(
                f"{self.name}: signature {key!r} rejected by the allowed "
                "predicate (off-ladder batch shape or dtype drift)")
        if self.expected is not None and key not in self.expected:
            raise RecompileGuardError(
                f"{self.name}: unexpected signature {key!r}; declared set "
                f"has {len(self.expected)} entries")
        self.calls += 1
        fresh = key not in self.signatures
        self.signatures[key] = self.signatures.get(key, 0) + 1
        if (self.max_signatures is not None and fresh
                and len(self.signatures) > self.max_signatures):
            raise RecompileGuardError(
                f"{self.name}: {len(self.signatures)} distinct signatures "
                f"> max_signatures={self.max_signatures} (unbounded shape "
                "growth)")
        return self.fn(*args, **kwargs)

    # -- post-run gates -----------------------------------------------------

    def assert_signatures(self, expected: Iterable) -> None:
        """Exact-set gate: the entry point ran its declared rung set, the
        whole set, and nothing but the set."""
        want = frozenset(expected)
        got = frozenset(self.signatures)
        if got != want:
            extra = sorted(map(repr, got - want))
            missing = sorted(map(repr, want - got))
            raise RecompileGuardError(
                f"{self.name}: signature set mismatch; "
                f"unexpected={extra or 'none'} missing={missing or 'none'}")

    def report(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "calls": self.calls,
            "n_signatures": len(self.signatures),
            "signatures": {repr(k): v for k, v in self.signatures.items()},
        }
