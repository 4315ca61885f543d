"""Shared AST lint framework + the ruff-fallback rule set.

The port's own copy of ``repro.analysis.lintcore`` (pure ``ast``, so the
port keeps it without importing the reference). The framework half
(``Finding``, ``Rule``, ``check_source``, ``run_paths``) is rule-agnostic:
a rule inspects one parsed module and yields findings; ``run_paths``
parses each file once, runs every rule, and applies ``# noqa`` suppression with
ruff's semantics — a bare ``# noqa`` suppresses every rule on that line,
``# noqa: F401`` (or ``# noqa: F401, TORCH02``) only the named codes.

The rule half is the network-free subset of ``ruff check``: syntax errors
(E9), unused imports (F401), duplicate top-level definitions (F811), and
f-strings without placeholders (F541). F401 resolves re-exports from the
*parsed* ``__all__`` assignment list, not from a textual search.

The PyTorch-aware rules (TORCH01-TORCH05) live in
``repro_torch.analysis.astchecks``.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Union

DEFAULT_PATHS = ("src", "tests", "benchmarks", "examples", "tools")

# bare `# noqa` (group "codes" empty) or `# noqa: C1[, C2...]`
_NOQA_RE = re.compile(
    r"#\s*noqa(?::\s*(?P<codes>[A-Z]+[0-9]+(?:\s*,\s*[A-Z]+[0-9]+)*))?",
    re.IGNORECASE,
)


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One lint finding, pinned to (path, line, code)."""

    path: str
    line: int
    code: str
    msg: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.msg}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def to_github(self) -> str:
        """GitHub Actions workflow-command form — printed to stdout in
        CI, the finding renders as an inline PR annotation."""
        msg = self.msg.replace("%", "%25").replace("\r", "%0D")
        msg = msg.replace("\n", "%0A")
        return (f"::error file={self.path},line={self.line},"
                f"title={self.code}::{msg}")


class Rule:
    """One lint rule: inspect a parsed module, yield findings.

    ``code`` is the rule's primary finding code (used in listings); a rule
    may emit findings under several codes as long as each Finding carries
    its own. ``# noqa`` filtering happens in ``check_source`` — rules should
    report every violation they see.
    """

    code: str = "?"

    def check(self, tree: ast.AST, source: str, path: str) -> Iterable[Finding]:
        raise NotImplementedError


def noqa_map(source: str) -> Dict[int, Optional[frozenset]]:
    """1-based line -> suppressed codes (None = every code, ruff's bare noqa)."""
    out: Dict[int, Optional[frozenset]] = {}
    for i, ln in enumerate(source.splitlines()):
        m = _NOQA_RE.search(ln)
        if m is None:
            continue
        codes = m.group("codes")
        if codes is None:
            out[i + 1] = None
        else:
            out[i + 1] = frozenset(c.strip().upper() for c in codes.split(","))
    return out


def is_suppressed(noqa: Dict[int, Optional[frozenset]], line: int, code: str) -> bool:
    if line not in noqa:
        return False
    codes = noqa[line]
    return codes is None or code.upper() in codes


def check_source(
    path: str, source: str, rules: Sequence[Rule]
) -> List[Finding]:
    """Parse one module and run every rule; noqa-filtered, line-ordered."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, "E9", f"syntax error: {e.msg}")]
    noqa = noqa_map(source)
    findings: List[Finding] = []
    for rule in rules:
        for f in rule.check(tree, source, path):
            if not is_suppressed(noqa, f.line, f.code):
                findings.append(f)
    return sorted(findings)


def iter_py_files(paths: Sequence[Union[str, Path]]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    return files


def run_paths(
    paths: Sequence[Union[str, Path]], rules: Sequence[Rule]
) -> List[Finding]:
    findings: List[Finding] = []
    for f in iter_py_files(paths):
        findings.extend(check_source(str(f), f.read_text(), rules))
    return findings


# ---------------------------------------------------------------------------
# The ruff-fallback rules (the astlint subset)
# ---------------------------------------------------------------------------


def used_names(tree: ast.AST) -> set:
    """Names referenced anywhere, with dotted access rooted: np.zeros -> np."""
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            n: ast.AST = node
            while isinstance(n, ast.Attribute):
                n = n.value
            if isinstance(n, ast.Name):
                used.add(n.id)
    return used


def dunder_all_names(tree: ast.AST) -> set:
    """String entries of every ``__all__`` assignment / extension.

    Parsed from the AST — a docstring or comment mentioning ``__all__``
    contributes nothing. Handles ``__all__ = [...]``, ``__all__ += [...]``
    and ``__all__.extend([...])`` / ``__all__.append("x")`` forms.
    """
    names: set = set()

    def literal_strings(node: Optional[ast.AST]):
        if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
            for elt in node.elts:
                if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                    names.add(elt.value)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            names.add(node.value)

    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            if any(isinstance(t, ast.Name) and t.id == "__all__"
                   for t in node.targets):
                literal_strings(node.value)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            t = node.target
            if isinstance(t, ast.Name) and t.id == "__all__":
                literal_strings(node.value)
        elif isinstance(node, ast.Call):
            fn = node.func
            if (isinstance(fn, ast.Attribute)
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id == "__all__"
                    and fn.attr in ("extend", "append")):
                for arg in node.args:
                    literal_strings(arg)
    return names


class UnusedImportRule(Rule):
    """F401: imported name never used and not re-exported via __all__."""

    code = "F401"

    def check(self, tree, source, path):
        used = used_names(tree)
        exported = dunder_all_names(tree)
        noqa = noqa_map(source)
        for node in ast.walk(tree):
            if not isinstance(node, (ast.Import, ast.ImportFrom)):
                continue
            if isinstance(node, ast.ImportFrom) and node.module == "__future__":
                continue
            # a noqa anywhere in a multi-line import statement covers every
            # alias in it (the directive sits on the opening line while the
            # names wrap onto the next)
            span = range(node.lineno, (node.end_lineno or node.lineno) + 1)
            if any(is_suppressed(noqa, ln, "F401") for ln in span):
                continue
            for alias in node.names:
                if alias.name == "*":
                    continue
                bound = alias.asname or alias.name
                name = bound.split(".")[0]
                if name in used or bound in exported or name in exported:
                    continue
                yield Finding(
                    path, alias.lineno, "F401",
                    f"unused import: {alias.asname or alias.name}")


class EmptyFStringRule(Rule):
    """F541: f-string without placeholders."""

    code = "F541"

    def check(self, tree, source, path):
        # format specs (f"{x:8.3f}") parse as nested JoinedStr nodes with
        # no FormattedValue of their own — they are not F541
        spec_ids = {id(node.format_spec) for node in ast.walk(tree)
                    if isinstance(node, ast.FormattedValue) and node.format_spec}
        for node in ast.walk(tree):
            if isinstance(node, ast.JoinedStr) and id(node) not in spec_ids:
                if not any(isinstance(v, ast.FormattedValue)
                           for v in node.values):
                    yield Finding(path, node.lineno, "F541",
                                  "f-string without placeholders")


class RedefinitionRule(Rule):
    """F811: duplicate top-level def/class names."""

    code = "F811"

    def check(self, tree, source, path):
        seen: Dict[str, int] = {}
        for node in tree.body if isinstance(tree, ast.Module) else []:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                if node.name in seen:
                    yield Finding(
                        path, node.lineno, "F811",
                        f"redefinition of {node.name!r} "
                        f"(first at line {seen[node.name]})")
                seen[node.name] = node.lineno


RUFF_FALLBACK_RULES = (UnusedImportRule(), EmptyFStringRule(),
                       RedefinitionRule())
