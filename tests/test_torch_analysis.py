"""The port's lint framework, TORCH rules, manifests and budget analyzer.

Held against the reference (``repro.analysis``) on the same inputs:

  * lint: the port's ``lintcore`` gives the reference's findings, exactly,
    on ``tests/fixtures/lint`` (with the reference's own JAX rules plugged
    into the port's framework) and on the reference's inline cases; the
    TORCH rules fire at the exact (file, line, code) of the planted
    fixtures in ``tests/fixtures/lint_torch``, noqa lines stay silent, and
    the port and ``chip_smoke.py`` lint clean under every rule;
  * budgets: the manifest registry has the reference's 17 names, each
    backend's ``abstract_state`` has the reference's leaf shapes (dtypes
    mapped to the port's storage), the hamming manifest analyzes clean
    with its int32 contract, and a planted unblocked flat scan is
    rejected, naming the op.

Tolerance: every comparison here is exact.
"""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.analysis import lintcore as ref_lint
from repro.analysis.astchecks import JAX_RULES
from repro_torch.analysis import (BudgetManifest, analyze_manifest,
                                  check_source, get_manifest, manifests,
                                  run_paths)
from repro_torch.analysis import astchecks, jaxpr_budget
from repro_torch.analysis.lintcore import RUFF_FALLBACK_RULES
from repro_torch.retrieval.base import get_backend, state_map

ROOT = Path(__file__).resolve().parents[1]
REF_FIXTURES = ROOT / "tests" / "fixtures" / "lint"
FIXTURES = ROOT / "tests" / "fixtures" / "lint_torch"


def _keys(findings):
    return sorted((Path(f.path).name, f.line, f.code, f.msg)
                  for f in findings)


# --- the framework against the reference -----------------------------------

@pytest.mark.parametrize("rules", ["fallback", "fallback+jax"])
def test_lintcore_matches_reference_on_its_fixtures(rules):
    port = tuple(RUFF_FALLBACK_RULES)
    ref = tuple(ref_lint.RUFF_FALLBACK_RULES)
    if rules == "fallback+jax":
        port, ref = port + tuple(JAX_RULES), ref + tuple(JAX_RULES)
    got = run_paths([REF_FIXTURES], port)
    want = ref_lint.run_paths([REF_FIXTURES], ref)
    assert _keys(got) == _keys(want)
    if rules == "fallback+jax":
        assert len(got) == 7          # the reference's planted findings


@pytest.mark.parametrize("source", [
    'import os\n\n__all__ = ["os"]\n',                  # F401 via __all__
    'import os\n\nX = "see __all__ for exports"\n',     # mention is no export
    "import os  # noqa: F401\n",                        # code-specific noqa
    "import os  # noqa\n",                              # bare noqa
    "import os  # noqa: F811\n",                        # another code's noqa
    "def broken(:\n",                                   # E9
    'x = f"static"\n',                                  # F541
    'x = f"{1:8.3f}"\n',                                # a format spec
    "def a():\n    pass\n\n\ndef a():\n    pass\n",     # F811
    "from x import (a,  # noqa: F401\n    b)\n",        # multi-line noqa
])
def test_lintcore_matches_reference_inline(source):
    got = check_source("m.py", source, RUFF_FALLBACK_RULES)
    want = ref_lint.check_source("m.py", source,
                                 ref_lint.RUFF_FALLBACK_RULES)
    assert [(f.line, f.code, f.msg) for f in got] == \
        [(f.line, f.code, f.msg) for f in want]


def test_noqa_map_matches_reference():
    from repro_torch.analysis.lintcore import noqa_map
    src = ("a = 1  # noqa\nb = 2  # noqa: F401, TORCH02\nc = 3\n"
           "d = 4  # NOQA: e9\n")
    assert noqa_map(src) == ref_lint.noqa_map(src)


# --- the TORCH rules ---------------------------------------------------------

def test_torch_fixtures_fire_at_exact_locations():
    findings = run_paths([FIXTURES],
                         tuple(RUFF_FALLBACK_RULES) + astchecks.TORCH_RULES)
    got = {(Path(f.path).name, f.line, f.code) for f in findings}
    assert got == {
        ("torch01_seed_reuse.py", 7, "TORCH01"),
        ("torch02_sync_free.py", 6, "TORCH02"),
        ("torch02_sync_free.py", 7, "TORCH02"),
        ("torch02_sync_free.py", 8, "TORCH02"),
        ("torch04_bare_topk.py", 6, "TORCH04"),
        ("torch04_bare_topk.py", 10, "TORCH04"),
        ("torch05_async_sync.py", 9, "TORCH05"),
        ("torch05_async_sync.py", 10, "TORCH05"),
        ("torch05_async_sync.py", 11, "TORCH05"),
        ("torch05_async_sync.py", 12, "TORCH05"),
    }, sorted(map(str, findings))


@pytest.mark.parametrize("name,rule,line", [
    ("torch01_seed_reuse.py", "TORCH01", 13),
    ("torch02_sync_free.py", "TORCH02", 14),
    ("torch04_bare_topk.py", "TORCH04", 14),
    ("torch05_async_sync.py", "TORCH05", 18),
])
def test_torch_noqa_lines_stay_silent(name, rule, line):
    src = (FIXTURES / name).read_text()
    assert f"# noqa: {rule}" in src.splitlines()[line - 1]
    findings = run_paths([FIXTURES / name], astchecks.TORCH_RULES)
    assert line not in [f.line for f in findings]
    # without the directive the same line fires
    bare = src.replace(f"# noqa: {rule}", "#")
    assert line in [f.line for f in check_source(name, bare,
                                                  astchecks.TORCH_RULES)]


def test_clean_fixture_and_the_port_lint_clean():
    rules = tuple(RUFF_FALLBACK_RULES) + astchecks.TORCH_RULES
    assert run_paths([FIXTURES / "clean.py"], rules) == []
    findings = run_paths([ROOT / "src" / "repro_torch",
                          ROOT / "chip_smoke.py"], rules)
    assert findings == [], "\n".join(map(str, findings))


def test_rule_set_has_no_torch03():
    """JAX03 (an undeclared static argument bloating the jit cache) has
    no counterpart: eager PyTorch has no jit cache (ROADMAP.md §C)."""
    codes = [r.code for r in astchecks.TORCH_RULES]
    assert codes == ["TORCH01", "TORCH02", "TORCH04", "TORCH05"]
    assert "TORCH03" not in codes
    assert not hasattr(astchecks, "KNOWN_STATIC_PARAMS")


def test_torch02_needs_a_tensor_annotation():
    src = ("import torch\n\n\ndef _merge(x: torch.Tensor, k: int):\n"
           "    return int(k), int(x)\n")
    findings = check_source("m.py", src, astchecks.TORCH_RULES)
    assert [(f.line, f.code) for f in findings] == [(5, "TORCH02")]
    assert "int(x)" in findings[0].msg


# --- manifests and abstract states -------------------------------------------

def test_manifest_registry_is_sorted_and_the_references():
    from repro.analysis import manifests as ref_manifests
    names = [m.name for m in manifests()]
    assert names == sorted(names)
    assert names == [m.name for m in ref_manifests()]
    assert len(names) == 17
    with pytest.raises(KeyError):
        get_manifest("no_such_entry_point")
    for m in manifests():
        ref = get_manifest(m.name)
        assert (m.n, m.n_alt) == (1 << 20, 1 << 19)
        assert m.max_block_bytes == ref.max_block_bytes == 64 * 2 ** 20


def test_manifest_budgets_and_geometry_are_the_references():
    import importlib
    ref = importlib.import_module("repro.analysis.manifests")
    port = importlib.import_module("repro_torch.analysis.manifests")
    for name in ("B", "MQ", "MD", "D", "K", "TOP_K", "RERANK", "N", "N_ALT",
                 "IVF_N_LIST"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.SCAN.block_docs == ref.SCAN.block_docs
    for m in manifests():
        r = ref.get_manifest(m.name)
        assert (m.max_block_bytes, m.max_bytes_per_doc) == \
            (r.max_block_bytes, r.max_bytes_per_doc), m.name
        assert (m.cost is None) == (r.cost is None), m.name
        if m.cost is not None:
            assert (m.cost.max_flops_per_doc, m.cost.max_bytes_per_doc) == \
                (r.cost.max_flops_per_doc, r.cost.max_bytes_per_doc)
        want = tuple(np.dtype(d).name for d in r.out_dtypes)
        got = tuple(str(d).replace("torch.", "") for d in m.out_dtypes)
        assert got == want, m.name


def _ref_leaves(state):
    return [(tuple(x.shape), np.dtype(x.dtype).name)
            for x in jax.tree_util.tree_leaves(state)]


def _port_leaves(state):
    out = []
    state_map(lambda t: out.append((tuple(t.shape),
                                    str(t.dtype).replace("torch.", "")))
              or t, state)
    return out


@pytest.mark.parametrize("backend,knobs", [
    ("flat", {}), ("float_flat", {}), ("hamming", {}),
    ("ivf", {"n_list": 64, "n_probe": 8}), ("hnsw", {}),
    ("cascade", {"p1": 64, "p2": 16}),
    ("flat", {"segments": (4096, 256, 16)}),
    ("float_flat", {"segments": (4096, 256, 16)}),
    ("hamming", {"segments": (4096, 256, 16)}),
    ("ivf", {"n_list": 64, "n_probe": 8, "segments": (128, 8)}),
    ("hnsw", {"segments": (4096,)}),
    ("cascade", {"p1": 64, "p2": 16, "segments": (4096, 256, 16)}),
])
def test_abstract_state_leaf_shapes_match_reference(backend, knobs):
    from repro.retrieval.base import get_backend as ref_backend
    n = 4096
    ref = _ref_leaves(ref_backend(backend).abstract_state(n=n, **knobs))
    port = _port_leaves(get_backend(backend).abstract_state(n=n, **knobs))
    # the port keeps scalars (hamming bits, hnsw entry) as Python ints and
    # shares one codebook tensor between a state and its structures: drop
    # the reference's 0-d leaves and hold the rest in order
    ref = [leaf for leaf in ref if leaf[0] != ()]
    assert [s for s, _ in port] == [s for s, _ in ref]
    # dtypes: uint8 codes stay uint8 (K <= 256), Hamming codes are uint16
    # in the port (convert.state_from_numpy), masks bool, ids int32
    for (shape, got), (_, want) in zip(port, ref):
        if want == "uint8" and got == "uint16":
            assert backend in ("hamming", "cascade")
            continue
        assert got == want, (shape, got, want)
    meta = []
    state_map(lambda t: meta.append(t.device.type) or t,
              get_backend(backend).abstract_state(n=n, **knobs))
    assert set(meta) == {"meta"}


def test_abstract_state_is_fake_under_a_fake_mode():
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    with FakeTensorMode():
        st = get_backend("flat").abstract_state(n=1 << 20, device="cpu")
    kinds = []
    state_map(lambda t: kinds.append(isinstance(t, FakeTensor)) or t, st)
    assert kinds and all(kinds)


# --- the budget analyzer -------------------------------------------------------

def test_hamming_manifest_clean_with_int32_contract():
    m = get_manifest("scan_hamming")
    assert m.out_dtypes == (torch.int32, torch.int32)
    assert analyze_manifest(m) == []
    tr = jaxpr_budget.trace_manifest(m, m.n)
    assert tr.out_dtypes == (torch.int32, torch.int32)
    assert not tr.real


@pytest.mark.parametrize("name", [m.name for m in manifests()])
def test_every_manifest_analyzes_clean(name):
    """The port's search paths at the reference's budgets: no intermediate
    above 64 MiB, the peak growing at most max_bytes_per_doc, the dtypes
    declared (the HNSW walks traced on real CPU tensors)."""
    m = get_manifest(name)
    assert analyze_manifest(m) == []
    rep = jaxpr_budget.report(m)
    assert rep["ok"] and rep["peak_growth_bytes_per_doc"] <= \
        m.max_bytes_per_doc
    assert rep["traced_on"] == ("real CPU tensors" if "hnsw" in name
                                else "fake tensors")


def _unblocked_trace(n, device="cpu"):
    """search_flat with the streaming scan swapped for the one-shot ADC
    path: the (B, Mq, N, Md) gather at full corpus width."""
    from repro_torch.core import late_interaction as li
    qe = torch.empty((8, 8, 16), device=device)
    qm = torch.empty((8, 8), dtype=torch.bool, device=device)
    codes = torch.empty((n, 16), dtype=torch.uint8, device=device)
    mask = torch.empty((n, 16), dtype=torch.bool, device=device)
    cb = torch.empty((256, 16), device=device)

    def fn(qe, qm, codes, mask, cb):
        scores = li.quantized_maxsim(qe, qm, codes, mask, cb)
        return torch.topk(scores, 16)  # noqa: TORCH04 - fixture trace
    return fn, (qe, qm, codes, mask, cb)


def test_unblocked_scan_is_rejected():
    """Acceptance: the naive one-shot ADC path allocates the (B, Mq, N,
    Md) gather, ~2 KB/doc against a 16 B/doc allowance; the analyzer
    names the op."""
    m = BudgetManifest(name="unblocked_flat", trace=_unblocked_trace,
                       out_dtypes=None, n=1 << 15, n_alt=1 << 14)
    violations = analyze_manifest(m)
    assert violations, "the unblocked gather must not pass the budget"
    kinds = {v.kind for v in violations}
    assert "n_scaling" in kinds and "block_bytes" in kinds
    assert all(v.manifest == "unblocked_flat" for v in violations)
    block = [v for v in violations if v.kind == "block_bytes"]
    assert any("index" in v.detail and "N-scaling" in v.detail
               for v in block), block
    # 8 x 8 x 2^15 x 16 f32 = 128 MiB: the gather, then its where
    worst = jaxpr_budget.max_intermediate_bytes(
        jaxpr_budget.trace_manifest(m, m.n))
    assert worst == 8 * 8 * (1 << 15) * 16 * 4


def test_dtype_contract_is_checked():
    m = BudgetManifest(name="wrong_dtypes", trace=_unblocked_trace,
                       out_dtypes=(torch.int32, torch.int64), n=1 << 10,
                       n_alt=1 << 9)
    kinds = [v.kind for v in analyze_manifest(m)]
    assert "dtype" in kinds


def test_recorder_peak_is_exact_and_views_are_free():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        rec = jaxpr_budget.Recorder()
        with rec:
            x = torch.empty(1 << 20)                  # 4 MiB input
            rec.mark()
            a = torch.empty(1 << 22)                  # 16 MiB
            v = a[: 1 << 10].view(-1)                 # views: no bytes
            b = torch.empty(1 << 22)                  # 32 MiB live
            del a, v
            c = torch.empty(1 << 21)                  # 24 MiB live
            s = x.narrow(0, 0, 16)                    # a view of an input
            del b, c, s
    assert rec.input_bytes == 4 << 20
    assert rec.peak_above_inputs == 32 << 20
    names = [r.name for r in rec.ops]
    views = [r for r in rec.ops if r.name in ("slice", "view", "narrow")]
    assert views and all(r.new_bytes == 0 for r in views)
    assert any(o[4] for r in rec.ops for o in r.outs), names   # input view


def test_sweep_compression_keeps_the_output_and_weights_the_block():
    """A compressed sweep runs one full block weighted by the blocks it
    stands for, then the ragged tail; the outputs are the full sweep's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core import scan as scan_mod
    n = 256 * 37 + 100
    for compress in (False, True):
        with FakeTensorMode():
            rec = jaxpr_budget.Recorder(compress_loops=compress)
            with rec:
                qc = torch.empty((4, 8), dtype=torch.uint8)
                qm = torch.empty((4, 8), dtype=torch.bool)
                dc = torch.empty((n, 16), dtype=torch.uint8)
                dm = torch.empty((n, 16), dtype=torch.bool)
                s, i = scan_mod.hamming_maxsim_topk(
                    qc, qm, dc, dm, bits=8, k=16,
                    scan=scan_mod.ScanConfig(256, "plain"))
            assert tuple(s.shape) == (4, 16) and s.dtype == torch.int32
        weighted = sum(r.weight for r in rec.ops)
        if compress:
            assert len(rec.ops) < weighted
            comp = (weighted, rec.peak)
        else:
            assert all(r.weight == 1 for r in rec.ops)
            full = (len(rec.ops), rec.peak)
    assert comp == full
