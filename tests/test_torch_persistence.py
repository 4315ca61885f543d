"""Index files (save/load, format v3): the port against the JAX package.

For every backend, monolithic and segmented (a build, two adds, deletes
and an upsert), the reference's file loads in the port and searches as the
reference does; the port's file of the same state (carried across by
``state_from_numpy``) loads in the reference and searches as the port
does; and the two files hold the same keys, each leaf with the same dtype,
shape and bytes, in ``jax.tree_util``'s leaf order. Float scores within
1e-4 (caveat C1), ids outside near-ties; Hamming scores exactly. Then the
counterparts of the reference's persistence tests on the port's own
builds: round trips, a wrong backend, a future version and a non-index
file rejected with the reference's messages, v1 and v2 files read, a
corrupt array named, and a SIGKILL in the middle of a save leaving the
previous file loadable.
"""
import os
import re
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import HNSWConfig as JHNSWConfig
from repro.core.index import IVFConfig as JIVFConfig
from repro.data import synthetic as jax_synthetic
from repro.retrieval import CascadeConfig as JCascadeConfig
from repro.retrieval import Corpus as JCorpus
from repro.retrieval import HPCConfig as JConfig
from repro.retrieval import Query as JQuery
from repro.retrieval import Retriever as JRetriever
from repro_torch import convert, state_from_numpy
from repro_torch.data import synthetic
from repro_torch.retrieval import (CascadeConfig, Corpus, HNSWConfig,
                                   HPCConfig, IVFConfig, Query, Retriever)
from repro_torch.retrieval import base as base_mod
from tests._torch_parity import assert_topk_match, state_arrays, to_torch

BACKENDS = ["flat", "float_flat", "hamming", "cascade", "ivf", "hnsw"]
LAYOUTS = ["monolithic", "segmented"]
SPEC = dict(n_docs=60, n_queries=8, n_patches=8, n_q_patches=4, dim=16,
            n_topics=4, patches_per_topic=8, noise=0.1)
N_BASE, N_D1, N_TOTAL = 40, 52, 60
DEAD = [3, 10, 41, 55]
UPSERT_ID, UPSERT_SRC = 5, 53
TOL = 1e-4
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _knobs(backend):
    return dict(k=16, p=80.0, backend=backend, kmeans_iters=6,
                kmeans_restarts=1, rerank=8)


def _jcfg(backend):
    return JConfig(cascade=JCascadeConfig(p1=24, p2=10),
                   ivf=JIVFConfig(n_list=4, n_probe=3, bucket_cap=32,
                                  iters=5),
                   hnsw=JHNSWConfig(m=4, ef_construction=16, ef_search=24,
                                    levels=3), **_knobs(backend))


def _tcfg(backend):
    return HPCConfig(cascade=CascadeConfig(p1=24, p2=10),
                     ivf=IVFConfig(n_list=4, n_probe=3, bucket_cap=32,
                                   iters=5),
                     hnsw=HNSWConfig(m=4, ef_construction=16, ef_search=24,
                                     levels=3), **_knobs(backend))


@pytest.fixture(scope="module")
def data():
    d = jax_synthetic.make_retrieval_corpus(
        jax.random.PRNGKey(7), jax_synthetic.CorpusSpec(**SPEC))
    return d._replace(**{f: np.asarray(getattr(d, f)) for f in d._fields})


def _jslice(d, lo, hi):
    return JCorpus(*(jnp.asarray(a[lo:hi]) for a in (
        d.doc_patches, d.doc_mask, d.doc_salience)))


def _queries(d):
    return (JQuery(*map(jnp.asarray, (d.query_patches, d.query_mask,
                                      d.query_salience))),
            Query(*to_torch(d.query_patches, d.query_mask,
                            d.query_salience)))


@pytest.fixture(scope="module", params=[(b, lay) for b in BACKENDS
                                        for lay in LAYOUTS],
                ids=[f"{b}-{lay}" for b in BACKENDS for lay in LAYOUTS])
def reference(request, data):
    """(backend, JAX retriever, JAX state): monolithic, or after two adds,
    deletes and an upsert."""
    backend, layout = request.param
    r = JRetriever(_jcfg(backend))
    st = r.build(jax.random.PRNGKey(0), _jslice(data, 0, N_BASE))
    if layout == "segmented":
        st = r.add(st, _jslice(data, N_BASE, N_D1))
        st = r.add(st, _jslice(data, N_D1, N_TOTAL))
        st = r.delete(st, np.array(DEAD))
        st = r.add(st, _jslice(data, UPSERT_SRC, UPSERT_SRC + 1),
                   doc_ids=np.array([UPSERT_ID]))
    return backend, r, st


def _check(got, want):
    """Integer (Hamming) scores and their ids exactly; float scores within
    TOL and ids outside near-ties."""
    got_s, got_i = (np.asarray(t) for t in got)
    want_s, want_i = map(np.asarray, want)
    if got_s.dtype == np.int32:
        np.testing.assert_array_equal(got_s, want_s)
        np.testing.assert_array_equal(got_i, want_i)
    else:
        assert_topk_match(got_s, got_i, want_s, want_i, TOL)


def _file(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def test_reference_file_loads_in_the_port(reference, data, tmp_path):
    backend, jret, jst = reference
    jq, tq = _queries(data)
    path = jret.save(str(tmp_path / "ref"), jst)
    ret = Retriever(_tcfg(backend))
    state = ret.load(path, device="cpu")
    assert (ret.backend._segmented(state) is None) == (
        jret.backend._segmented(jst) is None)
    _check(ret.search(state, tq, k=10), jret.search(jst, jq, k=10))
    _check(ret.backend.search(state, tq, k=10),
           jret.backend.search(jst, jq, k=10))


def test_port_file_loads_in_the_reference(reference, data, tmp_path):
    backend, jret, jst = reference
    jq, tq = _queries(data)
    ret = Retriever(_tcfg(backend))
    state = state_from_numpy(state_arrays(jst, backend), device="cpu",
                             backend=backend)
    path = ret.save(str(tmp_path / "port"), state)
    assert path.endswith(".npz") and not os.path.exists(path + ".tmp")
    loaded = jret.load(path)
    _check(ret.search(state, tq, k=10), jret.search(loaded, jq, k=10))


def test_port_and_reference_files_hold_the_same_arrays(reference, tmp_path):
    backend, jret, jst = reference
    ret = Retriever(_tcfg(backend))
    state = state_from_numpy(state_arrays(jst, backend), device="cpu",
                             backend=backend)
    want = _file(jret.save(str(tmp_path / "ref"), jst))
    got = _file(ret.save(str(tmp_path / "port"), state))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


def test_leaf_order_is_jax_tree_leaves(reference):
    """convert.state_leaves walks the port's state in the order
    jax.tree_util flattens the reference's, dtype for dtype."""
    backend, _, jst = reference
    state = state_from_numpy(state_arrays(jst, backend), device="cpu",
                             backend=backend)
    got = convert.state_leaves(state)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jst)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (i, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=str(i))
    # and back: the leaves rebuild the same state under the template
    aux = Retriever(_tcfg(backend)).backend._state_aux(state)
    n_seg = Retriever(_tcfg(backend)).backend._n_segments(state)
    template = Retriever(_tcfg(backend)).backend.state_template(aux, n_seg)
    assert convert.n_leaves(template) == len(want)
    again = convert.state_from_leaves(template, want, torch.device("cpu"))
    for g, w in zip(convert.state_leaves(again), want):
        np.testing.assert_array_equal(g, w)


def test_state_from_numpy_names_a_missing_array(reference):
    backend, _, jst = reference
    arrays = state_arrays(jst, backend)
    for key in arrays:
        rest = {k: v for k, v in arrays.items() if k != key}
        if key.endswith("pos_of_id"):
            # without it the fields read as a monolithic structure's,
            # whose own keys are then missing
            with pytest.raises(KeyError):
                state_from_numpy(rest, device="cpu", backend=backend)
            continue
        with pytest.raises(KeyError, match=re.escape(repr(key))):
            state_from_numpy(rest, device="cpu", backend=backend)


# ---------------------------------------------------------------------------
# The reference's persistence tests, on the port's own builds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tdata():
    d = synthetic.make_retrieval_corpus(synthetic.CorpusSpec(**SPEC), seed=7,
                                        device="cpu")
    return d._replace(**{f: getattr(d, f).numpy() for f in d._fields})


def _tslice(d, lo, hi):
    return Corpus(*to_torch(d.doc_patches[lo:hi], d.doc_mask[lo:hi],
                            d.doc_salience[lo:hi]))


@pytest.fixture(scope="module", params=BACKENDS)
def port_states(request, tdata):
    """(backend, retriever, monolithic state, segmented state) of the
    port's own build."""
    backend = request.param
    r = Retriever(_tcfg(backend))
    st = r.build(torch.Generator().manual_seed(0), _tslice(tdata, 0, N_BASE))
    seg = r.add(st, _tslice(tdata, N_BASE, N_TOTAL))
    seg = r.delete(seg, np.array(DEAD))
    return backend, r, st, seg


@pytest.mark.parametrize("layout", LAYOUTS)
def test_save_load_roundtrip(port_states, tdata, tmp_path, layout):
    backend, r, mono, seg = port_states
    state = mono if layout == "monolithic" else seg
    _, tq = _queries(tdata)
    path = r.save(str(tmp_path / f"{backend}_idx"), state)
    restored = r.load(path, device="cpu")
    for a, b in zip(convert.state_leaves(state),
                    convert.state_leaves(restored)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    s0, i0 = r.search(state, tq, k=5)
    s1, i1 = r.search(restored, tq, k=5)
    assert torch.equal(i0, i1) and torch.equal(s0, s1)
    info = base_mod.last_io
    assert info["bytes"] == os.path.getsize(path)
    assert 0.0 <= info["crc32_seconds"] <= info["seconds"]


def test_hnsw_roundtrip_keeps_ef_search_and_entry(tdata, tmp_path):
    r = Retriever(_tcfg("hnsw"))
    st = r.build(torch.Generator().manual_seed(1), _tslice(tdata, 0, N_BASE))
    restored = r.load(r.save(str(tmp_path / "hnsw_idx"), st), device="cpu")
    assert restored.backend_state.ef_search == 24
    assert restored.backend_state.index.entry == st.backend_state.index.entry
    assert isinstance(restored.backend_state.index.entry, int)


def test_load_rejects_wrong_backend(port_states, tmp_path):
    backend, r, mono, _ = port_states
    path = r.save(str(tmp_path / "idx"), mono)
    other = "hamming" if backend != "hamming" else "flat"
    with pytest.raises(ValueError, match="saved by backend"):
        Retriever(_tcfg(other)).load(path, device="cpu")


def test_load_rejects_future_format_version(port_states, tmp_path):
    _, r, _, seg = port_states
    path = r.save(str(tmp_path / "seg_idx"), seg)
    payload = _file(path)
    payload["format_version"] = np.asarray(99, np.int64)
    np.savez(path, **payload)
    with pytest.raises(ValueError, match="format version 99"):
        r.load(path, device="cpu")


def test_load_rejects_non_index_file(tmp_path):
    path = str(tmp_path / "junk.npz")
    np.savez(path, stuff=np.zeros(3))
    with pytest.raises(ValueError, match="no 'backend' key"):
        Retriever(_tcfg("flat")).load(path, device="cpu")


def test_load_reads_v1_and_v2_files(port_states, tdata, tmp_path):
    """v1: no format_version (monolithic); v2: no checksums."""
    _, r, mono, seg = port_states
    _, tq = _queries(tdata)
    for name, state, drop in (("v1", mono, ("format_version", "checksums")),
                              ("v2", seg, ("checksums",))):
        path = r.save(str(tmp_path / name), state)
        payload = {k: v for k, v in _file(path).items() if k not in drop}
        if name == "v2":
            payload["format_version"] = np.asarray(2, np.int64)
        np.savez(path, **payload)
        loaded = r.load(path, device="cpu")
        s0, i0 = r.search(state, tq, k=5)
        s1, i1 = r.search(loaded, tq, k=5)
        assert torch.equal(i0, i1) and torch.equal(s0, s1), name


def test_corrupt_array_is_named(tmp_path):
    rng = np.random.default_rng(0)
    emb = torch.from_numpy(rng.normal(size=(32, 4, 8)).astype(np.float32))
    mask = torch.ones((32, 4), dtype=torch.bool)
    from repro_torch.core import index as index_mod
    from repro_torch.retrieval.base import RetrieverState, get_backend
    state = RetrieverState(torch.zeros((4, 8)),
                           index_mod.build_float_flat(emb, mask),
                           torch.zeros((32, 4), dtype=torch.uint8), mask)
    backend = get_backend("float_flat")
    path = backend.save(str(tmp_path / "idx"), state)
    payload = _file(path)
    bad = payload["leaf_0001"].copy()
    bad.flat[0] += 1
    payload["leaf_0001"] = bad
    np.savez(path, **payload)
    with pytest.raises(ValueError, match="leaf_0001"):
        backend.load(path, device="cpu")
    payload["checksums"] = payload["checksums"][:2]
    np.savez(path, **payload)
    with pytest.raises(ValueError, match="truncated manifest"):
        backend.load(path, device="cpu")
    del payload["checksums"]               # a v2 file: nothing to verify
    payload["format_version"] = np.asarray(2, np.int64)
    np.savez(path, **payload)
    backend.load(path, device="cpu")


def test_sigkill_mid_save_leaves_loadable_index(tmp_path):
    """SIGKILL a process (torch, no JAX) in the middle of its save loop:
    the path holds the previous complete file and loads clean."""
    path = str(tmp_path / "idx.npz")
    code = f"""
import numpy as np, torch
from repro_torch.core import index as index_mod
from repro_torch.retrieval.base import RetrieverState, get_backend
rng = np.random.default_rng(0)
emb = torch.from_numpy(rng.normal(size=(256, 8, 16)).astype(np.float32))
mask = torch.ones((256, 8), dtype=torch.bool)
state = RetrieverState(torch.zeros((4, 16)),
                       index_mod.build_float_flat(emb, mask),
                       torch.zeros((256, 8), dtype=torch.uint8), mask)
b = get_backend("float_flat")
import sys
assert "jax" not in sys.modules and "repro" not in sys.modules
i = 0
while True:
    b.save({path!r}, state)
    i += 1
    print("SAVED", i, flush=True)
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(ROOT, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("SAVED"), line
        for _ in range(3):
            proc.stdout.readline()
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    from repro_torch.retrieval.base import get_backend
    state = get_backend("float_flat").load(path, device="cpu")
    assert tuple(state.rerank_codes.shape) == (256, 8)


def test_load_refuses_the_card_on_a_host_without_one(port_states, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    _, r, mono, _ = port_states
    path = r.save(str(tmp_path / "idx"), mono)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        r.load(path)
