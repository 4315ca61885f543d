"""The port's recsys family against the JAX package: DLRM, DCN-v2, DIN
(with and without history pruning) and DIEN at the repo's smoke configs
and with 26 small tables, the embedding substrate (``take_rows``'s fill
rule, ``embedding_bag``, the quantized tables), ``score_candidates``, the
batch maker and the training CLI.

The reference's init draws the weights, with random biases in place of
its zeros, and ``convert.recsys_params_from_numpy`` carries them across;
the same numpy batches go through the reference's jitted functions and
the port on the CPU. Grads are compared leaf by leaf in the reference's
tree (``convert.params_to_numpy``). Each tolerance is stated where it is
used.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import recsys_archs as jax_archs
from repro.data import synthetic as jax_synthetic
from repro.models import recsys as jax_recsys
from repro.optim import optimizer as jax_opt
from repro_torch import convert
from repro_torch.configs import recsys_archs
from repro_torch.data import synthetic
from repro_torch.launch import train as train_cli
from repro_torch.models import layers
from repro_torch.models import recsys
from repro_torch.models import transformer as T
from repro_torch.optim import optimizer as opt
from tests._torch_parity import to_torch
from tests.test_torch_train import (_STEP_OPT, _assert_adam_close, _flat,
                                    _host)

jax_init = jax.jit(jax_recsys.init, static_argnames=("cfg",))
jax_forward = jax.jit(jax_recsys.forward, static_argnames=("cfg",))
jax_loss_grad = jax.jit(jax.value_and_grad(jax_recsys.loss_fn, has_aux=True),
                        static_argnames=("cfg",))
jax_step = jax.jit(jax_recsys.train_step, static_argnames=("cfg", "opt_cfg"))
jax_cands = jax.jit(jax_recsys.score_candidates, static_argnames=("cfg",))

ARCHS = {"dlrm": "DLRM_MLPERF", "dcn": "DCN_V2", "din": "DIN",
         "dien": "DIEN"}
# the smoke configs, DIN with pruning, and DLRM/DCN-v2 with 26 small tables
CASES = {
    "dlrm": ("dlrm", {}), "dcn": ("dcn", {}), "din": ("din", {}),
    "din-prune50": ("din", {"din_prune_p": 50.0}), "dien": ("dien", {}),
    "dlrm-26": ("dlrm", {"table_rows": tuple(range(40, 300, 10))}),
    "dcn-26": ("dcn", {"table_rows": tuple(range(30, 290, 10))}),
}
LOGIT_TOL = 1e-5     # float32 logits and losses: rtol, with atol 1e-6
# each grad leaf: atol = 1e-5 x its max |grad|, that max floored at 1e-3 x
# the tree's (a leaf that is zero but for rounding, such as the bias before
# a softmax, which cancels)
GRAD_TOL = 1e-5


def _cfgs(case):
    family, kw = CASES[case]
    name = ARCHS[family]
    return (dataclasses.replace(getattr(jax_archs, name).smoke_config, **kw),
            dataclasses.replace(getattr(recsys_archs, name).smoke_config,
                                **kw))


def _perturb(tree, seed):
    """Random biases (x 0.1) in place of the init's zeros."""
    rng = np.random.default_rng(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if key == "b":
            return (0.1 * rng.standard_normal(node.shape)).astype(node.dtype)
        return node

    return walk(tree)


def _model(case, seed=0):
    """(JAX cfg, port cfg, host params, port model on the CPU)."""
    jcfg, tcfg = _cfgs(case)
    params = _perturb(_host(jax_init(jax.random.PRNGKey(seed), cfg=jcfg)),
                      seed + 1)
    return jcfg, tcfg, params, convert.recsys_params_from_numpy(
        params, tcfg, device="cpu")


def _batch(cfg, b, seed, ragged=True):
    """A numpy batch: ids in range, labels 0/1; for DIN/DIEN, histories
    of every length from 0 to S with random holes (ragged masks)."""
    rng = np.random.default_rng(seed)
    out = {"label": (rng.random(b) < 0.4).astype(np.float32)}
    if cfg.family in ("din", "dien"):
        s, n = cfg.seq_len, cfg.table_rows[0]
        lengths = np.arange(b) % (s + 1)
        mask = np.arange(s)[None, :] < lengths[:, None]
        if ragged:
            mask &= rng.random((b, s)) > 0.2
        out.update(hist_ids=rng.integers(0, n, (b, s)).astype(np.int32),
                   hist_mask=mask,
                   target_ids=rng.integers(0, n, b).astype(np.int32))
    else:
        out.update(dense=rng.standard_normal((b, cfg.n_dense)).astype(
                       np.float32),
                   sparse_ids=np.stack([rng.integers(0, r, b) for r in
                                        cfg.table_rows], 1).astype(np.int32))
    return out


def _tb(batch):
    return dict(zip(batch, to_torch(*batch.values())))


def _assert_trees_close(got, want, tol):
    """Leaf by leaf: |got - want| <= tol x the leaf's max |want|, floored
    at 1e-3 x the tree's."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-3 * top)
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=tol * scale, err_msg=k)


# ---------------------------------------------------------------------------
# the families against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_forward_loss_and_grads_match_the_reference(case):
    jcfg, tcfg, params, model = _model(case)
    batch = _batch(jcfg, 24, seed=3)
    want = np.asarray(jax_forward(params, batch, cfg=jcfg))
    got = recsys.forward(T.params_of(model), _tb(batch), tcfg)
    assert got.dtype == torch.float32 and got.shape == (24,)
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGIT_TOL, atol=1e-6)

    (jloss, jparts), jgrads = jax_loss_grad(params, batch, cfg=jcfg)
    loss, parts, grads = T.value_and_grad(
        lambda p: recsys.loss_fn(p, _tb(batch), tcfg), T.params_of(model))
    assert float(loss) == pytest.approx(float(jloss), rel=LOGIT_TOL)
    assert float(parts["acc"]) == pytest.approx(float(jparts["acc"]))
    _assert_trees_close(convert.params_to_numpy(grads), _host(jgrads),
                        GRAD_TOL)


@pytest.mark.parametrize("case", ["dlrm", "dcn", "din", "din-prune50",
                                  "dien", "dcn-26"])
def test_train_steps_match_the_reference(case):
    """8 AdamW steps on fresh batches (the LM tests' settings): loss and
    grad norm within 1e-5 each step, params after 1 and 8 steps as
    ``_assert_adam_close`` says."""
    jcfg, tcfg, params, model = _model(case, seed=4)
    jo, to = jax_opt.AdamWConfig(**_STEP_OPT), opt.AdamWConfig(**_STEP_OPT)
    jp, js = params, jax_opt.init(jo, params)
    tp = T.params_of(model)
    ts = opt.init(to, tp)
    sum_lr = 0.0
    for i in range(8):
        batch = _batch(jcfg, 16, seed=100 + i)
        jp, js, jm = jax_step(jp, js, batch, cfg=jcfg, opt_cfg=jo)
        tp, ts, tm = recsys.train_step(tp, ts, _tb(batch), tcfg, to)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5)
        sum_lr += float(jm["lr"])
        if i in (0, 7):
            _assert_adam_close(convert.params_to_numpy(tp), jp, sum_lr)
    assert int(ts.step) == int(js.step) == 8


def test_dlrm_bf16_params_match_the_reference():
    """bf16 params (the interaction multiplied in float32, cast after the
    gather): logits within 2 bf16 steps (2^-7) of the largest."""
    jcfg, tcfg = _cfgs("dlrm")
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, param_dtype="bfloat16")
    params = _perturb(_host(jax_init(jax.random.PRNGKey(6), cfg=jcfg)), 7)
    model = convert.recsys_params_from_numpy(params, tcfg, device="cpu")
    assert model.tables[0].dtype == torch.bfloat16
    batch = _batch(jcfg, 32, seed=8)
    want = np.asarray(jax_forward(params, batch, cfg=jcfg))
    got = recsys.forward(T.params_of(model), _tb(batch), tcfg).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())


def test_dlrm_interaction_gathers_the_upper_triangle_in_row_major_order():
    """Against the reference's interaction: within 1e-6 (float32 sums of
    5 products)."""
    rng = np.random.default_rng(22)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    emb = rng.standard_normal((3, 4, 5)).astype(np.float32)
    got = recsys._dot_interact(*to_torch(x, emb)).numpy()
    vecs = np.concatenate([x[:, None], emb], 1)
    want = np.asarray(jax_recsys._dot_interact(jnp.asarray(vecs)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got.shape == (3, 10)


@pytest.mark.parametrize("case", ["dlrm", "dcn", "din", "dien"])
def test_score_candidates_match_the_reference(case):
    jcfg, tcfg, params, model = _model(case, seed=9)
    user = {k: v[:1] for k, v in _batch(jcfg, 4, seed=10, ragged=False)
            .items() if k != "label"}
    n_items = jcfg.table_rows[-1]
    cands = np.random.default_rng(11).integers(0, n_items, 37).astype(
        np.int32)
    want = np.asarray(jax_cands(params, user, jnp.asarray(cands), cfg=jcfg))
    got = recsys.score_candidates(T.params_of(model), _tb(user),
                                  torch.from_numpy(cands), tcfg)
    assert got.shape == (37,)
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGIT_TOL, atol=1e-6)


def test_out_of_range_ids_give_nan_logits_as_the_reference():
    """An id past its table reads a NaN row: the logit is NaN in both."""
    jcfg, tcfg, params, model = _model("dcn", seed=12)
    batch = _batch(jcfg, 6, seed=13)
    batch["sparse_ids"][2, 1] = jcfg.table_rows[1] + 5
    batch["sparse_ids"][4, 0] = -1                    # wraps to the last row
    want = np.asarray(jax_forward(params, batch, cfg=jcfg))
    got = recsys.forward(T.params_of(model), _tb(batch), tcfg).numpy()
    assert np.isnan(want[2]) and np.isnan(got[2])
    keep = np.arange(6) != 2
    np.testing.assert_allclose(got[keep], want[keep], rtol=LOGIT_TOL,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the substrate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8])
def test_take_rows_follows_jnp_takes_fill_rule(dtype):
    """In-range ids, negative ids in [-rows, -1] (wrapped) and ids past
    either end (NaN, int32 min, uint8 max): equal to ``jnp.take``."""
    rng = np.random.default_rng(14)
    table = (rng.standard_normal((6, 3)) * 50).astype(dtype)
    ids = np.array([[0, 5, 6, 100], [-1, -6, -7, 3]], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0))
    got = layers.take_rows(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[1, 0], table[5])
    flat = layers.take_rows(torch.from_numpy(table[:, 0].copy()),
                            torch.from_numpy(ids))
    np.testing.assert_array_equal(flat.numpy(), want[..., 0])


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_the_reference(mode):
    """Bags of 0-4 ids, an id past the table (a NaN row, in its bag only)
    and a segment id past the bags (dropped): equal within 1e-6."""
    rng = np.random.default_rng(15)
    table = rng.standard_normal((20, 4)).astype(np.float32)
    values = rng.integers(0, 20, 12).astype(np.int32)
    values[3] = 25
    seg = np.sort(rng.integers(0, 5, 12)).astype(np.int32)
    seg[-1] = 9
    want = np.asarray(jax_recsys.embedding_bag(
        jnp.asarray(table), jnp.asarray(values), jnp.asarray(seg), 6, mode))
    got = recsys.embedding_bag(*to_torch(table, values, seg), 6, mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert np.isnan(want[seg[3]]).all() and not np.isnan(want[5]).any()


def test_quantized_lookup_is_bit_exact_given_the_same_codes():
    """The reference's codes and codebooks decoded by the port: equal bit
    for bit, an id past a table included (code 255)."""
    jcfg, tcfg = _cfgs("dcn")
    params = _host(jax_init(jax.random.PRNGKey(16), cfg=jcfg))
    qt = _host(jax_recsys.quantize_tables(jax.random.PRNGKey(17),
                                          [jnp.asarray(t) for t in
                                           params["tables"]], k=16, iters=4))
    ids = _batch(jcfg, 10, seed=18)["sparse_ids"]
    ids[0, 0] = 1000
    want = np.asarray(jax_recsys.quantized_lookup(qt, jnp.asarray(ids)))
    tq = {k: [torch.from_numpy(np.array(a)) for a in v]
          for k, v in qt.items()}
    got = recsys.quantized_lookup(tq, torch.from_numpy(ids)).numpy()
    assert got.tobytes() == want.tobytes()
    assert recsys.qtables_nbytes(tq) == jax_recsys.qtables_nbytes(qt)


def test_quantize_tables_quality_matches_the_reference():
    """Each table's reconstruction error within 5% of the reference's (the
    random streams differ), 1-byte codes, and the bytes the reference
    counts; a table of fewer rows than k gets one centroid per row (error
    0 in both)."""
    rng = np.random.default_rng(19)
    tables = [rng.standard_normal((r, 8)).astype(np.float32)
              for r in (600, 300, 20)]
    jq = _host(jax_recsys.quantize_tables(
        jax.random.PRNGKey(20), [jnp.asarray(t) for t in tables], k=32))
    tt = [torch.from_numpy(t) for t in tables]
    tq = recsys.quantize_tables(torch.Generator().manual_seed(21), tt, k=32)
    for i, t in enumerate(tables):
        assert tq["codes"][i].dtype == torch.uint8
        assert tq["codes"][i].shape == (t.shape[0],)
        want = np.mean((jq["codebooks"][i][jq["codes"][i]] - t) ** 2)
        got = float(torch.mean((tq["codebooks"][i][tq["codes"][i].long()]
                                - tt[i]) ** 2))
        assert got <= 1.05 * want + 1e-9, (i, got, want)
        assert tq["codebooks"][i].shape == jq["codebooks"][i].shape
    assert recsys.qtables_nbytes(tq) == jax_recsys.qtables_nbytes(jq)
    assert recsys.tables_nbytes(tt) == jax_recsys.tables_nbytes(
        [jnp.asarray(t) for t in tables])


# ---------------------------------------------------------------------------
# the batch maker and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["DLRM_MLPERF", "DCN_V2", "DIN", "DIEN"])
def test_make_recsys_batch_shapes_and_dtypes(arch):
    """The port's batch has the reference's keys, shapes and dtypes, at
    the smoke config and at the full config's 26 tables; the reference's
    own maker runs out of keys past 6 tables (caveat C9)."""
    for spec_cfg in ("smoke_config", "config"):
        jcfg = getattr(getattr(jax_archs, arch), spec_cfg)
        tcfg = getattr(getattr(recsys_archs, arch), spec_cfg)
        got = synthetic.make_recsys_batch(
            torch.Generator().manual_seed(0), 64, tcfg.n_dense,
            tcfg.table_rows, seq_len=tcfg.seq_len, family=tcfg.family)
        if len(jcfg.table_rows) > 6:
            with pytest.raises(StopIteration):
                jax_synthetic.make_recsys_batch(
                    jax.random.PRNGKey(0), 64, jcfg.n_dense,
                    jcfg.table_rows, seq_len=jcfg.seq_len,
                    family=jcfg.family)
            assert got["sparse_ids"].shape == (64, 26)
            assert (got["sparse_ids"] < torch.tensor(
                tcfg.table_rows)).all()
            continue
        want = jax_synthetic.make_recsys_batch(
            jax.random.PRNGKey(0), 64, jcfg.n_dense, jcfg.table_rows,
            seq_len=jcfg.seq_len, family=jcfg.family)
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
        assert set(np.unique(got["label"].numpy())) <= {0.0, 1.0}


@pytest.mark.parametrize("arch", ["dlrm-mlperf", "dcn-v2", "din", "dien"])
def test_smoke_training_learns_the_planted_signal(arch, tmp_path):
    """40 steps of the CLI at lr 1e-2 on fresh batches of 256: the mean
    loss of the last 10 steps is below that of the first 10."""
    out = train_cli.main(["--arch", arch, "--smoke", "--steps", "40",
                          "--batch", "256", "--lr", "1e-2", "--device",
                          "cpu", "--ckpt-dir", str(tmp_path),
                          "--ckpt-every", "0"])
    losses = [h["loss"] for h in out["history"]]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), losses
