"""The port's PNA and its neighbour sampler against the JAX package: the
node and graph tasks (isolated nodes, unlabelled nodes, duplicate edges),
loss, grads and train steps at the smoke config, the sampler's arrays bit
for bit, the graph makers and the CLI.

The reference's init draws the weights, with random biases in place of
its zeros, and ``convert.pna_params_from_numpy`` carries them across;
the same numpy graphs go through the reference's jitted functions and the
port on the CPU. Each tolerance is stated where it is used.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import gnn_archs as jax_archs
from repro.data import sampler as jax_sampler
from repro.data import synthetic as jax_synthetic
from repro.models import gnn as jax_gnn
from repro.optim import optimizer as jax_opt
from repro_torch import convert
from repro_torch.configs import gnn_archs
from repro_torch.data import sampler, synthetic
from repro_torch.launch import train as train_cli
from repro_torch.models import gnn
from repro_torch.models import transformer as T
from repro_torch.optim import optimizer as opt
from tests._torch_parity import to_torch
from tests.test_torch_recsys import _assert_trees_close, _perturb
from tests.test_torch_train import _STEP_OPT, _assert_adam_close, _host

jax_init = jax.jit(jax_gnn.init, static_argnames=("cfg",))
jax_loss_grad = jax.jit(jax.value_and_grad(jax_gnn.loss_fn, has_aux=True),
                        static_argnames=("cfg",))
jax_step = jax.jit(jax_gnn.train_step, static_argnames=("cfg", "opt_cfg"))
jax_serve = jax.jit(jax_gnn.serve_step, static_argnames=("cfg",))

# float32 logits and loss: rtol, with atol 1e-5 (two layers of sums over
# each node's messages, in another order than XLA's)
LOGIT_TOL = 1e-5
# grads (each leaf as tests/test_torch_recsys.py states) and the loss of a
# graph with labelled nodes that have no in-edge: such a node's
# attenuation scaler is delta / 1e-5 = 2e5, so its update is large and the
# loss and grads carry the sums' rounding magnified (measured here: 1.2e-5
# of a leaf's max, 1.3e-5 of the loss)
GRAD_TOL = 5e-5
LOSS_TOL = 5e-5


def _cfgs(task):
    jcfg, tcfg = jax_archs.PNA.smoke_config, gnn_archs.PNA.smoke_config
    if task == "graph":
        kw = dict(d_feat=6, n_classes=2, task="graph")
        jcfg = dataclasses.replace(jcfg, **kw)
        tcfg = dataclasses.replace(tcfg, **kw)
    return jcfg, tcfg


def _model(task, seed=0):
    jcfg, tcfg = _cfgs(task)
    params = _perturb(_host(jax_init(jax.random.PRNGKey(seed), cfg=jcfg)),
                      seed + 1)
    return jcfg, tcfg, params, convert.pna_params_from_numpy(
        params, tcfg, device="cpu")


def _graph(task, seed, padded=False):
    """A numpy batch. node: a community graph of 96 nodes (some with no
    in-edges: empty segments) with 8 more isolated ones, every 5th node
    unlabelled (-1) and the first 16 edges repeated (ties in max and
    min); ``padded``: a ring through the 96 nodes gives each an in-edge,
    and the 8 isolated ones are padding (label -1). graph: 12 molecules
    of 9 nodes."""
    key = jax.random.PRNGKey(seed)
    if task == "graph":
        b = _host(jax_synthetic.make_molecule_batch(key, 12, 9, 16, 6))
        return b
    g = _host(jax_synthetic.make_graph(key, 96, 384, 12, 3))
    rng = np.random.default_rng(seed)
    feats = np.concatenate([g["feats"], rng.standard_normal(
        (8, 12)).astype(np.float32)])
    labels = np.concatenate([g["labels"],
                             np.full(8, -1 if padded else 1, np.int32)])
    labels[::5] = -1
    ei = np.concatenate([g["edge_index"], g["edge_index"][:, :16]], 1)
    if padded:
        ring = np.arange(96, dtype=np.int32)
        ei = np.concatenate([ei, np.stack([ring, (ring + 1) % 96])], 1)
    return {"feats": feats, "edge_index": ei, "labels": labels}


def _tb(batch):
    return dict(zip(batch, to_torch(*batch.values())))


@pytest.mark.parametrize("task", ["node", "graph"])
def test_forward_loss_and_grads_match_the_reference(task):
    jcfg, tcfg, params, model = _model(task)
    batch = _graph(task, seed=2)
    want = np.asarray(jax_serve(params, batch, cfg=jcfg))
    got = gnn.serve_step(T.params_of(model), _tb(batch), tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)

    (jloss, jparts), jgrads = jax_loss_grad(params, batch, cfg=jcfg)
    loss, parts, grads = T.value_and_grad(
        lambda p: gnn.loss_fn(p, _tb(batch), tcfg), T.params_of(model))
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_TOL)
    assert float(parts["acc"]) == pytest.approx(float(jparts["acc"]))
    _assert_trees_close(convert.params_to_numpy(grads), _host(jgrads),
                        GRAD_TOL)


@pytest.mark.parametrize("task", ["node", "graph"])
def test_train_steps_match_the_reference(task):
    """8 AdamW steps: loss and grad norm within 1e-5 each step,
    params after 1 and 8 steps as ``_assert_adam_close`` says. Every
    labelled node has an in-edge here (``padded``): a node without one is
    scaled by 2e5, its loss runs to the tens or hundreds, and the
    rounding it magnifies moves more than the 0.1% of entries
    ``_assert_adam_close`` allows by up to 2 x lr (the forward test above
    holds that case to GRAD_TOL)."""
    jcfg, tcfg, params, model = _model(task, seed=3)
    jo, to = jax_opt.AdamWConfig(**_STEP_OPT), opt.AdamWConfig(**_STEP_OPT)
    jp, js = params, jax_opt.init(jo, params)
    tp = T.params_of(model)
    ts = opt.init(to, tp)
    sum_lr = 0.0
    for i in range(8):
        batch = _graph(task, seed=10 + i, padded=True)
        jp, js, jm = jax_step(jp, js, batch, cfg=jcfg, opt_cfg=jo)
        tp, ts, tm = gnn.train_step(tp, ts, _tb(batch), tcfg, to)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5)
        sum_lr += float(jm["lr"])
        if i in (0, 7):
            _assert_adam_close(convert.params_to_numpy(tp), jp, sum_lr)


def test_isolated_nodes_aggregate_to_zero():
    """An empty segment's mean, max and min are 0 and its std sqrt(1e-5),
    as the reference's where(isfinite) makes them."""
    msgs = torch.randn(5, 3, generator=torch.Generator().manual_seed(7))
    dst = torch.tensor([0, 0, 2, 2, 2])
    deg = torch.tensor([2.0, 0.0, 3.0, 0.0])
    agg = gnn._pna_aggregate(msgs, dst, 4, deg, 2.5)
    want = np.asarray(jax_gnn._pna_aggregate(
        msgs.numpy(), dst.numpy(), 4, deg.numpy(), 2.5))
    np.testing.assert_allclose(agg.numpy(), want, rtol=1e-6, atol=1e-6)
    d = 3
    for node in (1, 3):
        np.testing.assert_array_equal(agg[node, :3 * d].numpy(), 0.0)
        np.testing.assert_allclose(agg[node, 3 * d:4 * d].numpy(),
                                   np.sqrt(1e-5), rtol=1e-6)


def test_pna_params_reject_an_unexpected_array():
    jcfg, tcfg = _cfgs("node")
    params = _host(jax_init(jax.random.PRNGKey(4), cfg=jcfg))
    params["layers"].append(params["layers"][0])
    with pytest.raises(KeyError, match="unexpected"):
        convert.pna_params_from_numpy(params, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# the sampler and the makers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fanouts", [(5, 3), (15, 10)])
def test_sample_subgraph_equals_the_references_arrays(fanouts):
    """The same graph and the same np.random.Generator: build_csr and
    three consecutive sample_subgraph batches equal bit for bit (a node
    with no out-edges included, which samples itself)."""
    g = _host(jax_synthetic.make_graph(jax.random.PRNGKey(5), 500, 4000, 8,
                                       4))
    ei = g["edge_index"][:, g["edge_index"][0] != 7]   # node 7: degree 0
    want_csr = jax_sampler.build_csr(500, ei, g["feats"], g["labels"])
    got_csr = sampler.build_csr(500, ei, g["feats"], g["labels"])
    for f in ("indptr", "indices", "feats", "labels"):
        a, b = getattr(got_csr, f), getattr(want_csr, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    r_got, r_want = np.random.default_rng(6), np.random.default_rng(6)
    for _ in range(3):
        seeds = np.append(r_want.choice(500, 31, replace=False), 7)
        assert np.array_equal(seeds[:-1], r_got.choice(500, 31,
                                                       replace=False))
        want = jax_sampler.sample_subgraph(r_want, want_csr, seeds, fanouts)
        got = sampler.sample_subgraph(r_got, got_csr, seeds, fanouts)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("maker", ["graph", "molecule"])
def test_graph_makers_shapes_and_dtypes(maker):
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    if maker == "graph":
        got = synthetic.make_graph(gen, 200, 800, 10, 4)
        want = jax_synthetic.make_graph(key, 200, 800, 10, 4)
        # 80% intra-community edges: labels mostly agree along them
        ei, lab = got["edge_index"].long(), got["labels"]
        assert float((lab[ei[0]] == lab[ei[1]]).float().mean()) > 0.6
    else:
        got = synthetic.make_molecule_batch(gen, 8, 10, 18, 5)
        want = jax_synthetic.make_molecule_batch(key, 8, 10, 18, 5)
        pooled = torch.zeros(8).index_add_(0, got["graph_ids"].long(),
                                           got["feats"][:, 0])
        assert torch.equal(got["graph_labels"], (pooled > 0).int())
        e = got["edge_index"].long()
        g_ids = got["graph_ids"].long()
        assert torch.equal(g_ids[e[0]], g_ids[e[1]])   # edges stay inside
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
    n = got["feats"].shape[0]
    assert int(got["edge_index"].min()) >= 0
    assert int(got["edge_index"].max()) < n


def test_pna_smoke_learns_the_communities():
    """40 steps on one community graph (the reference's own test): the
    accuracy passes 0.7."""
    cfg = gnn_archs.PNA.smoke_config
    g = synthetic.make_graph(torch.Generator().manual_seed(1), 256, 1024,
                             cfg.d_feat, cfg.n_classes)
    model = gnn.init(cfg, generator=torch.Generator().manual_seed(2),
                     device="cpu")
    ocfg = opt.AdamWConfig(lr=5e-3, total_steps=60, warmup_steps=5)
    p = T.params_of(model)
    s = opt.init(ocfg, p)
    for _ in range(41):
        p, s, m = gnn.train_step(p, s, g, cfg, ocfg)
    assert float(m["acc"]) > 0.7


def test_train_cli_pna_smoke(tmp_path):
    out = train_cli.main(["--arch", "pna", "--smoke", "--steps", "4",
                          "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert out["step"] == 4
    assert all(np.isfinite(h["loss"]) for h in out["history"])
