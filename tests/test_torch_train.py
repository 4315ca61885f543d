"""The port's training path against the JAX package: AdamW and its int8
moments, gradient compression, the chunked LM loss and its train step,
ColPali's contrastive step, the remat, and the RAG generator's batches.

At the repo's smoke widths (2 layers, d_model 48-64) the reference's init
draws the weights, with random biases and norm weights in place of its
zeros and ones, and ``convert`` carries them across; the same numpy
batches go through the reference's jitted functions and the port. Grads
and optimizer moments are compared leaf by leaf in the reference's
stacked layout (``convert.params_to_numpy``). Each tolerance is stated
where it is used.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import colpali_hpc as jax_colpali_hpc
from repro.configs import lm_archs as jax_lm_archs
from repro.core import rag as jax_rag
from repro.data import synthetic as jax_synthetic
from repro.models import colpali as jax_colpali
from repro.models import transformer as jax_transformer
from repro.optim import grad_compression as jax_gc
from repro.optim import optimizer as jax_opt
from repro_torch import convert
from repro_torch.ckpt.checkpoint import leaves_with_paths
from repro_torch.configs import colpali_hpc, lm_archs
from repro_torch.core import rag
from repro_torch.data import synthetic
from repro_torch.models import colpali, layers
from repro_torch.models import transformer as T
from repro_torch.optim import grad_compression as gc
from repro_torch.optim import optimizer as opt
from tests._torch_parity import to_torch
from tests.test_torch_models import _perturb

jax_loss_grad = jax.jit(jax.value_and_grad(jax_transformer.loss_fn,
                                           has_aux=True),
                        static_argnames=("cfg",))
jax_lm_step = jax.jit(jax_transformer.train_step,
                      static_argnames=("cfg", "opt_cfg"))
jax_cl_grad = jax.jit(jax.value_and_grad(jax_colpali.contrastive_loss,
                                         has_aux=True),
                      static_argnames=("cfg",))
jax_cl_step = jax.jit(jax_colpali.train_step,
                      static_argnames=("cfg", "opt_cfg"))
jax_lm_init = jax.jit(jax_transformer.init, static_argnames=("cfg",))
jax_enc_init = jax.jit(jax_colpali.init, static_argnames=("cfg",))


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    """{keystr: host array} of a tree (JAX or port, same structure)."""
    return {k: np.asarray(v) for k, v in leaves_with_paths(_host(tree))}


def _lm_cfgs(arch, act="float32"):
    jspec = {"qwen2-1.5b": jax_lm_archs.QWEN2_1_5B,
             "glm4-9b": jax_lm_archs.GLM4_9B}[arch]
    tspec = {"qwen2-1.5b": lm_archs.QWEN2_1_5B,
             "glm4-9b": lm_archs.GLM4_9B}[arch]
    return (dataclasses.replace(jspec.smoke_config, activation_dtype=act),
            dataclasses.replace(tspec.smoke_config, activation_dtype=act))


def _lm(arch, act="float32", seed=0):
    """(JAX cfg, host params, port model on the CPU)."""
    jcfg, tcfg = _lm_cfgs(arch, act)
    params = _perturb(_host(jax_lm_init(jax.random.PRNGKey(seed),
                                        cfg=jcfg)), seed + 1)
    return jcfg, params, convert.lm_params_from_numpy(params, tcfg,
                                                      device="cpu")


def _lm_batch(seed, vocab, b=3, s=24):
    """Tokens and targets, the first 5 targets of each row and a random
    tenth of the rest masked (-1)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s), dtype=np.int32)
    targets = rng.integers(0, vocab, (b, s), dtype=np.int32)
    targets[:, :5] = -1
    targets[rng.random((b, s)) < 0.1] = -1
    return tokens, targets


def _assert_tree_close(got, want, rtol, atol=0.0, what="leaf"):
    """Leaf by leaf: max |got - want| <= rtol * max |want| + atol."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key in want:
        g = got[key].astype(np.float64)
        w = want[key].astype(np.float64)
        err = float(np.abs(g - w).max()) if w.size else 0.0
        scale = float(np.abs(w).max()) if w.size else 0.0
        assert err <= rtol * scale + atol, (what, key, err, scale)


def _assert_adam_close(got, want, sum_lr):
    """Params after Adam steps. Adam divides each grad entry by its own
    running scale, so an entry whose grad is near zero (within rounding of
    the two packages' sums) can step with the other sign: up to 2 x lr per
    step for that entry. Held: 99.9% of entries within 1e-6, at most 0.1%
    beyond it, and none further than that bound, 2 x the summed learning
    rates (measured here: at most 0.02% beyond 1e-6, the furthest 1.2% of
    the bound for the LM and 6.5% for ColPali)."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    err = np.concatenate([np.abs(got[k].astype(np.float64)
                                 - want[k].astype(np.float64)).ravel()
                          for k in want])
    assert np.quantile(err, 0.999) <= 1e-6
    assert np.mean(err > 1e-6) <= 1e-3
    assert err.max() <= 2 * sum_lr, (err.max(), sum_lr)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
    dict(lr=2e-3, warmup_steps=20, total_steps=300),
    dict(lr=3e-4, warmup_steps=1, total_steps=6)])
def test_schedule_matches_jax_at_every_step(kw):
    """float32 both sides: the cosine's last bit may differ, and the
    products after it can carry that to a few float32 ulps (rtol 5e-7)."""
    jc, tc = jax_opt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    steps = range(kw["total_steps"] + 3)
    want = np.array([float(jax_opt.schedule(jc, jnp.int32(s)))
                     for s in steps])
    got = np.array([float(opt.schedule(tc, torch.tensor(s,
                                                        dtype=torch.int32)))
                    for s in steps])
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=0)
    assert got[0] == 0.0


def test_global_norm_matches_jax():
    rng = np.random.default_rng(0)
    tree = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in (("a", (8, 16)), ("b", (16,)), ("c", (3, 4, 5)))}
    want = float(jax_opt.global_norm({k: jnp.asarray(v)
                                      for k, v in tree.items()}))
    got = float(opt.global_norm(dict(zip(tree, to_torch(*tree.values())))))
    # the per-leaf sums are added in another order: a few float32 ulps
    assert got == pytest.approx(want, rel=1e-6)


_OPT_CASES = {
    "fp32": dict(lr=1e-2, warmup_steps=3, total_steps=12, clip_norm=100.0),
    "fp32-clipped": dict(lr=1e-2, warmup_steps=3, total_steps=12,
                         clip_norm=0.05),
    "int8": dict(lr=1e-2, warmup_steps=3, total_steps=12, clip_norm=100.0,
                 moment_dtype="int8"),
    "int8-clipped": dict(lr=1e-2, warmup_steps=3, total_steps=12,
                         clip_norm=0.05, moment_dtype="int8"),
}


@pytest.mark.parametrize("case", sorted(_OPT_CASES))
def test_update_matches_jax_over_steps(case):
    """8 AdamW steps on the same params and grads. float32 moments: params
    and moments within rtol 1e-6 of each leaf's largest value (the
    scalars' last bits and the norm's sum order). int8 moments: the codes
    round x / scale half to even, so a last-bit difference in x can move a
    code by one at a .5 boundary; the dequantized moments are held to one
    code step (atol = the row's scale) and the params to 1e-5."""
    kw = _OPT_CASES[case]
    jc, tc = jax_opt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    rng = np.random.default_rng(7)
    shapes = {"a": (8, 16), "b": (16,), "c": (4, 3, 5)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jax_opt.init(jc, jp)
    tp = dict(zip(p0, to_torch(*p0.values())))
    ts = opt.init(tc, tp)
    upd = jax.jit(lambda g, s, p: jax_opt.update(jc, g, s, p))
    clipped = []
    for _ in range(8):
        g = {k: (0.3 * rng.standard_normal(s)).astype(np.float32)
             for k, s in shapes.items()}
        jp, js, jm = upd({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts, tm = opt.update(tc, dict(zip(g, to_torch(*g.values()))),
                                ts, tp)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=5e-7)
        clipped.append(float(jm["grad_norm"]) > tc.clip_norm)
    assert all(clipped) == ("clipped" in case)
    assert int(ts.step) == int(js.step) == 8
    if tc.moment_dtype == "fp32":
        _assert_tree_close(tp, jp, rtol=1e-6)
        _assert_tree_close(ts.m, js.m, rtol=1e-6)
        _assert_tree_close(ts.v, js.v, rtol=1e-6)
        return
    _assert_tree_close(tp, jp, rtol=1e-5)
    for name in shapes:
        for tq, jq in ((ts.m[name], js.m[name]), (ts.v[name], js.v[name])):
            assert tq.q.dtype == torch.int8
            np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                                       rtol=1e-6)
            deq_t = opt._dequantize_moment(tq).numpy()
            deq_j = np.asarray(jax_opt._dequantize_moment(jq))
            step = np.asarray(jq.scale) * (1 + 1e-6)
            assert np.all(np.abs(deq_t - deq_j) <= step), name
            assert np.mean(tq.q.numpy() == np.asarray(jq.q)) >= 0.95


def test_int8_moment_codec_matches_jax_exactly():
    """The same float32 moment quantizes to the same codes and scales (no
    arithmetic beyond one division and a round half to even)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((6, 33)) * 10.0 ** rng.integers(
        -6, 2, (6, 1))).astype(np.float32)
    x[2] = 0.0
    x[3, ::3] = 0.5 * np.float32(x[3].max()) / 127 * 2 * np.arange(11)
    want = jax_opt._quantize_moment(jnp.asarray(x))
    got = opt._quantize_moment(torch.from_numpy(x))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(
        opt._dequantize_moment(got).numpy(),
        np.asarray(jax_opt._dequantize_moment(want)))


def test_int8_state_layout_matches_jax():
    params = {"w": torch.ones((8, 16)), "b": torch.ones((16,))}
    st = opt.init(opt.AdamWConfig(moment_dtype="int8"), params)
    jst = jax_opt.init(jax_opt.AdamWConfig(moment_dtype="int8"),
                       {"w": jnp.ones((8, 16)), "b": jnp.ones((16,))})
    for name in params:
        assert st.m[name].q.dtype == torch.int8
        assert tuple(st.m[name].scale.shape) == jst.m[name].scale.shape
        np.testing.assert_array_equal(st.v[name].scale.numpy(),
                                      np.asarray(jst.v[name].scale))
    assert st.step.dtype == torch.int32 and st.step.shape == ()


def test_adamw_converges_on_the_reference_problem():
    """The reference's own convergence check (tests/test_optim.py), on the
    port: Rosenbrock-like, 300 steps, fp32 and int8 moments."""
    def run(md):
        cfg = opt.AdamWConfig(lr=3e-2, weight_decay=0.0, warmup_steps=10,
                              total_steps=300, moment_dtype=md)
        p = {"x": torch.full((4,), -1.0), "y": torch.full((4,), 2.0)}
        s = opt.init(cfg, p)

        def loss(p):
            return (torch.sum((1 - p["x"]) ** 2)
                    + 5 * torch.sum((p["y"] - p["x"] ** 2) ** 2))

        for _ in range(300):
            q = {k: v.detach().requires_grad_() for k, v in p.items()}
            g = dict(zip(q, torch.autograd.grad(loss(q), list(q.values()))))
            p, s, _ = opt.update(cfg, g, s, p)
        return float(loss(p))

    l32, l8 = run("fp32"), run("int8")
    assert l32 < 0.05
    assert l8 < max(10 * l32, 0.5), (l8, l32)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_topk_compress_matches_jax_exactly():
    """Top-k with error feedback over 5 rounds of the same grads: kept
    entries, residuals and the stats equal bit for bit (no ties in |g|)."""
    rng = np.random.default_rng(4)
    shapes = {"w": (10, 10), "b": (37,)}
    jstate = jax_gc.topk_init({k: jnp.zeros(s) for k, s in shapes.items()})
    tstate = gc.topk_init({k: torch.zeros(s) for k, s in shapes.items()})
    for _ in range(5):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        jk, jstate, jstats = jax_gc.topk_compress(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, frac=0.1)
        tk, tstate, tstats = gc.topk_compress(
            dict(zip(g, to_torch(*g.values()))), tstate, frac=0.1)
        assert tstats == jstats
        for k in shapes:
            np.testing.assert_array_equal(tk[k].numpy(), np.asarray(jk[k]))
            np.testing.assert_array_equal(tstate.residual[k].numpy(),
                                          np.asarray(jstate.residual[k]))
    assert int((tk["w"] != 0).sum()) == 10


def test_int8_grad_codec_matches_jax_given_the_codes():
    """The uniform draws differ (a torch generator against jax.random), so
    the codes are held by structure: the same scale, every code the floor
    of g / scale or one above it; and the reference's codes dequantize to
    the same values in the port."""
    rng = np.random.default_rng(5)
    g = (0.3 * rng.standard_normal((50, 40))).astype(np.float32)
    want = jax_gc.quantize_grad(jax.random.PRNGKey(0), jnp.asarray(g))
    got = gc.quantize_grad(torch.Generator().manual_seed(0),
                           torch.from_numpy(g))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    lo = np.floor(g / np.asarray(want.scale))
    q = got.q.numpy().astype(np.float64)
    assert np.all((q == np.clip(lo, -127, 127))
                  | (q == np.clip(lo + 1, -127, 127)))
    back = gc.dequantize_grad(gc.QGrad(torch.from_numpy(np.asarray(want.q)),
                                       torch.from_numpy(np.asarray(
                                           want.scale))))
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jax_gc.dequantize_grad(want)))
    grads = {"a": torch.zeros((3, 4)), "b": torch.zeros(7)}
    assert gc.compressed_bytes_int8(grads) == jax_gc.compressed_bytes_int8(
        {"a": jnp.zeros((3, 4)), "b": jnp.zeros(7)})
    tree = gc.decompress_tree_int8(gc.compress_tree_int8(
        torch.Generator().manual_seed(1), {"a": torch.from_numpy(g)}))
    assert tree["a"].shape == (50, 40)


def test_int8_stochastic_rounding_is_unbiased():
    """The reference's own check on the port: the mean of 64 codecs lies
    within Monte-Carlo noise (0.3 code steps) of g."""
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(2000, generator=gen) * 0.3
    deqs = torch.stack([gc.dequantize_grad(gc.quantize_grad(gen, g))
                        for _ in range(64)])
    bias = (deqs.mean(0) - g).abs()
    scale = float(g.abs().max()) / 127
    assert float(bias.mean()) < scale * 0.3


# ---------------------------------------------------------------------------
# the LM loss and its train step
# ---------------------------------------------------------------------------

def _port_loss_grads(model, tokens, targets, remat=True):
    return T.value_and_grad(
        lambda p: T.loss_fn(model, p, *to_torch(tokens, targets),
                            remat=remat), T.params_of(model))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "glm4-9b"])
@pytest.mark.parametrize("s", [24, 32])
def test_loss_fn_and_grads_match_jax(arch, s):
    """float32 activations: the loss within rtol 1e-6, each grad leaf within
    1e-5 of its largest entry. qwen2 ties its embeddings (the embed grad
    comes from the gather and the logits), glm4 does not. loss_chunk 16:
    s = 24 runs 3 chunks of 8, s = 32 two of 16; masked targets."""
    jcfg, params, model = _lm(arch)
    tokens, targets = _lm_batch(s, jcfg.vocab, s=s)
    (wl, wparts), wg = jax_loss_grad(params, tokens, targets, cfg=jcfg)
    loss, parts, grads = _port_loss_grads(model, tokens, targets)
    assert float(loss) == pytest.approx(float(wl), rel=1e-6)
    assert float(parts["ce"]) == pytest.approx(float(wparts["ce"]), rel=1e-6)
    assert float(parts["aux"]) == float(wparts["aux"]) == 0.0
    _assert_tree_close(convert.params_to_numpy(grads), wg, rtol=1e-5,
                       atol=1e-9)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "glm4-9b"])
def test_loss_fn_and_grads_bf16_activations(arch):
    """bf16 activations: each product is rounded to 8 bits, and a sum in
    another order can round to the neighbouring bf16 value (2^-8
    relative); those flips carry through 2 layers and back. Measured here:
    the loss within 2e-4 relative, grad leaves within 1.6% of their
    largest entry. Held: loss 1e-3, each leaf 5%, and the relative L2
    error of all grads together 2%."""
    jcfg, params, model = _lm(arch, "bfloat16")
    tokens, targets = _lm_batch(11, jcfg.vocab)
    (wl, _), wg = jax_loss_grad(params, tokens, targets, cfg=jcfg)
    loss, _, grads = _port_loss_grads(model, tokens, targets)
    assert float(loss) == pytest.approx(float(wl), rel=1e-3)
    got = _flat(convert.params_to_numpy(grads))
    want = _flat(wg)
    _assert_tree_close(convert.params_to_numpy(grads), wg, rtol=0.05)
    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    den = sum(float(np.sum(want[k].astype(np.float64) ** 2)) for k in want)
    assert np.sqrt(num / den) <= 0.02


def test_loss_fn_with_every_target_masked_is_zero():
    """n_valid is at least one: an all-masked batch gives loss 0 and zero
    grads, as in the reference."""
    jcfg, params, model = _lm("qwen2-1.5b")
    tokens, _ = _lm_batch(2, jcfg.vocab)
    targets = np.full_like(tokens, -1)
    (wl, _), _ = jax_loss_grad(params, tokens, targets, cfg=jcfg)
    loss, _, grads = _port_loss_grads(model, tokens, targets)
    assert float(loss) == float(wl) == 0.0
    assert all(float(g.abs().max()) == 0.0 for g in grads.values())


@pytest.mark.parametrize("arch,act", [("qwen2-1.5b", "float32"),
                                      ("glm4-9b", "float32"),
                                      ("qwen2-1.5b", "bfloat16")])
def test_remat_changes_no_bit(arch, act):
    """The checkpoints (per block, per attention query block, per loss
    chunk) recompute the same values: loss and grads equal bit for bit
    with and without them on the CPU."""
    jcfg, _, model = _lm(arch, act)
    tokens, targets = _lm_batch(9, jcfg.vocab, s=32)
    l1, _, g1 = _port_loss_grads(model, tokens, targets, remat=True)
    l2, _, g2 = _port_loss_grads(model, tokens, targets, remat=False)
    assert torch.equal(l1, l2)
    assert all(torch.equal(g1[k], g2[k]) for k in g1)


_STEP_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "glm4-9b"])
def test_train_step_matches_jax_after_1_and_8_steps(arch):
    """8 train steps on fresh batches: the loss and grad norm of every step
    within rtol 1e-5; params after 1 and 8 steps as ``_assert_adam_close``
    says; the step counts equal."""
    jcfg, params, model = _lm(arch)
    jo = jax_opt.AdamWConfig(**_STEP_OPT)
    to = opt.AdamWConfig(**_STEP_OPT)
    jp, js = params, jax_opt.init(jo, params)
    tp = T.params_of(model)
    ts = opt.init(to, tp)
    sum_lr = 0.0
    for i in range(8):
        tokens, targets = _lm_batch(100 + i, jcfg.vocab, s=16)
        jp, js, jm = jax_lm_step(jp, js, {"tokens": tokens,
                                          "targets": targets},
                                 cfg=jcfg, opt_cfg=jo)
        tp, ts, tm = T.train_step(model, tp, ts, dict(zip(
            ("tokens", "targets"), to_torch(tokens, targets))), to)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5)
        sum_lr += float(jm["lr"])
        if i in (0, 7):
            _assert_adam_close(convert.params_to_numpy(tp), jp, sum_lr)
    assert int(ts.step) == int(js.step) == 8


def test_train_step_leaves_its_inputs_alone():
    jcfg, _, model = _lm("qwen2-1.5b")
    p = T.params_of(model)
    before = {k: v.clone() for k, v in p.items()}
    s = opt.init(opt.AdamWConfig(), p)
    tokens, targets = _lm_batch(3, jcfg.vocab)
    p2, s2, m = T.train_step(model, p, s, dict(zip(
        ("tokens", "targets"), to_torch(tokens, targets))),
        opt.AdamWConfig())
    assert all(torch.equal(before[k], p[k]) for k in p)
    assert int(s.step) == 0 and int(s2.step) == 1
    assert not any(v.requires_grad for v in p2.values())
    assert set(m) == {"loss", "ce", "aux", "lr", "grad_norm"}


@pytest.mark.parametrize("which", ["lm", "colpali"])
def test_train_step_accumulates_bf16_in_float32_through_the_backward(
        which, monkeypatch):
    """The bf16 reduced-precision flag is cleared for every norm and
    product of the forward, the backward and the checkpoint recomputes
    inside it, and restored after."""
    flag = torch.backends.cuda.matmul
    seen = []
    grad_mode = []

    def recording(fn):
        def wrapped(*args, **kwargs):
            seen.append(flag.allow_bf16_reduced_precision_reduction)
            grad_mode.append(torch.is_grad_enabled())
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(layers, "rms_norm", recording(layers.rms_norm))
    monkeypatch.setattr(flag, "allow_bf16_reduced_precision_reduction", True)
    gen = torch.Generator().manual_seed(0)
    cfg = opt.AdamWConfig()
    if which == "lm":
        model = T.init(lm_archs.QWEN2_1_5B.smoke_config, generator=gen,
                       device="cpu")
        tok = torch.randint(0, model.cfg.vocab, (2, 16), generator=gen)
        p = T.params_of(model)
        T.train_step(model, p, opt.init(cfg, p),
                     {"tokens": tok, "targets": tok}, cfg)
    else:
        enc_cfg = colpali_hpc.COLPALI_HPC.smoke_config.encoder
        enc = colpali.init(enc_cfg, generator=gen, device="cpu")
        p = T.params_of(enc)
        colpali.train_step(enc, p, opt.init(cfg, p),
                           _colpali_batch_torch(2, enc_cfg, 0), cfg)
    # the recomputes in the backward call rms_norm again
    assert seen and not any(seen), seen
    assert len(seen) > 3 * 2
    assert flag.allow_bf16_reduced_precision_reduction is True


# ---------------------------------------------------------------------------
# ColPali's contrastive step
# ---------------------------------------------------------------------------

def _colpali_batch(seed, cfg, b):
    rng = np.random.default_rng(seed)
    return {
        "query_tokens": rng.integers(0, cfg.backbone.vocab,
                                     (b, cfg.query_len), dtype=np.int32),
        "query_mask": rng.random((b, cfg.query_len)) < 0.8,
        "doc_patches": rng.standard_normal(
            (b, cfg.n_patches, cfg.d_patch)).astype(np.float32),
        "doc_mask": rng.random((b, cfg.n_patches)) < 0.9,
    }


def _colpali_batch_torch(b, cfg, seed):
    batch = _colpali_batch(seed, cfg, b)
    return dict(zip(batch, to_torch(*batch.values())))


@pytest.fixture(scope="module")
def encoder():
    """(JAX cfg, perturbed host params, port encoder on the CPU)."""
    jcfg = jax_colpali_hpc.COLPALI_HPC.smoke_config.encoder
    tcfg = colpali_hpc.COLPALI_HPC.smoke_config.encoder
    params = _perturb(_host(jax_enc_init(jax.random.PRNGKey(3), cfg=jcfg)),
                      4)
    return jcfg, params, convert.colpali_params_from_numpy(params, tcfg,
                                                           device="cpu")


@pytest.mark.parametrize("b", [2, 5])
def test_contrastive_loss_acc_and_grads_match_jax(encoder, b):
    """float32 activations: the loss within rtol 1e-6, acc equal, each grad
    leaf within 1e-5 of its largest entry (padded queries and patches)."""
    jcfg, params, enc = encoder
    batch = _colpali_batch(b, jcfg, b)
    (wl, wparts), wg = jax_cl_grad(params, batch, cfg=jcfg)
    loss, parts, grads = T.value_and_grad(
        lambda p: colpali.contrastive_loss(
            enc, p, dict(zip(batch, to_torch(*batch.values())))),
        T.params_of(enc))
    assert float(loss) == pytest.approx(float(wl), rel=1e-6)
    assert float(parts["acc"]) == float(wparts["acc"])
    _assert_tree_close(convert.params_to_numpy(grads), wg, rtol=1e-5,
                       atol=1e-9)


def test_contrastive_remat_changes_no_bit(encoder):
    _, _, enc = encoder
    batch = _colpali_batch_torch(3, enc.cfg, 8)
    out = [T.value_and_grad(lambda p: colpali.contrastive_loss(
        enc, p, batch, remat=r), T.params_of(enc)) for r in (True, False)]
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(out[0][2][k], out[1][2][k]) for k in out[0][2])


def test_colpali_train_step_matches_jax(encoder):
    """3 contrastive steps: loss within rtol 1e-5, acc equal, params after
    each as ``_assert_adam_close`` says."""
    jcfg, params, enc = encoder
    jo = jax_opt.AdamWConfig(**_STEP_OPT)
    to = opt.AdamWConfig(**_STEP_OPT)
    jp, js = params, jax_opt.init(jo, params)
    tp = T.params_of(enc)
    ts = opt.init(to, tp)
    sum_lr = 0.0
    for i in range(3):
        batch = _colpali_batch(20 + i, jcfg, 4)
        jp, js, jm = jax_cl_step(jp, js, batch, cfg=jcfg, opt_cfg=jo)
        tp, ts, tm = colpali.train_step(
            enc, tp, ts, dict(zip(batch, to_torch(*batch.values()))), to)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        assert float(tm["acc"]) == float(jm["acc"])
        sum_lr += float(jm["lr"])
        _assert_adam_close(convert.params_to_numpy(tp), jp, sum_lr)


# ---------------------------------------------------------------------------
# the RAG generator and the batches
# ---------------------------------------------------------------------------

# benchmarks/rag_bench.py's generator (at a narrower corpus)
_GEN = dict(n_layers=3, d_model=96, n_heads=4, n_kv_heads=2, d_ff=192,
            q_chunk=8, loss_chunk=24, tie_embeddings=True)
_SEQ = 24


def test_rag_generator_training_follows_jax():
    """20 steps of rag_bench's generator (lr 2e-3, 20 warm-up steps, weight
    decay 0.01) on the reference's ``make_rag_train_batch`` batches, from
    the reference's init carried across: the loss at every step within
    rtol 1e-4 (float32; sum order compounds over 20 Adam steps)."""
    corpus, vocab = jax_synthetic.make_fact_corpus(
        jax.random.PRNGKey(1), n_docs=24, n_facts_vocab=60, facts_per_doc=3,
        dim=8, n_patches=6, n_queries=8, seq_len=16)
    rcfg = jax_rag.RAGConfig(top_k_docs=2, facts_per_doc=3,
                             fact0=vocab["fact0"], max_answer=3)
    jcfg = jax_transformer.LMConfig(vocab=vocab["size"], **_GEN)
    tcfg = T.LMConfig(vocab=vocab["size"], **_GEN)
    params = _host(jax_lm_init(jax.random.PRNGKey(2), cfg=jcfg))
    model = convert.lm_params_from_numpy(params, tcfg, device="cpu")
    kw = dict(lr=2e-3, total_steps=300, warmup_steps=20, weight_decay=0.01)
    jo, to = jax_opt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    jp, js = params, jax_opt.init(jo, params)
    tp = T.params_of(model)
    ts = opt.init(to, tp)
    make = jax.jit(lambda k: jax_rag.make_rag_train_batch(
        k, corpus, vocab, rcfg, batch=8, seq_len=_SEQ, n_docs=24))
    want, got = [], []
    for i in range(20):
        batch = _host(make(jax.random.fold_in(jax.random.PRNGKey(3), i)))
        jp, js, jm = jax_lm_step(jp, js, batch, cfg=jcfg, opt_cfg=jo)
        tp, ts, tm = T.train_step(model, tp, ts, dict(zip(
            batch, to_torch(*batch.values()))), to)
        want.append(float(jm["loss"]))
        got.append(float(tm["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


@pytest.fixture(scope="module")
def fact_corpus():
    return synthetic.make_fact_corpus(seed=0, n_docs=32, n_facts_vocab=20,
                                      facts_per_doc=3, dim=8, n_patches=6,
                                      n_queries=8, seq_len=16, device="cpu")


def test_make_rag_train_batch_keeps_the_reference_assertions(fact_corpus):
    """tests/test_serving_rag.py's assertions, on the port: shapes, only
    the answer positions supervised, every supervised target a fact."""
    corpus, vocab = fact_corpus
    rcfg = rag.RAGConfig(top_k_docs=2, facts_per_doc=3, max_answer=3)
    batch = rag.make_rag_train_batch(torch.Generator().manual_seed(0),
                                     corpus, vocab, rcfg, batch=4,
                                     seq_len=24, n_docs=32)
    assert batch["tokens"].shape == (4, 24)
    assert batch["targets"].shape == (4, 24)
    assert batch["tokens"].dtype == batch["targets"].dtype == torch.int32
    assert int((batch["targets"] >= 0).sum()) == 4 * 3
    sup = batch["targets"][batch["targets"] >= 0]
    assert bool((sup >= vocab["fact0"]).all())


def test_make_rag_train_batch_layout_matches_jax(fact_corpus):
    """The structure the reference builds: the gold doc's facts in the
    context, the probe one of them, the answer all of them, at the same
    positions as the reference's batch."""
    corpus, vocab = fact_corpus
    rcfg = rag.RAGConfig(top_k_docs=3, facts_per_doc=3, max_answer=3)
    b, seq = 64, 20
    batch = rag.make_rag_train_batch(torch.Generator().manual_seed(1),
                                     corpus, vocab, rcfg, batch=b,
                                     seq_len=seq, n_docs=32)
    jcorpus, jvocab = jax_synthetic.make_fact_corpus(
        jax.random.PRNGKey(0), n_docs=32, n_facts_vocab=20, facts_per_doc=3,
        dim=8, n_patches=6, n_queries=8, seq_len=16)
    jbatch = _host(jax_rag.make_rag_train_batch(
        jax.random.PRNGKey(1), jcorpus, jvocab, rcfg, batch=b, seq_len=seq,
        n_docs=32))
    tok, tgt = batch["tokens"].numpy(), batch["targets"].numpy()
    np.testing.assert_array_equal(tgt >= 0, jbatch["targets"] >= 0)
    np.testing.assert_array_equal(tok == 0, jbatch["tokens"] == 0)
    keep, prompt_len = 4, 3 * 4 + 4
    facts = corpus.doc_facts.numpy() + vocab["fact0"]
    for r in range(b):
        answer = tgt[r][tgt[r] >= 0]
        ctx = tok[r, :3 * keep].reshape(3, keep)
        gold = [i for i in range(3) if list(ctx[i, :3]) == list(answer)]
        assert gold, r                                # the gold doc is there
        assert (ctx[:, 3] == vocab["sep"]).all()
        assert any((facts == ctx[i, :3]).all(-1).any() for i in range(3))
        assert tok[r, 12] == vocab["query"] and tok[r, 14] == vocab["sep"]
        assert tok[r, 13] in answer
        np.testing.assert_array_equal(tok[r, prompt_len:prompt_len + 2],
                                      answer[:2])
    # the gold doc's slot is spread over the context
    slots = [next(i for i in range(3)
                  if list(tok[r, i * keep:i * keep + 3])
                  == list(tgt[r][tgt[r] >= 0])) for r in range(b)]
    assert set(slots) == {0, 1, 2}


def test_make_lm_batch_shape_range_and_determinism():
    """The reference's layout (int32 tokens and targets shifted by one, in
    [0, vocab), every row from state pair (0, 1)), and the same batch from
    the same seed; the chain is learnable: each state pair has at most 4
    successors."""
    def make(seed, vocab=50):
        return synthetic.make_lm_batch(torch.Generator().manual_seed(seed),
                                       vocab, 6, 40)
    a, b, c = make(0), make(0), make(1)
    assert a["tokens"].shape == a["targets"].shape == (6, 40)
    assert a["tokens"].dtype == torch.int32
    assert torch.equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 50
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    ref = _host(jax_synthetic.make_lm_batch(jax.random.PRNGKey(0), 50, 6,
                                            40))
    assert ref["tokens"].shape == tuple(a["tokens"].shape)
    assert ref["tokens"].dtype == np.int32
    big = synthetic.make_lm_batch(torch.Generator().manual_seed(2), 1000,
                                  32, 64)
    full = torch.cat([big["tokens"], big["targets"][:, -1:]], 1).numpy()
    succ = {}
    for row in full:
        for s1, s2, s3 in zip(row, row[1:], row[2:]):
            succ.setdefault((s1, s2), set()).add(s3)
    assert max(len(v) for v in succ.values()) <= 4
    assert int(full.max()) < 64
