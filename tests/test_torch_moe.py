"""The port's MoE LM family against the JAX package: the routed experts
with capacity dropping, the shared expert, the load-balance loss,
chunked-local (iRoPE) attention, and llama4-scout and kimi-k2 at their
smoke widths through forward, prefill, decode, the loss, its train step,
checkpoints and the training CLI.

The same numpy inputs (from a seed) go through the reference's jitted
functions and the port, in float32, held to atol = rtol = 1e-5 unless a
test says otherwise. Model weights come from the reference's own init with
random norm weights (``_perturb``) and reach the port through
``convert``. Full-width configs are never built here: llama4-scout has
109 B parameters.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jax_ck
from repro.configs import lm_archs as jax_lm_archs
from repro.models import layers as jax_layers
from repro.models import transformer as jax_transformer
from repro.optim import optimizer as jax_opt
from repro_torch import convert
from repro_torch.ckpt import checkpoint as ck
from repro_torch.configs import lm_archs
from repro_torch.launch import train as train_cli
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.optim import optimizer as opt
from tests._torch_parity import to_torch
from tests.test_torch_models import _close, _perturb, _tokens
from tests.test_torch_train import (_assert_adam_close, _assert_tree_close,
                                    _flat, _host)

ARCHS = ("llama4-scout-17b-a16e", "kimi-k2-1t-a32b")

jax_moe = jax.jit(jax_layers.moe_apply, static_argnames=(
    "top_k", "capacity_factor", "expert_chunks"))
jax_attention = jax.jit(jax_layers.attention, static_argnames=(
    "n_heads", "n_kv", "head_dim", "theta", "chunk", "q_chunk",
    "want_salience"))
jax_attention_decode = jax.jit(jax_layers.attention_decode, static_argnames=(
    "n_heads", "n_kv", "head_dim", "theta", "chunk"))
jax_lm_init = jax.jit(jax_transformer.init, static_argnames=("cfg",))
jax_forward = jax.jit(jax_transformer.forward, static_argnames=("cfg",))
jax_logits = jax.jit(jax_transformer.logits_fn, static_argnames=("cfg",))
jax_prefill = jax.jit(jax_transformer.prefill,
                      static_argnames=("cfg", "max_len"))
jax_decode = jax.jit(jax_transformer.decode_step, static_argnames=("cfg",))
jax_loss_grad = jax.jit(jax.value_and_grad(jax_transformer.loss_fn,
                                           has_aux=True),
                        static_argnames=("cfg",))
jax_lm_step = jax.jit(jax_transformer.train_step,
                      static_argnames=("cfg", "opt_cfg"))


def _cfgs(arch, **changes):
    """(JAX smoke config, the port's), with the same changes."""
    jspec = {s.arch_id: s for s in (jax_lm_archs.LLAMA4_SCOUT,
                                    jax_lm_archs.KIMI_K2)}[arch]
    tspec = {s.arch_id: s for s in (lm_archs.LLAMA4_SCOUT,
                                    lm_archs.KIMI_K2)}[arch]
    return (dataclasses.replace(jspec.smoke_config, **changes),
            dataclasses.replace(tspec.smoke_config, **changes))


@functools.lru_cache(maxsize=None)
def _params(arch, seed=0, **changes):
    jcfg, _ = _cfgs(arch, **changes)
    return _perturb(_host(jax_lm_init(jax.random.PRNGKey(seed), cfg=jcfg)),
                    seed + 1)


def _model(arch, seed=0, **changes):
    """(JAX cfg, host params, the port's model on the CPU)."""
    jcfg, tcfg = _cfgs(arch, **changes)
    params = _params(arch, seed, **changes)
    return jcfg, params, convert.lm_params_from_numpy(params, tcfg,
                                                      device="cpu")


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,e,k,cf", [
    (40, 8, 2, 1.25), (40, 8, 2, 0.5), (1, 16, 1, 2.0), (12288, 16, 1, 1.25),
    (12288, 16, 1, 16.0), (256, 384, 8, 1.25), (4, 384, 8, 2.0),
    (256, 384, 8, 48.0), (1000, 7, 3, 1.1)])
def test_moe_capacity_matches_jax(t, e, k, cf):
    got = layers.moe_capacity(t, e, k, cf)
    assert got == jax_layers.moe_capacity(t, e, k, cf)
    assert got >= 8 and got % 8 == 0


D, F_, E, K_TOP, T_TOK = 48, 32, 8, 2, 40


def _moe_case(seed, n_shared, dtype=np.float32):
    """The reference's params (numpy) and the port's MoE module holding
    them: router (D, E) float32, experts (E, D, F) / (E, F, D)."""
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
         "w_gate": rng.standard_normal((E, D, F_)) / np.sqrt(D),
         "w_up": rng.standard_normal((E, D, F_)) / np.sqrt(D),
         "w_down": rng.standard_normal((E, F_, D)) / np.sqrt(F_)}
    if n_shared:
        p["shared"] = {
            "w_gate": rng.standard_normal((D, F_ * n_shared)) / np.sqrt(D),
            "w_up": rng.standard_normal((D, F_ * n_shared)) / np.sqrt(D),
            "w_down": rng.standard_normal((F_ * n_shared, D))
            / np.sqrt(F_ * n_shared)}
    p = jax.tree.map(lambda a: a.astype(np.float32), p)
    mod = layers.MoE(D, F_, E, n_shared, K_TOP, torch.float32,
                     torch.device("cpu"))
    with torch.no_grad():
        for name, t in mod.named_parameters():
            node = p
            for part in name.split("."):
                node = node[part]
            t.copy_(torch.from_numpy(node))
    x = rng.standard_normal((T_TOK, D)).astype(dtype)
    return p, mod, x


def _jp(p):
    return jax.tree.map(jnp.asarray, p)


def _port_kept(r, t, e):
    """The port's kept assignments as a (T, E) bool table."""
    kept = torch.zeros((t, e), dtype=torch.bool)
    kept[r.sorted_token[r.keep], r.sorted_expert[r.keep]] = True
    return kept.numpy()


@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("chunks", [1, 2, 4])
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_moe_apply_output_and_aux_match_jax(cf, chunks, n_shared):
    """Top-2 of 8 experts over 40 tokens: at capacity factor 0.5 (c = 8
    slots for a mean load of 10, so at least 16 of the 80 assignments
    drop) and 1.25 (c = 16) experts over their capacity drop their latest
    tokens; in 1, 2 and 4 expert blocks, with and without the shared
    expert."""
    p, mod, x = _moe_case(3, n_shared)
    want, want_aux = jax_moe(_jp(p), jnp.asarray(x), top_k=K_TOP,
                             capacity_factor=cf, expert_chunks=chunks)
    with torch.no_grad():
        got, aux = layers.moe_apply(mod, torch.from_numpy(x), top_k=K_TOP,
                                    capacity_factor=cf, expert_chunks=chunks)
    _close(got, want)
    _close(aux, want_aux)
    assert got.dtype == torch.float32 and aux.shape == ()


def _probe_experts(p):
    """The same router with experts whose output lies in column e only
    (expert e's w_down row block is zero outside column e): the combined
    output's column e is nonzero exactly where a token was kept at
    expert e. No shared expert."""
    rng = np.random.default_rng(11)
    probe = {"router": p["router"],
             "w_gate": np.abs(rng.standard_normal((E, D, F_))).astype(
                 np.float32),
             "w_up": np.abs(rng.standard_normal((E, D, F_))).astype(
                 np.float32),
             "w_down": np.zeros((E, F_, D), np.float32)}
    for e in range(E):
        probe["w_down"][e, :, e] = 1.0
    return probe


@pytest.mark.parametrize("cf", [0.5, 1.25, 2.0])
def test_moe_drops_the_references_assignments(cf):
    """The kept (token, expert) set equals the reference's, read from its
    output through probe experts: an expert fills its slots in token order
    and drops the rest. At 0.5 (8 slots an expert for 80 assignments) at
    least 16 drop."""
    p, _, x = _moe_case(4, 0)
    x = np.abs(x)           # positive inputs: every probe output is > 0
    probe = _probe_experts(p)
    want, _ = jax_moe(_jp(probe), jnp.asarray(x), top_k=K_TOP,
                      capacity_factor=cf)
    want_kept = np.asarray(want)[:, :E] != 0
    mod = layers.MoE(D, F_, E, 0, K_TOP, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for name in ("router", "w_gate", "w_up", "w_down"):
            getattr(mod, name).copy_(torch.from_numpy(probe[name]))
    r = layers.moe_route(mod, torch.from_numpy(x), K_TOP, cf)
    got_kept = _port_kept(r, T_TOK, E)
    np.testing.assert_array_equal(got_kept, want_kept)
    n_dropped = T_TOK * K_TOP - int(got_kept.sum())
    assert n_dropped == int((~r.keep).sum())
    assert n_dropped >= (16 if cf == 0.5 else 0), n_dropped
    # the dropped ones of each expert are its latest tokens
    for e in range(E):
        chosen = np.nonzero((r.expert.numpy() == e).any(-1))[0]
        kept = np.nonzero(got_kept[:, e])[0]
        np.testing.assert_array_equal(kept, chosen[:r.capacity])


def test_moe_apply_bf16_activations():
    """bf16 tokens and experts against the reference in float32 on the
    same bf16 values (XLA on this CPU runs no bf16 x bf16 -> float32
    batched product: ``DotThunk`` rejects it). The port rounds each
    expert product, SiLU x up and each gated contribution to bf16 and adds
    a token's contributions in bf16 in the reference's sorted order;
    float32 skips those roundings, 2^-8 relative each. Measured here: at
    most 1.32 steps of the largest output and 0.45% RMS.
    Held: 4 steps and 2% RMS; the routing is float32 from bf16 inputs
    (widened exactly), so the aux loss within 1e-6 and the kept set
    equal."""
    p, _, x = _moe_case(5, 1)
    pb = jax.tree.map(lambda a: a if a.shape == (D, E) else
                      np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32), p)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    want, want_aux = jax_moe(_jp(pb), jnp.asarray(xb), top_k=K_TOP,
                             capacity_factor=1.0, expert_chunks=2)
    mod = layers.MoE(D, F_, E, 1, K_TOP, torch.bfloat16, torch.device("cpu"))
    with torch.no_grad():
        for name, t in mod.named_parameters():
            node = pb
            for part in name.split("."):
                node = node[part]
            t.copy_(torch.from_numpy(node))
        got, aux = layers.moe_apply(mod, torch.from_numpy(xb).bfloat16(),
                                    top_k=K_TOP, capacity_factor=1.0,
                                    expert_chunks=2)
    assert got.dtype == torch.bfloat16 and mod.router.dtype == torch.float32
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    step = 2.0 ** -8 * np.abs(w).max()
    assert np.abs(g - w).max() <= 4 * step
    assert np.linalg.norm(g - w) <= 0.02 * np.linalg.norm(w)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)


@pytest.mark.parametrize("chunks", [1, 2])
def test_moe_apply_grads_match_jax(chunks):
    """Grads of sum(out x R) + 0.5 x aux for x, the router (through the
    gates and the aux loss), the experts and the shared expert, each within
    1e-5 of its leaf's largest entry; capacity 1.0 drops some."""
    p, mod, x = _moe_case(6, 1)
    rmat = np.random.default_rng(7).standard_normal((T_TOK, D)).astype(
        np.float32)

    def jloss(pp, xx):
        out, aux = jax_layers.moe_apply(pp, xx, top_k=K_TOP,
                                        capacity_factor=1.0,
                                        expert_chunks=chunks)
        return jnp.sum(out * rmat) + 0.5 * aux

    want_gp, want_gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        _jp(p), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = layers.moe_apply(mod, xt, top_k=K_TOP, capacity_factor=1.0,
                                expert_chunks=chunks, remat=True)
    (torch.sum(out * torch.from_numpy(rmat)) + 0.5 * aux).backward()
    got_gp = {}
    for name, t in mod.named_parameters():
        node = got_gp
        *head, last = name.split(".")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = t.grad.numpy()
    _assert_tree_close(got_gp, want_gp, rtol=1e-5, atol=1e-9)
    _assert_tree_close({"x": xt.grad.numpy()}, {"x": want_gx}, rtol=1e-5)
    assert float(np.abs(got_gp["router"]).max()) > 0


# ---------------------------------------------------------------------------
# chunked-local attention
# ---------------------------------------------------------------------------

def _attn_case(seed, d=48, n_heads=4, n_kv=2, hd=16):
    rng = np.random.default_rng(seed)
    p = {"wq": rng.standard_normal((d, n_heads * hd)) / np.sqrt(d),
         "wk": rng.standard_normal((d, n_kv * hd)) / np.sqrt(d),
         "wv": rng.standard_normal((d, n_kv * hd)) / np.sqrt(d),
         "wo": rng.standard_normal((n_heads * hd, d)) / np.sqrt(n_heads * hd)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    mod = layers.Attention(d, n_heads, n_kv, hd, False, torch.float32,
                           torch.device("cpu"))
    with torch.no_grad():
        for k, v in p.items():
            getattr(mod, k).copy_(torch.from_numpy(v))
    return p, mod, dict(n_heads=n_heads, n_kv=n_kv, head_dim=hd)


@pytest.mark.parametrize("s,chunk,q_chunk", [
    (32, 8, 8),      # S a multiple of the window, a window of 1 block
    (32, 16, 4),     # 4 query blocks a window
    (28, 8, 4),      # the keys padded to 32
    (20, 16, 8),     # q blocks halved to 4, the keys padded to 32
    (12, 16, 4)])    # the window longer than S: global attention
def test_chunked_attention_and_salience_match_jax(s, chunk, q_chunk):
    p, mod, dims = _attn_case(2)
    x = np.random.default_rng(3).standard_normal((2, s, 48)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    want_o, want_s = jax_attention(
        _jp(p), jnp.asarray(x), jnp.asarray(pos), theta=1e4, chunk=chunk,
        q_chunk=q_chunk, want_salience=True, **dims)
    got_o, got_s = layers.attention(mod, *to_torch(x, pos), theta=1e4,
                                    chunk=chunk, q_chunk=q_chunk,
                                    want_salience=True, **dims)
    _close(got_o, want_o)
    _close(got_s, want_s)
    assert got_s.shape == (2, s)
    # every query's probabilities sum to one over each of the 4 heads
    _close(got_s.sum(-1), np.full(2, 4.0))
    if chunk < s:
        # the first query of a window attends to itself alone
        full = layers.attention(mod, *to_torch(x, pos), theta=1e4,
                                q_chunk=q_chunk, **dims)[0]
        assert not torch.allclose(got_o[:, chunk:], full[:, chunk:])


@pytest.mark.parametrize("pos", [5, 13, 16, 23])
def test_chunked_attention_decode_matches_jax(pos):
    """A cache of 24 slots in windows of 8: ``pos`` in the first window,
    a later one, and at a window's first slot. The slots outside the
    window hold random values, which must not be read."""
    p, mod, dims = _attn_case(4)
    rng = np.random.default_rng(5 + pos)
    b, s_max = 3, 24
    x = rng.standard_normal((b, 1, 48)).astype(np.float32)
    kc = rng.standard_normal((b, s_max, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((b, s_max, 2, 16)).astype(np.float32)
    want = jax_attention_decode(_jp(p), jnp.asarray(x), jnp.int32(pos),
                                jnp.asarray(kc), jnp.asarray(vc), theta=1e4,
                                chunk=8, **dims)
    got = layers.attention_decode(mod, *to_torch(x), pos, *to_torch(kc, vc),
                                  theta=1e4, chunk=8, **dims)
    for g, w in zip(got, want):
        _close(g, w)
    w0 = pos // 8 * 8
    vc2 = vc.copy()
    vc2[:, :w0] += 100.0
    vc2[:, pos + 1:] += 100.0
    again = layers.attention_decode(mod, *to_torch(x), pos,
                                    *to_torch(kc, vc2), theta=1e4, chunk=8,
                                    **dims)[0]
    _close(again, want[0])


# ---------------------------------------------------------------------------
# the MoE transformers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_aux_and_logits_match_jax(arch):
    """S = 32 tokens: llama4-scout's layers 0-2 attend in windows of 8 and
    layer 3 globally; kimi-k2 routes top-2 of 8."""
    jcfg, params, model = _model(arch)
    tok = _tokens(20, 2, 32, jcfg.vocab)
    h, aux, _ = jax_forward(params, jnp.asarray(tok), cfg=jcfg)
    want_logits = jax_logits(params, h, cfg=jcfg)
    with torch.no_grad():
        got_h, got_aux, sal = model(torch.from_numpy(tok))
        got_logits = model.logits(got_h)
    _close(got_h, h)
    _close(got_aux, aux)
    _close(got_logits, want_logits)
    assert sal is None and float(got_aux) > 0
    chunked = [blk.chunked for blk in model.blocks]
    assert chunked == [bool(c) for c in np.asarray(jcfg.layer_is_chunked())]
    assert chunked == ([True, True, True, False] if jcfg.attn_chunk
                       else [False, False])


def _crowd_tokens(seed, b, s, vocab, crowd):
    """Prompts (B, S) and a next token (B,) where the first ``crowd`` rows
    are one row repeated: they route alike, so one expert gets ``crowd``
    assignments in a decode step."""
    tok = _tokens(seed, b, s + 1, vocab)
    tok[:crowd] = tok[0]
    return tok[:, :s], tok[:, s]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_with_drops(arch):
    """Prefill of 24 prompts of 12 tokens (capacity factor 1.25, so some
    assignments drop) and 3 decode steps. The decode steps route at 2.0:
    c = max(8, ceil8(2 x 24 x k / E)) = 16 slots, and 20 identical rows
    crowd one expert, so it drops 4 or more of them; the logits and the
    caches equal the reference's, which drops the same rows."""
    jcfg, params, model = _model(arch)
    b, s, crowd = 24, 12, 20
    max_len = 16
    prompt, nxt = _crowd_tokens(21, b, s, jcfg.vocab, crowd)
    want, jc = jax_prefill(params, jnp.asarray(prompt), cfg=jcfg,
                           max_len=max_len)
    got, pc = T.prefill(model, torch.from_numpy(prompt), max_len=max_len)
    _close(got, want)
    _close(pc.k, jc.k)
    _close(pc.v, jc.v)
    dropped = []
    hooks = [blk.moe.register_forward_hook(
        lambda m, args, out: dropped.append(int((~layers.moe_route(
            m, args[0], m.top_k, args[1]).keep).sum())))
        for blk in model.blocks]
    for i in range(3):
        want, jc = jax_decode(params, jnp.asarray(nxt), jc, jnp.int32(s + i),
                              cfg=jcfg)
        got, pc = T.decode_step(model, torch.from_numpy(nxt), pc, s + i)
        _close(got, want)
        _close(pc.k, jc.k)
        nxt = np.asarray(want).argmax(-1).astype(np.int32)
    for h in hooks:
        h.remove()
    assert max(dropped) >= crowd - 16, dropped


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_the_no_drop_forward(arch):
    """The reference's own check (tests/test_models_lm.py): at capacity
    factor E / k nothing drops, so prefill and 6 greedy decode steps give
    the teacher-forced forward's logits at each position. llama4-scout's
    prompt of 14 runs into its second window of 8, and the cache of 24
    holds three."""
    jcfg, tcfg = _cfgs(arch)
    cf = jcfg.n_experts / jcfg.moe_top_k
    _, _, model = _model(arch, capacity_factor=cf)
    tok = torch.from_numpy(_tokens(22, 2, 14, tcfg.vocab))
    logits, cache = T.prefill(model, tok, max_len=24)
    seq = tok
    for i in range(6):
        with torch.no_grad():
            h, _, _ = model(seq)
            ref = model.logits(h[:, -1:])[:, 0]
        np.testing.assert_allclose(logits.numpy(), ref.numpy(), atol=2e-5,
                                   rtol=1e-5)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
        logits, cache = T.decode_step(model, nxt, cache, 14 + i)


def _lm_batch(seed, vocab, b=3, s=24):
    """Tokens and targets, the first 3 targets of each row masked."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s), dtype=np.int32)
    targets = rng.integers(0, vocab, (b, s), dtype=np.int32)
    targets[:, :3] = -1
    return tokens, targets


def _loss_grads(model, tokens, targets, remat=True):
    return T.value_and_grad(
        lambda p: T.loss_fn(model, p, *to_torch(tokens, targets),
                            remat=remat), T.params_of(model))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_jax(arch):
    """ce + 0.01 x aux and its parts within rtol 1e-5, each grad leaf
    (the stacked (L, E, D, F) experts included) within 1e-5 of its largest
    entry, compared in the reference's layout."""
    jcfg, params, model = _model(arch)
    tokens, targets = _lm_batch(23, jcfg.vocab)
    (wl, wparts), wg = jax_loss_grad(params, tokens, targets, cfg=jcfg)
    loss, parts, grads = _loss_grads(model, tokens, targets)
    assert float(loss) == pytest.approx(float(wl), rel=1e-5)
    for k in ("ce", "aux"):
        assert float(parts[k]) == pytest.approx(float(wparts[k]), rel=1e-5)
    got = convert.params_to_numpy(grads)
    assert got["blocks"]["moe"]["w_gate"].shape == (
        jcfg.n_layers, jcfg.n_experts, jcfg.d_model, jcfg.moe_d_ff)
    _assert_tree_close(got, wg, rtol=1e-5, atol=1e-9)


def test_aux_loss_is_positive():
    """The reference's check (tests/test_models_lm.py) on the port."""
    jcfg, _, model = _model("kimi-k2-1t-a32b")
    tok = _tokens(24, 2, 16, jcfg.vocab)
    _, parts, _ = _loss_grads(model, tok, np.roll(tok, -1, 1))
    assert float(parts["aux"]) > 0.0


@pytest.mark.parametrize("arch,chunks", [("llama4-scout-17b-a16e", 1),
                                         ("kimi-k2-1t-a32b", 2),
                                         ("kimi-k2-1t-a32b", 4)])
def test_remat_changes_no_bit(arch, chunks):
    """The block, query-block, expert-block and loss-chunk checkpoints
    recompute the same values: the loss and every grad equal bit for bit
    with and without them."""
    jcfg, _, model = _model(arch, moe_expert_chunks=chunks)
    tokens, targets = _lm_batch(25, jcfg.vocab, s=32)
    l1, _, g1 = _loss_grads(model, tokens, targets, remat=True)
    l2, _, g2 = _loss_grads(model, tokens, targets, remat=False)
    assert torch.equal(l1, l2)
    assert all(torch.equal(g1[k], g2[k]) for k in g1)


_STEP_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)


def _step(model, tp, ts, i, vocab, to):
    tokens, targets = _lm_batch(200 + i, vocab, s=16)
    batch = {"tokens": tokens, "targets": targets}
    return batch, T.train_step(model, tp, ts, dict(zip(
        ("tokens", "targets"), to_torch(tokens, targets))), to)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_after_1_and_8_steps(arch):
    """8 train steps with float32 moments on fresh batches, each package
    stepping its own state. The first step's loss, aux and grad norm
    within rtol 1e-5; the params after 1 and 8 steps as
    ``_assert_adam_close`` says. An entry whose grad is at rounding level
    steps with either sign (up to 2 x lr), which moves the later steps'
    losses and grad norms a little (measured: 3.4e-6 and 2.7e-5 relative);
    those are held to 1e-4."""
    jcfg, params, model = _model(arch)
    jo = jax_opt.AdamWConfig(**_STEP_OPT)
    to = opt.AdamWConfig(**_STEP_OPT)
    jp, js = params, jax_opt.init(jo, params)
    tp = T.params_of(model)
    ts = opt.init(to, tp)
    sum_lr = 0.0
    for i in range(8):
        batch, (tp, ts, tm) = _step(model, tp, ts, i, jcfg.vocab, to)
        jp, js, jm = jax_lm_step(jp, js, batch, cfg=jcfg, opt_cfg=jo)
        for k in ("loss", "aux", "grad_norm"):
            assert float(tm[k]) == pytest.approx(
                float(jm[k]), rel=1e-5 if i == 0 else 1e-4), (i, k)
        sum_lr += float(jm["lr"])
        if i in (0, 7):
            _assert_adam_close(convert.params_to_numpy(tp), jp, sum_lr)
    assert int(ts.step) == int(js.step) == 8


def _port_state(js):
    """The reference's int8 ``AdamWState`` with the port's ``QMoment``
    leaves, as ``convert`` reads them."""
    def qm(node):
        if isinstance(node, dict):
            return {k: qm(v) for k, v in node.items()}
        return opt.QMoment(np.asarray(node.q), np.asarray(node.scale))
    return jax_opt.AdamWState(np.asarray(js.step), qm(js.m), qm(js.v))


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_train_steps_match_jax_from_its_state(arch):
    """8 train steps with int8 moments, the port starting each one from
    the reference's params and (E, D, F)-row quantized moments, carried
    across by ``convert.train_state_from_tree``.

    The reference's per-row int8 codec rounds a second moment below half
    a code to 0; an entry whose grad is then near zero steps by lr x m /
    (sqrt(v) + eps) with sqrt(v) near eps, up to 3e5 x lr here, and that
    step follows its grad's rounding. So two runs that each step their own
    state part after the second step (ROADMAP.md caveat C8), and each step
    is held from the same state instead: the loss, aux and grad norm
    within rtol 1e-5; the new codes equal for 99.99% of entries (measured:
    at most 23 of 871,552 differ by one); 99.9% of the params within 1e-5
    and each within 2 x lr plus 2% of the reference's step (measured: at
    most 239 beyond 1e-5, the furthest 1.7% of its step). The
    first step equals the float32 one (its update reads the unquantized
    moments) and is held as ``_assert_adam_close`` says."""
    jcfg, params, model = _model(arch)
    jo = jax_opt.AdamWConfig(**_STEP_OPT, moment_dtype="int8")
    to = opt.AdamWConfig(**_STEP_OPT, moment_dtype="int8")
    jp, js = params, jax_opt.init(jo, params)
    like = T.params_of(model)
    largest = 0.0
    for i in range(8):
        tp, ts = convert.train_state_from_tree(
            (_host(jp), _port_state(js)), like)
        before = _flat(jp)
        batch, (tp, ts, tm) = _step(model, tp, ts, i, jcfg.vocab, to)
        jp, js, jm = jax_lm_step(jp, js, batch, cfg=jcfg, opt_cfg=jo)
        for k in ("loss", "aux", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
        lr = float(jm["lr"])
        if i == 0:
            _assert_adam_close(convert.params_to_numpy(tp), jp, lr)
        got, want = _flat(convert.params_to_numpy(tp)), _flat(jp)
        err = np.concatenate([np.abs(got[k].astype(np.float64) - want[k])
                              .ravel() for k in want])
        step = np.concatenate([np.abs(want[k].astype(np.float64)
                                      - before[k]).ravel() for k in want])
        largest = max(largest, float(step.max()) / lr)
        assert np.mean(err > 1e-5) <= 1e-3, (i, np.mean(err > 1e-5))
        assert np.all(err <= 2 * lr + 0.02 * step), (i, err.max())
        gm = _flat(convert.adamw_state_to_numpy(ts))
        wm = _flat(js)
        codes = [k for k in wm if k.endswith(".q")]
        assert gm[codes[0]].dtype == np.int8
        differ = sum(int((gm[k] != wm[k]).sum()) for k in codes)
        assert differ <= 1e-4 * sum(wm[k].size for k in codes), (i, differ)
        assert all(np.abs(gm[k].astype(int) - wm[k]).max() <= 1
                   for k in codes)
    name = "blocks.0.moe.w_up"
    assert tuple(ts.m[name].scale.shape) == (jcfg.n_experts, jcfg.d_model, 1)
    # the reference's own m / eps steps (measured: up to 3e5 x lr)
    assert largest > 1e3, largest


def test_int8_moment_codec_on_expert_leaves_matches_jax_exactly():
    """A stacked (L, E, D, F) moment quantizes per row of F to the same
    codes and scales as each layer's (E, D, F) slice in the port."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((2, 4, 6, 12)) * 10.0 ** rng.integers(
        -5, 1, (2, 4, 6, 1))).astype(np.float32)
    x[1, 2] = 0.0
    want = jax_opt._quantize_moment(jnp.asarray(x))
    for layer in range(2):
        got = opt._quantize_moment(torch.from_numpy(x[layer]))
        np.testing.assert_array_equal(got.q.numpy(),
                                      np.asarray(want.q)[layer])
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale)[layer])


@pytest.mark.parametrize("arch", ARCHS)
def test_module_parameter_count_is_the_configs(arch):
    """The port's module holds ``param_count()`` weights, the reference
    tree's count, under the reference's keys (``blocks/moe/router``,
    ``blocks/moe/shared/w_gate``, ...)."""
    jcfg, tcfg = _cfgs(arch)
    model = T.init(tcfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == tcfg.param_count() == jcfg.param_count()
    jtree = jax.eval_shape(functools.partial(jax_transformer.init, cfg=jcfg),
                           jax.random.PRNGKey(0))
    assert n == sum(np.prod(a.shape) for a in jax.tree.leaves(jtree))
    mine = convert.params_to_numpy(model)
    assert sorted(_flat(mine)) == sorted(_flat(jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), jtree)))
    moe = model.blocks[0].moe
    assert moe.router.dtype == torch.float32
    d, f = tcfg.d_model, tcfg.moe_d_ff
    # the reference's scales: 1/sqrt(D) in, 1/sqrt(F) for w_down
    assert abs(float(moe.w_up.std()) * np.sqrt(d) - 1.0) < 0.1
    assert abs(float(moe.w_down.std()) * np.sqrt(f) - 1.0) < 0.1
    assert abs(float(moe.router.std()) * np.sqrt(d) - 1.0) < 0.2


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------

def _npz(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_moe_checkpoint_restores_in_the_port(tmp_path, arch):
    """The reference's (params, int8 AdamWState) after 2 steps restores
    into the port's named tensors and int8 state, and the port's save of
    it is the same file, key for key and byte for byte."""
    jcfg, params, model = _model(arch)
    ocfg = jax_opt.AdamWConfig(moment_dtype="int8")
    state = jax_opt.init(ocfg, params)
    rng = np.random.default_rng(9)
    for _ in range(2):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), params)
        params, state, _ = jax.jit(jax_opt.update, static_argnums=0)(
            ocfg, grads, state, params)
    params, state = _host(params), _host(state)
    jpath = jax_ck.save(str(tmp_path / "jax"), 2, (params, state))
    like = T.params_of(model)
    fresh = opt.init(opt.AdamWConfig(moment_dtype="int8"), like)
    tree = ck.restore(jpath, convert.train_template(like, fresh))
    p, s = convert.train_state_from_tree(tree, like)
    assert int(s.step) == 2
    assert s.m["blocks.1.moe.w_down"].q.shape == (
        jcfg.n_experts, jcfg.moe_d_ff, jcfg.d_model)
    tpath = ck.save(str(tmp_path / "port"), 2, convert.train_tree(p, s))
    want, got = _npz(jpath), _npz(tpath)
    assert sorted(got) == sorted(want)
    assert "[0]['blocks']['moe']['router']" in got
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].tobytes() == want[key].tobytes(), key


@pytest.mark.parametrize("arch", ARCHS)
def test_port_moe_checkpoint_restores_in_the_reference(tmp_path, arch):
    """The port trains 2 steps (int8 moments) and saves; the reference
    restores the file into its own template, every value equal."""
    jcfg, params, model = _model(arch)
    jstate = jax_opt.init(jax_opt.AdamWConfig(moment_dtype="int8"), params)
    ocfg = opt.AdamWConfig(moment_dtype="int8")
    p = T.params_of(model)
    s = opt.init(ocfg, p)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        tok = torch.randint(0, jcfg.vocab, (2, 16), generator=gen)
        p, s, _ = T.train_step(model, p, s, {"tokens": tok,
                                             "targets": tok}, ocfg)
    path = ck.save(str(tmp_path), 2, convert.train_tree(p, s))
    back = _host(jax_ck.restore(path, (params, jstate)))
    flat_back = dict(ck.leaves_with_paths(back))
    flat_want = dict(ck.leaves_with_paths(convert.train_tree(p, s)))
    assert sorted(flat_back) == sorted(flat_want)
    for key, val in flat_want.items():
        np.testing.assert_array_equal(flat_back[key], val, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_the_moe_archs_and_resumes(tmp_path, arch):
    args = ["--arch", arch, "--smoke", "--batch", "4", "--seq", "16",
            "--lr", "1e-2", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "5"]
    out = train_cli.main(args + ["--steps", "10"])
    losses = [h["loss"] for h in out["history"]]
    assert out["step"] == 10 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert ck.latest_step(str(tmp_path)) == 10
    out2 = train_cli.main(args + ["--steps", "12"])
    assert out2["step"] == 12 and len(out2["history"]) == 2
    assert out2["model"].cfg.is_moe
