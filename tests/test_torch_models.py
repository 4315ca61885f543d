"""The port's transformer and ColPali encoder against the JAX package.

At the smoke widths of the repo's configs (2 layers, d_model 48-64), the
reference's own init draws the weights; its zero biases and unit norms are
replaced by random values from a numpy seed (so the QKV bias and the norm
weights are exercised), and ``convert`` carries the tree across. The same
numpy inputs then go through both packages. float32 activations are held
to atol = rtol = 1e-5; bf16 activations to the bound
``test_forward_bf16_activations`` states.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import colpali_hpc as jax_colpali_hpc
from repro.configs import lm_archs as jax_lm_archs
from repro.core import rag as jax_rag
from repro.models import colpali as jax_colpali
from repro.models import layers as jax_layers
from repro.models import transformer as jax_transformer
from repro_torch.configs import colpali_hpc, lm_archs
from repro_torch.convert import (colpali_params_from_numpy,
                                 lm_params_from_numpy)
from repro_torch.core import rag
from repro_torch.models import colpali
from repro_torch.models import layers
from repro_torch.models import transformer
from tests._torch_parity import to_torch

TOL = 1e-5
DENSE = ("qwen2-1.5b", "glm4-9b", "llama3.2-3b")
# the reference's functions, jitted once per config (eager dispatch of its
# layer scans costs seconds per call on the CPU)
jax_forward = jax.jit(jax_transformer.forward,
                      static_argnames=("cfg", "want_salience"))
jax_logits = jax.jit(jax_transformer.logits_fn, static_argnames=("cfg",))
jax_prefill = jax.jit(jax_transformer.prefill,
                      static_argnames=("cfg", "max_len"))
jax_decode = jax.jit(jax_transformer.decode_step, static_argnames=("cfg",))
jax_lm_init = jax.jit(jax_transformer.init, static_argnames=("cfg",))
jax_enc_init = jax.jit(jax_colpali.init, static_argnames=("cfg",))
jax_encode_doc = jax.jit(jax_colpali.encode_doc, static_argnames=("cfg",))
jax_encode_query = jax.jit(jax_colpali.encode_query, static_argnames=("cfg",))
jax_attention = jax.jit(jax_layers.attention, static_argnames=(
    "n_heads", "n_kv", "head_dim", "theta", "q_chunk", "want_salience"))
jax_attention_decode = jax.jit(jax_layers.attention_decode, static_argnames=(
    "n_heads", "n_kv", "head_dim", "theta"))


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb(tree, seed):
    """Random biases (x 0.1) and norm weights (1 + 0.1 x normal) in place
    of the init's zeros and ones."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for key, val in node.items():
            if isinstance(val, dict):
                out[key] = walk(val)
            elif key in ("bq", "bk", "bv"):
                out[key] = (0.1 * rng.standard_normal(val.shape)).astype(
                    val.dtype)
            elif key in ("ln1", "ln2", "ln_f"):
                out[key] = (1.0 + 0.1 * rng.standard_normal(val.shape)
                            ).astype(val.dtype)
            else:
                out[key] = val
        return out

    return walk(tree)


def _jax_cfg(arch_id):
    spec = {s.arch_id: s for s in (jax_lm_archs.QWEN2_1_5B,
                                   jax_lm_archs.GLM4_9B,
                                   jax_lm_archs.LLAMA32_3B)}[arch_id]
    return spec.smoke_config


def _port_cfg(arch_id):
    spec = {s.arch_id: s for s in (lm_archs.QWEN2_1_5B, lm_archs.GLM4_9B,
                                   lm_archs.LLAMA32_3B)}[arch_id]
    return spec.smoke_config


@pytest.fixture(scope="module", params=DENSE)
def lm(request):
    """(arch id, JAX cfg, perturbed host params, port model on the CPU)."""
    jcfg = _jax_cfg(request.param)
    params = _perturb(_host(jax_lm_init(jax.random.PRNGKey(0), cfg=jcfg)), 1)
    model = lm_params_from_numpy(params, _port_cfg(request.param),
                                 device="cpu")
    return request.param, jcfg, params, model


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 5, 48), (3, 16)])
def test_rms_norm_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(shape[-1:])).astype(np.float32)
    want = jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = layers.rms_norm(*to_torch(x, w), 1e-5)
    _close(got, want)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)).copy()
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.apply_rope(*to_torch(x, pos), theta)
    _close(got, want)


def _attn_case(seed, d=48, n_heads=4, n_kv=2, hd=16):
    rng = np.random.default_rng(seed)
    p = {"wq": rng.standard_normal((d, n_heads * hd)) / np.sqrt(d),
         "wk": rng.standard_normal((d, n_kv * hd)) / np.sqrt(d),
         "wv": rng.standard_normal((d, n_kv * hd)) / np.sqrt(d),
         "wo": rng.standard_normal((n_heads * hd, d)) / np.sqrt(n_heads * hd),
         "bq": 0.1 * rng.standard_normal(n_heads * hd),
         "bk": 0.1 * rng.standard_normal(n_kv * hd),
         "bv": 0.1 * rng.standard_normal(n_kv * hd)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    mod = layers.Attention(d, n_heads, n_kv, hd, True, torch.float32,
                           torch.device("cpu"))
    with torch.no_grad():
        for k, v in p.items():
            getattr(mod, k).copy_(torch.from_numpy(v))
    return p, mod, dict(n_heads=n_heads, n_kv=n_kv, head_dim=hd)


@pytest.mark.parametrize("s,q_chunk", [(32, 8), (24, 16), (12, 512)])
def test_attention_output_and_salience_match_jax(s, q_chunk):
    p, mod, dims = _attn_case(2)
    x = np.random.default_rng(3).standard_normal((2, s, 48)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    want_o, want_s = jax_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(pos), theta=1e4, q_chunk=q_chunk, want_salience=True,
        **dims)
    got_o, got_s = layers.attention(mod, *to_torch(x, pos), theta=1e4,
                                    q_chunk=q_chunk, want_salience=True,
                                    **dims)
    _close(got_o, want_o)
    _close(got_s, want_s)
    # every query's probabilities sum to one over each of the H heads
    _close(got_s.sum(-1), np.full(2, 4.0))


def test_attention_decode_matches_jax():
    p, mod, dims = _attn_case(4)
    rng = np.random.default_rng(5)
    b, s_max, pos = 3, 10, 6
    x = rng.standard_normal((b, 1, 48)).astype(np.float32)
    kc = rng.standard_normal((b, s_max, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((b, s_max, 2, 16)).astype(np.float32)
    want = jax_attention_decode(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.int32(pos), jnp.asarray(kc), jnp.asarray(vc), theta=1e4, **dims)
    got = layers.attention_decode(mod, *to_torch(x), pos, *to_torch(kc, vc),
                                  theta=1e4, **dims)
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------

def test_forward_and_logits_match_jax(lm):
    arch, jcfg, params, model = lm
    tok = _tokens(6, 2, 32, jcfg.vocab)
    h, aux, sal = jax_forward(params, jnp.asarray(tok), cfg=jcfg,
                              want_salience=True)
    want_logits = jax_logits(params, h, cfg=jcfg)
    with torch.no_grad():
        got_h, got_aux, got_sal = model(torch.from_numpy(tok),
                                        want_salience=True)
        got_logits = model.logits(got_h)
    _close(got_h, h)
    _close(got_sal, sal)
    _close(got_logits, want_logits)
    assert got_logits.dtype == torch.float32 and float(got_aux) == 0.0
    assert model(torch.from_numpy(tok))[2] is None


def test_prefill_logits_and_caches_match_jax(lm):
    arch, jcfg, params, model = lm
    tok = _tokens(7, 3, 12, jcfg.vocab)
    want_logits, want_cache = jax_prefill(params, jnp.asarray(tok),
                                          cfg=jcfg, max_len=16)
    got_logits, got_cache = transformer.prefill(model, torch.from_numpy(tok),
                                                max_len=16)
    _close(got_logits, want_logits)
    _close(got_cache.k, want_cache.k)
    _close(got_cache.v, want_cache.v)
    assert got_cache.k.shape == (jcfg.n_layers, 3, 16, jcfg.n_kv_heads,
                                 jcfg.hd)


def test_decode_steps_match_jax(lm):
    arch, jcfg, params, model = lm
    tok = _tokens(8, 2, 10, jcfg.vocab)
    steps = _tokens(9, 4, 2, jcfg.vocab)
    _, jc = jax_prefill(params, jnp.asarray(tok), cfg=jcfg, max_len=14)
    _, pc = transformer.prefill(model, torch.from_numpy(tok), max_len=14)
    for i in range(4):
        want, jc = jax_decode(params, jnp.asarray(steps[i]), jc,
                              jnp.int32(10 + i), cfg=jcfg)
        got, pc = transformer.decode_step(model, torch.from_numpy(steps[i]),
                                          pc, 10 + i)
        _close(got, want)
        _close(pc.k, jc.k)
        _close(pc.v, jc.v)


@pytest.mark.parametrize("lm", ["qwen2-1.5b"], indirect=True)
def test_greedy_generate_gives_the_reference_tokens(lm):
    arch, jcfg, params, model = lm
    prompt = _tokens(10, 4, 9, jcfg.vocab)
    want = jax_rag.greedy_generate(params, jnp.asarray(prompt), jcfg,
                                   max_new=5, prompt_len=9)
    got = rag.greedy_generate(model, torch.from_numpy(prompt), max_new=5,
                              prompt_len=9)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_forward_bf16_activations():
    """bf16 activations (the qwen2-1.5b config's own). bf16 keeps 8
    significant bits, a relative step of 2^-8. The port rounds to bf16
    after every op, as the reference's program says; XLA on the CPU may
    keep float32 inside a fusion and skip some of those roundings (its
    excess-precision default), and each library sums a product in its own
    order. So an intermediate can land a step or two apart and carry that
    through the next layer: over 2 layers the hidden states differ by
    about 1% RMS and at most 3 steps at their own scale. They are held to
    4 steps of their largest magnitude elementwise and 2% RMS, and the
    float32 logits and the salience of those states to the same."""
    jcfg = dataclasses.replace(_jax_cfg("qwen2-1.5b"),
                               activation_dtype="bfloat16")
    pcfg = dataclasses.replace(_port_cfg("qwen2-1.5b"),
                               activation_dtype="bfloat16")
    params = _perturb(_host(jax_lm_init(jax.random.PRNGKey(2), cfg=jcfg)), 3)
    model = lm_params_from_numpy(params, pcfg, device="cpu")
    tok = _tokens(11, 2, 32, jcfg.vocab)
    h, _, sal = jax_forward(params, jnp.asarray(tok), cfg=jcfg,
                            want_salience=True)
    want_logits = jax_logits(params, h, cfg=jcfg)
    with torch.no_grad():
        got_h, _, got_sal = model(torch.from_numpy(tok), want_salience=True)
        got_logits = model.logits(got_h)
    assert got_h.dtype == torch.bfloat16
    assert got_logits.dtype == torch.float32
    for got, want in ((got_h.float(), h.astype(jnp.float32)),
                      (got_logits, want_logits), (got_sal, sal)):
        got, want = got.numpy(), np.asarray(want)
        step = 2.0 ** -8 * np.abs(want).max()
        assert np.abs(got - want).max() <= 4 * step
        assert np.linalg.norm(got - want) <= 0.02 * np.linalg.norm(want)


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def encoder():
    """(JAX cfg, host params, port encoder) at the colpali-smoke widths."""
    jcfg = jax_colpali_hpc.COLPALI_HPC.smoke_config.encoder
    pcfg = colpali_hpc.COLPALI_HPC.smoke_config.encoder
    params = _perturb(_host(jax_enc_init(jax.random.PRNGKey(3), cfg=jcfg)),
                      4)
    return jcfg, params, colpali_params_from_numpy(params, pcfg,
                                                   device="cpu")


def test_encode_doc_matches_jax_with_padded_patches(encoder):
    jcfg, params, enc = encoder
    rng = np.random.default_rng(12)
    patches = rng.standard_normal((3, jcfg.n_patches, jcfg.d_patch)).astype(
        np.float32)
    mask = np.ones((3, jcfg.n_patches), bool)
    mask[1, 11:] = False
    mask[2, 5:] = False
    want_e, want_s = jax_encode_doc(params, jnp.asarray(patches),
                                    jnp.asarray(mask), cfg=jcfg)
    got_e, got_s = enc.encode_doc(*to_torch(patches, mask))
    _close(got_e, want_e)
    _close(got_s, want_s)
    assert got_e.dtype == torch.float32 and not got_e[1, 11:].any()
    norms = torch.linalg.vector_norm(got_e[0], dim=-1)
    np.testing.assert_allclose(norms.numpy(), 1.0, rtol=1e-5)
    # an unpadded page's salience sums to n_heads
    np.testing.assert_allclose(float(got_s[0].sum()),
                               jcfg.backbone.n_heads, rtol=1e-5)


def test_encode_query_matches_jax_with_padded_tokens(encoder):
    jcfg, params, enc = encoder
    tok = _tokens(13, 4, jcfg.query_len, jcfg.backbone.vocab)
    mask = np.arange(jcfg.query_len)[None] < np.array([[8], [5], [3], [1]])
    want_e, want_s = jax_encode_query(params, jnp.asarray(tok),
                                      jnp.asarray(mask), cfg=jcfg)
    got_e, got_s = enc.encode_query(*to_torch(tok, mask))
    _close(got_e, want_e)
    _close(got_s, want_s)
    assert not got_e[3, 1:].any() and not got_s[2, 3:].any()


def test_port_init_follows_the_reference_layout():
    """The port's own draws: ones for norms, zeros for biases, the embedding
    at std 0.02, projections at std 1/sqrt(in); as many weights as the
    reference's tree (param_count plus the QKV biases it leaves out)."""
    cfg = colpali_hpc.COLPALI_HPC.smoke_config.encoder
    enc = colpali.init(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    enc.requires_grad_(False)
    blk = enc.backbone.blocks[1]
    assert float(blk.ln1.weight.min()) == 1.0 == float(blk.ln1.weight.max())
    assert not blk.attn.bq.any() and float(blk.attn.wq.std()) > 0
    assert 0.015 < float(enc.backbone.embed.std()) < 0.025
    d = cfg.backbone.d_model
    assert abs(float(blk.ffn.w_up.std()) * np.sqrt(d) - 1.0) < 0.1
    jparams = jax.eval_shape(functools.partial(
        jax_colpali.init, cfg=jax_colpali_hpc.COLPALI_HPC.smoke_config
        .encoder), jax.random.PRNGKey(0))
    bb = cfg.backbone
    biases = bb.n_layers * (bb.n_heads + 2 * bb.n_kv_heads) * bb.hd
    n_port = sum(p.numel() for p in enc.parameters())
    assert n_port == sum(np.prod(a.shape) for a in jax.tree.leaves(jparams))
    assert n_port == cfg.param_count() + biases


# ---------------------------------------------------------------------------
# convert, the entry points' flag and the configs
# ---------------------------------------------------------------------------

def test_convert_rejects_a_missing_array_by_name(lm):
    arch, jcfg, params, _ = lm
    bad = dict(params)
    bad["blocks"] = {**params["blocks"],
                     "attn": {k: v for k, v in params["blocks"]["attn"]
                              .items() if k != "wk"}}
    with pytest.raises(KeyError, match="blocks/attn/wk"):
        lm_params_from_numpy(bad, _port_cfg(arch), device="cpu")
    extra = {**params, "stray": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="stray"):
        lm_params_from_numpy(extra, _port_cfg(arch), device="cpu")


def test_convert_rejects_a_wrong_shape_by_name(lm):
    arch, jcfg, params, _ = lm
    bad = {**params, "ln_f": np.ones(jcfg.d_model + 1, np.float32)}
    with pytest.raises(ValueError, match="ln_f"):
        lm_params_from_numpy(bad, _port_cfg(arch), device="cpu")
    stack = params["blocks"]["ffn"]["w_up"]
    bad = dict(params)
    bad["blocks"] = {**params["blocks"], "ffn": {
        **params["blocks"]["ffn"], "w_up": stack[:1]}}
    with pytest.raises(ValueError, match="blocks/ffn/w_up"):
        lm_params_from_numpy(bad, _port_cfg(arch), device="cpu")


_ENTRY_POINTS = ("forward", "logits", "prefill", "decode_step",
                 "encode_doc", "encode_query")


@pytest.mark.parametrize("entry", _ENTRY_POINTS)
def test_entry_points_accumulate_bf16_in_float32(entry, monkeypatch):
    """Each model entry point clears PyTorch's bf16 reduced-precision
    reduction flag for its products, whatever the caller left it at, and
    restores it after."""
    flag = torch.backends.cuda.matmul
    seen = []

    def recording(fn):
        def wrapped(*args, **kwargs):
            seen.append(flag.allow_bf16_reduced_precision_reduction)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(layers, "rms_norm", recording(layers.rms_norm))
    monkeypatch.setattr(torch, "matmul", recording(torch.matmul))
    monkeypatch.setattr(flag, "allow_bf16_reduced_precision_reduction", True)
    gen = torch.Generator().manual_seed(0)
    enc_cfg = colpali_hpc.COLPALI_HPC.smoke_config.encoder
    enc = colpali.init(enc_cfg, generator=gen, device="cpu")
    model = enc.backbone
    tok = torch.from_numpy(_tokens(14, 2, 6, model.cfg.vocab))
    calls = {
        "forward": lambda: model(tok),
        "logits": lambda: model.logits(torch.ones((2, 1, model.cfg.d_model))),
        "prefill": lambda: transformer.prefill(model, tok, max_len=8),
        "decode_step": lambda: transformer.decode_step(
            model, tok[:, 0], transformer.init_cache(model.cfg, 2, 8,
                                                     device="cpu"), 0),
        "encode_doc": lambda: enc.encode_doc(
            torch.ones((1, enc_cfg.n_patches, enc_cfg.d_patch)),
            torch.ones((1, enc_cfg.n_patches), dtype=torch.bool)),
        "encode_query": lambda: enc.encode_query(tok, torch.ones_like(
            tok, dtype=torch.bool)),
    }
    calls[entry]()
    assert seen and not any(seen), seen
    assert flag.allow_bf16_reduced_precision_reduction is True


def test_configs_are_the_reference_configs():
    """The port's config copies hold the reference's values, field for
    field, for every LM architecture and for colpali-hpc."""
    for name in ("GLM4_9B", "QWEN2_1_5B", "LLAMA32_3B", "LLAMA4_SCOUT",
                 "KIMI_K2"):
        mine, ref = getattr(lm_archs, name), getattr(jax_lm_archs, name)
        for cfg_m, cfg_r in ((mine.config, ref.config),
                             (mine.smoke_config, ref.smoke_config)):
            assert dataclasses.asdict(cfg_m) == dataclasses.asdict(cfg_r)
            assert cfg_m.param_count() == cfg_r.param_count()
        assert [dataclasses.asdict(s) for s in mine.shapes] == \
            [dataclasses.asdict(s) for s in ref.shapes]
    for which in ("config", "smoke_config"):
        mine = getattr(colpali_hpc.COLPALI_HPC, which)
        ref = getattr(jax_colpali_hpc.COLPALI_HPC, which)
        assert dataclasses.asdict(mine.encoder) == \
            dataclasses.asdict(ref.encoder)
        assert mine.encoder.param_count() == ref.encoder.param_count()
        for f in ("k", "p", "prune_side", "backend", "rerank",
                  "kmeans_iters", "kmeans_restarts", "kmeans_seed_batch",
                  "kmeans_minibatch", "mode", "index"):
            assert getattr(mine.hpc, f) == getattr(ref.hpc, f), f
        assert (mine.corpus_docs, mine.kept_patches, mine.top_k) == \
            (ref.corpus_docs, ref.kept_patches, ref.top_k)
