"""``encoded_flat``: the paper's query path, a query encoder in front of
the ``flat`` index.

Inputs (drawn from the seed on the device): the ``flat`` kind's index
inputs, drawn alike (``flat.inputs``); the encoder's weights
(``draw_weights``, drawn again whenever a side needs them, so that no
second copy is held while the port serves); a pool of ``query_pool``
token queries, each ``query_len`` slots of ids uniform over the
vocabulary, its valid length uniform in [``query_tokens_min``,
``query_len``], the valid ids first and pad id 0 after.

The port's query encoder is ``models/colpali.ColPaliEncoder`` built from
the configuration's ``encoder`` block, its weights copied in by
``models/transformer.load_params``; ``encoder`` hands on its
``encode_query``. The index and its search are the ``flat`` kind's.
"""
from __future__ import annotations

import math

import torch

from portbench import corpus, roofline
from portbench.kinds import flat
from portbench.reference import encoded_flat as reference_encoded
from portbench.reference import flat as reference_flat

# the generator streams of the pool and of the weights (the index draws
# on stream 0, as the flat kind's)
POOL_STREAM, WEIGHT_STREAM = 1, 2


def _shapes(cfg):
    """The stacked weights' shapes, by leaf."""
    enc = cfg["encoder"]
    bb = enc["backbone"]
    n, d, ff = bb["n_layers"], bb["d_model"], bb["d_ff"]
    hd = bb["head_dim"] or d // bb["n_heads"]
    q_out, kv_out = bb["n_heads"] * hd, bb["n_kv_heads"] * hd
    shapes = {"embed": (bb["vocab"], d),
              "wq": (n, d, q_out), "wk": (n, d, kv_out),
              "wv": (n, d, kv_out), "wo": (n, q_out, d),
              "w_gate": (n, d, ff), "w_up": (n, d, ff), "w_down": (n, ff, d),
              "ln1": (n, d), "ln2": (n, d), "ln_f": (d,),
              "out_proj": (d, enc["proj_dim"]),
              "patch_proj": (enc["d_patch"], d)}
    if bb["qkv_bias"]:
        shapes.update(bq=(n, q_out), bk=(n, kv_out), bv=(n, kv_out))
    return shapes


def draw_weights(cfg, seed, device):
    """The encoder's weights as stacked float32 leaves (a layer's slice is
    its own), one draw a leaf from the seed's weight stream: a product's
    weight normal x 1/sqrt(its input width), the embedding normal x
    ``embed_scale``, the q/k/v biases normal x ``bias_scale``, the norms'
    weights 1 + normal x ``norm_scale``."""
    gen = corpus.generator(seed, device, WEIGHT_STREAM)
    out = {}
    for name, shape in _shapes(cfg).items():
        w = torch.randn(shape, generator=gen, device=device)
        if name == "embed":
            w.mul_(cfg["embed_scale"])
        elif name in ("bq", "bk", "bv"):
            w.mul_(cfg["bias_scale"])
        elif name in ("ln1", "ln2", "ln_f"):
            w.mul_(cfg["norm_scale"]).add_(1.0)
        else:
            w.mul_(1.0 / math.sqrt(shape[-2]))
        out[name] = w
    return out


def inputs(cfg, seed, device):
    enc = cfg["encoder"]
    if (enc["query_len"], enc["proj_dim"]) != (cfg["query_len"],
                                               cfg["proj_dim"]):
        raise ValueError("the encoder's query_len and proj_dim must be the "
                         "index's")
    inp = flat.inputs(cfg, seed, device)
    pool, lq = cfg["query_pool"], cfg["query_len"]
    gen = corpus.generator(seed, device, POOL_STREAM)
    ids = torch.randint(0, enc["backbone"]["vocab"], (pool, lq),
                        generator=gen, device=device)
    lengths = torch.randint(cfg["query_tokens_min"], lq + 1, (pool, 1),
                            generator=gen, device=device)
    mask = torch.arange(lq, device=device) < lengths
    tokens = torch.where(mask, ids, 0)
    inp.pool = (tokens.cpu().numpy(), mask.cpu().numpy(),
                torch.zeros((pool, lq)).numpy())
    inp.seed, inp.device = int(seed), device
    return inp


def system(cfg, inp):
    return flat.system(cfg, inp)


def encoder(cfg, inp):
    """The port's query encoder as ``(tokens, mask) -> (embeddings (B, Lq,
    D) float32, mask, salience)``; its ``weights`` are the module's
    parameters."""
    from repro_torch.models import transformer
    from repro_torch.models.colpali import ColPaliConfig, ColPaliEncoder
    enc_cfg = cfg["encoder"]
    ccfg = ColPaliConfig(
        **{**enc_cfg, "backbone": transformer.LMConfig(**enc_cfg["backbone"])})
    enc = ColPaliEncoder(ccfg, device=inp.device)
    w = draw_weights(cfg, inp.seed, inp.device)
    per_layer = {"wq": "attn.wq", "wk": "attn.wk", "wv": "attn.wv",
                 "wo": "attn.wo", "bq": "attn.bq", "bk": "attn.bk",
                 "bv": "attn.bv", "w_gate": "ffn.w_gate", "w_up": "ffn.w_up",
                 "w_down": "ffn.w_down", "ln1": "ln1.weight",
                 "ln2": "ln2.weight"}
    params = {"backbone.embed": w["embed"],
              "backbone.ln_f.weight": w["ln_f"],
              "out_proj": w["out_proj"], "patch_proj": w["patch_proj"]}
    for leaf, name in per_layer.items():
        if leaf in w:
            for i, t in enumerate(w[leaf]):
                params[f"backbone.blocks.{i}.{name}"] = t
    transformer.load_params(enc, params)
    del w, params

    def encode(tokens, mask):
        e, sal = enc.encode_query(tokens, mask)
        return e, mask, sal
    encode.weights = tuple(enc.parameters())
    return encode


def costs(cfg, inp, b, q_valid):
    """The flat kind's search, and the encoder's work over the batch's
    valid tokens (``roofline.encoder_cost``): each valid token at position
    i attends to i + 1 keys, the valid tokens being a prefix."""
    out = flat.costs(cfg, inp, b, q_valid)
    enc = cfg["encoder"]
    bb = enc["backbone"]
    out["encoder"] = [roofline.encoder_cost(
        n_layers=bb["n_layers"], d_model=bb["d_model"],
        n_heads=bb["n_heads"], n_kv_heads=bb["n_kv_heads"],
        head_dim=bb["head_dim"] or bb["d_model"] // bb["n_heads"],
        d_ff=bb["d_ff"], proj_dim=enc["proj_dim"], b=b,
        lq=cfg["query_len"], tokens=sum(q_valid),
        attn_pairs=sum(v * (v + 1) // 2 for v in q_valid),
        bf16=bb["activation_dtype"] == "bfloat16")]
    return out


def launches(cfg, b, sms):
    return flat.launches(cfg, b, sms)


def reference(cfg, inp, device, tf32=False):
    """The plain reference; ``tf32`` asks for the control: the encoder one
    step below its activation dtype, the search in TF32."""
    enc = reference_encoded.EncoderReference(
        cfg["encoder"], draw_weights(cfg, inp.seed, device), lower=tf32)
    search = reference_flat.FlatReference(
        inp.codebook, inp.codes, inp.mask, inp.codes_full, inp.mask_full,
        rerank=cfg["rerank"], top_k=cfg["top_k"], tf32=tf32)
    return reference_encoded.EncodedFlatReference(enc, search)
