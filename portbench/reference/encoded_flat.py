"""The plain reference of the ``encoded_flat`` configuration: a query
encoder in front of the ``flat`` index.

``EncoderReference.encode`` is the dense decoder the configuration states,
written from its equations over the benchmark's own weights (the stacked
leaves ``kinds.encoded_flat.draw_weights`` draws): the token ids' rows of
the embedding; per layer a pre-norm block, RMSNorm (x / sqrt(mean(x^2) +
eps) * w), causal GQA attention with the q/k/v biases and RoPE over split
halves (query head h reads kv head h // (heads / kv heads)), softmax over
the scores / sqrt(head_dim), the output projection, a residual add, then
RMSNorm, the SwiGLU FFN (silu(x Wg) * (x Wu)) Wd and a residual add; a
last RMSNorm; the output projection to ``proj_dim``; each row L2
normalised (its norm at least 1e-6) and zeroed where the mask is False.
Padded tokens still attend, as in the port; they sit after the valid ones,
so no valid token reads them. Every product is float32 with TF32 off.

``lower`` asks for the control: every product's two inputs rounded one
step below the configuration's activation dtype, the products still
accumulated in float32: for bfloat16, to float8 e4m3 under a scale per
tensor (per weight matrix, per activation) that maps its largest
magnitude to e4m3's largest finite value, as fp8 products are run; for
float32, to TF32 (``reference.lower``).

``EncodedFlatReference`` judges the search apart from the encoder: its
``search`` and ``exact`` take embeddings (the ones the port served) and
are ``reference.flat``'s.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import fp32, lower as tf32_lower
from portbench.reference.flat import FlatReference

# e4m3's largest finite magnitude
E4M3_MAX = 448.0
# the weights that are a product's input (the rest are added, scaled by or
# looked up)
PRODUCT_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                   "out_proj")


def fp8(x: torch.Tensor, dims) -> torch.Tensor:
    """x rounded to float8 e4m3 (to nearest) under a scale per slice over
    ``dims`` that maps the slice's largest magnitude to ``E4M3_MAX``; back
    in float32 at x's scale."""
    x = x.float()
    scale = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class EncoderReference:
    """``encode(tokens (B, S), mask (B, S)) -> (B, S, proj_dim) float32``.

    ``enc``: the configuration's ``encoder`` block (its ``backbone`` and
    ``proj_dim``); ``w``: the stacked weights; ``lower``: the control."""

    def __init__(self, enc: dict, w: dict, *, lower: bool = False):
        bb = enc["backbone"]
        if bb.get("n_experts", 0) or bb.get("attn_chunk", 0):
            raise NotImplementedError(
                "the encoder reference is the dense decoder: no experts, "
                "no chunked-local attention")
        self.n_layers, self.d = bb["n_layers"], bb["d_model"]
        self.heads, self.kv = bb["n_heads"], bb["n_kv_heads"]
        self.hd = bb["head_dim"] or self.d // self.heads
        self.theta, self.eps = float(bb["rope_theta"]), float(bb["norm_eps"])
        self.bias = bool(bb["qkv_bias"])
        self.mode = None
        if lower:
            self.mode = ("fp8" if bb["activation_dtype"] == "bfloat16"
                         else "tf32")
        self.w = {k: self._weight(v) if k in PRODUCT_WEIGHTS else v.float()
                  for k, v in w.items()}

    def _weight(self, m: torch.Tensor) -> torch.Tensor:
        """A product's weight (a matrix, or one a layer) in the reference's
        precision, rounded once."""
        if self.mode == "fp8":
            return fp8(m, (-2, -1))
        return tf32_lower(m, self.mode == "tf32")

    def _mm(self, a: torch.Tensor, b: torch.Tensor, rhs_ready: bool = False
            ) -> torch.Tensor:
        """a @ b in float32, both inputs in the reference's precision (b
        already rounded where ``rhs_ready``)."""
        def low(x):
            if self.mode == "fp8":
                return fp8(x, tuple(range(x.dim())))
            return tf32_lower(x, self.mode == "tf32")
        with fp32():
            return low(a) @ (b if rhs_ready else low(b))

    def _norm(self, x, w):
        return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True)
                               + self.eps) * w

    def _rope(self, x, pos):
        """x (B, S, H, hd) rotated by split halves, angles in float32."""
        half = self.hd // 2
        freqs = 1.0 / (self.theta ** (torch.arange(
            half, dtype=torch.float32, device=x.device) / half))
        ang = pos[:, None].float() * freqs                  # (S, hd/2)
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def _attention(self, h, layer, pos, causal):
        w, b, s = self.w, h.shape[0], h.shape[1]
        q = self._mm(h, w["wq"][layer], True)
        k = self._mm(h, w["wk"][layer], True)
        v = self._mm(h, w["wv"][layer], True)
        if self.bias:
            q, k, v = (q + w["bq"][layer], k + w["bk"][layer],
                       v + w["bv"][layer])
        q = self._rope(q.view(b, s, self.heads, self.hd), pos)
        k = self._rope(k.view(b, s, self.kv, self.hd), pos)
        v = v.view(b, s, self.kv, self.hd)
        g = self.heads // self.kv
        k = k.repeat_interleave(g, dim=2).transpose(1, 2)    # (B, H, S, hd)
        v = v.repeat_interleave(g, dim=2).transpose(1, 2)
        scores = self._mm(q.transpose(1, 2), k.transpose(-1, -2))
        scores = (scores / math.sqrt(self.hd)).masked_fill(~causal, -1e30)
        out = self._mm(torch.softmax(scores, dim=-1), v)     # (B, H, S, hd)
        out = out.transpose(1, 2).reshape(b, s, self.heads * self.hd)
        return self._mm(out, w["wo"][layer], True)

    def encode(self, tokens: torch.Tensor, mask: torch.Tensor
               ) -> torch.Tensor:
        w = self.w
        s = tokens.shape[1]
        pos = torch.arange(s, device=tokens.device)
        causal = torch.ones((s, s), dtype=torch.bool,
                            device=tokens.device).tril_()
        x = w["embed"][tokens.long()]
        for layer in range(self.n_layers):
            x = x + self._attention(self._norm(x, w["ln1"][layer]), layer,
                                    pos, causal)
            h = self._norm(x, w["ln2"][layer])
            gate = self._mm(h, w["w_gate"][layer], True)
            up = self._mm(h, w["w_up"][layer], True)
            x = x + self._mm(torch.nn.functional.silu(gate) * up,
                             w["w_down"][layer], True)
        e = self._mm(self._norm(x, w["ln_f"]), w["out_proj"], True)
        e = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True).clamp_min(
            1e-6)
        return e * mask[..., None].float()


class EncodedFlatReference:
    """``encode`` (the encoder reference), and ``search`` / ``exact`` of
    ``reference.flat`` on the embeddings they are given."""

    def __init__(self, encoder: EncoderReference, flat: FlatReference):
        self.encoder, self.flat = encoder, flat

    def encode(self, tokens, mask):
        return self.encoder.encode(tokens, mask)

    def search(self, q, qm):
        return self.flat.search(q, qm)

    def exact(self, q, qm, ids):
        return self.flat.exact(q, qm, ids)
