"""AdamW with optional int8-quantized moments, and the LR schedule.

The counterpart of ``repro.optim.optimizer``: warmup-cosine schedule,
global-norm clipping, decoupled weight decay, and int8 blockwise moments
(1 byte per entry with a float32 scale per row of the last axis).

Plain functions over dicts of named tensors (``{name: tensor}``), not
``torch.optim``: ``update`` returns new params and a new state and leaves
its inputs alone, so the train loop's non-finite guard can keep the old
and the new side by side and pick one (``train.loop.guard_nonfinite``).
A moment dict holds a tensor, or a ``QMoment`` for int8 moments, per
parameter name.

The scalars follow the reference's float32 arithmetic: the step is cast
to float32, and the schedule, the clip factor and the bias corrections
are float32 tensors (a Python double would round differently in the last
bits). ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Literal, NamedTuple, Tuple, Union

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: Literal["fp32", "int8"] = "fp32"
    param_dtype: Literal["fp32", "bf16"] = "fp32"


def _f32(x: float, like: Tensor) -> Tensor:
    """A 0-d float32 tensor of ``x`` on ``like``'s device."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def schedule(cfg: AdamWConfig, step: Tensor) -> Tensor:
    """Linear warmup -> cosine decay to min_lr_frac * lr, as a 0-d float32
    tensor."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


# --- int8 blockwise moment codec ------------------------------------------

class QMoment(NamedTuple):
    q: Tensor       # int8, same shape as the moment
    scale: Tensor   # float32, shape = moment.shape[:-1] + (1,)


def _quantize_moment(x: Tensor) -> QMoment:
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return QMoment(q, scale.to(torch.float32))


def _dequantize_moment(qm: QMoment) -> Tensor:
    return qm.q.to(torch.float32) * qm.scale


Moment = Union[Tensor, QMoment]


class AdamWState(NamedTuple):
    step: Tensor               # 0-d int32
    m: Dict[str, Moment]
    v: Dict[str, Moment]


def init(cfg: AdamWConfig, params: Dict[str, Tensor]) -> AdamWState:
    """Zero moments (float32, or int8 with scale 1e-12) for every param,
    on its device, and step 0."""
    def zero_like(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _quantize_moment(z) if cfg.moment_dtype == "int8" else z

    if not params:
        raise ValueError("init: no parameters")
    first = next(iter(params.values()))
    return AdamWState(
        torch.zeros((), dtype=torch.int32, device=first.device),
        {k: zero_like(p) for k, p in params.items()},
        {k: zero_like(p) for k, p in params.items()})


def global_norm(tree: Dict[str, Tensor]) -> Tensor:
    """sqrt of the sum of per-tensor sums of squares, in float32, summed in
    the dict's order."""
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Dict[str, Tensor], state: AdamWState,
           params: Dict[str, Tensor]
           ) -> Tuple[Dict[str, Tensor], AdamWState, Dict[str, Tensor]]:
    """One AdamW step. Returns (new_params, new_state, metrics {lr,
    grad_norm}); ``grads``, ``state.m`` and ``state.v`` are keyed as
    ``params``."""
    if set(grads) != set(params):
        raise KeyError(f"update: grads {sorted(set(grads) ^ set(params))} "
                       "do not match the params")
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    gnorm = global_norm(grads)
    clip = torch.clamp(_f32(cfg.clip_norm, gnorm)
                       / torch.clamp(gnorm, min=1e-12), max=1.0)
    bc1 = 1 - torch.pow(_f32(cfg.b1, stepf), stepf)
    bc2 = 1 - torch.pow(_f32(cfg.b2, stepf), stepf)

    new_p, new_m, new_v = {}, {}, {}
    for name, p in params.items():
        m, v = state.m[name], state.v[name]
        quantized = isinstance(m, QMoment)
        g = grads[name].to(torch.float32) * clip
        m_f = _dequantize_moment(m) if quantized else m
        v_f = _dequantize_moment(v) if quantized else v
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * g * g
        mh = m_f / bc1
        vh = v_f / bc2
        pf = p.to(torch.float32)
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
        new_p[name] = (pf - lr * delta).to(p.dtype)
        if quantized:
            new_m[name], new_v[name] = (_quantize_moment(m_f),
                                        _quantize_moment(v_f))
        else:
            new_m[name], new_v[name] = m_f, v_f
    metrics = {"lr": lr, "grad_norm": gnorm}
    return new_p, AdamWState(step, new_m, new_v), metrics


def state_specs(param_specs: Dict[str, tuple], cfg: AdamWConfig
                ) -> AdamWState:
    """Logical specs of the optimizer state, keyed as the params: each
    moment shards like its param; an int8 moment's ``q`` does too, and its
    per-row scale drops the last dim's sharding (its last dim is 1). The
    step is replicated."""
    def moment(spec):
        spec = tuple(spec)
        if cfg.moment_dtype == "int8":
            return QMoment(spec, spec[:-1] + (None,))
        return spec
    m = {k: moment(v) for k, v in param_specs.items()}
    return AdamWState((), m, dict(m))
