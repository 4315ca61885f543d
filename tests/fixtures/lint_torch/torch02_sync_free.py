"""Planted TORCH02 fixture: host syncs in declared sync-free bodies."""
import torch


def _merge(top_s: torch.Tensor, s: torch.Tensor, k: int):
    worst = s.min().item()
    n = int(top_s)
    torch.cuda.synchronize()
    ok = int(k)
    return worst, n, ok


def moe_route(probs: torch.Tensor):
    return probs.tolist()  # noqa: TORCH02 - fixture: a debugging dump


def not_declared(x: torch.Tensor):
    return x.item()
