"""Planted TORCH04 fixture: bare topk off the scan path (never run)."""
import torch


def best(scores):
    return torch.topk(scores, 5)


def best_method(scores):
    return scores.topk(3, dim=-1)


def best_guarded(scores):
    return torch.topk(scores, 1)  # noqa: TORCH04 - k=1 <= any input length
