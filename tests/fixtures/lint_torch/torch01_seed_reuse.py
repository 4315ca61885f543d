"""Planted TORCH01 fixture: one seed seeds two generators (never run)."""
import torch


def draws(seed):
    a = torch.Generator().manual_seed(seed)
    b = torch.Generator("cuda").manual_seed(seed)
    return a, b


def derived(seed):
    a = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)  # noqa: TORCH01 - the global stream is unused
    return a
