"""Clean TORCH fixture: every rule's pattern done right (never run)."""
import torch


def draws(seed):
    a = torch.Generator().manual_seed(seed)
    b = torch.Generator().manual_seed(seed + 1)
    return torch.randn(4, generator=a), torch.randn(4, generator=b)


def _merge(top_s: torch.Tensor, s: torch.Tensor, k: int):
    cat = torch.cat([top_s, s], dim=1)
    return torch.sort(cat, dim=1, descending=True, stable=True)[0][:, :k]


async def respond(loop, fn, scores):
    return await loop.run_in_executor(None, fn, scores)
