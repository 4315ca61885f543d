"""The plain references that decide ``correct``.

Each is plain PyTorch over the benchmark's own inputs: it imports nothing
of the port, calls none of the port's kernels, plain versions or test
helpers, and works out again everything the port derives from the inputs
(codes, pruning, binary codes, pruned floats, every stage). Float products
run in float32 with TF32 off, unless ``tf32`` asks for the control: the
same reference one precision lower (``lower``).

Ties keep the lower position, as one stable descending sort over the
whole candidate list does: a stage's candidates keep the order the stage
before ranked them in.
"""
from __future__ import annotations

import contextlib

import torch

# a masked doc slot's float score and a masked slot's Hamming similarity,
# the semantics of the paper's kernels (the late-interaction references
# of the original implementation)
NEG = -1e30
BINARY_MASKED = -(2 ** 20)
# elements of a block's broadcast temporary
BLOCK_ELEMS = 1 << 29


@contextlib.contextmanager
def fp32():
    """Float32 matmuls in full float32, whatever the process set."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def lower(x: torch.Tensor, tf32: bool) -> torch.Tensor:
    """x as a product's input: float32, or for the control rounded to
    TF32's 10-bit mantissa (to nearest), as the tensor cores read it; the
    products still accumulate in float32, on a card and on the CPU alike."""
    x = x.float().contiguous()
    if not tf32:
        return x
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """a @ b with both inputs in the reference's precision."""
    with fp32():
        return lower(a, tf32) @ lower(b, tf32)


def top_stable(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """The k best (scores, ids) per row, ties in the given order."""
    srt, sel = torch.sort(scores, dim=1, descending=True, stable=True)
    return srt[:, :k], torch.gather(ids, 1, sel[:, :k])


def set_max(table: torch.Tensor, present: torch.Tensor, fill):
    """For each query patch and page, the best table entry among the
    codes the page holds: table (B, Mq, C), present (n, C) bool -> (B, Mq,
    n); a page that holds no code gets ``fill``."""
    b, mq, c = table.shape
    n = present.shape[0]
    out = torch.empty((b, mq, n), dtype=table.dtype, device=table.device)
    step = max(1, BLOCK_ELEMS // max(1, b * mq * c))
    for s in range(0, n, step):
        pres = present[s:s + step]
        v = torch.where(pres[None, None], table[:, :, None, :], fill)
        out[:, :, s:s + step] = v.amax(dim=-1)
    return out


def presence(codes: torch.Tensor, mask: torch.Tensor, n_codes: int,
             rows: int = 1 << 18) -> torch.Tensor:
    """(N, n_codes) bool: which codes each page holds in a valid slot."""
    n = codes.shape[0]
    out = torch.zeros((n, n_codes + 1), dtype=torch.bool, device=codes.device)
    for s in range(0, n, rows):
        idx = torch.where(mask[s:s + rows].bool(),
                          codes[s:s + rows].long(), n_codes)
        out[s:s + rows].scatter_(1, idx, True)
    return out[:, :n_codes].contiguous()
