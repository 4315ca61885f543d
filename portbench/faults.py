"""Faults planted in the port's served path, to show that ``correct``
comes out false when the timed path is broken:

  stale    the search hands back the last answers it gave a batch of the
           same size: a state served unchanged
  half     the search answers the first half of the batch and hands those
           answers to the second half's rows
  altered  the kernel that produces the served scores leaves them 1e-4
           high (relative): the flat path's ADC kernel, the cascade's
           float stage (the port's plain versions, which run on the CPU)
  stale_row  the query encoder gives each batch's first query the
           embeddings it gave the batch before's first: a token's answer
           altered where it is produced (kinds with an encoder stage)

``planted(name, kind)`` plants one for the duration of a ``with`` block.
The CPU tests plant each at a tiny size; ``control.py --fault`` plants
one in a run at a cell's own size on the card.
"""
from __future__ import annotations

import contextlib

import torch

NAMES = ("stale", "half", "altered", "stale_row")


def _stale(search):
    last = {}

    def wrapped(self, state, query, *, k):
        out = search(self, state, query, k=k)
        b = out[0].shape[0]
        prev, last[b] = last.get(b), out
        return prev if prev is not None else out
    return wrapped


def _half(search):
    def wrapped(self, state, query, *, k):
        s, i = (t.clone() for t in search(self, state, query, k=k))
        h = s.shape[0] // 2
        s[s.shape[0] - h:], i[s.shape[0] - h:] = s[:h], i[:h]
        return s, i
    return wrapped


def _altered(fn):
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        if isinstance(out, tuple):
            s, p = out
            return torch.where(s > -1e29, s * (1 + 1e-4), s), p
        return out * (1 + 1e-4)
    return wrapped


def _stale_row(encode):
    last = []

    def wrapped(self, tokens, token_mask, *a, **kw):
        e, sal = encode(self, tokens, token_mask, *a, **kw)
        prev = last[0] if last else None
        last[:] = [e[0].clone()]
        if prev is not None:
            e = e.clone()
            e[0] = prev
        return e, sal
    return wrapped


def _site(name: str, kind: str):
    """The (owner, attribute, wrapper) a fault replaces."""
    if name in ("stale", "half"):
        from repro_torch.retrieval.retriever import Retriever
        return Retriever, "search", _stale if name == "stale" else _half
    if name == "altered":
        from repro_torch.kernels import maxsim, quantized_maxsim
        if kind in ("flat", "encoded_flat"):
            return quantized_maxsim, "quantized_maxsim_topk_plain", _altered
        return maxsim, "maxsim_plain", _altered
    if name == "stale_row":
        from repro_torch.models.colpali import ColPaliEncoder
        return ColPaliEncoder, "encode_query", _stale_row
    raise ValueError(f"unknown fault {name!r}; known: {NAMES}")


@contextlib.contextmanager
def planted(name: str, kind: str):
    owner, attr, wrap = _site(name, kind)
    orig = getattr(owner, attr)
    setattr(owner, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)
