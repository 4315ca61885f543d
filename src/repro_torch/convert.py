"""Carry a built index across from host arrays, or to another device.

``state_from_numpy`` turns the arrays of a ``RetrieverState`` — keyed by
the reference package's field names — into the port's state on ``device``,
so the port searches exactly the index those arrays hold. Every backend
shares ``codebook``, ``rerank_codes`` and ``rerank_mask``; its own
structure's fields come beside them:

  * ``flat``: ``codes``, ``mask``, ``doc_ids`` (the flat index; the
    codebook is the shared one);
  * ``float_flat``: ``embeddings``, ``mask``, ``doc_ids``;
  * ``hamming``: ``codes``, ``mask``, ``doc_ids``, ``bits``;
  * ``cascade``: each member's fields prefixed with its stage name
    (``hamming/codes``, ``flat/mask``, ``float_flat/embeddings``, ...),
    plus the budgets ``p1`` and ``p2``.

``state_to`` copies a built state of any backend to another device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.core.index import FlatIndex, FloatFlatIndex, HammingIndex
from repro_torch.device import resolve_device
from repro_torch.retrieval.base import RetrieverState
from repro_torch.retrieval.cascade import STAGES, CascadeState
from repro_torch.retrieval.hamming import HammingState

SHARED_KEYS = ("codebook", "rerank_codes", "rerank_mask")
MEMBER_KEYS = {"flat": ("codes", "mask", "doc_ids"),
               "float_flat": ("embeddings", "mask", "doc_ids"),
               "hamming": ("codes", "mask", "doc_ids", "bits")}


def _member(backend: str, get: Callable[[str], torch.Tensor],
            codebook: torch.Tensor):
    """One backend's structure from its fields (``get(field)``)."""
    ids = get("doc_ids").to(torch.int32)
    mask = get("mask").to(torch.bool)
    if backend == "flat":
        return FlatIndex(get("codes"), mask, codebook, ids)
    if backend == "float_flat":
        return FloatFlatIndex(get("embeddings").to(torch.float32), mask, ids)
    bits = int(get("bits"))
    return HammingState(HammingIndex(get("codes").to(torch.uint16), mask,
                                     ids, bits), bits)


def state_from_numpy(arrays: Dict[str, np.ndarray], *, device="cuda",
                     backend: str = "flat") -> RetrieverState:
    """``backend``'s state from host arrays keyed as the module docstring
    says: ``codebook`` (K, D), pruned ``codes``/``mask`` (N, Md'),
    ``doc_ids`` (N,) and unpruned ``rerank_codes``/``rerank_mask``
    (N, Md) for ``flat``, and likewise for the others."""
    if backend == "cascade":
        needed = [f"{stage}/{field}" for stage in STAGES
                  for field in MEMBER_KEYS[stage]] + ["p1", "p2"]
    elif backend in MEMBER_KEYS:
        needed = list(MEMBER_KEYS[backend])
    else:
        raise ValueError(f"state_from_numpy: unknown backend {backend!r}")
    missing = [k for k in (*SHARED_KEYS, *needed) if k not in arrays]
    if missing:
        raise KeyError(f"state_from_numpy: missing arrays {missing}")
    dev = resolve_device(device)

    def get(key: str) -> torch.Tensor:
        return torch.from_numpy(np.array(arrays[key], copy=True)).to(dev)

    codebook = get("codebook").to(torch.float32)
    if backend == "cascade":
        members = tuple(_member(stage, lambda f, s=stage: get(f"{s}/{f}"),
                                codebook) for stage in STAGES)
        structure = CascadeState(members, int(arrays["p1"]),
                                 int(arrays["p2"]))
    else:
        structure = _member(backend, get, codebook)
    return RetrieverState(codebook, structure, get("rerank_codes"),
                          get("rerank_mask").to(torch.bool))


def state_to(state: Any, device) -> Any:
    """A copy of ``state`` (tensors inside named tuples, dataclasses and
    tuples, at any depth) with every tensor on ``device``."""
    if isinstance(state, torch.Tensor):
        return state.to(device)
    if isinstance(state, tuple):
        moved = [state_to(x, device) for x in state]
        return type(state)(*moved) if hasattr(state, "_fields") else \
            tuple(moved)
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{
            f.name: state_to(getattr(state, f.name), device)
            for f in dataclasses.fields(state)})
    return state
