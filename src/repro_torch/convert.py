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

A segmented (mutated) structure holds its segments' fields under
``segments/<i>/<field>`` (``codes``, ``mask``, ``doc_ids``, or
``embeddings``, ``mask``, ``doc_ids``), one live-bit array per segment
under ``live/<i>``, and ``pos_of_id``; a Hamming member keeps ``bits``
beside them, and a cascade's members each sit under their stage prefix
(``flat/segments/0/codes``, ``flat/live/0``, ``flat/pos_of_id``, ...).
``pos_of_id`` marks a structure as segmented.

``state_to`` copies a built state of any backend to another device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from repro_torch.core.index import (FlatIndex, FloatFlatIndex, HammingIndex,
                                    SegmentedState)
from repro_torch.device import resolve_device
from repro_torch.retrieval.base import RetrieverState
from repro_torch.retrieval.cascade import STAGES, CascadeState
from repro_torch.retrieval.hamming import HammingState

SHARED_KEYS = ("codebook", "rerank_codes", "rerank_mask")
MEMBER_KEYS = {"flat": ("codes", "mask", "doc_ids"),
               "float_flat": ("embeddings", "mask", "doc_ids"),
               "hamming": ("codes", "mask", "doc_ids", "bits")}


def _payload(backend: str, get: Callable[[str], torch.Tensor],
             codebook: torch.Tensor, bits: int):
    """One index payload (a structure or a segment) from its fields."""
    ids = get("doc_ids").to(torch.int32)
    mask = get("mask").to(torch.bool)
    if backend == "flat":
        return FlatIndex(get("codes"), mask, codebook, ids)
    if backend == "float_flat":
        return FloatFlatIndex(get("embeddings").to(torch.float32), mask, ids)
    return HammingIndex(get("codes").to(torch.uint16), mask, ids, bits)


def _n_segments(arrays, prefix: str) -> int:
    n = 0
    while f"{prefix}live/{n}" in arrays:
        n += 1
    return n


def _needed(arrays, backend: str, prefix: str) -> List[str]:
    """The keys one member's structure needs under ``prefix``."""
    fields = [f for f in MEMBER_KEYS[backend] if f != "bits"]
    extra = ["bits"] if backend == "hamming" else []
    if f"{prefix}pos_of_id" not in arrays:
        return [prefix + f for f in fields + extra]
    return ([f"{prefix}segments/{i}/{f}"
             for i in range(max(_n_segments(arrays, prefix), 1))
             for f in fields]
            + [f"{prefix}{f}" for f in ["pos_of_id", *extra]])


def _member(backend: str, arrays, prefix: str,
            get: Callable[[str], torch.Tensor], codebook: torch.Tensor):
    """One backend's structure from its fields under ``prefix``:
    monolithic, or segmented when ``pos_of_id`` is among them."""
    bits = int(arrays[prefix + "bits"]) if backend == "hamming" else 0
    if f"{prefix}pos_of_id" not in arrays:
        structure = _payload(backend, lambda f: get(prefix + f), codebook,
                             bits)
    else:
        n_seg = _n_segments(arrays, prefix)
        segments = tuple(
            _payload(backend, lambda f, i=i: get(f"{prefix}segments/{i}/{f}"),
                     codebook, bits) for i in range(n_seg))
        live = tuple(get(f"{prefix}live/{i}").to(torch.bool)
                     for i in range(n_seg))
        structure = SegmentedState(segments, live,
                                   get(prefix + "pos_of_id").to(torch.int32))
    return HammingState(structure, bits) if backend == "hamming" \
        else structure


def state_from_numpy(arrays: Dict[str, np.ndarray], *, device="cuda",
                     backend: str = "flat") -> RetrieverState:
    """``backend``'s state from host arrays keyed as the module docstring
    says: ``codebook`` (K, D), pruned ``codes``/``mask`` (N, Md'),
    ``doc_ids`` (N,) and unpruned ``rerank_codes``/``rerank_mask``
    (N, Md) for ``flat``, and likewise for the others and for segmented
    structures."""
    if backend == "cascade":
        needed = [k for stage in STAGES
                  for k in _needed(arrays, stage, f"{stage}/")]
        needed += ["p1", "p2"]
    elif backend in MEMBER_KEYS:
        needed = _needed(arrays, backend, "")
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
        members = tuple(_member(stage, arrays, f"{stage}/", get, codebook)
                        for stage in STAGES)
        structure = CascadeState(members, int(arrays["p1"]),
                                 int(arrays["p2"]))
    else:
        structure = _member(backend, arrays, "", get, codebook)
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
