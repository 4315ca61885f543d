"""Carry a built index across from host arrays.

``state_from_numpy`` turns the arrays of a flat ``RetrieverState`` —
keyed by the reference package's field names — into the port's state on
``device``, so the port searches exactly the index those arrays hold.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.index import FlatIndex
from repro_torch.device import resolve_device
from repro_torch.retrieval.base import RetrieverState

FLAT_STATE_KEYS = ("codebook", "codes", "mask", "doc_ids", "rerank_codes",
                   "rerank_mask")


def state_from_numpy(arrays: Dict[str, np.ndarray], *,
                     device="cuda") -> RetrieverState:
    """Flat-backend state from host arrays: ``codebook`` (K, D),
    ``codes``/``mask`` (N, Md') pruned, ``doc_ids`` (N,), and
    ``rerank_codes``/``rerank_mask`` (N, Md) unpruned."""
    missing = [k for k in FLAT_STATE_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"state_from_numpy: missing arrays {missing}")
    dev = resolve_device(device)
    t = {k: torch.from_numpy(np.array(arrays[k], copy=True)).to(dev)
         for k in FLAT_STATE_KEYS}
    codebook = t["codebook"].to(torch.float32)
    flat = FlatIndex(t["codes"], t["mask"].to(torch.bool), codebook,
                     t["doc_ids"].to(torch.int32))
    return RetrieverState(codebook, flat, t["rerank_codes"],
                          t["rerank_mask"].to(torch.bool))
