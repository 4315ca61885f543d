"""Carry a built index across from host arrays, or to another device, and
walk a state's leaves for the index files.

``state_from_numpy`` turns the arrays of a ``RetrieverState`` — keyed by
the reference package's field names — into the port's state on ``device``,
so the port searches exactly the index those arrays hold. Every backend
shares ``codebook``,
``rerank_codes`` and ``rerank_mask``; its own structure's fields come
beside them (a payload that carries a codebook, as ``FlatIndex``,
``IVFIndex`` and ``HNSWIndex`` do, takes the shared one):

  * ``flat``: ``codes``, ``mask``, ``doc_ids``;
  * ``float_flat``: ``embeddings``, ``mask``, ``doc_ids``;
  * ``hamming``: ``codes``, ``mask``, ``doc_ids``, and the knob ``bits``;
  * ``ivf``: ``routing_centroids``, ``bucket_codes``, ``bucket_mask``,
    ``bucket_valid``, ``bucket_doc_ids``, and the knob ``n_probe``;
  * ``hnsw``: ``doc_vecs``, ``neighbors``, ``entry``, ``node_level``,
    ``codes``, ``mask``, ``doc_ids``, and the knob ``ef_search``;
  * ``cascade``: each member's fields prefixed with its stage name
    (``hamming/codes``, ``flat/mask``, ``float_flat/embeddings``, ...),
    plus the budgets ``p1`` and ``p2``.

A segmented (mutated) structure holds its segments' fields under
``segments/<i>/<field>``, one live-bit array per segment under
``live/<i>``, and ``pos_of_id``; the knob stays beside them, and a
cascade's members each sit under their stage prefix
(``flat/segments/0/codes``, ``flat/live/0``, ``flat/pos_of_id``, ...).
``pos_of_id`` marks a structure as segmented.

``state_leaves`` lists a state's arrays in the order ``jax.tree_util``
flattens the reference's state, and ``state_from_leaves`` rebuilds a
state from such a list and a skeleton (``IndexBackend.state_template``):
the index files' leaf order. Named-tuple fields holding a Python int
(``HammingIndex.bits``, ``HNSWIndex.entry``) are 0-d int32 leaves, as in
the reference; ints of the wrapper dataclasses are knobs, not leaves.

``state_to`` copies a built state of any backend to another device.

``lm_params_from_numpy`` and ``colpali_params_from_numpy`` carry a model's
weights across: they take the reference's param dicts as host arrays
(nested dicts, or flat ``/``-joined keys: ``embed``, ``ln_f``, optional
``unembed``, the stacked ``blocks/...`` of shape (L, ...), and for the
encoder ``backbone/...``, ``patch_proj``, ``out_proj``) and return the
port's module on ``device``, each block taking its slice of the stack. A
missing, unexpected or misshapen array is rejected by name.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from repro_torch.core.graph import HNSWIndex
from repro_torch.core.index import (FlatIndex, FloatFlatIndex, HammingIndex,
                                    IVFIndex, SegmentedState)
from repro_torch.device import resolve_device
from repro_torch.models.colpali import ColPaliConfig, ColPaliEncoder
from repro_torch.models.transformer import LMConfig, Transformer
from repro_torch.retrieval.base import RetrieverState
from repro_torch.retrieval.cascade import STAGES, CascadeState
from repro_torch.retrieval.hamming import HammingState
from repro_torch.retrieval.hnsw import HNSWState
from repro_torch.retrieval.ivf import IVFState

SHARED_KEYS = ("codebook", "rerank_codes", "rerank_mask")
MEMBER_KEYS = {"flat": ("codes", "mask", "doc_ids"),
               "float_flat": ("embeddings", "mask", "doc_ids"),
               "hamming": ("codes", "mask", "doc_ids"),
               "ivf": ("routing_centroids", "bucket_codes", "bucket_mask",
                       "bucket_valid", "bucket_doc_ids"),
               "hnsw": ("doc_vecs", "neighbors", "entry", "node_level",
                        "codes", "mask", "doc_ids")}
# each wrapper backend's knob: its key and its state type
KNOBS = {"hamming": ("bits", HammingState), "ivf": ("n_probe", IVFState),
         "hnsw": ("ef_search", HNSWState)}


def _payload(backend: str, get: Callable[[str], torch.Tensor],
             arr: Callable[[str], np.ndarray], codebook: torch.Tensor,
             bits: int):
    """One index payload (a structure or a segment) from its fields."""
    if backend == "ivf":
        return IVFIndex(get("routing_centroids").to(torch.float32),
                        get("bucket_codes"),
                        get("bucket_mask").to(torch.bool),
                        get("bucket_valid").to(torch.bool),
                        get("bucket_doc_ids").to(torch.int32), codebook)
    ids = get("doc_ids").to(torch.int32)
    mask = get("mask").to(torch.bool)
    if backend == "flat":
        return FlatIndex(get("codes"), mask, codebook, ids)
    if backend == "float_flat":
        return FloatFlatIndex(get("embeddings").to(torch.float32), mask, ids)
    if backend == "hnsw":
        return HNSWIndex(get("doc_vecs").to(torch.float32),
                         get("neighbors").to(torch.int32), int(arr("entry")),
                         get("node_level").to(torch.int32), get("codes"),
                         mask, ids, codebook)
    return HammingIndex(get("codes").to(torch.uint16), mask, ids, bits)


def _n_segments(arrays, prefix: str, first: str) -> int:
    """The segment count: segment i is there while its live bits or its
    ``first`` field is."""
    n = 0
    while (f"{prefix}live/{n}" in arrays
           or f"{prefix}segments/{n}/{first}" in arrays):
        n += 1
    return n


def _needed(arrays, backend: str, prefix: str) -> List[str]:
    """The keys one member's structure needs under ``prefix``."""
    fields = list(MEMBER_KEYS[backend])
    extra = [KNOBS[backend][0]] if backend in KNOBS else []
    if f"{prefix}pos_of_id" not in arrays:
        return [prefix + f for f in fields + extra]
    return ([f"{prefix}{key}"
             for i in range(max(_n_segments(arrays, prefix, fields[0]), 1))
             for key in (*(f"segments/{i}/{f}" for f in fields), f"live/{i}")]
            + [f"{prefix}{f}" for f in ["pos_of_id", *extra]])


def _member(backend: str, arrays, prefix: str,
            get: Callable[[str], torch.Tensor], codebook: torch.Tensor):
    """One backend's structure from its fields under ``prefix``:
    monolithic, or segmented when ``pos_of_id`` is among them."""
    knob = int(arrays[prefix + KNOBS[backend][0]]) if backend in KNOBS \
        else 0
    bits = knob if backend == "hamming" else 0
    if f"{prefix}pos_of_id" not in arrays:
        structure = _payload(backend, lambda f: get(prefix + f),
                             lambda f: arrays[prefix + f], codebook, bits)
    else:
        n_seg = _n_segments(arrays, prefix, MEMBER_KEYS[backend][0])
        segments = tuple(
            _payload(backend,
                     lambda f, i=i: get(f"{prefix}segments/{i}/{f}"),
                     lambda f, i=i: arrays[f"{prefix}segments/{i}/{f}"],
                     codebook, bits) for i in range(n_seg))
        live = tuple(get(f"{prefix}live/{i}").to(torch.bool)
                     for i in range(n_seg))
        structure = SegmentedState(segments, live,
                                   get(prefix + "pos_of_id").to(torch.int32))
    return KNOBS[backend][1](structure, knob) if backend in KNOBS \
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


def _host(t) -> np.ndarray:
    """A tensor (or int) as a contiguous host array of the same dtype."""
    if isinstance(t, torch.Tensor):
        return np.ascontiguousarray(t.detach().cpu().numpy())
    return np.asarray(t, np.int32)


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _walk(node, leaf: Callable, int_leaf: Callable):
    """Rebuild ``node`` with each tensor slot (a tensor or None) mapped by
    ``leaf`` and each named-tuple int by ``int_leaf``, in the reference's
    flatten order; dataclass ints (knobs) are kept."""
    if node is None or isinstance(node, torch.Tensor):
        return leaf(node)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(int_leaf(v) if _is_int(v)
                            else _walk(v, leaf, int_leaf) for v in node))
    if isinstance(node, tuple):
        return tuple(_walk(v, leaf, int_leaf) for v in node)
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **{
            f.name: _walk(getattr(node, f.name), leaf, int_leaf)
            for f in dataclasses.fields(node)
            if not _is_int(getattr(node, f.name))})
    raise TypeError(f"not a state node: {type(node).__name__}")


def state_leaves(state: RetrieverState) -> List[np.ndarray]:
    """The state's arrays on the host, in the reference's flatten order."""
    out: List[np.ndarray] = []

    def collect(v):
        out.append(_host(v))
        return v

    _walk(state, collect, collect)
    return out


def n_leaves(template: RetrieverState) -> int:
    """The leaf count of a state skeleton."""
    out = [0]

    def count(v):
        out[0] += 1
        return v

    _walk(template, count, count)
    return out[0]


def state_from_leaves(template: RetrieverState, leaves: List[np.ndarray],
                      device) -> RetrieverState:
    """The state of ``template``'s structure whose leaves, in order, are
    ``leaves`` (host arrays), on ``device``."""
    it = iter(leaves)

    def tensor(_):
        a = np.ascontiguousarray(next(it))
        if not a.flags.writeable:       # a tensor must own writable memory
            a = a.copy()
        return torch.from_numpy(a).to(device)

    def integer(_):
        return int(next(it))

    return _walk(template, tensor, integer)


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


# ---------------------------------------------------------------------------
# model weights
# ---------------------------------------------------------------------------

def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays -> {"a/b/c": array}."""
    if not isinstance(tree, dict):
        return {prefix.rstrip("/"): tree}
    out = {}
    for key, val in tree.items():
        out.update(_flatten(val, f"{prefix}{key}/"))
    return out


def _reference_path(name: str):
    """A port parameter name -> (the reference's key, layer index or None):
    ``backbone.blocks.3.attn.wq`` -> (``backbone/blocks/attn/wq``, 3);
    a norm's ``.weight`` is the reference's bare key (``ln_f``)."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts = parts[:-1]
    layer = None
    if "blocks" in parts:
        at = parts.index("blocks")
        layer = int(parts.pop(at + 1))
    return "/".join(parts), layer


def _load_module(module: torch.nn.Module, tree, what: str):
    arrays = _flatten(tree)
    params = dict(module.named_parameters())
    wanted = {}
    for name, param in params.items():
        key, layer = _reference_path(name)
        wanted.setdefault(key, []).append((layer, param))
    missing = sorted(set(wanted) - set(arrays))
    if missing:
        raise KeyError(f"{what}: missing arrays {missing}")
    extra = sorted(set(arrays) - set(wanted))
    if extra:
        raise KeyError(f"{what}: unexpected arrays {extra}")
    for key, targets in wanted.items():
        arr = np.asarray(arrays[key])
        layers = [layer for layer, _ in targets]
        shape = targets[0][1].shape
        want = shape if layers == [None] else (len(layers), *shape)
        if arr.shape != tuple(want):
            raise ValueError(f"{what}: {key} has shape {arr.shape}, "
                             f"expected {tuple(want)}")
        with torch.no_grad():
            for layer, param in targets:
                part = arr if layer is None else arr[layer]
                param.copy_(torch.from_numpy(np.array(part, copy=True)))
    return module


def lm_params_from_numpy(tree, cfg: LMConfig, *, device="cuda"
                         ) -> Transformer:
    """The reference's LM params (``repro.models.transformer.init``'s
    tree, as host arrays) -> the port's ``Transformer`` on ``device``."""
    return _load_module(Transformer(cfg, device=device), tree,
                        "lm_params_from_numpy")


def colpali_params_from_numpy(tree, cfg: ColPaliConfig, *, device="cuda"
                              ) -> ColPaliEncoder:
    """The reference's encoder params (``repro.models.colpali.init``'s
    tree, as host arrays) -> the port's ``ColPaliEncoder`` on ``device``."""
    return _load_module(ColPaliEncoder(cfg, device=device), tree,
                        "colpali_params_from_numpy")
