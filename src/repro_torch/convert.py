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

``lm_params_from_numpy``, ``colpali_params_from_numpy``,
``recsys_params_from_numpy`` and ``pna_params_from_numpy`` carry a
model's weights across: they take the reference's param dicts as host arrays
(nested dicts, or flat ``/``-joined keys: ``embed``, ``ln_f``, optional
``unembed``, the stacked ``blocks/...`` of shape (L, ...) (a MoE layer's
``blocks/moe/router``, ``blocks/moe/w_gate`` (L, E, D, F), ...,
``blocks/moe/shared/...``), and for the encoder ``backbone/...``,
``patch_proj``, ``out_proj``; the recsys and PNA trees' lists of dicts,
``tables[i]``, ``bot[i]['w']``, ``layers[i]['pre'][0]['b']``) and return
the port's module on ``device``, each block taking its slice of the stack
(a list item is the parameter ``<name>.<i>``). A
missing, unexpected or misshapen array is rejected by name.

The way back: ``params_to_numpy`` turns a module, or a dict of named
tensors (``transformer.params_of``), into the reference's tree, the
blocks' tensors stacked on a leading layer axis, and ``params_from_numpy``
takes such a tree to a dict of named tensors shaped as a given one.
``adamw_state_to_numpy``/``adamw_state_from_numpy`` do the same for an
``AdamWState`` (float32 moments or int8 ``QMoment`` ones, named as the
params). ``train_tree`` (params, optimizer state) is the tree the
training checkpoints hold, ``train_template`` its shapes without the
data, and ``train_state_from_tree`` the way back from a restored one:
the keys, dtypes and stacked shapes of the reference's
``(params, AdamWState)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import ArraySpec, numpy_dtype

from repro_torch.core.graph import HNSWIndex
from repro_torch.core.index import (FlatIndex, FloatFlatIndex, HammingIndex,
                                    IVFIndex, SegmentedState)
from repro_torch.device import resolve_device
from repro_torch.models.colpali import ColPaliConfig, ColPaliEncoder
from repro_torch.models.gnn import PNAConfig, PNAModel
from repro_torch.models.recsys import RecsysConfig, RecsysModel
from repro_torch.models.transformer import LMConfig, Transformer
from repro_torch.optim.optimizer import AdamWState, QMoment
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
    """A nested dict (or list) of arrays -> {"a/b/c": array}, a list's
    items keyed by their index ("bot/0/w")."""
    if isinstance(tree, list):
        tree = {str(i): v for i, v in enumerate(tree)}
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


def _by_reference_key(names) -> Dict[str, List[Tuple[Optional[int], str]]]:
    """Port parameter names grouped by the reference key they map to, each
    group as (layer or None, name) in layer order."""
    groups: Dict[str, List[Tuple[Optional[int], str]]] = {}
    for name in names:
        key, layer = _reference_path(name)
        groups.setdefault(key, []).append((layer, name))
    for key, items in groups.items():
        layers = [layer for layer, _ in items]
        if layers != [None] and sorted(layers) != list(range(len(layers))):
            raise ValueError(f"{key}: layers {layers} are not 0..L-1 "
                             "once each")
        items.sort(key=lambda t: t[0])
    return groups


def _listify(node):
    """Dicts keyed "0".."n-1" -> lists, at any depth: the reference's
    list-of-dict trees (``tables[i]``, ``layers[i]['pre'][j]['w']``)."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and sorted(out) == sorted(str(i) for i in range(len(out))):
        return [out[str(i)] for i in range(len(out))]
    return out


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"a/b": x, "c/0/w": y} -> {"a": {"b": x}, "c": [{"w": y}]}."""
    out: Dict[str, Any] = {}
    for key, val in flat.items():
        node = out
        *head, last = key.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = val
    return _listify(out)


def _lookup(tree, key: str):
    node = tree
    for part in key.split("/"):
        if isinstance(node, list) and part.isdigit() \
                and int(part) < len(node):
            node = node[int(part)]
        elif isinstance(node, dict) and part in node:
            node = node[part]
        else:
            raise KeyError(f"the tree has no array {key}")
    return node


def _reference_tree(named: Dict[str, Any], leaf: Callable) -> Dict[str, Any]:
    """Named per-layer values -> the reference's nested tree; ``leaf(xs,
    stacked)`` builds each leaf from its group's values in layer order."""
    return _nest({key: leaf([named[n] for _, n in items],
                            items[0][0] is not None)
                  for key, items in _by_reference_key(named).items()})


def _host_leaf(xs: list, stacked: bool):
    """Tensors (one per layer, or one) -> a host array, stacked on a
    leading axis; each tensor is copied off its device straight into the
    array. QMoments field by field."""
    if isinstance(xs[0], QMoment):
        return QMoment(*(_host_leaf([getattr(x, f) for x in xs], stacked)
                         for f in QMoment._fields))
    first = xs[0]
    shape = ((len(xs), *first.shape) if stacked else tuple(first.shape))
    out = np.empty(shape, dtype=numpy_dtype(first.dtype))
    view = torch.from_numpy(out)
    for i, x in enumerate(xs):
        (view[i] if stacked else view).copy_(x.detach())
    return out


def _spec_leaf(xs: list, stacked: bool):
    if isinstance(xs[0], QMoment):
        return QMoment(*(_spec_leaf([getattr(x, f) for x in xs], stacked)
                         for f in QMoment._fields))
    first = xs[0]
    shape = ((len(xs), *first.shape) if stacked else tuple(first.shape))
    return ArraySpec(shape, numpy_dtype(first.dtype))


def _named(params) -> Dict[str, Any]:
    if isinstance(params, torch.nn.Module):
        return {n: p.detach() for n, p in params.named_parameters()}
    return dict(params)


def params_to_numpy(params) -> Dict[str, Any]:
    """A port module, or its dict of named tensors, -> the reference's
    param tree as host arrays (``transformer.init``'s or
    ``colpali.init``'s structure, the blocks stacked as (L, ...)): the
    inverse of ``lm_params_from_numpy``/``colpali_params_from_numpy``."""
    return _reference_tree(_named(params), _host_leaf)


def _tensor_from(arr, shape, dtype, device, what: str) -> torch.Tensor:
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {arr.shape}, expected "
                         f"{tuple(shape)}")
    arr = np.require(arr, requirements="C")
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def _unstack(tree, like: Dict[str, torch.Tensor], device, take: Callable
             ) -> Dict[str, Any]:
    """For each name of ``like``, ``take(node, layer, name, device)`` over
    its reference node; ``device`` None means ``like[name]``'s device."""
    dev = None if device is None else resolve_device(device)
    out = {}
    for key, items in _by_reference_key(like).items():
        node = _lookup(tree, key)
        if items[0][0] is not None:
            for arr in (node if isinstance(node, QMoment) else (node,)):
                shape = np.shape(arr)
                if not shape or shape[0] != len(items):
                    raise ValueError(f"{key} has shape {shape}, expected "
                                     f"{len(items)} stacked layers")
        for layer, name in items:
            out[name] = take(node, layer, name,
                             like[name].device if dev is None else dev)
    return {name: out[name] for name in like}   # like's order: sums follow it


def _part(arr, layer):
    arr = np.asarray(arr)
    return arr if layer is None else arr[layer]


def params_from_numpy(tree, like: Dict[str, torch.Tensor], *, device=None
                      ) -> Dict[str, torch.Tensor]:
    """The reference's param tree (host arrays) -> a dict of named tensors
    with ``like``'s names, shapes and dtypes, on ``device`` (default: each
    ``like`` tensor's own device)."""
    return _unstack(tree, like, device, lambda node, layer, name, dev:
                    _tensor_from(_part(node, layer), like[name].shape,
                                 like[name].dtype, dev, name))


def adamw_state_to_numpy(state: AdamWState) -> AdamWState:
    """An ``AdamWState`` -> the reference's, as host arrays: ``step`` 0-d
    int32, the moments as param trees (``QMoment`` leaves for int8)."""
    return AdamWState(_host_leaf([state.step], False),
                      _reference_tree(state.m, _host_leaf),
                      _reference_tree(state.v, _host_leaf))


def adamw_state_from_numpy(tree: AdamWState, like: Dict[str, torch.Tensor],
                           *, device=None) -> AdamWState:
    """The reference's ``AdamWState`` (host arrays) -> the port's, with the
    moments named as the params ``like`` and on their devices (or
    ``device``); a ``QMoment`` leaf gives int8 moments."""
    def moment(node, layer, name, dev):
        shape = tuple(like[name].shape)
        if isinstance(node, QMoment):
            return QMoment(
                _tensor_from(_part(node.q, layer), shape, torch.int8, dev,
                             f"{name}.q"),
                _tensor_from(_part(node.scale, layer), shape[:-1] + (1,),
                             torch.float32, dev, f"{name}.scale"))
        return _tensor_from(_part(node, layer), shape, torch.float32, dev,
                            name)

    first = next(iter(like.values()))
    step = _tensor_from(tree.step, (), torch.int32,
                        first.device if device is None
                        else resolve_device(device), "step")
    return AdamWState(step, _unstack(tree.m, like, device, moment),
                      _unstack(tree.v, like, device, moment))


def train_tree(params: Dict[str, torch.Tensor], state: AdamWState) -> tuple:
    """(params, optimizer state) as the reference's ``(params,
    AdamWState)`` of host arrays: what a training checkpoint holds."""
    return (params_to_numpy(params), adamw_state_to_numpy(state))


def train_template(params: Dict[str, torch.Tensor], state: AdamWState
                   ) -> tuple:
    """``train_tree``'s structure with ``ArraySpec`` leaves (no copies):
    the template ``ckpt.checkpoint.restore`` checks a checkpoint
    against."""
    return (_reference_tree(_named(params), _spec_leaf),
            AdamWState(ArraySpec((), np.dtype(np.int32)),
                       _reference_tree(state.m, _spec_leaf),
                       _reference_tree(state.v, _spec_leaf)))


def train_state_from_tree(tree: tuple, like: Dict[str, torch.Tensor], *,
                          device=None) -> Tuple[Dict[str, torch.Tensor],
                                                AdamWState]:
    """A restored ``train_tree`` -> (params, optimizer state) named and
    shaped as the params ``like``, on their devices (or ``device``)."""
    return (params_from_numpy(tree[0], like, device=device),
            adamw_state_from_numpy(tree[1], like, device=device))


def _load_module(module: torch.nn.Module, tree, what: str):
    own = _named(module)
    extra = sorted(set(_flatten(tree)) - set(_by_reference_key(own)))
    if extra:
        raise KeyError(f"{what}: unexpected arrays {extra}")
    # host views of the arrays, copied once into the module's own weights
    with torch.no_grad():
        for name, t in params_from_numpy(tree, own, device="cpu").items():
            own[name].copy_(t)
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


def recsys_params_from_numpy(tree, cfg: RecsysConfig, *, device="cuda"
                             ) -> RecsysModel:
    """The reference's recsys params (``repro.models.recsys.init``'s tree
    of lists: ``tables[i]``, ``bot[i]['w']``, ``gru1['wx']``, ... as host
    arrays) -> the port's ``RecsysModel`` on ``device``."""
    return _load_module(RecsysModel(cfg, device=device), tree,
                        "recsys_params_from_numpy")


def pna_params_from_numpy(tree, cfg: PNAConfig, *, device="cuda"
                          ) -> PNAModel:
    """The reference's PNA params (``repro.models.gnn.init``'s tree:
    ``encoder[0]['w']``, ``layers[i]['pre'][0]['b']``, ``head[0]['w']``,
    ... as host arrays) -> the port's ``PNAModel`` on ``device``."""
    return _load_module(PNAModel(cfg, device=device), tree,
                        "pna_params_from_numpy")
