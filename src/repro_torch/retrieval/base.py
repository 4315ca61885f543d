"""The `IndexBackend` contract, its registry and the shared build stages.

The counterpart of ``repro.retrieval.base`` for monolithic (unsegmented)
states. A backend owns one primary search structure behind

    build(generator, corpus, cfg)          -> RetrieverState
    search(state, query, *, k, scan)       -> (scores (B, k), doc_ids (B, k))
    search_candidates(state, query, ids, *, k, scan)
    storage_bytes(state)                   -> {"payload": ..., ...}

Codebook training and corpus quantization are shared here
(``fit_codebook``, ``encode_corpus``). Random draws come from a
``torch.Generator`` on the corpus' device.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.core import pruning
from repro_torch.core import quantization as quant
from repro_torch.retrieval.config import HPCConfig

Tensor = torch.Tensor


def code_dtype(k: int) -> torch.dtype:
    """Dtype of centroid-index codes for a K-entry codebook: uint8 for
    K <= 256, else uint16 (stored as such; widened to int32 before any
    arithmetic, since torch has few uint16 ops)."""
    return torch.uint8 if k <= 256 else torch.uint16


class Corpus(NamedTuple):
    """Doc-side inputs: (N, Md, D) embeddings, (N, Md) mask/salience."""
    embeddings: Tensor
    mask: Tensor
    salience: Tensor


class Query(NamedTuple):
    """Query-side inputs: (B, Mq, D) embeddings, (B, Mq) mask/salience."""
    embeddings: Tensor
    mask: Tensor
    salience: Tensor


class RetrieverState(NamedTuple):
    """Built index state: the backend structure plus the unpruned codes
    and mask the facade's rerank reads (indexed by global doc id)."""

    codebook: Tensor
    backend_state: Any
    rerank_codes: Tensor
    rerank_mask: Tensor


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, "IndexBackend"] = {}


def register_backend(name: str):
    """Class decorator: ``@register_backend("flat")`` installs a singleton."""
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls()
        return cls
    return deco


def _ensure_builtin_backends() -> None:
    """Install the built-in backends (idempotent, import-cycle safe)."""
    from repro_torch.retrieval import (cascade, flat, float_flat,  # noqa: F401
                                       hamming)


def get_backend(name: str) -> "IndexBackend":
    if name not in _REGISTRY:
        _ensure_builtin_backends()
    if name not in _REGISTRY:
        raise KeyError(f"unknown index backend {name!r}; available: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_backends() -> Tuple[str, ...]:
    _ensure_builtin_backends()
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Shared build stages
# ---------------------------------------------------------------------------

def kmeans_config(cfg: HPCConfig) -> quant.KMeansConfig:
    """The codebook-training config implied by an HPCConfig."""
    return quant.KMeansConfig(
        k=cfg.k, iters=cfg.kmeans_iters, seed_batch=cfg.kmeans_seed_batch,
        n_restarts=cfg.kmeans_restarts, minibatch=cfg.kmeans_minibatch)


def fit_codebook(gen: torch.Generator, corpus: Corpus,
                 cfg: HPCConfig) -> Tensor:
    """Train the K-Means codebook on valid patches only: invalid rows are
    replaced by resampled valid rows, so Lloyd sees real data."""
    d = corpus.embeddings.shape[-1]
    flat = corpus.embeddings.reshape(-1, d)
    flat_mask = corpus.mask.reshape(-1).to(torch.bool)
    valid_idx = torch.argsort((~flat_mask).to(torch.uint8), stable=True)
    n_valid = flat_mask.sum()
    pos = torch.arange(flat.shape[0], device=flat.device)
    gather_idx = torch.where(
        pos < n_valid, valid_idx,
        valid_idx[torch.remainder(pos, torch.clamp(n_valid, min=1))])
    codebook, _ = quant.kmeans_fit(gen, flat[gather_idx], kmeans_config(cfg))
    return codebook


def encode_corpus(gen: torch.Generator, corpus: Corpus, cfg: HPCConfig
                  ) -> Tuple[torch.Generator, Tensor, Tensor, Tensor, Tensor]:
    """Shared offline stages of the code-based backends: train the
    codebook, quantize the full corpus (the rerank rows) and prune the doc
    patches for the primary structure.

    Returns (generator, codebook, codes_full, codes, mask); the generator,
    advanced past the codebook's draws, is free for the backend's own
    structure.
    """
    codebook = fit_codebook(gen, corpus, cfg)
    codes_full = quant.quantize(corpus.embeddings, codebook,
                                code_dtype=code_dtype(cfg.k))  # (N, Md)
    if cfg.prune_side in ("doc", "both"):
        codes, _, mask, _ = pruning.prune_topp_codes(
            codes_full, corpus.salience, corpus.mask, p=cfg.p)
    else:
        codes, mask = codes_full, corpus.mask.to(torch.bool)
    return gen, codebook, codes_full, codes, mask


# ---------------------------------------------------------------------------
# Backend base class
# ---------------------------------------------------------------------------

class IndexBackend:
    """Contract every index backend implements (see module docstring)."""

    name: str = "?"
    # True -> scores are exact late-interaction scores over raw embeddings;
    # the facade then skips the quantized rerank stage.
    exact_scores: bool = False

    def build(self, gen: torch.Generator, corpus: Corpus,
              cfg: HPCConfig) -> RetrieverState:
        """Offline indexing."""
        raise NotImplementedError

    def search(self, state: RetrieverState, query: Query, *, k: int,
               scan=None) -> Tuple[Tensor, Tensor]:
        """Candidate search -> (scores (B, k), doc_ids (B, k)).

        Sentinel contract: with fewer than k valid documents (k > N) the
        tail rows carry doc id -1 and scores at or below NEG_INF;
        consumers ignore ``id < 0`` rows.
        """
        raise NotImplementedError

    def search_candidates(self, state: RetrieverState, query: Query,
                          candidate_ids, *, k: int,
                          scan=None) -> Tuple[Tensor, Tensor]:
        """Score only a (B, P) per-query pool of corpus positions (-1 =
        empty slot) -> (B, k) top-k under the same sentinel contract.
        ``candidate_ids=None`` is the whole corpus, i.e. ``search``."""
        if candidate_ids is None:
            return self.search(state, query, k=k, scan=scan)
        raise NotImplementedError(
            f"backend {self.name!r} does not support candidate-restricted "
            "search")

    def storage_bytes(self, state: RetrieverState) -> Dict[str, int]:
        """Measured storage of the built index (paper Table III)."""
        raise NotImplementedError

    def build_stats(self, state: RetrieverState) -> Dict[str, float]:
        """Structure-quality stats of a built index; the exhaustive scans
        have nothing to report."""
        return {}
