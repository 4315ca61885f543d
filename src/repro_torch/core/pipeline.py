"""HPC-ColPali end-to-end pipeline (paper §III-E) — the v0 shim.

The counterpart of ``repro.core.pipeline``: the v0 entry points
(``build_index`` / ``query`` / ``storage_bytes``, ``HPCIndex``) as thin
wrappers over the ``Retriever`` facade. New code should use
``repro_torch.retrieval.Retriever`` directly.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

# submodule imports (not the package) so `repro_torch.core` and
# `repro_torch.retrieval` can initialise in either order
from repro_torch.retrieval.base import (  # noqa: F401
    Corpus, Query, RetrieverState, code_dtype)
from repro_torch.retrieval.config import HPCConfig  # noqa: F401
from repro_torch.retrieval.retriever import Retriever

Tensor = torch.Tensor

# v0 name for the built index state
HPCIndex = RetrieverState


def build_index(gen: torch.Generator, doc_emb: Tensor, doc_mask: Tensor,
                doc_salience: Tensor, config: HPCConfig) -> HPCIndex:
    """Offline indexing (paper §III-E1): ``Retriever.build`` over
    doc_emb (N, Md, D), doc_mask (N, Md) and doc_salience (N, Md);
    ``gen`` is a generator on the corpus' device."""
    return Retriever(config).build(gen, Corpus(doc_emb, doc_mask,
                                               doc_salience))


def query(index: HPCIndex, q_emb: Tensor, q_mask: Tensor, q_salience: Tensor,
          config: HPCConfig, *, k: int) -> Tuple[Tensor, Tensor]:
    """Online query (paper §III-E2): ``Retriever.search`` -> (scores
    (B, k), doc_ids (B, k))."""
    return Retriever(config).search(index, Query(q_emb, q_mask, q_salience),
                                    k=k)


def storage_bytes(index: HPCIndex, config: HPCConfig) -> Dict[str, int]:
    """Measured storage footprint of the built index (paper Table III)."""
    return Retriever(config).storage_bytes(index)
