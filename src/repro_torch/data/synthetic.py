"""Synthetic multi-vector retrieval corpus with planted graded relevance.

The counterpart of ``repro.data.synthetic.make_retrieval_corpus``: the same
planted structure, drawn from a ``torch.Generator`` on the target device,
so the random numbers differ from the JAX corpus at the same seed.

Structure: each topic owns a bank of patch prototypes. A document samples
its salient patches from its topic bank (shared within a group of
near-duplicates) and background patches from any bank. A query is built
from a target doc's salient patches plus noise. Relevance: target doc = 3,
its near-duplicates = 2, same-topic docs = 1, the rest 0.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.device import resolve_device

Tensor = torch.Tensor

_NOISE_CHUNK_DOCS = 1024  # bounds the noise temporary at full ColPali width


class RetrievalData(NamedTuple):
    doc_patches: Tensor     # (N, Md, D) float32
    doc_mask: Tensor        # (N, Md) bool
    doc_salience: Tensor    # (N, Md) float32 — synthetic attention salience
    doc_topic: Tensor       # (N,) int32
    query_patches: Tensor   # (Q, Mq, D)
    query_mask: Tensor      # (Q, Mq) bool
    query_salience: Tensor  # (Q, Mq)
    relevance: Tensor       # (Q, N) int32 graded 0..3


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    n_docs: int = 2048
    n_queries: int = 128
    n_patches: int = 32        # Md
    n_q_patches: int = 8       # Mq
    dim: int = 128             # D
    n_topics: int = 32
    patches_per_topic: int = 64
    noise: float = 0.25        # patch noise (higher -> harder corpus)
    salient_frac: float = 0.5  # fraction of patches that carry signal
    dup_per_doc: int = 3       # graded-relevant near-duplicates per query


def make_retrieval_corpus(spec: CorpusSpec, *, seed: int,
                          device="cuda") -> RetrievalData:
    """Build a corpus with planted graded relevance on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randint(high, *shape):
        return torch.randint(0, high, shape, generator=gen, device=dev)

    n, md, d = spec.n_docs, spec.n_patches, spec.dim
    t_centers = normal(spec.n_topics, d)
    banks = t_centers[:, None, :] + 0.7 * normal(
        spec.n_topics, spec.patches_per_topic, d)

    group = torch.arange(n, device=dev) // (1 + spec.dup_per_doc)
    topic = group % spec.n_topics
    n_sal = max(1, int(md * spec.salient_frac))
    proto_idx = randint(spec.patches_per_topic,
                        n // (1 + spec.dup_per_doc) + 1, n_sal)
    patches = torch.empty((n, md, d), device=dev)
    patches[:, :n_sal] = banks[topic[:, None], proto_idx[group]]
    bg_topic = randint(spec.n_topics, n, md - n_sal)
    bg_proto = randint(spec.patches_per_topic, n, md - n_sal)
    patches[:, n_sal:] = banks[bg_topic, bg_proto]
    for start in range(0, n, _NOISE_CHUNK_DOCS):
        part = patches[start:start + _NOISE_CHUNK_DOCS]
        part.add_(normal(*part.shape), alpha=spec.noise)
    # L2 normalise in place (ColPali embeddings are normalised)
    patches.div_(torch.linalg.vector_norm(patches, dim=-1, keepdim=True))

    sal = torch.cat([0.8 + 0.2 * uniform(n, n_sal),
                     0.2 * uniform(n, md - n_sal)], dim=1)
    mask = torch.ones((n, md), dtype=torch.bool, device=dev)

    q_target = (torch.arange(spec.n_queries, device=dev)
                * (1 + spec.dup_per_doc)) % n
    mq = spec.n_q_patches
    pick = randint(n_sal, spec.n_queries, mq)
    q_patches = patches[q_target[:, None], pick]
    q_patches = q_patches + spec.noise * normal(*q_patches.shape)
    q_patches = q_patches / torch.linalg.vector_norm(q_patches, dim=-1,
                                                     keepdim=True)
    q_sal = 0.5 + 0.5 * uniform(spec.n_queries, mq)
    q_mask = torch.ones((spec.n_queries, mq), dtype=torch.bool, device=dev)

    same_group = group[None, :] == group[q_target][:, None]
    same_topic = topic[None, :] == topic[q_target][:, None]
    is_target = torch.arange(n, device=dev)[None, :] == q_target[:, None]
    rel = (is_target.to(torch.int32) * 3
           + (same_group & ~is_target).to(torch.int32) * 2
           + (same_topic & ~same_group).to(torch.int32))
    return RetrievalData(patches, mask, sal, topic.to(torch.int32),
                         q_patches, q_mask, q_sal, rel)
