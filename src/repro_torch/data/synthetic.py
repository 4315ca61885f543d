"""Synthetic corpora with planted structure: the multi-vector retrieval
corpus with graded relevance, and the RAG fact corpus.

The counterparts of ``repro.data.synthetic.make_retrieval_corpus`` and
``make_fact_corpus``: the same planted structure, drawn from a
``torch.Generator`` on the target device, so the random numbers differ
from the JAX corpora at the same seed.

Retrieval corpus: each topic owns a bank of patch prototypes. A document
samples its salient patches from its topic bank (shared within a group of
near-duplicates) and background patches from any bank. A query is built
from a target doc's salient patches plus noise. Relevance: target doc = 3,
its near-duplicates = 2, same-topic docs = 1, the rest 0.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

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


# ---------------------------------------------------------------------------
# RAG fact corpus (paper Table V)
# ---------------------------------------------------------------------------

class FactCorpus(NamedTuple):
    doc_patches: Tensor     # (N, Md, D) float32
    doc_mask: Tensor        # (N, Md) bool
    doc_salience: Tensor    # (N, Md) float32 (ones)
    doc_facts: Tensor       # (N, F) int32 fact ids carried by each doc
    doc_tokens: Tensor      # (N, Ld) int32 generator-side rendering
    query_tokens: Tensor    # (Q, 4) int32
    query_patches: Tensor   # (Q, 4, D) retriever-side rendering
    query_mask: Tensor      # (Q, 4) bool
    query_salience: Tensor  # (Q, 4) float32 (ones)
    gold_doc: Tensor        # (Q,) int32 the doc answering each query
    gold_facts: Tensor      # (Q, F) int32 reference facts (gold doc's)


def make_fact_corpus(*, seed: int, n_docs: int = 256,
                     n_facts_vocab: int = 200, facts_per_doc: int = 4,
                     dim: int = 64, n_patches: int = 16, n_queries: int = 64,
                     seq_len: int = 32, device="cuda"
                     ) -> Tuple[FactCorpus, Dict[str, int]]:
    """Legal-summarisation stand-in where hallucination is measurable, on
    ``device``: the reference's layout and shapes, drawn from ``seed``.

    Token layout: [0] PAD, [1] SEP, [2] QUERY-marker,
    [3 .. 3+n_facts_vocab) fact tokens. A doc's tokens are its fact tokens
    and a SEP; a query asks (the QUERY marker, one probe fact token, SEP)
    for the doc holding that fact; the reference summary is the gold doc's
    fact set. Each fact has a patch-space prototype, and a doc's patches
    are its facts' prototypes repeated, plus noise, L2-normalised.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    vocab = {"pad": 0, "sep": 1, "query": 2, "fact0": 3,
             "size": 3 + n_facts_vocab}

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def randint(high, *shape):
        return torch.randint(0, high, shape, generator=gen, device=dev)

    fact_proto = normal(n_facts_vocab, dim)
    doc_facts = randint(n_facts_vocab, n_docs, facts_per_doc)
    reps = n_patches // facts_per_doc
    pat_f = doc_facts.repeat_interleave(reps, dim=1)[:, :n_patches]
    patches = fact_proto[pat_f]
    for start in range(0, n_docs, _NOISE_CHUNK_DOCS):
        part = patches[start:start + _NOISE_CHUNK_DOCS]
        part.add_(normal(*part.shape), alpha=0.15)
    patches.div_(torch.linalg.vector_norm(patches, dim=-1, keepdim=True))
    sal = torch.ones((n_docs, n_patches), device=dev)
    mask = torch.ones((n_docs, n_patches), dtype=torch.bool, device=dev)

    dt = torch.full((n_docs, seq_len), vocab["pad"], dtype=torch.int32,
                    device=dev)
    dt[:, :facts_per_doc] = doc_facts + vocab["fact0"]
    dt[:, facts_per_doc] = vocab["sep"]

    gold_doc = randint(n_docs, n_queries)
    probe_slot = randint(facts_per_doc, n_queries)
    probe_fact = doc_facts[gold_doc, probe_slot]                # (Q,)
    qt = torch.full((n_queries, 4), vocab["pad"], dtype=torch.int32,
                    device=dev)
    qt[:, 0] = vocab["query"]
    qt[:, 1] = probe_fact + vocab["fact0"]
    qt[:, 2] = vocab["sep"]

    mq = 4
    q_patches = fact_proto[probe_fact][:, None].expand(n_queries, mq, dim)
    q_patches = q_patches + 0.15 * normal(n_queries, mq, dim)
    q_patches = q_patches / torch.linalg.vector_norm(q_patches, dim=-1,
                                                     keepdim=True)
    fc = FactCorpus(
        patches, mask, sal, doc_facts.to(torch.int32), dt, qt, q_patches,
        torch.ones((n_queries, mq), dtype=torch.bool, device=dev),
        torch.ones((n_queries, mq), device=dev), gold_doc.to(torch.int32),
        doc_facts[gold_doc].to(torch.int32))
    return fc, vocab


# ---------------------------------------------------------------------------
# LM token streams (order-2 Markov chain — learnable)
# ---------------------------------------------------------------------------

def make_lm_batch(generator: torch.Generator, vocab: int, batch: int,
                  seq: int, n_states: int = 64) -> Dict[str, Tensor]:
    """A batch of an order-2 Markov chain over ``n_states`` states (mod
    ``vocab``), on the generator's device: the reference's
    ``make_lm_batch`` drawn from ``generator``.

    Each state pair has 4 moves with Dirichlet(0.5) weights and random
    next states; every row starts at (0, 1) and draws seq + 1 moves (the
    Gumbel-max trick over log(p + 1e-9), as ``jax.random.categorical``).
    Dirichlet(0.5) is drawn as normalised squares of standard normals
    (Gamma(1/2) = Z^2 / 2). Returns int32 ``tokens`` (B, seq) and
    ``targets`` (B, seq), the tokens shifted by one."""
    dev = generator.device
    z = torch.randn((n_states, n_states, 4), generator=generator,
                    device=dev)
    trans = z * z
    trans = trans / trans.sum(dim=-1, keepdim=True)
    nxt = torch.randint(0, n_states, (n_states, n_states, 4),
                        generator=generator, device=dev)
    logp = torch.log(trans + 1e-9)
    s1 = torch.zeros((batch,), dtype=torch.long, device=dev)
    s2 = torch.ones((batch,), dtype=torch.long, device=dev)
    tiny = torch.finfo(torch.float32).tiny
    toks = []
    for _ in range(seq + 1):
        u = torch.rand((batch, 4), generator=generator, device=dev)
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        choice = torch.argmax(logp[s1, s2] + gumbel, dim=-1)
        s3 = nxt[s1, s2, choice]
        toks.append(s3)
        s1, s2 = s2, s3
    toks = torch.stack(toks, dim=1) % vocab
    return {"tokens": toks[:, :seq].to(torch.int32),
            "targets": toks[:, 1:seq + 1].to(torch.int32)}
