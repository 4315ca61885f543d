"""Synthetic corpora and batches with planted structure: the multi-vector
retrieval corpus with graded relevance, the RAG fact corpus, LM token
streams, graphs and molecule batches, and recsys batches.

The counterparts of ``repro.data.synthetic``'s makers: the same planted
structure, drawn from a ``torch.Generator`` on the target device, so the
random numbers differ from the JAX ones at the same seed.

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


# ---------------------------------------------------------------------------
# Graphs
# ---------------------------------------------------------------------------

def make_graph(generator: torch.Generator, n_nodes: int, n_edges: int,
               d_feat: int, n_classes: int, n_comm: int = 8
               ) -> Dict[str, Tensor]:
    """A community-structured graph on the generator's device, the
    reference's ``make_graph`` drawn from ``generator``: 80% of the edges
    join a node to one 1-4 places after it in community order (the same
    community, mostly), the rest are random; labels are the community mod
    ``n_classes`` and features lie around a class centre (noise 0.8).
    Returns float32 ``feats`` (N, d_feat), int32 ``edge_index`` (2, E)
    and ``labels`` (N,)."""
    dev = generator.device

    def randint(low, high, n):
        return torch.randint(low, high, (n,), generator=generator,
                             device=dev)

    comm = randint(0, n_comm, n_nodes)
    n_intra = int(n_edges * 0.8)
    src_i = randint(0, n_nodes, n_intra)
    perm = torch.argsort(comm, stable=True)
    pos_of = torch.empty_like(perm)
    pos_of[perm] = torch.arange(n_nodes, device=dev)
    off = randint(1, 5, n_intra)
    dst_i = perm[torch.clamp(pos_of[src_i] + off, 0, n_nodes - 1)]
    src_r = randint(0, n_nodes, n_edges - n_intra)
    dst_r = randint(0, n_nodes, n_edges - n_intra)
    edge_index = torch.stack([torch.cat([src_i, src_r]),
                              torch.cat([dst_i, dst_r])]).to(torch.int32)
    labels = comm % n_classes
    centers = torch.randn((n_classes, d_feat), generator=generator,
                          device=dev)
    feats = centers[labels] + 0.8 * torch.randn((n_nodes, d_feat),
                                                generator=generator,
                                                device=dev)
    return {"feats": feats, "edge_index": edge_index,
            "labels": labels.to(torch.int32)}


def make_molecule_batch(generator: torch.Generator, n_graphs: int,
                        nodes_per: int, edges_per: int, d_feat: int
                        ) -> Dict[str, Tensor]:
    """``n_graphs`` small graphs of ``nodes_per`` nodes, each a ring plus
    ``edges_per - nodes_per`` random chords, on the generator's device;
    a graph's label is whether its nodes' first features sum above 0.
    Returns ``feats``, ``edge_index``, ``graph_ids`` and
    ``graph_labels``."""
    dev = generator.device
    n = n_graphs * nodes_per
    feats = torch.randn((n, d_feat), generator=generator, device=dev)
    base = torch.arange(nodes_per, device=dev)
    off = torch.repeat_interleave(torch.arange(n_graphs, device=dev)
                                  * nodes_per, nodes_per)
    ring_src = base.repeat(n_graphs) + off
    ring_dst = ((base + 1) % nodes_per).repeat(n_graphs) + off
    extra = edges_per - nodes_per
    goff = torch.arange(n_graphs, device=dev)[:, None] * nodes_per
    es = torch.randint(0, nodes_per, (n_graphs, extra), generator=generator,
                       device=dev) + goff
    ed = torch.randint(0, nodes_per, (n_graphs, extra), generator=generator,
                       device=dev) + goff
    graph_ids = torch.repeat_interleave(torch.arange(n_graphs, device=dev),
                                        nodes_per)
    pooled = torch.zeros((n_graphs,), device=dev).index_add_(
        0, graph_ids, feats[:, 0])
    return {"feats": feats,
            "edge_index": torch.stack([
                torch.cat([ring_src, es.reshape(-1)]),
                torch.cat([ring_dst, ed.reshape(-1)])]).to(torch.int32),
            "graph_ids": graph_ids.to(torch.int32),
            "graph_labels": (pooled > 0).to(torch.int32)}


# ---------------------------------------------------------------------------
# RecSys batches (planted logistic teacher)
# ---------------------------------------------------------------------------

def make_recsys_batch(generator: torch.Generator, batch: int, n_dense: int,
                      table_rows, seq_len: int = 0, family: str = "dlrm"
                      ) -> Dict[str, Tensor]:
    """A recsys batch with a planted signal, on the generator's device: the
    reference's ``make_recsys_batch`` drawn from ``generator``, for any
    number of tables (the reference's runs out of keys past 6).

    din/dien: ``hist_ids`` (B, S) int32 with ``hist_mask`` valid for the
    first S/2..S items, ``target_ids``, and a click when the target's id
    mod 7 matches the sum of the history's ids mod 7, flipped with
    probability 0.1. dlrm/dcn: ``dense`` (B, n_dense) normal, one id per
    table in ``sparse_ids``, and a click drawn from a logistic teacher
    over the dense features and the ids mod 5."""
    dev = generator.device
    if family in ("din", "dien"):
        n_items = table_rows[0]
        hist = torch.randint(0, n_items, (batch, seq_len),
                             generator=generator, device=dev)
        hl = torch.randint(seq_len // 2, seq_len + 1, (batch,),
                           generator=generator, device=dev)
        mask = torch.arange(seq_len, device=dev)[None, :] < hl[:, None]
        target = torch.randint(0, n_items, (batch,), generator=generator,
                               device=dev)
        sig = (torch.sum((hist % 7) * mask, dim=1) % 7) == (target % 7)
        noise = torch.rand((batch,), generator=generator, device=dev) < 0.1
        return {"hist_ids": hist.to(torch.int32), "hist_mask": mask,
                "target_ids": target.to(torch.int32),
                "label": (sig ^ noise).to(torch.float32)}
    dense = torch.randn((batch, n_dense), generator=generator, device=dev)
    sparse = torch.stack([torch.randint(0, r, (batch,), generator=generator,
                                        device=dev) for r in table_rows],
                         dim=1)
    w = torch.randn((n_dense,), generator=generator, device=dev)
    logit = dense @ w + 0.5 * torch.sum((sparse % 5) - 2, dim=1) / len(
        table_rows)
    u = torch.rand((batch,), generator=generator, device=dev)
    return {"dense": dense, "sparse_ids": sparse.to(torch.int32),
            "label": (torch.sigmoid(logit) > u).to(torch.float32)}
