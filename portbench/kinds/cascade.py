"""``cascade``: the paper's full funnel over a corpus of float pages.

Inputs (drawn from the seed on the device): pages, salience and queries
of ``corpus.PageCorpus`` (``make_retrieval_corpus``'s rule, a chunk of
pages at a time), and a codebook of ``k`` unit-norm bank prototypes (made
from the seed, not fit).

The port's state is built as ``CascadeBackend.build`` builds it, with two
departures: the codebook is the input above (no k-means), and the corpus
goes through the port's ``quantize`` (the ``kmeans_assign`` kernel),
``prune_topp_codes`` and ``pruned_embeddings`` a chunk of pages at a time,
so the full-width float corpus is never whole on the card. The members
are then built by ``index.build_hamming``, ``build_flat`` and
``build_float_flat`` over the whole corpus, and searched by
``Retriever.search``: query codes, the Hamming sweep for the top ``p1``,
ADC over those for the top ``p2``, float MaxSim over those for the top k.
"""
from __future__ import annotations

import math
import types

import torch

from portbench import corpus, kinds, roofline
from portbench.reference import cascade as reference_cascade

# pages the float stage scores per launch (the scan's block_docs)
BLOCK_DOCS = 256


def rule(cfg) -> corpus.CorpusRule:
    return corpus.CorpusRule(
        n_docs=cfg["corpus_docs"], n_patches=cfg["n_patches"],
        n_q_patches=cfg["query_len"], dim=cfg["proj_dim"],
        n_topics=cfg["n_topics"], patches_per_topic=cfg["patches_per_topic"],
        noise=cfg["noise"], salient_frac=cfg["salient_frac"],
        dup_per_doc=cfg["dup_per_doc"])


def inputs(cfg, seed, device):
    pages = corpus.PageCorpus(rule(cfg), seed, device, cfg["chunk_docs"])
    codebook = pages.codebook(cfg["k"])
    return types.SimpleNamespace(pages=pages, codebook=codebook,
                                 n_docs=cfg["corpus_docs"],
                                 pool=pages.queries(cfg["query_pool"]))


def system(cfg, inp):
    from repro_torch.core import index, pruning
    from repro_torch.core import quantization as quant
    from repro_torch.retrieval import (Corpus, HPCConfig, Retriever,
                                       RetrieverState)
    from repro_torch.retrieval.base import code_dtype
    from repro_torch.retrieval.cascade import CascadeState
    from repro_torch.retrieval.config import CascadeConfig
    from repro_torch.retrieval.float_flat import pruned_embeddings
    from repro_torch.retrieval.hamming import HammingState
    hpc = HPCConfig(k=cfg["k"], p=cfg["p"], prune_side=cfg["prune_side"],
                    backend="cascade", rerank=cfg["rerank"],
                    cascade=CascadeConfig(p1=cfg["p1"], p2=cfg["p2"]))
    if hpc.bits != cfg["bits"]:
        raise ValueError(f"bits {cfg['bits']} != ceil(log2 k) = {hpc.bits}")
    cb = inp.codebook
    dev, n, m, d = cb.device, cfg["corpus_docs"], cfg["n_patches"], \
        cfg["proj_dim"]
    keep = pruning.keep_count(m, cfg["p"])
    cdt = code_dtype(cfg["k"])
    codes_full = torch.empty((n, m), dtype=cdt, device=dev)
    codes = torch.empty((n, keep), dtype=cdt, device=dev)
    mask = torch.empty((n, keep), dtype=torch.bool, device=dev)
    emb = torch.empty((n, keep, d), device=dev)
    emb_mask = torch.empty((n, keep), dtype=torch.bool, device=dev)
    for start, x, sal in inp.pages.chunks():
        rows = slice(start, start + x.shape[0])
        chunk = Corpus(x, torch.ones(sal.shape, dtype=torch.bool,
                                     device=dev), sal)
        codes_full[rows] = quant.quantize(x, cb, code_dtype=cdt)
        codes[rows], _, mask[rows], _ = pruning.prune_topp_codes(
            codes_full[rows], sal, chunk.mask, p=cfg["p"])
        emb[rows], emb_mask[rows] = pruned_embeddings(chunk, hpc)
        del x, chunk
    members = (HammingState(index.build_hamming(codes, mask, hpc.bits),
                            hpc.bits),
               index.build_flat(codes, mask, cb),
               index.build_float_flat(emb, emb_mask))
    state = RetrieverState(
        codebook=cb,
        backend_state=CascadeState(members, cfg["p1"], cfg["p2"]),
        rerank_codes=codes_full,
        rerank_mask=torch.ones((n, m), dtype=torch.bool, device=dev))
    return Retriever(hpc), state


def costs(cfg, inp, b, q_valid):
    """Query codes for the valid query patches; stage 1 reads every page's
    kept codes (at ``bits`` a code) and mask once and looks up, per valid
    query patch and page, the page's codes; stages 2 and 3 read at least
    one pool (pools of different queries may share pages) and score, per
    valid query patch, its own pool: a lookup per page in stage 2, 2 * D
    FLOPs per valid slot in stage 3."""
    n, mq, k, d = inp.n_docs, cfg["query_len"], cfg["k"], cfg["proj_dim"]
    keep, p1, p2 = kinds.keep_count(cfg), cfg["p1"], cfg["p2"]
    qv = sum(q_valid)
    code_bytes = -(-cfg["bits"] // 8)
    return {
        "kmeans_assign": [roofline.assign_cost(rows=qv, d=d, k=k)],
        "hamming_maxsim": [roofline.hamming_cost(
            b=b, mq=mq, pages=n, md=keep, code_bytes=code_bytes,
            mask_bytes=1, out_bytes=b * p1 * 8, pairs=qv * n,
            slot_pairs=qv * n * keep)],
        "quantized_maxsim": [roofline.qmaxsim_cost(
            b=b, mq=mq, k=k, pages=p1, md=keep, code_bytes=1, mask_bytes=1,
            out_bytes=b * p2 * 8, pairs=qv * p1, slot_pairs=qv * p1 * keep)],
        "maxsim": [roofline.maxsim_cost(
            b=b, mq=mq, d=d, q_valid_slots=qv * p2 * keep, read_pages=p2,
            md=keep, mask_bytes=1, out_bytes=b * cfg["top_k"] * 8)],
    }


def launches(cfg, b, sms):
    return {"kmeans_assign": 1,
            "hamming_maxsim": kinds.hamming_launches(
                b, cfg["corpus_docs"], cfg["p1"], sms),
            "quantized_maxsim": kinds.qmaxsim_launches(
                b, cfg["p1"], cfg["p2"], sms),
            "maxsim": math.ceil(cfg["p2"] / BLOCK_DOCS)}


def reference(cfg, inp, device, tf32=False):
    return reference_cascade.CascadeReference(
        inp.pages, inp.codebook, p=cfg["p"], p1=cfg["p1"], p2=cfg["p2"],
        top_k=cfg["top_k"], bits=cfg["bits"], tf32=tf32)
