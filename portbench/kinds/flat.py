"""``flat``: the paper's main configuration over an index of codes.

Inputs (drawn from the seed on the device): unit-norm centroids; each
page's ``n_patches`` codes from a window of ``code_window`` codebook
entries (``corpus.window_codes``); the page's salience falls along its
patches, so doc-side top-p keeps its first ``keep_count`` codes, stored
in ``kept_patches`` slots (the last ones masked); every patch valid for
the rerank; a pool of unit-norm queries, every patch valid.

The port's state is ``RetrieverState(codebook, index.build_flat(codes,
mask, codebook), full codes, full mask)`` searched by ``Retriever.search``
with the config's ``HPCConfig``: the ADC sweep over every page for the
top ``rerank``, then the facade's rerank over the unpruned codes.
"""
from __future__ import annotations

import types

import torch

from portbench import corpus, kinds, roofline
from portbench.reference import flat as reference_flat


def inputs(cfg, seed, device):
    n, m, d, k = (cfg["corpus_docs"], cfg["n_patches"], cfg["proj_dim"],
                  cfg["k"])
    slots = cfg["kept_patches"]
    gen = corpus.generator(seed, device, 0)
    codebook = corpus.unit_rows(gen, k, d, device)
    codes_full = corpus.window_codes(gen, n, m, k, cfg["code_window"],
                                     device)
    codes = codes_full[:, :slots].contiguous()
    mask = (torch.arange(slots, device=device) < kinds.keep_count(cfg)).expand(
        n, slots).contiguous()
    mask_full = torch.ones((n, m), dtype=torch.bool, device=device)
    pool = cfg["query_pool"]
    q = corpus.unit_rows(gen, pool * cfg["query_len"], d, device).reshape(
        pool, cfg["query_len"], d)
    qs = 0.5 + 0.5 * torch.rand((pool, cfg["query_len"]), generator=gen,
                                device=device)
    qm = torch.ones((pool, cfg["query_len"]), dtype=torch.bool)
    return types.SimpleNamespace(
        codebook=codebook, codes=codes, mask=mask, codes_full=codes_full,
        mask_full=mask_full, n_docs=n,
        pool=(q.cpu().numpy(), qm.numpy(), qs.cpu().numpy()))


def system(cfg, inp):
    from repro_torch.core import index
    from repro_torch.retrieval import HPCConfig, Retriever, RetrieverState
    hpc = HPCConfig(k=cfg["k"], p=cfg["p"], prune_side=cfg["prune_side"],
                    backend="flat", rerank=cfg["rerank"])
    state = RetrieverState(
        codebook=inp.codebook,
        backend_state=index.build_flat(inp.codes, inp.mask, inp.codebook),
        rerank_codes=inp.codes_full, rerank_mask=inp.mask_full)
    return Retriever(hpc), state


def costs(cfg, inp, b, q_valid):
    """The sweep reads every page's codes and mask once and looks up, per
    valid query patch and page, the page's codes; the rerank reads at
    least one pool's ``rerank`` full rows (pools of different queries may
    share pages) and looks up, per valid query patch, its own pool's."""
    n, mq, k, m = inp.n_docs, cfg["query_len"], cfg["k"], cfg["n_patches"]
    r, qv = cfg["rerank"], sum(q_valid)
    sweep = roofline.qmaxsim_cost(
        b=b, mq=mq, k=k, pages=n, md=cfg["kept_patches"], code_bytes=1,
        mask_bytes=1, out_bytes=b * r * 8, pairs=qv * n,
        slot_pairs=qv * n * kinds.keep_count(cfg))
    rerank = roofline.qmaxsim_cost(
        b=b, mq=mq, k=k, pages=r, md=m, code_bytes=1, mask_bytes=1,
        out_bytes=b * cfg["top_k"] * 8, pairs=qv * r, slot_pairs=qv * r * m)
    return {"quantized_maxsim": [sweep, rerank]}


def launches(cfg, b, sms):
    return {"quantized_maxsim":
            kinds.qmaxsim_launches(b, cfg["corpus_docs"], cfg["rerank"], sms)
            + kinds.qmaxsim_launches(b, cfg["rerank"], cfg["top_k"], sms)}


def reference(cfg, inp, device, tf32=False):
    return reference_flat.FlatReference(
        inp.codebook, inp.codes, inp.mask, inp.codes_full, inp.mask_full,
        rerank=cfg["rerank"], top_k=cfg["top_k"], tf32=tf32)
