"""The plain reference of the ``cascade`` configuration.

Given the codebook, the pages' float patches and salience (drawn again a
chunk at a time from the seed) and the queries, it works out again:

  * every patch's code, the nearest centroid by squared distance;
  * doc-side top-p pruning: a page keeps its ``ceil(M p / 100)`` most
    salient valid patches, in descending salience, ties to the lower
    patch;
  * stage 1: each query patch's code, and every page's Hamming score over
    its kept codes (per valid query patch, the best ``bits - popcount(a ^
    b)`` over the page's kept codes; summed); the ``p1`` best pages;
  * stage 2: their ADC scores over the kept codes; the ``p2`` best, in
    stage 1's order on ties;
  * stage 3: their float late-interaction scores over the kept patches;
    the ``top_k`` best, in stage 2's order on ties.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import (BINARY_MASKED, NEG, fp32, lower, matmul,
                                 presence, set_max, top_stable)

SWEEP_PAGES = 1 << 14
# queries taken through stages 2-3 at a time
ROWS = 8


def nearest(x, codebook, tf32: bool):
    """Nearest centroid of each row of x (n, D): argmin of ||c||^2 - 2
    x.c, the squared distance less the row's own constant norm."""
    dots = matmul(x, codebook.t(), tf32)
    c2 = (codebook * codebook).sum(dim=-1)
    return torch.argmin(c2[None, :] - 2.0 * dots, dim=-1)


def popcount_table(bits: int, device) -> torch.Tensor:
    """(2^bits, 2^bits) int32: bits - popcount(a ^ b)."""
    v = torch.arange(1 << bits, device=device)
    x = v[:, None] ^ v[None, :]
    ones = torch.zeros_like(x)
    for i in range(bits):
        ones += (x >> i) & 1
    return (bits - ones).to(torch.int32)


class CascadeReference:

    def __init__(self, pages, codebook, *, p: float, p1: int, p2: int,
                 top_k: int, bits: int, tf32: bool = False):
        self.codebook = codebook.float()
        self.p1, self.p2, self.top_k, self.bits = p1, p2, top_k, bits
        self.tf32 = tf32
        r = pages.rule
        keep = max(1, min(r.n_patches, math.ceil(r.n_patches * p / 100.0)))
        dev = codebook.device
        n = r.n_docs
        self.codes = torch.empty((n, keep), dtype=torch.int64, device=dev)
        self.emb = torch.empty((n, keep, r.dim), device=dev)
        for start, x, sal in pages.chunks():
            t = x.shape[0]
            codes = nearest(x.reshape(-1, r.dim), self.codebook,
                            tf32).reshape(t, r.n_patches)
            # every patch of a page is valid: the top `keep` by salience
            order = torch.sort(sal, dim=1, descending=True, stable=True)
            idx = order.indices[:, :keep]
            self.codes[start:start + t] = torch.gather(codes, 1, idx)
            self.emb[start:start + t] = torch.gather(
                x, 1, idx[:, :, None].expand(t, keep, r.dim))
            del x, codes, order, idx
        self.mask = torch.ones((n, keep), dtype=torch.bool, device=dev)
        self.present = presence(self.codes, self.mask, 1 << bits)
        self.ham = popcount_table(bits, dev)

    def _float_scores(self, q, qmf, ids):
        """Float late interaction of each query with its pages ids (B, P)."""
        emb = self.emb[ids]                                  # (B, P, M, D)
        with fp32():
            sim = torch.einsum("bqd,bpmd->bqpm", lower(q, self.tf32),
                               lower(emb, self.tf32))
        per_q = torch.where(self.mask[ids][:, None], sim, NEG).amax(dim=-1)
        return (per_q * qmf[:, :, None]).sum(dim=1)

    def search(self, q, qm):
        """-> (scores (B, top_k), ids (B, top_k))."""
        b, mq, d = q.shape
        qmf = qm.float()
        q_codes = nearest(q.reshape(b * mq, d).float(), self.codebook,
                          self.tf32).reshape(b, mq)
        sim = self.ham[q_codes]                              # (B, Mq, 2^bits)
        qmi = qm.to(torch.int32)
        n = self.present.shape[0]
        top_s = torch.empty((b, 0), dtype=torch.int32, device=q.device)
        top_i = torch.empty((b, 0), dtype=torch.int64, device=q.device)
        for s in range(0, n, SWEEP_PAGES):
            per_q = set_max(sim, self.present[s:s + SWEEP_PAGES],
                            BINARY_MASKED)
            sc = (per_q * qmi[:, :, None]).sum(dim=1, dtype=torch.int32)
            ids = torch.arange(s, s + sc.shape[1], device=q.device).expand(
                b, -1)
            top_s, top_i = top_stable(torch.cat([top_s, sc], 1),
                                      torch.cat([top_i, ids], 1), self.p1)
        out_s, out_i = [], []
        for r0 in range(0, b, ROWS):
            rows = slice(r0, r0 + ROWS)
            s3, i3 = self._stages_2_3(q[rows], qmf[rows], top_i[rows])
            out_s.append(s3)
            out_i.append(i3)
        return torch.cat(out_s), torch.cat(out_i)

    def _stages_2_3(self, q, qmf, pool):
        b, mq, d = q.shape
        # stage 2: ADC over the pool's kept codes
        table = matmul(q.reshape(b * mq, d), self.codebook.t(),
                       self.tf32).reshape(b, mq, -1)
        codes = self.codes[pool]                             # (B, p1, M)
        p, m = codes.shape[1], codes.shape[2]
        adc = torch.gather(table, 2, codes.reshape(b, 1, p * m).expand(
            b, mq, p * m)).reshape(b, mq, p, m)
        per_q = torch.where(self.mask[pool][:, None], adc, NEG).amax(dim=-1)
        s2 = (per_q * qmf[:, :, None]).sum(dim=1)
        _, ids2 = top_stable(s2, pool, self.p2)
        # stage 3: float late interaction over the pool's kept patches
        return top_stable(self._float_scores(q, qmf, ids2), ids2, self.top_k)

    def exact(self, q, qm, ids):
        """The final score of pages ``ids`` (B, P): float late interaction
        over their kept patches."""
        return self._float_scores(q, qm.float(), ids.long())
