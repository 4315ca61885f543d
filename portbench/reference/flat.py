"""The plain reference of the ``flat`` configuration.

Given the codebook, the pruned codes and mask, the full codes and mask,
and the queries: the ADC score of every page (per valid query patch, the
best table entry among the codes the page holds in a valid slot; summed),
the ``rerank`` best pages in page order, their ADC score over the full
codes, and the ``top_k`` best of those in that order.
"""
from __future__ import annotations

import torch

from portbench.reference import NEG, matmul, presence, set_max, top_stable

# pages scored per step of the sweep
SWEEP_PAGES = 1 << 16


class FlatReference:

    def __init__(self, codebook, codes, mask, codes_full, mask_full, *,
                 rerank: int, top_k: int, tf32: bool = False):
        self.codebook = codebook.float()
        self.k_codes = codebook.shape[0]
        self.present = presence(codes, mask, self.k_codes)
        self.codes_full, self.mask_full = codes_full, mask_full
        self.rerank, self.top_k, self.tf32 = rerank, top_k, tf32

    def table(self, q):
        """(B, Mq, K): every query patch's dot with every centroid."""
        b, mq, d = q.shape
        return matmul(q.reshape(b * mq, d), self.codebook.t(),
                      self.tf32).reshape(b, mq, self.k_codes)

    def _full_scores(self, table, qmf, ids):
        """ADC scores over the full codes of ``ids`` (B, P)."""
        b, mq, _ = table.shape
        codes = self.codes_full[ids.long()].long()          # (B, P, M)
        valid = self.mask_full[ids.long()].bool()
        p, m = codes.shape[1], codes.shape[2]
        sim = torch.gather(table, 2, codes.reshape(b, 1, p * m).expand(
            b, mq, p * m)).reshape(b, mq, p, m)
        per_q = torch.where(valid[:, None], sim, NEG).amax(dim=-1)
        return (per_q * qmf[:, :, None]).sum(dim=1)          # (B, P)

    def search(self, q, qm):
        """-> (scores (B, top_k), ids (B, top_k))."""
        table = self.table(q)
        qmf = qm.float()
        b = q.shape[0]
        n = self.present.shape[0]
        top_s = torch.empty((b, 0), device=q.device)
        top_i = torch.empty((b, 0), dtype=torch.int64, device=q.device)
        for s in range(0, n, SWEEP_PAGES):
            per_q = set_max(table, self.present[s:s + SWEEP_PAGES], NEG)
            sc = (per_q * qmf[:, :, None]).sum(dim=1)
            ids = torch.arange(s, s + sc.shape[1], device=q.device).expand(
                b, -1)
            top_s, top_i = top_stable(torch.cat([top_s, sc], 1),
                                      torch.cat([top_i, ids], 1),
                                      self.rerank)
        return top_stable(self._full_scores(table, qmf, top_i), top_i,
                          self.top_k)

    def exact(self, q, qm, ids):
        """The final score of pages ``ids`` (B, P): ADC over full codes."""
        return self._full_scores(self.table(q), qm.float(), ids)
