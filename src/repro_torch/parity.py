"""Comparison of two top-k results up to near-ties, in numpy only.

Two searches over the same index may order documents whose scores agree
to within float rounding differently (the kernel and the plain version sum
in different orders). ``topk_mismatches`` names the positions where two
results differ by more than that. ``tie_aware_recall_at_k`` scores an
approximate search against an exhaustive one over the same scoring
function. The parity tests and ``chip_smoke.py`` share them.
"""
from __future__ import annotations

import numpy as np


def topk_mismatches(ids_a, s_a, ids_b, s_b, tol=1e-4):
    """Positions where two (B, k) top-k results differ by more than a
    reordering inside a group of scores within ``tol`` (relative, floor 1)
    of each other, or a swap at the cut-off of such a group."""
    ids_a, s_a, ids_b, s_b = map(np.asarray, (ids_a, s_a, ids_b, s_b))
    bad = []
    for r in range(ids_a.shape[0]):
        for j in range(ids_a.shape[1]):
            if ids_a[r, j] == ids_b[r, j]:
                continue
            scale = tol * max(1.0, abs(float(s_a[r, j])))
            if abs(float(s_a[r, j]) - float(s_b[r, j])) > scale:
                bad.append((r, j))
                continue
            hit = np.nonzero(ids_b[r] == ids_a[r, j])[0]
            ref = s_b[r, hit[0]] if hit.size else s_b[r, -1]
            if abs(float(ref) - float(s_a[r, j])) > scale:
                bad.append((r, j))
    return bad


def tie_aware_recall_at_k(scores, ids, oracle_scores, k, rtol=1e-5):
    """Mean fraction of a query's returned top-k (ids >= 0) whose score
    reaches the oracle's k-th score, within ``rtol`` (relative, floor 1).
    Documents with identical codes score alike, so an equal-scored
    substitute counts; sentinel rows never do."""
    out = []
    for qi in range(np.shape(scores)[0]):
        thresh = np.sort(np.asarray(oracle_scores[qi]))[::-1][k - 1]
        tol = rtol * max(abs(float(thresh)), 1.0)
        s = np.asarray(scores[qi][:k])
        valid = np.asarray(ids[qi][:k]) >= 0
        out.append(float(np.sum((s >= thresh - tol) & valid)) / k)
    return float(np.mean(out))

