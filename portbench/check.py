"""The numbers that decide ``correct``: the served answers of a sample of
the window's requests against the plain reference's.

  lost         requests that failed or never came back
  bad_answers  sampled answers that are malformed: not ``top_k`` ids, an
               id outside the corpus or twice in one answer, a score that
               is not finite
  score_err    the widest gap between a served score and the reference's
               score of the same page for the same query, relative to it
  rank_miss    the share of sampled answers whose rank gap (the widest gap
               by which a served score lies below the reference's score at
               the same rank, relative to it) passes RANK_TOL

``lost`` and ``bad_answers`` are exact (limit 0). The limits of the other
two are each cell's, set from readings on the card.

A cell whose kind has an encoder stage judges the encoder apart from the
search, and the search on the embeddings the port served, so
``score_err`` and ``rank_miss`` read the search alone there:

  enc_err      the median, over the sampled queries, of the relative
               Frobenius error of the served embeddings against the
               reference encoder's, on the query's valid tokens (the
               widest over the query's instances in the window; a query
               none of whose instances is found reads ``NOT_SERVED``)
  enc_miss     the share of sampled queries whose error passes the cell's
               ``enc_tol``: where a routed encoder's near-tie reroutes
               show, as ``rank_miss`` counts code near-ties

On qwen2-1.5b with bfloat16 activations (the cell qenc-flat4m-backlog,
68 sound runs of 64 queries) a query's error read 0.0156-0.0268 and the
medians 0.0196-0.0207; the control (products' inputs in float8 e4m3)
read 0.151-0.245 a query, medians 0.191-0.196 (5 seeds); a query given
another's embeddings about 1.5. ``enc_tol`` 0.08 sits 3.0x above the
widest sound error and 1.9x under the least control error; ``enc_err``'s
limit 0.08 3.9x above the sound medians and 2.4x under the control's;
``enc_miss``'s 0.02 lets one query of 64 pass, where the fault that
gives each batch's first query the batch before's embeddings read 6-11
of 64 and the control all 64. The search there, judged on the served
embeddings, read ``score_err`` 1.1e-7-2.3e-7 and ``rank_miss`` 0 (TF32
control: 1.1e-4-1.9e-4 and 0.33-0.50), under the flat cell's limits.

``rank_miss`` counts answers, not the widest gap, because a funnel may
part from its reference without fault: a patch nearly equidistant from
two centroids gets either code by rounding, and a code that moves a page
across a stage's cut moves the final answer. On 4096 queries of the
cascade cell, 333 of 80.6M kept codes differed and 2 answers had rank
gaps of 5.5e-4 and 1.7e-3; every other answer's gap was at most 1.23e-6.
RANK_TOL sits 8x above that, and below the TF32 control's widest score
errors (2.6e-5 to 6.2e-5), which miss in 6-31% of the flat cell's answers
and 67-72% of the cascade's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

TINY = 1e-6
RANK_TOL = 1e-5
# the numbers a cell with an encoder stage adds, in the order printed
ENCODER_NUMBERS = ("enc_err", "enc_miss")
# the encoder error of a query whose served embeddings were not found (a
# served row's error is at most 2: both sides are unit rows)
NOT_SERVED = 1e9


def well_formed(answer, top_k: int, n_docs: int) -> bool:
    if answer is None:
        return False
    scores, ids = (np.asarray(a) for a in answer)
    return (scores.shape == (top_k,) and ids.shape == (top_k,)
            and bool(np.isfinite(scores).all())
            and bool(((ids >= 0) & (ids < n_docs)).all())
            and len(set(ids.tolist())) == top_k)


def numbers(answers: List[Optional[Tuple[np.ndarray, np.ndarray]]],
            ref_scores: np.ndarray, exact: np.ndarray, lost: int,
            top_k: int, n_docs: int
            ) -> Tuple[Dict[str, float], List[Optional[Tuple[float, float]]]]:
    """answers: the served (scores, ids) of each sampled request (None if
    it never came); ref_scores (S, top_k): the reference's answer; exact
    (S, top_k): the reference's score of each served page (ignored where
    the answer is malformed). Also returns each answer's score error and
    rank gap (None where malformed), for the log."""
    ok = [well_formed(a, top_k, n_docs) for a in answers]
    errs: List[Optional[Tuple[float, float]]] = []
    for j, a in enumerate(answers):
        if not ok[j]:
            errs.append(None)
            continue
        served = np.asarray(a[0], dtype=np.float64)
        e = np.asarray(exact[j], dtype=np.float64)
        r = np.asarray(ref_scores[j], dtype=np.float64)
        errs.append((float(np.max(np.abs(served - e)
                                  / np.maximum(np.abs(e), TINY))),
                     float(np.max((r - served) / np.maximum(np.abs(r), TINY)))))
    sound = [x for x in errs if x is not None]
    return {"lost": float(lost), "bad_answers": float(ok.count(False)),
            "score_err": max((x[0] for x in sound), default=0.0),
            "rank_miss": (sum(x[1] > RANK_TOL for x in sound) / len(sound)
                          if sound else 0.0)}, errs


def rel_error(served, ref, mask) -> float:
    """||served - ref|| / ||ref|| (Frobenius) over the rows ``mask``
    keeps: one query's (Lq, D) embeddings."""
    keep = mask.bool()
    s, r = served[keep].double(), ref[keep].double()
    return float(np.linalg.norm((s - r).cpu().numpy())
                 / max(float(np.linalg.norm(r.cpu().numpy())), TINY))


def encoder_numbers(errors: List[float], enc_tol: float) -> Dict[str, float]:
    """``enc_err`` and ``enc_miss`` of the sampled queries' errors."""
    if not errors:
        return {"enc_err": 0.0, "enc_miss": 0.0}
    return {"enc_err": float(np.median(errors)),
            "enc_miss": sum(e > enc_tol for e in errors) / len(errors)}


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(values[name] <= limits[name] for name in limits)
