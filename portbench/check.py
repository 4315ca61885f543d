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


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(values[name] <= limits[name] for name in limits)
