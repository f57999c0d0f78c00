"""The numbers that decide ``correct``, and their comparison with the limits.

For a sample of answered queries (S queries, k answers each), against the
reference's true scores (``reference/exact.py``):

- ``bad_answers``: answers that cannot be right whatever the scores: an id
  outside the corpus, an id twice in one answer, a NaN score, fewer than k
  answers, or scores that rise along an answer. Limit 0.
- ``rank_gap_mean``: the mean, over queries and ranks r, of the gap by
  which the true score of the program's r-th best answer lies below the
  true r-th best score. 0 for an exact answer. Rounding in the program's
  planes swaps answers only where true scores lie closer together than
  the rounding, and by about that much, so the mean grows with the square
  of the rounding: it parts the program's bfloat16 planes from a lower
  precision more widely than any widest gap does.
- ``score_rms``: the root mean square, over every sampled answer, of the
  gap between the score the program returned and the true score of the
  row it names.

``rank_gap`` and ``score_err``, the widest of the same gaps, are printed
beside them but not compared: a lower precision reads only about three
times what the program reads there, and they swing from seed to seed.
"""

from __future__ import annotations

import numpy as np


def bad_answers(ids: np.ndarray, scores: np.ndarray, n: int, k: int) -> int:
    ids = np.asarray(ids)
    scores = np.asarray(scores, dtype=np.float64)
    if ids.ndim != 2 or ids.shape[1] != k or scores.shape != ids.shape:
        return int(ids.shape[0] * k) if ids.ndim == 2 else k
    bad = (ids < 0) | (ids >= n) | np.isnan(scores)
    srt = np.sort(ids, axis=1)
    dup = np.zeros_like(bad)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    rising = np.zeros_like(bad)
    rising[:, 1:] = scores[:, 1:] > scores[:, :-1]
    return int(bad.sum() + dup.sum() + rising.sum())


def measures(ids, scores, top, probed, n: int, k: int) -> dict:
    """The three numbers for answers ``ids`` / ``scores`` (S, k), given the
    reference's true best scores ``top`` (S, k, descending) and the true
    scores ``probed`` of ``ids``."""
    ids = np.asarray(ids)
    probed = np.asarray(probed, dtype=np.float64)
    got = -np.sort(-np.where(np.isnan(probed), -np.inf, probed), axis=1)
    with np.errstate(invalid="ignore"):
        gap = np.asarray(top, dtype=np.float64) - got
        err = np.abs(np.asarray(scores, dtype=np.float64) - probed)
    if not gap.size:
        return {"bad_answers": bad_answers(ids, scores, n, k), "rank_gap_mean": float("inf"),
                "score_rms": float("inf"), "rank_gap": float("inf"), "score_err": float("inf")}
    gap = np.where(np.isfinite(gap), gap, np.inf)
    err = np.where(np.isfinite(err), err, np.inf)
    return {
        "bad_answers": bad_answers(ids, scores, n, k),
        "rank_gap_mean": float(np.mean(gap)),
        "score_rms": float(np.sqrt(np.mean(np.square(err)))),
        "rank_gap": float(np.max(gap)),
        "score_err": float(np.max(err)),
    }


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value": v, "limit": l}}): correct when every
    number is at most its limit (a missing or non-finite number fails)."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        fine = v is not None and np.isfinite(v) and v <= limit
        ok &= bool(fine)
        out[name] = {"value": v if v is None or np.isfinite(v) else str(v), "limit": limit}
    return ok, out
