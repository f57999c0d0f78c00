"""The plain reference against a brute-force NumPy top-k, and the judge
catching planted faults."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import check
from perfbench.reference.exact import ExactScan, int8_rows

K = 10


def brute(q, rows, k):
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    rn = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    s = qn @ rn.T
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return order, np.take_along_axis(s, order, 1), s


@pytest.fixture
def inputs():
    rng = np.random.default_rng(7)
    rows = rng.standard_normal((1000, 32)).astype(np.float16)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    return q, rows


def scan(q, rows, probe=None, control=False, block=128):
    s = ExactScan(q, K, probe=probe, control=control)
    for lo in range(0, len(rows), block):
        s.feed(lo, torch.from_numpy(rows[lo : lo + block]))
    return s.result()


def test_top_scores_and_probes_match_brute_force(inputs):
    q, rows = inputs
    ids, vals, full = brute(q.astype(np.float64), rows.astype(np.float64), K)
    probe = np.stack([ids[:, 0], np.full(len(q), 999), np.full(len(q), 5000)], 1)
    ref = scan(q, rows, probe=probe)
    np.testing.assert_allclose(ref["top"], vals, atol=1e-6)
    np.testing.assert_allclose(ref["probed"][:, 0], vals[:, 0], atol=1e-6)
    np.testing.assert_allclose(ref["probed"][:, 1], full[:, 999], atol=1e-6)
    assert np.isnan(ref["probed"][:, 2]).all()  # outside the corpus


def test_exact_answers_read_zero(inputs):
    q, rows = inputs
    ids, vals, _ = brute(q.astype(np.float64), rows.astype(np.float64), K)
    ref = scan(q, rows, probe=ids)
    m = check.measures(ids, vals.astype(np.float32), ref["top"], ref["probed"], len(rows), K)
    assert m["bad_answers"] == 0
    assert m["rank_gap"] < 1e-6 and m["score_err"] < 1e-6 and m["score_rms"] < 1e-6


def test_planted_wrong_id_and_score_error_are_caught(inputs):
    q, rows = inputs
    ids, vals, full = brute(q.astype(np.float64), rows.astype(np.float64), K)
    wrong = ids.copy()
    worst = np.argsort(full[0])[0]  # the row least like query 0
    wrong[0, 3] = worst
    ref = scan(q, rows, probe=wrong)
    m = check.measures(wrong, vals.astype(np.float32), ref["top"], ref["probed"], len(rows), K)
    assert m["rank_gap"] > 0.3 and m["score_err"] > 0.3
    ok, _ = check.judge(m, {"bad_answers": 0, "rank_gap": 1e-3, "score_err": 1e-3, "score_rms": 1e-3})
    assert not ok

    scores = vals.astype(np.float32).copy()
    scores[2, 0] += 0.01  # a score altered where it is produced
    ref = scan(q, rows, probe=ids)
    m = check.measures(ids, scores, ref["top"], ref["probed"], len(rows), K)
    assert m["rank_gap"] < 1e-6 and m["score_err"] == pytest.approx(0.01, rel=1e-3)


def test_structural_faults_count_as_bad_answers():
    ids = np.array([[0, 1, 2], [3, 3, 4], [5, 6, 99]])
    scores = np.array([[0.9, 0.8, 0.7], [0.9, 0.8, 0.85], [0.9, np.nan, 0.1]], dtype=np.float32)
    # duplicate 3, rising 0.8 -> 0.85, NaN, id 99 outside a corpus of 10
    assert check.bad_answers(ids, scores, 10, 3) == 4
    assert check.bad_answers(ids[:, :2], scores[:, :2], 10, 3) == 9  # too few answers: all of them


def test_int8_control_rounds_to_127_steps():
    x = torch.tensor([[1.0, -0.5, 0.25, 0.0]])
    v, s = int8_rows(x)
    assert v.tolist() == [[127.0, -64.0, 32.0, 0.0]]  # round half to even: -63.5 -> -64
    assert s.item() == pytest.approx(1 / 127)


def test_control_ranks_by_int8_scores(inputs):
    q, rows = inputs
    ref = scan(q, rows, control=True)
    q8, qs = int8_rows(torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True)))
    r = torch.from_numpy(rows.astype(np.float32))
    r8, rs = int8_rows(r / r.norm(dim=1, keepdim=True))
    cs = ((q8 @ r8.T) * qs * rs.T).numpy()
    np.testing.assert_allclose(ref["control_scores"], -np.sort(-cs, axis=1)[:, :K], rtol=1e-6)
