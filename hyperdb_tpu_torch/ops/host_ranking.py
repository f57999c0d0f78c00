"""Host (NumPy) ranking fast path for tiny corpora.

Below ``CONFIG.host_path_max_cells`` score cells (rows x queries) a device
launch and readback cost more than the scan itself, so the engine ranks
directly on the host master arrays — same masks, same NaN policy, same
recency term, same segment-max document reduction, and the same tie order
as the device top-k (higher score first, lower index on ties) — so results
are interchangeable with the device path.

Semantics mirrored from hyperdb_tpu_torch.ops.metrics / ops.ranking:
- all metrics "higher is better" (1/(1+dist) transforms, d_max - hamming)
- pure binarization (x > 0), never mutating inputs (Q6 fix)
- NaN scores -> -inf (constant-vector pearson, 0/0 jaccard)
- zero norms treated as 1 in cosine
"""

from __future__ import annotations

import numpy as np

NEG_INF = float("-inf")


def _normalize(x: np.ndarray) -> np.ndarray:
    n = np.sqrt(np.sum(np.square(x, dtype=x.dtype), axis=-1, keepdims=True))
    n[n == 0] = 1.0
    return x / n


def host_scores(q: np.ndarray, v: np.ndarray, metric: str) -> np.ndarray:
    """(B, d) x (N, d) -> (B, N) similarities; parity with ops.metrics.

    Computes in f32 except when either side is f64 (store.host_view keeps
    f64 masters at full precision so f64 corpora match the NumPy
    reference's low-order score bits — ADVICE r2)."""
    dtype = (
        np.float64
        if np.float64 in (np.asarray(q).dtype, np.asarray(v).dtype)
        else np.float32
    )
    q = np.asarray(q, dtype=dtype)
    v = np.asarray(v, dtype=dtype)
    if metric == "dot_product":
        return q @ v.T
    if metric == "cosine_similarity":
        return _normalize(q) @ _normalize(v).T
    if metric == "euclidean_metric":
        d2 = (
            np.sum(v * v, axis=1)[None, :]
            - 2.0 * (q @ v.T)
            + np.sum(q * q, axis=1)[:, None]
        )
        return 1.0 / (1.0 + np.sqrt(np.maximum(d2, 0.0)))
    if metric == "manhattan_distance":
        dist = np.abs(v[None, :, :] - q[:, None, :]).sum(axis=-1)
        return 1.0 / (1.0 + dist)
    if metric == "jaccard_similarity":
        qb = (q > 0).astype(np.float32)
        vb = (v > 0).astype(np.float32)
        inter = qb @ vb.T
        union = vb.sum(axis=1)[None, :] + qb.sum(axis=1)[:, None] - inter
        with np.errstate(invalid="ignore", divide="ignore"):
            return inter / union  # 0/0 -> NaN, scrubbed by the ranker
    if metric == "hamming_distance":
        qb = (q > 0).astype(np.float32)
        vb = (v > 0).astype(np.float32)
        inter = qb @ vb.T
        dist = vb.sum(axis=1)[None, :] + qb.sum(axis=1)[:, None] - 2.0 * inter
        return np.float32(v.shape[-1]) - dist
    if metric == "pearson_correlation":
        qc = q - q.mean(axis=-1, keepdims=True)
        vc = v - v.mean(axis=-1, keepdims=True)
        num = qc @ vc.T
        den = (
            np.sqrt(np.sum(qc * qc, axis=-1))[:, None]
            * np.sqrt(np.sum(vc * vc, axis=-1))[None, :]
        )
        r = num / np.where(den == 0, 1.0, den)
        return np.where(den == 0, np.nan, r)
    raise ValueError(f"Unknown metric: {metric}")


def host_top_k(s: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Top-k with ``lax.top_k`` tie order (descending score, ascending index).

    argpartition bounds the sort to k + ties instead of N log N; plain
    advanced indexing instead of take_along_axis (whose index-broadcast
    helper costs ~40 us per call — material at demo scale).
    """
    b, n = s.shape
    k = min(k, n)
    rows = np.arange(b)[:, None]
    if k < n:
        part = np.argpartition(-s, k - 1, axis=1)[:, :k]
        # argpartition picks an ARBITRARY subset of the scores tied at the
        # k-th boundary; lax.top_k keeps the lowest indices. Repair each row
        # whose boundary value also occurs outside the partition by
        # re-selecting over all candidates >= the boundary value.
        kth = s[rows, part].min(axis=1)
        ties_total = (s >= kth[:, None]).sum(axis=1)
        for i in np.flatnonzero(ties_total > k):
            # rows strictly above the boundary all survive (< k of them);
            # the boundary value's ties fill the rest in INDEX order —
            # exactly lax.top_k's resolution — without ever sorting more
            # than k candidates (widely-shared boundary values, e.g. the
            # integer-scored hamming/jaccard metrics, would otherwise
            # degenerate to a full-row sort)
            row = s[i]
            above = np.flatnonzero(row > kth[i])
            at = np.flatnonzero(row == kth[i])[: k - above.size]
            cand = np.concatenate([above, at])
            part[i] = cand[np.lexsort((cand, -row[cand]))]

    else:
        part = np.tile(np.arange(n), (b, 1))
    part_vals = s[rows, part]
    order = np.lexsort((part, -part_vals), axis=1)
    idx = part[rows, order]
    return s[rows, idx], idx


def rank_block_host(
    q_block: np.ndarray,
    rows: np.ndarray,
    k: int,
    metric: str,
    doc_mask: np.ndarray | None = None,
    recency: np.ndarray | None = None,
    row_docs: np.ndarray | None = None,
    num_docs: int | None = None,
    rows_norm: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Score + (optionally) reduce rows to documents + top-k, all on host.

    Mirrors ``rank_top_k`` when ``row_docs`` is None (rows ARE documents)
    and ``rank_docs_top_k`` otherwise (per-document max over chunk rows,
    SURVEY.md Q1). ``doc_mask`` / ``recency`` are document-level, matching
    the engine's fused program order: NaN scrub, then doc reduction, then
    recency add, then mask. ``rows_norm`` (the store's cached unit-norm
    corpus) skips the per-call corpus normalization for cosine.
    """
    # f16 wire blocks (serving upload opt-in) score in f32 on the host path
    q_block = np.asarray(q_block, dtype=np.float32)
    if metric == "cosine_similarity" and rows_norm is not None:
        # rows_norm carries the master dtype (f64 masters stay f64 —
        # ADVICE r2); the f32 query is promoted by the matmul
        q32 = np.asarray(q_block, dtype=np.float32)
        s = _normalize(q32) @ rows_norm.T
    else:
        s = host_scores(np.asarray(q_block, dtype=np.float32), rows, metric)
    score_dtype = s.dtype if s.dtype == np.float64 else np.float32
    s = np.where(np.isnan(s), NEG_INF, s).astype(score_dtype)

    if row_docs is not None:
        nd = int(num_docs)
        doc_s = np.full((s.shape[0], nd), NEG_INF, dtype=score_dtype)
        bidx = np.arange(s.shape[0])[:, None]
        np.maximum.at(doc_s, (bidx, np.asarray(row_docs)[None, :]), s)
        s = doc_s
    if recency is not None:
        s = s + np.asarray(recency, dtype=score_dtype)[None, :]
    if doc_mask is not None:
        s = np.where(np.asarray(doc_mask, dtype=bool)[None, :], s, NEG_INF)
    return host_top_k(s, k)
