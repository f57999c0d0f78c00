"""The query engine.

Counterpart of ``hyperdb_tpu/query/engine.py``: filters become host masks,
then one ranking call runs on the store's device (score + NaN scrub + mask
+ recency + top-k). Served: unchunked corpora (one row per document)
on float, int8 and int8-pure planes, with the grouped, kernel and streamed
routes of all seven metrics; chunked corpora (several rows per document,
ranked at document level); the key-filter override branch; the tiny-corpus
host path; and text queries, embedded on the host path or kept on the
device as a query block. With an IVF index (``index/ivf.py``) a single
query is pre-filtered to its probed candidates and scored on them alone
(``ranking.rank_gathered``), and a batch can share one probe frontier
(:func:`_rank_block_ivf`); with a projscan index an int8-pure scan runs as
its two stages (``index/projscan.py``).

Preserved reference semantics (SURVEY.md §2.4): Q10/Q11 metric naming and
the brute-force INFO message, Q13 empty-candidate handling, Q16/Q17
recency over the surviving documents, Q20 soft failures.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from hyperdb_tpu_torch.config import CONFIG
from hyperdb_tpu_torch.core.nested import get_nested_value
from hyperdb_tpu_torch.core.store import bucket_size
from hyperdb_tpu_torch.ops.host_ranking import rank_block_host
from hyperdb_tpu_torch.ops import ranking as _ranking
from hyperdb_tpu_torch.ops.metrics import METRICS, pearson_center_normalize
from hyperdb_tpu_torch.ops.quantized import rank_top_k_int8
from hyperdb_tpu_torch.ops.ranking import rank_top_k
from hyperdb_tpu_torch.query import filters as _filters
from hyperdb_tpu_torch.utils import log
from hyperdb_tpu_torch.utils.devio import fetch

# Query metric -> constructor/ANN metric (reference hyperdb.py:1453-1459).
METRIC_TO_ANN = {
    "dot_product": "dot",
    "cosine_similarity": "cosine",
    "euclidean_metric": "euclidean",
    "manhattan_distance": "manhattan",
    "hamming_distance": "hamming",
}


def _pad_pow2(k: int) -> int:
    return 1 << max(0, (k - 1)).bit_length() if k > 1 else 1


def _grouped_group(n_pad: int, batch: int) -> int:
    """Resolved group size for the grouped routes, or 0 when the corpus is
    too small / not group-divisible (one halving rule for every caller)."""
    if CONFIG.grouped_topk_min_rows <= 0 or n_pad < CONFIG.grouped_topk_min_rows:
        return 0
    group = _ranking._auto_group(batch)
    while group >= 32 and n_pad % group:
        group //= 2
    return group if group >= 32 and n_pad % group == 0 else 0


def is_numeric_array(array: np.ndarray) -> bool:
    return np.issubdtype(array.dtype, np.number) and not np.issubdtype(
        array.dtype, np.complexfloating
    )


def generate_and_validate_query_vector(db, query_input) -> np.ndarray:
    """String -> embedding; array-like -> validated (reference
    hyperdb.py:1197-1216). Returns a 1-D float32 vector."""
    if (
        isinstance(query_input, np.ndarray)
        and query_input.dtype == np.float32
        and query_input.ndim == 1
        and query_input.size
        and (db.dim is None or query_input.shape[0] == db.dim)
    ):
        return query_input
    try:
        if isinstance(query_input, str):
            emb = db.embedding_function([query_input])[0]
            query_vector = np.squeeze(np.asarray(emb, dtype=np.float32))
            if query_vector.ndim == 2:  # chunked long query: average chunks
                query_vector = query_vector.mean(axis=0)
        elif isinstance(query_input, (list, np.ndarray, tuple)):
            arr = np.array(query_input)
            if not is_numeric_array(arr):
                raise ValueError("Numeric array-like query_input expected.")
            if arr.ndim > 2:
                raise ValueError("query_input must be a 1D or 2D array.")
            if arr.ndim == 1:
                arr = arr[None, :]
            if db.dim is not None and arr.shape[1] != db.dim:
                raise ValueError(
                    f"The dimension of the query_vector ({arr.shape[1]}) must "
                    f"match the dimension of the vectors in the database ({db.dim})."
                )
            query_vector = np.squeeze(arr.astype(np.float32))
        else:
            raise ValueError(
                "query_input must be either a string or a numeric array-like object."
            )
        if query_vector.size == 0:
            raise ValueError("The generated query vector is empty.")
        return query_vector
    except Exception as e:
        print(f"An exception occurred due to invalid input: {e}")
        raise


def generate_query_vectors_batch(db, texts) -> np.ndarray:
    """Embed a block of query texts in one encoder pass -> (B, d) f32.

    The batched twin of the string branch of
    :func:`generate_and_validate_query_vector`: long queries (more than 510
    tokens) are averaged over their chunks as the single-query path does.
    """
    if not isinstance(texts, (list, tuple)) or not all(isinstance(t, str) for t in texts):
        raise ValueError("texts must be a list of strings")
    if not texts:
        return np.zeros((0, db.dim or 0), dtype=np.float32)
    emb, src, _ = db.embedding_function(list(texts))
    emb = np.asarray(emb, dtype=np.float32)
    src = np.asarray(src, dtype=np.int64)
    if emb.shape[0] == len(texts) and np.array_equal(src, np.arange(len(texts))):
        return emb
    out = np.zeros((len(texts), emb.shape[1]), dtype=np.float32)
    np.add.at(out, src, emb)
    counts = np.bincount(src, minlength=len(texts)).astype(np.float32)
    return out / np.maximum(counts, 1.0)[:, None]


def _default_embed_path(db):
    """``(embedder, prepare_fn)`` when ``db`` embeds through the default
    chunk-then-encode pipeline (its own or one built by
    ``make_embedding_function``), ``(None, None)`` for other embedding
    functions."""
    fn = db.embedding_function
    if fn == getattr(db, "get_embedding", None):
        return db._embedder(), db.prepare_texts_and_indices
    emb = getattr(fn, "embedder", None)
    tok = getattr(fn, "tokenizer", None)
    if emb is not None and tok is not None:
        from hyperdb_tpu_torch.core import chunker as _chunker

        return emb, lambda docs: _chunker.prepare_texts_and_indices(docs, tok)
    return None, None


def generate_query_vectors_batch_device(db, texts):
    """Twin of :func:`generate_query_vectors_batch` whose block stays on
    the encoder's device: a ``(b_pad, d)`` float32 tensor, ``b_pad`` the
    next power of two >= ``len(texts)`` (pad rows are finite; pass
    ``n_valid=len(texts)`` to the batch query). None when the block cannot
    stay there and the caller must take the host path: embedding functions
    outside the default pipeline, embedders without ``encode_device`` (the
    hash and hybrid encoders compute on the host), or texts that chunk
    (the chunk mean is host arithmetic)."""
    if not isinstance(texts, (list, tuple)) or not all(isinstance(t, str) for t in texts):
        raise ValueError("texts must be a list of strings")
    if not texts:
        return None
    embedder, prepare = _default_embed_path(db)
    if embedder is None or not hasattr(embedder, "encode_device"):
        return None
    chunk_texts, src, _ = prepare(list(texts))
    if len(chunk_texts) != len(texts) or not np.array_equal(
        np.asarray(src), np.arange(len(texts))
    ):
        return None
    return embedder.encode_device(chunk_texts)


def handle_timestamps(db, recency_bias, timestamp_key, doc_indices) -> np.ndarray | None:
    """Recency term over surviving documents (reference hyperdb.py:1310-1346):
    a dense (num_docs,) f32 array (zeros outside ``doc_indices``), or None
    when recency_bias == 0."""
    if recency_bias == 0:
        return None
    if timestamp_key is None:
        timestamp_key = "timestamp"
    if timestamp_key not in db.metadata_keys:
        raise ValueError(
            f"The timestamp_key '{timestamp_key}' must be present in "
            f"metadata_keys when recency_bias is not 0."
        )
    timestamps = [
        get_nested_value(db.documents[i], [timestamp_key]) for i in doc_indices
    ]
    if any(t is None for t in timestamps):
        raise ValueError(
            "All timestamps must be populated when recency_bias is not 0 "
            "or timestamp_key is provided."
        )
    t = np.asarray(timestamps, dtype=np.float64)
    dense = np.zeros(len(db.documents), dtype=np.float32)
    dense[np.asarray(doc_indices, dtype=np.int64)] = (
        recency_bias * np.exp(t - t.max())
    ).astype(np.float32)
    return dense


def _base_mask(num_docs: int, filters) -> np.ndarray:
    """skip_doc is applied first (reference hyperdb.py:1474-1481)."""
    mask = np.ones(num_docs, dtype=bool)
    for name, params in filters or ():
        if name not in _filters.FILTER_NAMES:
            raise ValueError(f"Invalid filter name {name}")
        if name == "skip_doc":
            mask &= _filters.skip_doc_mask(num_docs, params)
            break
    return mask


def execute_query(
    db,
    query_input,
    top_k: int = 5,
    return_similarities: bool = True,
    filters=None,
    recency_bias: float = 0,
    timestamp_key=None,
    metric: str = "cosine_similarity",
    ann_percent: int = 5,
):
    start_time = _time.perf_counter()
    num_docs = len(db.documents)
    if db.vectors is None or len(db.vectors) == 0 or not db.documents:
        raise Exception("The database is empty. Cannot proceed with the query.")
    if metric not in METRICS:
        raise ValueError(
            f"Invalid metric '{metric}'. Supported: "
            "'dot_product', 'cosine_similarity', 'euclidean_metric', "
            "'manhattan_distance', 'jaccard_similarity', "
            "'pearson_correlation', 'hamming_distance'"
        )

    query_vector = generate_and_validate_query_vector(db, query_input)
    if query_vector.ndim != 1:
        query_vector = query_vector[0]

    use_ann = METRIC_TO_ANN.get(metric) == db.ann_metric
    if not use_ann:
        log.info(
            f"INFO: Metric '{metric}' is not supported by the current ANN "
            f"index ('{db.ann_metric}'). Bruteforce method used instead."
        )

    filters = list(filters) if filters is not None else None
    base_mask = _base_mask(num_docs, filters)
    mask = base_mask.copy()

    # ANN pre-filter (Q12): candidate rows and their documents. projscan
    # accelerates inside _rank_block instead, where it needs cand_rows None
    cand_rows = None
    index = db.ann_index
    if use_ann and getattr(index, "is_ann", False) and getattr(index, "kind", None) != "projscan":
        budget = max(top_k * 20, -(-int(base_mask.sum()) * ann_percent // 100))
        cand_rows = index.probe(query_vector, budget)
        cand_docs = np.zeros(num_docs, dtype=bool)
        if cand_rows.size:
            cand_docs[np.asarray(db.source_indices, dtype=np.int64)[cand_rows]] = True
        mask &= cand_docs

    override = None
    if filters:
        mask, override = _filters.apply_filters(db, filters, mask)

    # empty-candidate fallback (Q13)
    if not mask.any():
        if filters:
            log.info(
                "INFO: Falling back to brute-force search after no results "
                "from ANN pre-filtering."
            )
            cand_rows = None
            mask, override = _filters.apply_filters(db, filters, base_mask.copy())
        else:
            log.info("INFO: No document matches your query.")
            return []
    if not mask.any():
        log.info(
            "INFO: No document matches your query with the brute-force "
            "method and the current filters."
        )
        return []

    surviving = int(mask.sum())
    if top_k > surviving:
        log.info(
            f"Warning: top_k ({top_k}) is greater than the number of filtered "
            f"documents ({surviving}). Setting top_k to {surviving}."
        )
        top_k = surviving
    if surviving == 1:
        # reference stdout parity (ranking_algorithm.py:188-190)
        if override is not None:
            log.info("Info: Only one document left.")
        else:
            src = np.asarray(db.source_indices, dtype=np.int64)
            if int((src == int(np.flatnonzero(mask)[0])).sum()) == 1:
                log.info("Info: Only one document left.")

    recency = handle_timestamps(
        db, recency_bias, timestamp_key, np.flatnonzero(mask)
    )

    with db.stats.phase("query.rank"):
        doc_ids, vals = _rank_block(
            db, query_vector[None, :], mask, override, recency, metric, top_k,
            cand_rows=cand_rows,
        )
    doc_ids, scores_out = doc_ids[0], vals[0]

    db.stats.record("query.execute", _time.perf_counter() - start_time)
    results = []
    ann_recency_path = use_ann and recency_bias != 0
    for doc_id, score in zip(doc_ids, scores_out):
        document = db.documents[doc_id]
        if not return_similarities:
            results.append(document)
        elif ann_recency_path:
            results.append((document, float(score)))  # Q4 shape parity
        else:
            results.append((document, float(score), int(doc_id)))
    return results


def execute_query_batch(
    db,
    query_inputs,
    top_k: int = 5,
    return_similarities: bool = True,
    filters=None,
    recency_bias: float = 0,
    timestamp_key=None,
    metric: str = "cosine_similarity",
    ann_percent: int = 5,
    n_valid: int | None = None,
):
    """Batched multi-query search: the filter masks are computed once and the
    whole (B, d) block rides one ranking call. Per-query results have the
    shape of :func:`execute_query`'s."""
    doc_ids, scores_out = execute_query_batch_arrays(
        db,
        query_inputs,
        top_k=top_k,
        filters=filters,
        recency_bias=recency_bias,
        timestamp_key=timestamp_key,
        metric=metric,
        ann_percent=ann_percent,
        n_valid=n_valid,
    )
    results = []
    for b in range(doc_ids.shape[0]):
        row = []
        for doc_id, score in zip(doc_ids[b], scores_out[b]):
            document = db.documents[int(doc_id)]
            if return_similarities:
                row.append((document, float(score), int(doc_id)))
            else:
                row.append(document)
        results.append(row)
    return results


def execute_query_batch_arrays(
    db,
    query_inputs,
    top_k: int = 5,
    filters=None,
    recency_bias: float = 0,
    timestamp_key=None,
    metric: str = "cosine_similarity",
    ann_percent: int = 5,
    n_valid: int | None = None,
):
    """Array-level core of :func:`execute_query_batch`.

    Returns ``(doc_ids, scores)`` as ``(B, k)`` int64 / float32 NumPy arrays
    with ``k = min(top_k, surviving docs)`` (``k == 0`` when filters
    eliminate everything). float16 query blocks stay float16 up to the
    ranking call. ``query_inputs`` may be a 2-D tensor on the database's
    device (a tensor elsewhere raises). ``n_valid`` limits how many leading
    rows are real queries.
    """
    num_docs = len(db.documents)
    start_time = _time.perf_counter()
    if db.vectors is None or len(db.vectors) == 0 or not db.documents:
        raise Exception("The database is empty. Cannot proceed with the query.")
    if metric not in METRICS:
        raise ValueError(f"Invalid metric '{metric}'.")

    device_block = isinstance(query_inputs, torch.Tensor) and query_inputs.ndim == 2
    if device_block:
        # a block already on the store's device (the text path's
        # generate_query_vectors_batch_device): it rides into the scan as it
        # is, never fetched or padded here
        if query_inputs.device != db._store.device:
            raise ValueError(
                f"query block is on {query_inputs.device}, the database on "
                f"{db._store.device}"
            )
        q_block = query_inputs
    elif isinstance(query_inputs, np.ndarray) and query_inputs.ndim == 2:
        q_block = (
            query_inputs
            if query_inputs.dtype == np.float16
            else query_inputs.astype(np.float32)
        )
    else:
        q_block = np.stack(
            [generate_and_validate_query_vector(db, q) for q in query_inputs]
        ).astype(np.float32)
    if db.dim is not None and q_block.shape[1] != db.dim:
        raise ValueError(
            f"The dimension of the query vectors ({q_block.shape[1]}) must "
            f"match the dimension of the vectors in the database ({db.dim})."
        )

    # Batch-dim bucketing (HYPERDB_BATCH_BUCKET): pad B up to the next power
    # of two with copies of row 0 and slice the pad rows off the results, so
    # both packages scan the same batch shapes. Host-path-sized corpora skip
    # it (padding could push them onto the device path).
    b_real = q_block.shape[0]
    if (
        not device_block  # device blocks arrive padded to a power of two
        and CONFIG.batch_bucket
        and db._store.num_rows * b_real > CONFIG.host_path_max_cells
    ):
        b_pad = _pad_pow2(b_real)
        if b_pad != b_real:
            q_block = np.concatenate(
                [q_block, np.repeat(q_block[:1], b_pad - b_real, axis=0)]
            )

    filters = list(filters) if filters is not None else None
    base_mask = _base_mask(num_docs, filters)
    mask = base_mask.copy()
    override = None
    if filters:
        mask, override = _filters.apply_filters(db, filters, mask)
    n_out = b_real if n_valid is None else min(int(n_valid), b_real)
    if not mask.any():
        return (
            np.zeros((n_out, 0), dtype=np.int64),
            np.zeros((n_out, 0), dtype=np.float32),
        )

    k = min(top_k, int(mask.sum()))
    recency = handle_timestamps(
        db, recency_bias, timestamp_key, np.flatnonzero(mask)
    )
    doc_ids = scores_out = None
    if (
        METRIC_TO_ANN.get(metric) == db.ann_metric
        and hasattr(db.ann_index, "probe_batch")  # IVF
        and override is None
        # IVF probing is host arithmetic: a device block stays on the exact
        # masked scan instead of paying a fetch
        and not device_block
        and num_docs == db._store.num_rows
        and num_docs >= CONFIG.batch_ivf_min_rows
        and db._store.precision != "int8-pure"
    ):
        budget = max(top_k * 20, -(-int(base_mask.sum()) * ann_percent // 100))
        doc_ids, scores_out = _rank_block_ivf(db, q_block, mask, recency, metric, k, budget)
    if doc_ids is None:
        doc_ids, scores_out = _rank_block(db, q_block, mask, override, recency, metric, k)

    db.stats.record("query.batch_arrays", _time.perf_counter() - start_time)
    db.stats.bump("query.batch_queries", n_out)
    return (
        np.asarray(doc_ids[:n_out], dtype=np.int64),
        np.asarray(scores_out[:n_out], dtype=np.float32),
    )


def _rank_block_ivf(db, q_block, mask, recency, metric, top_k, budget):
    """Batched IVF: one shared probe frontier for the query block.

    The union of the clusters the queries probed is gathered once and the
    whole block scores it in one pass, each query restricted to its own
    clusters by a (B, U) validity matrix. Queries left with fewer than
    ``top_k`` masked candidates take the exact masked scan (the batched Q13
    fallback). Returns (None, None) when probing yields nothing: the caller
    then scans the block exactly."""
    cand_ids, valid = db.ann_index.probe_batch(q_block, budget)
    if cand_ids.size == 0:
        return None, None
    valid = valid & mask[cand_ids][None, :]
    counts = valid.sum(axis=1)
    need_fallback = np.flatnonzero(counts < top_k)
    ivf_rows = np.flatnonzero(counts >= top_k)

    nq = q_block.shape[0]
    doc_ids = np.zeros((nq, top_k), dtype=np.int64)
    scores_out = np.full((nq, top_k), -np.inf, dtype=np.float32)
    if ivf_rows.size:
        q = torch.from_numpy(np.ascontiguousarray(q_block[ivf_rows])).to(db._store.device)
        k_pad = min(_pad_pow2(top_k), bucket_size(len(db.documents)))
        idx_h, vals_h = _rank_candidates(
            db, q, cand_ids, valid[ivf_rows], recency, metric, k_pad
        )
        doc_ids[ivf_rows] = idx_h[:, :top_k]
        scores_out[ivf_rows] = vals_h[:, :top_k]
    if need_fallback.size:
        fb_ids, fb_vals = _rank_block(
            db, q_block[need_fallback], mask, None, recency, metric, top_k
        )
        doc_ids[need_fallback] = fb_ids
        scores_out[need_fallback] = fb_vals
    return doc_ids, scores_out


def _rank_candidates(db, q, cand, valid, recency, metric, k_pad):
    """Score a query block ``q`` (on the device) against the unchunked rows
    ``cand`` alone (``ranking.rank_gathered``): ``valid`` is None (every
    candidate live for every query) or a (B, len(cand)) matrix. The
    candidates are padded to a bucket size, the pad inert. Returns host
    ((B, k) row ids, (B, k) scores)."""
    store = db._store
    device = store.device
    dv = store.device_view(db.source_indices)
    n_cand = int(cand.size)
    c_pad = bucket_size(n_cand)
    ids = np.zeros(c_pad, dtype=np.int64)
    ids[:n_cand] = cand
    live = np.zeros(c_pad if valid is None else (valid.shape[0], c_pad), dtype=bool)
    live[..., :n_cand] = True if valid is None else valid
    rec_c = None
    if recency is not None:
        rc = np.zeros(c_pad, dtype=np.float32)
        rc[:n_cand] = recency[cand]
        rec_c = torch.from_numpy(rc).to(device)
    prenorm = metric == "cosine_similarity"
    vals, idx = _ranking.rank_gathered(
        q,
        dv["rows_norm"] if prenorm else dv["rows"],
        torch.from_numpy(ids).to(device),
        torch.from_numpy(live).to(device),
        k=min(k_pad, c_pad),
        metric=metric,
        recency=rec_c,
        prenormalized=prenorm,
    )
    return fetch(idx, vals)


def _rank_block(db, q_block, mask, override, recency, metric, top_k, cand_rows=None):
    """Run the ranking call; returns ((B, k) doc_ids, (B, k) scores).
    ``cand_rows`` (single queries with an IVF index) restricts an unchunked
    float corpus to the probed rows, scored alone; the mask already carries
    the same restriction for every other route."""
    num_docs = len(db.documents)
    store = db._store
    device = store.device

    # Tiny-corpus host fast path (ops/host_ranking): below this cell count a
    # device launch and readback cost more than the scan.
    cells = store.num_rows * max(1, int(q_block.shape[0]))
    device_block = isinstance(q_block, torch.Tensor)
    if 0 < cells <= CONFIG.host_path_max_cells:
        if device_block:
            # below this cell count a device launch costs more than the
            # block's readback and the host scan together
            q_block = q_block.cpu().numpy()
        if override is not None:
            vals, idx = rank_block_host(
                q_block, override, top_k, metric, doc_mask=mask, recency=recency
            )
        elif num_docs == store.num_rows:
            hv = store.host_view()
            vals, idx = rank_block_host(
                q_block, hv["rows"], top_k, metric,
                doc_mask=mask, recency=recency, rows_norm=hv["rows_norm"],
            )
        else:
            hv = store.host_view()
            vals, idx = rank_block_host(
                q_block, hv["rows"], top_k, metric,
                doc_mask=mask, recency=recency,
                row_docs=np.asarray(db.source_indices, dtype=np.int64),
                num_docs=num_docs, rows_norm=hv["rows_norm"],
            )
        return idx, vals

    if device_block:
        q = q_block if q_block.dtype in (torch.float16, torch.float32) else q_block.float()
    else:
        q_host = np.ascontiguousarray(q_block)
        if q_host.dtype != np.float16:
            q_host = q_host.astype(np.float32, copy=False)
        q = torch.from_numpy(q_host).to(device)
    k_pad = min(_pad_pow2(top_k), bucket_size(num_docs))

    if (
        cand_rows is not None
        and cand_rows.size
        and override is None
        and num_docs == store.num_rows
        and store.precision != "int8-pure"  # no float rows to gather from
    ):
        cand = cand_rows[mask[cand_rows]]
        if cand.size:
            idx_h, vals_h = _rank_candidates(db, q, cand, None, recency, metric, k_pad)
            return idx_h[:, :top_k], vals_h[:, :top_k]

    if override is not None:
        # Key-filter path: per-document override vectors (rows == docs).
        d_pad = bucket_size(num_docs)
        padded = np.zeros((d_pad, override.shape[1]), dtype=np.float32)
        padded[:num_docs] = override
        mask_pad = np.zeros(d_pad, dtype=bool)
        mask_pad[:num_docs] = mask
        rec_pad = None
        if recency is not None:
            rec_pad = np.zeros(d_pad, dtype=np.float32)
            rec_pad[:num_docs] = recency
            rec_pad = torch.from_numpy(rec_pad).to(device)
        vals, idx = rank_top_k(
            q,
            torch.from_numpy(padded).to(device),
            k=k_pad,
            metric=metric,
            row_mask=torch.from_numpy(mask_pad).to(device),
            recency=rec_pad,
        )
    elif num_docs == store.num_rows:
        # Unchunked corpus: rows ARE docs — rank rows directly.
        dv = store.device_view(db.source_indices)
        n_pad = dv["n_pad"]
        if mask.all():
            row_mask_dev = dv["row_valid"]  # no per-query mask upload
        else:
            row_mask = np.zeros(n_pad, dtype=bool)
            row_mask[:num_docs] = mask
            row_mask_dev = torch.from_numpy(row_mask).to(device)
        rec_pad = None
        if recency is not None:
            rec_host = np.zeros(n_pad, dtype=np.float32)
            rec_host[:num_docs] = recency
            rec_pad = torch.from_numpy(rec_host).to(device)
        prenorm = metric == "cosine_similarity"
        precision = store.precision
        k_eff = min(k_pad, n_pad)
        batch = int(q.shape[0])
        if precision in ("int8", "int8-pure") and metric in (
            "dot_product",
            "cosine_similarity",
        ):
            qq = q
            if prenorm and device_block:
                q32 = q.float()
                qn = torch.sqrt(torch.sum(q32 * q32, dim=1, keepdim=True))
                qq = q32 / torch.where(qn == 0, torch.ones_like(qn), qn)
            elif prenorm:
                # on the host in NumPy, as the JAX engine does: f32
                # accumulation, result back at the wire dtype, so both
                # packages quantize the same query bits
                q32 = np.asarray(q_host, dtype=np.float32)
                qn = np.linalg.norm(q32, axis=1, keepdims=True)
                qn[qn == 0] = 1.0
                qq = torch.from_numpy(
                    np.ascontiguousarray((q32 / qn).astype(q_host.dtype))
                ).to(device)
            psidx = db.ann_index
            if (
                getattr(psidx, "kind", None) == "projscan"
                and precision == "int8-pure"
                and METRIC_TO_ANN.get(metric) == db.ann_metric  # Q11
                and psidx.num_rows == n_pad
                and cand_rows is None
            ):
                # the opt-in two-stage scan: stage B rescores on the same
                # int8 plane the exact scan reads
                vals, idx = psidx.search(
                    qq,
                    dv["rowsn_q"] if prenorm else dv["rows_q"],
                    dv["rown_scales"] if prenorm else dv["row_scales"],
                    k=k_eff,
                    overfetch=CONFIG.projscan_overfetch,
                    row_mask=row_mask_dev,
                    recency=rec_pad,
                )
            else:
                rescore = None
                if precision == "int8":
                    rescore = dv["rows_norm"] if prenorm else dv["rows"]
                vals, idx = rank_top_k_int8(
                    qq,
                    dv["rowsn_q"] if prenorm else dv["rows_q"],
                    dv["rown_scales"] if prenorm else dv["row_scales"],
                    k=k_eff,
                    row_mask=row_mask_dev,
                    recency=rec_pad,
                    rescore_rows=rescore,
                )
        elif precision == "int8-pure":
            raise ValueError(
                f"device_precision='int8-pure' supports only dot_product and "
                f"cosine_similarity on the device scan (got '{metric}'); use "
                "device_precision='int8' or 'auto' for other metrics."
            )
        elif metric in _ranking.GROUPED_METRICS and _grouped_group(n_pad, batch):
            # euclidean/hamming/jaccard ride the grouped epilogue routes:
            # exact scores fused into the grouped product + group-max
            if metric == "euclidean_metric":
                g_rows, g_aux = dv["rows"], dv["row_sq"]
            else:
                bv = store.binary_view(db.source_indices)
                g_rows, g_aux = bv["rows_bin"], bv["row_bin_sum"]
            vals, idx = _ranking.rank_top_k_grouped_metric(
                q,
                g_rows,
                g_aux,
                k=k_eff,
                metric=metric,
                row_mask=row_mask_dev,
                recency=rec_pad,
                group=_grouped_group(n_pad, batch),
            )
        elif metric == "pearson_correlation" and _grouped_group(n_pad, batch):
            # pearson == dot over centered unit-norm rows (store.pearson_view
            # has the algebra), so the big-batch scan rides the dot routing.
            # Constant rows/queries become NaN operands whose scores every
            # route scrubs to -inf, as the pearson_scores fallback does.
            plane = store.pearson_view(db.source_indices)["rows_pearson"]
            if device_block:
                # no zero guard, as on the host: a constant query is NaN
                qc = q.float() - q.float().mean(dim=1, keepdim=True)
                qq = qc / torch.sqrt(torch.sum(qc * qc, dim=1, keepdim=True))
            else:
                qq = torch.from_numpy(
                    pearson_center_normalize(np.array(q_host, dtype=np.float32))
                ).to(device)
            vals, idx = rank_top_k(
                qq.to(plane.dtype),
                plane,
                k=k_eff,
                metric="dot_product",
                row_mask=row_mask_dev,
                recency=rec_pad,
            )
        else:
            vals, idx = rank_top_k(
                q,
                dv["rows_norm"] if prenorm else dv["rows"],
                k=k_eff,
                metric=metric,
                row_mask=row_mask_dev,
                recency=rec_pad,
                prenormalized=prenorm,
            )
    else:
        # Chunked corpus: score rows, reduce each document to its best row.
        dv = store.device_view(db.source_indices)
        d_pad = bucket_size(num_docs)
        doc_mask = np.zeros(d_pad, dtype=bool)
        doc_mask[:num_docs] = mask
        rec_pad = None
        if recency is not None:
            rec_host = np.zeros(d_pad, dtype=np.float32)
            rec_host[:num_docs] = recency
            rec_pad = torch.from_numpy(rec_host).to(device)
        prenorm = metric == "cosine_similarity"
        vals, idx = _ranking.rank_docs_top_k(
            q,
            dv["rows_norm"] if prenorm else dv["rows"],
            dv["row_docs"],
            dv["row_valid"],
            k=min(k_pad, d_pad),
            num_docs=d_pad,
            metric=metric,
            doc_mask=torch.from_numpy(doc_mask).to(device),
            recency=rec_pad,
            prenormalized=prenorm,
        )

    idx_h, vals_h = fetch(idx, vals)
    return idx_h[:, :top_k], vals_h[:, :top_k]
