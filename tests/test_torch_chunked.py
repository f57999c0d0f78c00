"""Chunked corpora (several rows per document): the port against the JAX
package, at the ranking function and through ``HyperDB``.

``rank_docs_top_k`` of both packages gets the same seeded numpy inputs (all
seven metrics, a document mask, recency, padding rows and an empty padded
document). Then a ``HyperDB`` of each package is built the same way (a
base of single-row documents plus multi-row documents added one by one) and
answers the same queries before and after ``remove_document``. The host
fast path is switched off on both configs, so every query takes the device
branch (on CPU tensors in the port).

Ids must be identical. Scores: hamming and jaccard are exact integer counts
and must be equal (1e-6 once recency adds an f32 term); manhattan sums
|v - q| in f32 in another order, ``rtol 1e-6``; the others are f32 sums of
products in different orders over rows of norm ~1, 1e-5 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperdb_tpu import HyperDB as JaxDB
from hyperdb_tpu.config import CONFIG as JAX_CONFIG
from hyperdb_tpu.ops import ranking as JR
from hyperdb_tpu.ops.metrics import METRICS
from hyperdb_tpu_torch import HyperDB as TorchDB
from hyperdb_tpu_torch.config import CONFIG as TORCH_CONFIG
from hyperdb_tpu_torch.ops import ranking as TR

D = 32
EXACT = ("hamming_distance", "jaccard_similarity")


@pytest.fixture(autouse=True, scope="module")
def fresh_jax_programs():
    yield
    JR.rank_docs_top_k.clear_cache()


def _assert_scores(metric, got, want, recency=False):
    if metric in EXACT:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 if recency else 0)
    elif metric == "manhattan_distance":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 if recency else 0)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _rows(seed, n_docs=300, n_pad=1024, d_pad=320):
    """Padded rows of ``n_docs`` documents with 1-4 rows each; the documents
    past ``n_docs`` are padding (no row points at them)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 5, size=n_docs)
    src = np.repeat(np.arange(n_docs), counts)
    n = src.size
    assert n <= n_pad
    rows = np.zeros((n_pad, D), dtype=np.float32)
    rows[:n] = rng.standard_normal((n, D)) / np.sqrt(D)
    rows[7] = 0.125  # a constant row: pearson NaN, scrubbed
    row_docs = np.full(n_pad, src[-1], dtype=np.int32)  # padding rows: the last document
    row_docs[:n] = src
    valid = np.zeros(n_pad, dtype=bool)
    valid[:n] = True
    doc_mask = np.zeros(d_pad, dtype=bool)
    doc_mask[:n_docs] = rng.random(n_docs) < 0.8
    rec = np.zeros(d_pad, dtype=np.float32)
    rec[:n_docs] = rng.random(n_docs) * 0.01
    q = rng.standard_normal((8, D)).astype(np.float32)
    return q, rows, row_docs, valid, doc_mask, rec, d_pad


@pytest.mark.parametrize("how", ["plain", "mask", "recency", "mask+recency"])
@pytest.mark.parametrize("metric", METRICS)
def test_rank_docs_top_k_matches_jax(metric, how):
    q, rows, row_docs, valid, doc_mask, rec, d_pad = _rows(len(metric))
    if "mask" not in how:
        doc_mask = None
    elif metric == "cosine_similarity":
        doc_mask[row_docs[-1]] = True  # padding rows point at a LIVE document
    rec = rec if "recency" in how else None
    prenorm = metric == "cosine_similarity"
    if prenorm:
        norms = np.linalg.norm(rows, axis=1, keepdims=True)
        rows = rows / np.where(norms == 0, 1.0, norms)
    k = 16
    jv, ji = JR.rank_docs_top_k(
        jnp.asarray(q), jnp.asarray(rows), jnp.asarray(row_docs), jnp.asarray(valid),
        k=k, num_docs=d_pad, metric=metric,
        doc_mask=None if doc_mask is None else jnp.asarray(doc_mask),
        recency=None if rec is None else jnp.asarray(rec), prenormalized=prenorm,
    )
    tv, ti = TR.rank_docs_top_k(
        torch.from_numpy(q), torch.from_numpy(rows), torch.from_numpy(row_docs),
        torch.from_numpy(valid), k, d_pad, metric=metric,
        doc_mask=None if doc_mask is None else torch.from_numpy(doc_mask),
        recency=None if rec is None else torch.from_numpy(rec), prenormalized=prenorm,
    )
    assert ti.dtype == torch.int64 and ti.shape == (8, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _assert_scores(metric, tv.numpy(), np.asarray(jv), recency=rec is not None)
    assert (ti < 300).all()  # never a padding document
    if doc_mask is not None:
        assert doc_mask[ti.numpy()].all()


def test_rank_docs_top_k_empty_and_dead_documents():
    """A document with no row, a document whose rows are all NaN, and a
    masked document stay -inf and rank last, in id order; padding rows that
    point at a live document cannot raise it."""
    rows = torch.tensor([[1.0, 0.0], [0.5, 0.0], [float("nan"), 0.0], [0.9, 0.0], [9.0, 0.0]])
    row_docs = torch.tensor([0, 0, 1, 3, 3], dtype=torch.int32)  # document 2 has no row
    valid = torch.tensor([True, True, True, True, False])  # the last row is padding
    doc_mask = torch.tensor([True, True, True, True, False, False, False, False])
    q = torch.tensor([[1.0, 0.0]])
    vals, idx = TR.rank_docs_top_k(
        q, rows, row_docs, valid, 4, 8, metric="dot_product", doc_mask=doc_mask
    )
    assert idx.tolist() == [[0, 3, 1, 2]]
    assert vals[0, :2].tolist() == [1.0, pytest.approx(0.9)]
    assert torch.isneginf(vals[0, 2:]).all()
    jv, ji = JR.rank_docs_top_k(
        jnp.asarray(q.numpy()), jnp.asarray(rows.numpy()), jnp.asarray(row_docs.numpy()),
        jnp.asarray(valid.numpy()), k=4, num_docs=8, metric="dot_product",
        doc_mask=jnp.asarray(doc_mask.numpy()),
    )
    assert np.asarray(ji).tolist() == idx.tolist()


def test_rank_docs_top_k_chunks_over_queries(monkeypatch):
    q, rows, row_docs, valid, doc_mask, rec, d_pad = _rows(5)
    args = (torch.from_numpy(q), torch.from_numpy(rows), torch.from_numpy(row_docs),
            torch.from_numpy(valid), 16, d_pad)
    kw = {"metric": "manhattan_distance", "doc_mask": torch.from_numpy(doc_mask),
          "recency": torch.from_numpy(rec)}
    want = TR.rank_docs_top_k(*args, **kw)
    monkeypatch.setattr(TR, "_CHUNK_CELLS", 3 * 1024)  # 3 queries per chunk
    got = TR.rank_docs_top_k(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------- HyperDB

N_BASE, N_MULTI = 1500, 250


def _build(cls, fp_precision, **kw):
    """1500 single-row documents from the constructor, then 250 documents of
    2-4 rows each through ``add``."""
    rng = np.random.default_rng(11)
    base = (rng.standard_normal((N_BASE, D)) / np.sqrt(D)).astype(np.float32)
    docs = [
        {"name": f"doc{i}", "ts": float(i % 89) / 89.0, "kind": ("a", "b", "c")[i % 3]}
        for i in range(N_BASE)
    ]
    db = cls(docs, base, fp_precision=fp_precision, metadata_keys=["kind", "ts"], **kw)
    for j in range(N_MULTI):
        i = N_BASE + j
        block = (rng.standard_normal((2 + j % 3, D)) / np.sqrt(D)).astype(np.float32)
        db.add({"name": f"doc{i}", "ts": float(i % 89) / 89.0, "kind": ("a", "b", "c")[i % 3]},
               vectors=block)
    return db


@pytest.fixture(autouse=True)
def device_branch(monkeypatch):
    monkeypatch.setattr(JAX_CONFIG, "host_path_max_cells", 0)
    monkeypatch.setattr(TORCH_CONFIG, "host_path_max_cells", 0)


@pytest.fixture(scope="module", params=["float32", "float16"])
def dbs(request):
    return _build(JaxDB, request.param), _build(TorchDB, request.param, device="cpu")


KWARGS = {
    "plain": {},
    "filter": {"filters": [("metadata", {"kind": "b"})]},
    "recency": {"recency_bias": 0.05, "timestamp_key": "ts"},
}
DB_METRICS = ("cosine_similarity", "dot_product", "manhattan_distance", "euclidean_metric",
              "hamming_distance")


def _queries(b, seed):
    return np.random.default_rng(seed).standard_normal((b, D)).astype(np.float32)


def _compare(jdb, tdb, metric, how, b=24, seed=0):
    q = _queries(b, seed)
    ji, js = jdb.query_batch_arrays(q, top_k=10, metric=metric, **KWARGS[how])
    ti, ts = tdb.query_batch_arrays(q, top_k=10, metric=metric, **KWARGS[how])
    assert ti.shape == (b, 10) and ti.dtype == np.int64
    np.testing.assert_array_equal(ti, ji)
    _assert_scores(metric, ts, js, recency=how == "recency")
    return ti


def test_chunked_state_is_the_jax_state(dbs):
    jdb, tdb = dbs
    n_docs = N_BASE + N_MULTI
    assert tdb.source_indices == jdb.source_indices
    assert len(tdb.documents) == n_docs and tdb._store.num_rows > n_docs
    assert tdb.size() == jdb.size() == n_docs
    assert tdb.size(with_chunks=True) == jdb.size(with_chunks=True) == tdb._store.num_rows
    assert tdb.size(metadata={"kind": "a"}) == jdb.size(metadata={"kind": "a"})
    assert tdb.split_info == jdb.split_info
    assert tdb._metadata_index == jdb._metadata_index
    np.testing.assert_array_equal(tdb.vectors, jdb.vectors)
    td, jd = tdb.dict(vectors=True), jdb.dict(vectors=True)
    assert td == jd and len(td) == n_docs
    # a multi-row document exports its FIRST row
    first = tdb.source_indices.index(N_BASE + 1)
    assert td[N_BASE + 1]["vector"] == tdb.vectors[first].tolist()
    assert tdb.dict(metadata={"kind": "c"}) == jdb.dict(metadata={"kind": "c"})


@pytest.mark.parametrize("how", list(KWARGS))
@pytest.mark.parametrize("metric", DB_METRICS)
def test_chunked_db_matches_jax(dbs, metric, how):
    jdb, tdb = dbs
    ids = _compare(jdb, tdb, metric, how)
    assert (ids >= N_BASE).any()  # multi-row documents do rank
    if how == "filter":
        assert (ids % 3 == 1).all()


@pytest.mark.parametrize("metric", ["cosine_similarity", "manhattan_distance"])
def test_chunked_query_and_query_batch(dbs, metric):
    jdb, tdb = dbs
    q = _queries(5, seed=3)
    jb = jdb.query_batch(q, top_k=4, metric=metric)
    tb = tdb.query_batch(q, top_k=4, metric=metric)
    assert [[r[2] for r in row] for row in tb] == [[r[2] for r in row] for row in jb]
    assert [[r[0] for r in row] for row in tb] == [[r[0] for r in row] for row in jb]
    j1 = jdb.query(q[2], top_k=4, metric=metric)
    t1 = tdb.query(q[2], top_k=4, metric=metric)
    assert [r[2] for r in t1] == [r[2] for r in j1] == [r[2] for r in tb[2]]
    np.testing.assert_allclose([r[1] for r in t1], [r[1] for r in j1], rtol=1e-5, atol=1e-5)
    # the best chunk decides: a query equal to a later row of a document finds it
    doc = N_BASE + 7
    rows = [r for r, s in enumerate(tdb.source_indices) if s == doc]
    hit = tdb.query(np.asarray(tdb.vectors[rows[-1]], dtype=np.float32), top_k=1, metric=metric)
    assert hit[0][2] == doc


def test_remove_document_then_query():
    jdb, tdb = _build(JaxDB, "float32"), _build(TorchDB, "float32", device="cpu")
    gone = [3, N_BASE + 1, N_BASE + 7, -1]
    rows_before = tdb.size(with_chunks=True)
    jdb.remove_document(gone)
    tdb.remove_document(gone)
    assert tdb.source_indices == jdb.source_indices
    assert tdb.source_indices == sorted(tdb.source_indices)
    assert set(tdb.source_indices) == set(range(N_BASE + N_MULTI - 4))
    assert tdb.size() == jdb.size() == N_BASE + N_MULTI - 4
    assert tdb.size(with_chunks=True) == jdb.size(with_chunks=True) < rows_before - 4
    assert tdb._metadata_index == jdb._metadata_index
    assert tdb.documents == jdb.documents
    np.testing.assert_array_equal(tdb.vectors, jdb.vectors)
    for metric in ("cosine_similarity", "manhattan_distance"):
        for how in KWARGS:
            _compare(jdb, tdb, metric, how, seed=5)
    tdb.remove_document(0)
    assert tdb.documents[0]["name"] == "doc1" and tdb.source_indices[0] == 0
    with pytest.raises(IndexError):
        tdb.remove_document(10**6)


def test_remove_back_to_one_row_per_document():
    """Removing every multi-row document leaves an unchunked corpus, which
    takes the row-level branch again."""
    tdb = _build(TorchDB, "float32", device="cpu")
    tdb.remove_document(list(range(N_BASE, N_BASE + N_MULTI)))
    assert tdb.size() == tdb.size(with_chunks=True) == N_BASE
    ids, _ = tdb.query_batch_arrays(_queries(4, 9), top_k=3)
    assert ids.shape == (4, 3) and ids.max() < N_BASE


@pytest.mark.parametrize("precision", ["float32", "float16"])
def test_from_state_with_repeated_source_indices(precision):
    """A JAX DB's plain state with repeated ``source_indices`` makes a
    chunked port DB that answers as the JAX DB does."""
    jdb = _build(JaxDB, precision)
    state = {
        "vectors": np.asarray(jdb.vectors), "documents": list(jdb.documents),
        "source_indices": list(jdb.source_indices), "metadata_keys": list(jdb.metadata_keys),
        "fp_precision": jdb.fp_precision, "ann_metric": jdb.ann_metric,
    }
    tdb = TorchDB.from_state(state, device="cpu")
    assert tdb.size() == N_BASE + N_MULTI < tdb.size(with_chunks=True)
    for metric in ("cosine_similarity", "manhattan_distance"):
        _compare(jdb, tdb, metric, "filter", seed=13)
