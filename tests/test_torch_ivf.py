"""The IVF index: ``hyperdb_tpu_torch`` against ``hyperdb_tpu`` on the CPU.

The same seeded clustered corpora go through both packages. k-means sums in
another order in each (``index_add_`` against ``segment_sum``), so
centroids agree within 1e-5 and, on these well-separated clusters, every
row lands in the same cluster: ``row_order`` and ``offsets`` must be EQUAL.
Where a test compares answers through a DB, the JAX index's state is carried
into the port (``IVFIndex.from_state``), so both walk the same clusters
(``probe`` / ``probe_batch`` are NumPy in both and must return identical
candidates) and the answers must agree: ids identical, scores within 1e-6
(f32 rows, the same products summed in another order; the port's plain
euclidean runs in f64, 1e-5 relative there).
"""

import os

import numpy as np
import pytest

from hyperdb_tpu import HyperDB as JaxDB
from hyperdb_tpu.config import CONFIG as JAX_CONFIG
from hyperdb_tpu.core import db as JDB_MODULE
from hyperdb_tpu.index.ivf import IVFIndex as JaxIVF
from hyperdb_tpu_torch import HyperDB as TorchDB
from hyperdb_tpu_torch.config import CONFIG as TORCH_CONFIG
from hyperdb_tpu_torch.config import EngineConfig
from hyperdb_tpu_torch.core import db as TDB_MODULE
from hyperdb_tpu_torch.index.flat import FlatIndex
from hyperdb_tpu_torch.index.ivf import IVFIndex, default_nlist

ATOL = 1e-6


def _clustered(n=8000, d=32, n_clusters=50, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)) * 3
    assign = rng.integers(0, n_clusters, size=n)
    return (centers[assign] + rng.standard_normal((n, d))).astype(np.float32)


@pytest.fixture
def ivf_on(monkeypatch):
    """IVF from 500 rows in both packages; the batched branch from 500 rows
    when a test asks for it."""
    monkeypatch.setattr(JDB_MODULE, "IVF_THRESHOLD", 500)
    monkeypatch.setattr(TDB_MODULE, "IVF_THRESHOLD", 500)

    def batch(rows):
        monkeypatch.setattr(JAX_CONFIG, "batch_ivf_min_rows", rows)
        monkeypatch.setattr(TORCH_CONFIG, "batch_ivf_min_rows", rows)

    return batch


def _pair(v, docs=None, carry=True, **kw):
    """A JAX DB and a port DB over the same rows; with ``carry`` the port
    takes the JAX index's state."""
    docs = docs if docs is not None else [{"i": int(i)} for i in range(len(v))]
    jdb = JaxDB(documents=[dict(d) for d in docs], vectors=v, **kw)
    tdb = TorchDB(documents=[dict(d) for d in docs], vectors=v, device="cpu", **kw)
    assert isinstance(tdb.ann_index, IVFIndex)
    _same_index(tdb.ann_index, jdb.ann_index)
    if carry:
        tdb.ann_index = IVFIndex.from_state(jdb.ann_index.state(), device="cpu")
    return jdb, tdb


def _same_index(t, j):
    assert (t.nlist, t.metric, t.normalized) == (j.nlist, j.metric, j.normalized)
    np.testing.assert_array_equal(t.offsets, j.offsets)
    np.testing.assert_array_equal(t.row_order, j.row_order)
    np.testing.assert_allclose(t.centroids, j.centroids, rtol=0, atol=1e-5)


def _same_hits(got, want, rtol=0.0):
    assert [h[2] for h in got] == [h[2] for h in want]
    assert [h[0] for h in got] == [h[0] for h in want]
    np.testing.assert_allclose([h[1] for h in got], [h[1] for h in want], rtol=rtol, atol=ATOL)


# ---------------------------------------------------------------- the index


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_ivf_build_invariants(metric):
    v = _clustered()
    index = IVFIndex.build(v, metric=metric, nlist=64, device="cpu")
    assert index.nlist == 64 and index.num_rows == len(v)
    assert sorted(index.row_order.tolist()) == list(range(len(v)))
    assert index.offsets[0] == 0 and index.offsets[-1] == len(v)
    _same_index(index, JaxIVF.build(v, metric=metric, nlist=64))
    assert default_nlist(len(v)) == 2 * round(np.sqrt(len(v))) and default_nlist(10**8) == 4096


def test_ivf_recall_at_10():
    v = _clustered()
    index = IVFIndex.build(v, metric="cosine", nlist=64, device="cpu")
    carried = IVFIndex.from_state(
        JaxIVF.build(v, metric="cosine", nlist=64).state(), device="cpu"
    )
    jax_index = JaxIVF.from_state(carried.state())
    rng = np.random.default_rng(1)
    queries = v[rng.choice(len(v), 20)] + 0.1 * rng.standard_normal((20, v.shape[1])).astype(np.float32)
    vn = v / np.linalg.norm(v, axis=1, keepdims=True)
    recalls = []
    for q in queries:
        cand = index.probe(q, len(v) // 5)
        np.testing.assert_array_equal(carried.probe(q, len(v) // 5), jax_index.probe(q, len(v) // 5))
        oracle = set(np.argsort(-(vn @ q), kind="stable")[:10].tolist())
        recalls.append(len(oracle & set(cand.tolist())) / 10)
    assert np.mean(recalls) >= 0.9, f"mean recall@10 {np.mean(recalls)}"


def test_ivf_probe_budget():
    v = _clustered(n=2000)
    index = IVFIndex.build(v, metric="euclidean", nlist=32, device="cpu")
    cand = index.probe(v[0], budget=100)
    assert 100 <= cand.size < 2000
    np.testing.assert_array_equal(
        cand, JaxIVF.from_state(index.state()).probe(v[0], budget=100)
    )


def test_ivf_state_roundtrip():
    v = _clustered(n=1000)
    index = IVFIndex.build(v, metric="cosine", nlist=16, device="cpu")
    state = index.state()
    assert state["kind"] == "ivf"
    restored = IVFIndex.from_state(state, device="cpu")
    np.testing.assert_array_equal(restored.row_order, index.row_order)
    np.testing.assert_array_equal(restored.offsets, index.offsets)
    np.testing.assert_array_equal(restored.probe(v[3], 50), index.probe(v[3], 50))
    # the JAX package reads the port's state, and the reverse
    np.testing.assert_array_equal(JaxIVF.from_state(state).probe(v[3], 50), index.probe(v[3], 50))


def test_probe_batch_matches_per_query_probe():
    v = _clustered(n=3000, d=16, n_clusters=20)
    index = IVFIndex.build(v, metric="cosine", nlist=32, device="cpu")
    q_block = v[np.random.default_rng(7).choice(len(v), 8)]
    cand_ids, valid = index.probe_batch(q_block, 200)
    assert valid.shape == (8, cand_ids.size)
    for b in range(8):
        assert set(cand_ids[valid[b]].tolist()) == set(index.probe(q_block[b], 200).tolist())
    j_ids, j_valid = JaxIVF.from_state(index.state()).probe_batch(q_block, 200)
    np.testing.assert_array_equal(cand_ids, j_ids)
    np.testing.assert_array_equal(valid, j_valid)


def test_build_with_device_rows_matches_host_build():
    """The build over the store's plane draws the same sample as the host
    build and gives the same clusters on separated data, in both packages."""
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(5)
    n, d = 4096, 32
    centers = rng.standard_normal((32, d)).astype(np.float32) * 3
    v = centers[rng.integers(0, 32, size=n)] + rng.standard_normal((n, d)).astype(np.float32)
    vn = v / np.linalg.norm(v, axis=1, keepdims=True)
    host = IVFIndex.build(v, metric="cosine", nlist=64, device="cpu")
    padded = np.zeros((n + 64, d), np.float32)  # the store pads its plane
    padded[:n] = vn
    dev = IVFIndex.build(v, metric="cosine", nlist=64, device_rows=torch.from_numpy(padded))
    j_dev = JaxIVF.build(v, metric="cosine", nlist=64, device_rows=jnp.asarray(padded))
    _same_index(dev, j_dev)
    _same_index(host, JaxIVF.build(v, metric="cosine", nlist=64))
    q = centers[3] + rng.standard_normal(d).astype(np.float32)
    oracle = set(np.argsort(-(vn @ (q / np.linalg.norm(q))))[:10].tolist())
    for index in (host, dev):
        assert len(set(index.probe(q, 400).tolist()) & oracle) / 10 >= 0.9
    assert dev.num_rows == n and dev.normalized


def test_add_rows_assigns_like_jax():
    v = _clustered(n=1000, d=16, n_clusters=10)
    extra = _clustered(n=60, d=16, n_clusters=10, seed=3)
    t = IVFIndex.build(v, metric="cosine", device="cpu")
    j = JaxIVF.from_state(t.state())
    t.add_rows(extra, 1000)
    j.add_rows(extra, 1000)
    _same_index(t, j)
    assert t.num_rows == 1060


# ---------------------------------------------------------------- the DB


def test_db_with_ivf_matches_bruteforce(ivf_on):
    v = _clustered(n=1000, d=16, n_clusters=10)
    jdb, tdb = _pair(v)
    got, want = tdb.query(v[123], top_k=5), jdb.query(v[123], top_k=5)
    assert got[0][0]["i"] == 123
    _same_hits(got, want)
    # pearson has no ANN mapping: the exact scan in both
    bf = tdb.query(v[123], top_k=5, metric="pearson_correlation")
    _same_hits(bf, jdb.query(v[123], top_k=5, metric="pearson_correlation"))


@pytest.mark.parametrize(
    "ann_metric,metric",
    [("dot", "dot_product"), ("euclidean", "euclidean_metric"), ("hamming", "hamming_distance")],
)
def test_db_ivf_non_cosine_metrics(ivf_on, ann_metric, metric):
    """The gathered fast path scores with the QUERY metric."""
    from hyperdb_tpu_torch.ops.metrics import scores

    v = np.abs(_clustered(n=1000, d=16, n_clusters=10))
    jdb, tdb = _pair(v, ann_metric=ann_metric)
    got = tdb.query(v[42], top_k=5, metric=metric)
    rtol = 1e-5 if metric == "euclidean_metric" else 0.0
    _same_hits(got, jdb.query(v[42], top_k=5, metric=metric), rtol=rtol)
    if metric == "euclidean_metric":
        assert got[0][0]["i"] == 42
    import torch

    expect = scores(torch.from_numpy(v[42][None]), torch.from_numpy(v), metric)[0].numpy()
    for _, score, doc_id in got:
        np.testing.assert_allclose(score, expect[doc_id], rtol=1e-6)


def test_query_batch_ivf_non_cosine(ivf_on):
    ivf_on(500)
    v = _clustered(n=1500, d=16, n_clusters=10)
    jdb, tdb = _pair(v, ann_metric="dot")
    got = tdb.query_batch(v[:4], top_k=5, metric="dot_product", ann_percent=20)
    want = jdb.query_batch(v[:4], top_k=5, metric="dot_product", ann_percent=20)
    for b, (g, w) in enumerate(zip(got, want)):
        _same_hits(g, w, rtol=1e-6)
        for _, score, doc_id in g:
            np.testing.assert_allclose(score, v[doc_id] @ v[b], rtol=1e-5)


def test_ivf_incremental_add(ivf_on):
    v = _clustered(n=1000, d=16, n_clusters=10)
    jdb, tdb = _pair(v)
    built = tdb.ann_index
    extra = np.random.default_rng(9).standard_normal((50, 16)).astype(np.float32) + 40.0
    for db in (jdb, tdb):
        db.add([{"i": 1000 + j} for j in range(50)], vectors=extra)
    assert tdb.ann_index is built and tdb.ann_index.num_rows == 1050  # incremental
    _same_index(tdb.ann_index, jdb.ann_index)
    res = tdb.query(extra[0], top_k=1)
    assert res[0][0]["i"] == 1000
    _same_hits(res, jdb.query(extra[0], top_k=1))
    tdb.remove_document(0)  # removal rebuilds
    assert tdb.ann_index is not built and tdb.ann_index.num_rows == 1049


def test_ivf_growth_past_half_rebuilds(ivf_on):
    v = _clustered(n=1000, d=16, n_clusters=10)
    tdb = TorchDB(documents=[{"i": i} for i in range(1000)], vectors=v, device="cpu")
    built = tdb.ann_index
    more = _clustered(n=501, d=16, n_clusters=10, seed=4)
    tdb.add([{"i": 1000 + j} for j in range(501)], vectors=more)
    assert tdb.ann_index is not built and tdb._ivf_built_rows == 1501
    tdb.set_ann_metric("euclidean")  # a metric switch rebuilds too
    assert tdb.ann_index.metric == "euclidean" and not tdb.ann_index.normalized


def test_db_ivf_with_filters(ivf_on):
    v = _clustered(n=1000, d=16, n_clusters=10)
    docs = [{"i": int(i), "parity": "even" if i % 2 == 0 else "odd"} for i in range(len(v))]
    jdb, tdb = _pair(v, docs=docs, metadata_keys=["parity"])
    f = [("metadata", {"parity": "even"})]
    got = tdb.query(v[10], top_k=5, filters=f)
    assert all(doc["parity"] == "even" for doc, *_ in got) and got[0][0]["i"] == 10
    _same_hits(got, jdb.query(v[10], top_k=5, filters=f))
    # a filter that empties the probed set falls back to the exact scan (Q13)
    rare = [("metadata", {"parity": "odd"}), ("skip_doc", 0)]
    _same_hits(tdb.query(v[10], top_k=3, filters=rare, ann_percent=0),
               jdb.query(v[10], top_k=3, filters=rare, ann_percent=0))


def test_query_batch_ivf_matches_bruteforce(ivf_on):
    ivf_on(500)
    v = _clustered(n=2000, d=16, n_clusters=10)
    jdb, tdb = _pair(v)
    q_block = (v[np.random.default_rng(3).choice(len(v), 6)] + 0.01).astype(np.float32)
    ivf_res = tdb.query_batch(q_block, top_k=5, ann_percent=30)
    for g, w in zip(ivf_res, jdb.query_batch(q_block, top_k=5, ann_percent=30)):
        _same_hits(g, w)
    ivf_on(10**9)  # the exact scan
    bf_res = tdb.query_batch(q_block, top_k=5)
    recalls = []
    for ivf_row, bf_row in zip(ivf_res, bf_res):
        bf_by_id = {r[2]: r[1] for r in bf_row}
        recalls.append(len({r[2] for r in ivf_row} & set(bf_by_id)) / 5)
        for _, score, doc_id in ivf_row:  # candidates are rescored exactly
            if doc_id in bf_by_id:
                np.testing.assert_allclose(score, bf_by_id[doc_id], rtol=0, atol=ATOL)
    assert np.mean(recalls) >= 0.9


def test_query_batch_ivf_filter_fallback(ivf_on):
    """A filter that leaves a query fewer than top_k candidates sends that
    query to the exact masked scan."""
    ivf_on(500)
    v = _clustered(n=2000, d=16, n_clusters=10)
    docs = [{"i": int(i), "rare": "yes" if i % 400 == 0 else "no"} for i in range(len(v))]
    jdb, tdb = _pair(v, docs=docs, metadata_keys=["rare"])
    f = [("metadata", {"rare": "yes"})]
    got = tdb.query_batch(v[:4], top_k=3, filters=f)
    for g, w in zip(got, jdb.query_batch(v[:4], top_k=3, filters=f)):
        assert len(g) == 3 and all(doc["rare"] == "yes" for doc, *_ in g)
        assert all(np.isfinite(s) for _, s, _ in g)
        _same_hits(g, w)


def test_query_batch_ivf_recency(ivf_on):
    ivf_on(500)
    v = _clustered(n=1500, d=16, n_clusters=10)
    docs = [{"i": int(i), "ts": float(i)} for i in range(len(v))]
    jdb, tdb = _pair(v, docs=docs, metadata_keys=["ts"])
    kw = dict(top_k=5, recency_bias=5.0, timestamp_key="ts")
    got = tdb.query_batch(v[:2], **kw)
    assert (len(v) - 1) in {r[2] for row in got for r in row}
    for g, w in zip(got, jdb.query_batch(v[:2], **kw)):
        _same_hits(g, w)


def test_query_batch_ivf_arrays_and_f16_wire(ivf_on):
    ivf_on(500)
    v = _clustered(n=1500, d=16, n_clusters=10)
    jdb, tdb = _pair(v, fp_precision="float16")
    q = (v[:5] + 0.05).astype(np.float16)
    ti, ts = tdb.query_batch_arrays(q, top_k=4)
    ji, js = jdb.query_batch_arrays(q, top_k=4)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)  # bf16 operands, f32 sums


def test_ivf_is_opt_in_by_default():
    assert TORCH_CONFIG.ivf_threshold == 1 << 62 == TDB_MODULE.IVF_THRESHOLD
    assert TORCH_CONFIG.batch_ivf_min_rows == 1 << 62
    rng = np.random.default_rng(0)
    db = TorchDB(
        documents=[{"i": int(i)} for i in range(70_000)],
        vectors=rng.standard_normal((70_000, 8)).astype(np.float32),
        device="cpu",
    )
    assert isinstance(db.ann_index, FlatIndex) and not getattr(db.ann_index, "is_ann", False)


def test_engine_config_env(monkeypatch):
    for name, attr, value in (
        ("HYPERDB_IVF_THRESHOLD", "ivf_threshold", 1234),
        ("HYPERDB_IVF_NLIST", "ivf_nlist", 77),
        ("HYPERDB_BATCH_IVF_MIN_ROWS", "batch_ivf_min_rows", 99),
        ("HYPERDB_PROJSCAN_DPRIME", "projscan_dprime", 64),
        ("HYPERDB_PROJSCAN_OVERFETCH", "projscan_overfetch", 512),
        ("HYPERDB_PROJSCAN_MIN_VARIANCE", "projscan_min_variance", 0.25),
    ):
        monkeypatch.setenv(name, str(value))
        assert getattr(EngineConfig(), attr) == value, name
    monkeypatch.setenv("HYPERDB_PROJSCAN_MIN_VARIANCE", "not a number")
    assert EngineConfig().projscan_min_variance == 0.5


def test_ivf_nlist_sets_the_db_cluster_count(ivf_on, monkeypatch):
    """``HYPERDB_IVF_NLIST`` sets the DB's cluster count (0 keeps the
    default); with the same count both packages cluster alike."""
    v = _clustered(n=1500, d=16, n_clusters=10)
    docs = [{"i": int(i)} for i in range(len(v))]
    tdb = TorchDB(documents=[dict(d) for d in docs], vectors=v, device="cpu")
    assert tdb.ann_index.nlist == default_nlist(len(v)) != 24
    monkeypatch.setattr(TORCH_CONFIG, "ivf_nlist", 24)
    tdb = TorchDB(documents=[dict(d) for d in docs], vectors=v, device="cpu")
    assert tdb.ann_index.nlist == 24
    _same_index(tdb.ann_index, JaxIVF.build(v, metric="cosine", nlist=24))


def test_int8_pure_with_ivf_index_queries(ivf_on, monkeypatch):
    """int8-pure stores hold no float rows: the gathered fast path steps
    aside and the probed candidates ride the mask of the int8 scan."""
    rng = np.random.default_rng(11)
    n, d = 2048, 32
    v = rng.standard_normal((n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    jdb, tdb = _pair(v, carry=False, device_precision="int8-pure")
    q = (v[37] + 0.01 * rng.standard_normal(d)).astype(np.float32)
    tdb.ann_index = IVFIndex.from_state(jdb.ann_index.state(), device="cpu")
    res = tdb.query(q, top_k=5)
    assert res and res[0][2] == 37
    _same_hits(res, jdb.query(q, top_k=5))
    ivf_on(100)
    out = tdb.query_batch(np.stack([q, v[99]]), top_k=3)
    assert out[0][0][2] == 37 and out[1][0][2] == 99


# ---------------------------------------------------------------- persistence


def test_load_without_ann_index_clears_previous_index(tmp_path, monkeypatch):
    monkeypatch.setattr(TDB_MODULE, "IVF_THRESHOLD", 50)
    rng = np.random.default_rng(3)
    db = TorchDB(documents=[{"i": i} for i in range(100)],
                 vectors=rng.standard_normal((100, 8)).astype(np.float32), device="cpu")
    assert isinstance(db.ann_index, IVFIndex)
    small = TorchDB(documents=[{"i": i} for i in range(10)],
                    vectors=rng.standard_normal((10, 8)).astype(np.float32), device="cpu")
    small.save(str(tmp_path / "small.pickle"), save_ann_index=False)
    db.load(str(tmp_path / "small.pickle"), load_ann_index=False)
    assert db.ann_index is None and db._ivf_built_rows == 0
    assert len(db.query(rng.standard_normal(8).astype(np.float32), top_k=3)) == 3


def test_checkpoint_overwrite_removes_stale_index(tmp_path, monkeypatch):
    monkeypatch.setattr(TDB_MODULE, "IVF_THRESHOLD", 50)
    rng = np.random.default_rng(4)
    big = TorchDB(documents=[{"i": i} for i in range(120)],
                  vectors=rng.standard_normal((120, 8)).astype(np.float32), device="cpu")
    d = str(tmp_path / "ckpt")
    big.save(d, format="checkpoint")
    assert os.path.exists(os.path.join(d, "index.npz"))
    monkeypatch.setattr(TDB_MODULE, "IVF_THRESHOLD", 1 << 62)
    small = TorchDB(documents=[{"i": i} for i in range(10)],
                    vectors=rng.standard_normal((10, 8)).astype(np.float32), device="cpu")
    small.ann_index = None
    small.save(d, format="checkpoint")
    assert not os.path.exists(os.path.join(d, "index.npz"))
    fresh = TorchDB(device="cpu")
    fresh.load(d, format="checkpoint")
    assert len(fresh.query(rng.standard_normal(8).astype(np.float32), top_k=3)) == 3


def test_loaded_ivf_takes_incremental_add_path(tmp_path, monkeypatch):
    monkeypatch.setattr(TDB_MODULE, "IVF_THRESHOLD", 50)
    rng = np.random.default_rng(5)
    db = TorchDB(documents=[{"i": i} for i in range(100)],
                 vectors=rng.standard_normal((100, 8)).astype(np.float32), device="cpu")
    db.save(str(tmp_path / "db.pickle"))
    new = TorchDB(device="cpu")
    new.load(str(tmp_path / "db.pickle"))
    assert isinstance(new.ann_index, IVFIndex)
    assert new._ivf_built_rows == new.ann_index.num_rows == 100
    loaded = new.ann_index
    new.add([{"i": 100}], vectors=rng.standard_normal((1, 8)).astype(np.float32))
    assert new.ann_index is loaded and new.ann_index.num_rows == 101


def test_remove_all_then_bulk_add_rebuilds_index(monkeypatch):
    monkeypatch.setattr(TDB_MODULE, "IVF_THRESHOLD", 50)
    rng = np.random.default_rng(6)
    db = TorchDB(documents=[{"i": i} for i in range(100)],
                 vectors=rng.standard_normal((100, 8)).astype(np.float32), device="cpu")
    old = db.ann_index
    db.remove_document(list(range(100)))
    assert db.ann_index is None and db._ivf_built_rows == 0
    db.add([{"i": i} for i in range(120)], vectors=rng.standard_normal((120, 8)).astype(np.float32))
    assert db.ann_index is not None and db.ann_index is not old and db.ann_index.num_rows == 120
    assert len(db.query(rng.standard_normal(8).astype(np.float32), top_k=3)) == 3


@pytest.mark.parametrize("fmt", ["pickle", "checkpoint"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_ivf_files_cross_packages(tmp_path, ivf_on, fmt, direction):
    """An IVF DB saved by one package (``.pickle`` + ``.ann`` sidecar, or a
    checkpoint with ``index.npz``) loads in the other with the same index
    state and answers the same, single queries and batches."""
    ivf_on(500)
    v = _clustered(n=1200, d=16, n_clusters=10)
    jdb, tdb = _pair(v)
    saver, make = (jdb, lambda: TorchDB(device="cpu")) if direction == "jax_to_torch" else (
        tdb, JaxDB)
    path = str(tmp_path / ("db.pickle" if fmt == "pickle" else "ckpt"))
    saver.save(path, format=fmt)
    loaded = make()
    loaded.load(path, format=fmt)
    state, want = loaded.ann_index.state(), saver.ann_index.state()
    assert state["kind"] == "ivf" and loaded._ivf_built_rows == 1200
    for key in ("centroids", "row_order", "offsets"):
        np.testing.assert_array_equal(state[key], want[key])
    for q in (v[5], v[700] + 0.1):
        _same_hits(loaded.query(q, top_k=5), saver.query(q, top_k=5))
    for g, w in zip(loaded.query_batch(v[:3], top_k=4), saver.query_batch(v[:3], top_k=4)):
        _same_hits(g, w)
