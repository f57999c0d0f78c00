"""The slice as a whole: ``hyperdb_tpu_torch.HyperDB`` against ``hyperdb_tpu.HyperDB``.

Both DBs are built from the same seeded float16 corpus (bf16 device planes)
and answer the same queries; the port runs with ``device="cpu"``, so its
stage-1 wrappers take their plain versions. With ``grouped_topk_min_rows``
lowered, b = 512 goes through the port's gmax route (the JAX package, on the
CPU, keeps its XLA grouped form) and b = 64 through the plain grouped route.

Ids must be identical. Scores agree within 1e-5 absolute (values are
cosines, or dots of near-unit rows): the f32 sums of the same bf16 products
run in different orders, and the two packages' f32 query norms may differ
by an ulp, which can flip the bf16 rounding of a rare query element.
"""

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, set up by conftest)
import numpy as np
import pytest

from hyperdb_tpu import HyperDB as JaxDB
from hyperdb_tpu.config import CONFIG as JAX_CONFIG
from hyperdb_tpu_torch import HyperDB as TorchDB
from hyperdb_tpu_torch.config import CONFIG as TORCH_CONFIG
from hyperdb_tpu_torch.core import db as TDB_MODULE
from hyperdb_tpu_torch.ops import gmax as G

N, D = 16384, 128
ATOL = 1e-5
METRICS = ("cosine_similarity", "dot_product")


def _corpus(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float16)
    v[17] = v[4]  # exact duplicate: the lower id must come first
    docs = [
        {"name": f"doc{i}", "info": {"kind": ("a", "b", "c")[i % 3]}} for i in range(n)
    ]
    return docs, v


@pytest.fixture(scope="module")
def dbs():
    docs, v = _corpus()
    jdb = JaxDB(docs, v, fp_precision="float16", metadata_keys=["info.kind"])
    tdb = TorchDB(docs, v, fp_precision="float16", metadata_keys=["info.kind"], device="cpu")
    return jdb, tdb, v


@pytest.fixture(params=["default", "grouped"])
def route(request, monkeypatch):
    if request.param == "grouped":
        monkeypatch.setattr(JAX_CONFIG, "grouped_topk_min_rows", 4096)
        monkeypatch.setattr(TORCH_CONFIG, "grouped_topk_min_rows", 4096)
    return request.param


def _queries(b, v, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, D)).astype(np.float32)
    q[0] = v[4].astype(np.float32) * 2
    return q


def _same(jres, tres):
    ji, js = jres
    ti, ts = tres
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=ATOL)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b", [512, 64])
def test_query_batch_arrays(dbs, route, metric, b):
    jdb, tdb, v = dbs
    q = _queries(b, v, seed=b)
    jres = jdb.query_batch_arrays(q, top_k=10, metric=metric)
    tres = tdb.query_batch_arrays(q, top_k=10, metric=metric)
    assert tres[0].shape == (b, 10) and tres[0].dtype == np.int64
    _same(jres, tres)
    assert list(tres[0][0, :2]) == [4, 17]


@pytest.mark.parametrize("metric", METRICS)
def test_query_batch_and_query(dbs, route, metric):
    jdb, tdb, v = dbs
    q = _queries(100, v, seed=5)  # padded to 128 by the batch bucketing
    jrows = jdb.query_batch(q, top_k=5, metric=metric)
    trows = tdb.query_batch(q, top_k=5, metric=metric)
    assert len(trows) == 100
    for jr, tr in zip(jrows, trows):
        assert [t[0] for t in tr] == [t[0] for t in jr]
        assert [t[2] for t in tr] == [t[2] for t in jr]
        np.testing.assert_allclose([t[1] for t in tr], [t[1] for t in jr], atol=ATOL)
    jq = jdb.query(q[1], top_k=7, metric=metric)
    tq = tdb.query(q[1], top_k=7, metric=metric)
    assert [t[2] for t in tq] == [t[2] for t in jq]
    np.testing.assert_allclose([t[1] for t in tq], [t[1] for t in jq], atol=ATOL)
    assert tdb.query(q[1], top_k=7, metric=metric) is tq  # LRU hit


@pytest.mark.parametrize(
    "filters",
    [
        [("metadata", {"info.kind": "b"})],
        [("skip_doc", 4)],
        [("skip_doc", 3), ("metadata", {"info.kind": "a"})],
    ],
)
def test_filters(dbs, route, filters):
    jdb, tdb, v = dbs
    q = _queries(512, v, seed=9)
    jres = jdb.query_batch_arrays(q, top_k=10, filters=filters)
    tres = tdb.query_batch_arrays(q, top_k=10, filters=filters)
    _same(jres, tres)
    if filters[0] == ("metadata", {"info.kind": "b"}):
        assert (tres[0] % 3 == 1).all()
    jq = jdb.query(q[3], top_k=4, filters=filters)
    tq = tdb.query(q[3], top_k=4, filters=filters)
    assert [t[2] for t in tq] == [t[2] for t in jq]


def test_host_path_tiny_corpus(monkeypatch):
    """A tiny corpus ranks on the host (NumPy) in both packages."""
    monkeypatch.setattr(JAX_CONFIG, "host_path_max_cells", 1 << 20)
    monkeypatch.setattr(TORCH_CONFIG, "host_path_max_cells", 1 << 20)
    docs, v = _corpus(seed=3, n=64, d=16)
    jdb = JaxDB(docs, v, fp_precision="float16")
    tdb = TorchDB(docs, v, fp_precision="float16", device="cpu")
    q = np.random.default_rng(4).standard_normal((8, 16)).astype(np.float32)
    for metric in ("cosine_similarity", "dot_product", "euclidean_metric"):
        _same(
            jdb.query_batch_arrays(q, top_k=5, metric=metric),
            tdb.query_batch_arrays(q, top_k=5, metric=metric),
        )
    assert tdb._store._device is None  # never built a device view


def test_add_then_query(route):
    docs, v = _corpus(seed=6, n=2048)
    jdb = JaxDB(docs[:2000], v[:2000], fp_precision="float16")
    tdb = TorchDB(docs[:2000], v[:2000], fp_precision="float16", device="cpu")
    for db in (jdb, tdb):
        db.add(docs[2000:], vectors=v[2000:])
        db.add(docs[0], vectors=v[0])
    assert tdb.size() == jdb.size() == 2049
    q = _queries(64, v, seed=7)
    _same(jdb.query_batch_arrays(q, top_k=10), tdb.query_batch_arrays(q, top_k=10))
    assert tdb.dict()[:3] == jdb.dict()[:3]


@pytest.mark.parametrize("precision", ["float16", "float32"])
def test_from_state(route, precision):
    """A port DB built from a JAX DB's plain fields answers alike."""
    docs, v = _corpus(seed=8, n=8192)
    jdb = JaxDB(docs, v.astype(precision), fp_precision=precision,
                metadata_keys=["info.kind"], ann_metric="dot")
    state = {
        "vectors": np.asarray(jdb.vectors),
        "documents": list(jdb.documents),
        "source_indices": list(jdb.source_indices),
        "metadata_keys": list(jdb.metadata_keys),
        "fp_precision": np.dtype(jdb.fp_precision).name,
        "ann_metric": jdb.ann_metric,
    }
    tdb = TorchDB.from_state(state, device="cpu")
    assert tdb.vectors.dtype == jdb.vectors.dtype and tdb.ann_metric == "dot"
    q = _queries(512, v, seed=10)
    for metric in METRICS:
        _same(
            jdb.query_batch_arrays(q, top_k=10, metric=metric),
            tdb.query_batch_arrays(q, top_k=10, metric=metric),
        )
    filters = [("metadata", {"info.kind": "c"})]
    _same(
        jdb.query_batch_arrays(q, top_k=10, filters=filters),
        tdb.query_batch_arrays(q, top_k=10, filters=filters),
    )


def test_gmax_route_runs_plain_on_cpu(dbs, monkeypatch):
    """b = 512 over the bf16 plane goes through rank_top_k_grouped_gmax,
    whose wrappers run their plain versions on CPU tensors."""
    monkeypatch.setattr(TORCH_CONFIG, "grouped_topk_min_rows", 4096)
    jdb, tdb, v = dbs
    calls = []
    real = G.rank_top_k_grouped_gmax
    monkeypatch.setattr(
        G, "rank_top_k_grouped_gmax", lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw)
    )
    before = dict(G.LAUNCHES)
    tdb.query_batch_arrays(_queries(300, v, seed=11), top_k=10)  # padded to 512
    assert calls == [(512, D)]
    assert G.LAUNCHES == before


def test_not_ported_branches_raise(monkeypatch, tmp_path):
    """No branch raises any more: the IVF index builds over an embedded
    corpus at the threshold, and text embedding and persistence answer
    (``tests/test_torch_ivf.py`` holds the index in full)."""
    from hyperdb_tpu_torch.index.ivf import IVFIndex

    monkeypatch.setattr(TDB_MODULE, "IVF_THRESHOLD", 16)
    ivf_db = TorchDB([f"some text {i}" for i in range(20)], device="cpu")
    assert isinstance(ivf_db.ann_index, IVFIndex) and ivf_db.ann_index.num_rows == 20
    assert len(ivf_db.query("some text 3", top_k=3)) == 3
    monkeypatch.undo()
    assert TorchDB(["some text"], device="cpu").size() == 1
    docs, v = _corpus(seed=1, n=32)
    db = TorchDB(docs, v, device="cpu")
    db.save(tmp_path / "x.pkl")
    db.add({"name": "x"})  # no vectors: embedded (a one-row document)
    assert db.split_info == {32: 1}
    db.add({"name": "x"}, vectors=np.zeros((2, D)))  # two rows for one document
    assert (db.size(), db.size(with_chunks=True)) == (34, 35)
    assert TorchDB(docs, v, device="cpu", device_precision="int8")._store.precision == "int8"
    with pytest.raises(ValueError):
        TorchDB(docs, v, device="cpu", device_precision="int4")


@pytest.mark.parametrize("metric", METRICS)
def test_split_plane_corpus_runs_as_one_plane(monkeypatch, metric):
    """A corpus past ``plane_rows`` splits into several device planes in
    both packages (the planar capacity route), and the port gives the JAX
    package's answers through its own planes
    (``tests/test_torch_planar.py`` holds the route in full)."""
    monkeypatch.setattr(JAX_CONFIG, "plane_rows", 1024)
    monkeypatch.setattr(TORCH_CONFIG, "plane_rows", 1024)
    docs, v = _corpus(seed=2, n=4096)
    jdb = JaxDB(docs, v, fp_precision="float16")
    tdb = TorchDB(docs, v, fp_precision="float16", device="cpu")
    assert jdb._store.is_planar(4096) and tdb._store.is_planar(4096)
    q = _queries(64, v, seed=1)
    got = tdb.query_batch_arrays(q, top_k=10, metric=metric)
    _same(jdb.query_batch_arrays(q, top_k=10, metric=metric), got)
    assert list(got[0][0, :2]) == [4, 17]
    dv = tdb._store.device_view(tdb.source_indices)
    planes = dv["rows_norm_planes" if metric == "cosine_similarity" else "rows_planes"]
    assert [p.shape[0] for p in planes] == [1024] * 4
    assert "rows" not in dv and "rows_norm" not in dv  # no one-plane build
