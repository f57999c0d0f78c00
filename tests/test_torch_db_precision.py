"""The int8 and grouped-metric slice as a whole: ``hyperdb_tpu_torch.HyperDB``
against ``hyperdb_tpu.HyperDB``.

Both DBs are built from the same seeded float16 corpus and answer the same
queries, with filters and recency; the port runs with ``device="cpu"``, so
its stage-1 wrappers take their plain versions. ``grouped_topk_min_rows``
is lowered on both configs so the 16384-row corpus takes the grouped routes,
and the int8 epilogue budget is lowered so b = 256 reaches the int8 kernel
route (the JAX package, on the CPU, runs its XLA forms there).

Ids must be identical. Score tolerances: int8-pure scores are the same f32
operations over exact integer dots, 1e-6 relative plus 1e-6 absolute (XLA
may fuse the final multiply-add); rescored int8 and pearson scores are f32
sums of the same products in different orders over near-unit rows, 1e-5
absolute; euclidean 1e-5 relative plus 1e-6 absolute, where two results of
one query may trade places if their scores agree within that tolerance
(the cancellation in ``|v|^2 - 2 q.v + |q|^2`` makes 1-ulp ties, which each
package's sum order settles its own way); hamming and jaccard
are exact integer counts and one IEEE division, so they must be equal —
without recency. The recency term is ``bias * exp(t - max t)`` computed by
each package's NumPy host code in the same way, so it changes no tolerance
except that hamming/jaccard then carry an f32 addition in a different
place: 1e-6.
"""

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, set up by conftest)
import numpy as np
import pytest

from hyperdb_tpu import HyperDB as JaxDB
from hyperdb_tpu.config import CONFIG as JAX_CONFIG
from hyperdb_tpu.ops import quantized as JQ
from hyperdb_tpu_torch import HyperDB as TorchDB
from hyperdb_tpu_torch.config import CONFIG as TORCH_CONFIG
from hyperdb_tpu_torch.ops import gmax as G
from hyperdb_tpu_torch.ops import quantized as TQ

N, D = 16384, 128
PRECISIONS = ("auto", "int8", "int8-pure")
GROUPED = ("euclidean_metric", "hamming_distance", "jaccard_similarity", "pearson_correlation")


def _corpus(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float16)
    v[21] = 0.25  # constant row: pearson NaN -> never ranked
    docs = [
        {"name": f"doc{i}", "ts": float(i % 97) / 97.0, "info": {"kind": ("a", "b", "c")[i % 3]}}
        for i in range(n)
    ]
    return docs, v


def _queries(b, seed):
    return np.random.default_rng(seed).standard_normal((b, D)).astype(np.float32)


@pytest.fixture(autouse=True)
def lowered(monkeypatch):
    monkeypatch.setattr(JAX_CONFIG, "grouped_topk_min_rows", 4096)
    monkeypatch.setattr(TORCH_CONFIG, "grouped_topk_min_rows", 4096)
    monkeypatch.setattr(JQ, "_EPILOGUE_BUDGET_BYTES", 1 << 22)
    monkeypatch.setattr(TQ, "_EPILOGUE_BUDGET_BYTES", 1 << 22)
    JQ.rank_top_k_int8.clear_cache()  # the budget is read when the scan is traced
    yield
    JQ.rank_top_k_int8.clear_cache()


@pytest.fixture(scope="module")
def dbs():
    docs, v = _corpus()
    keys = ["info.kind", "ts"]
    out = {}
    for p in PRECISIONS:
        out[p] = (
            JaxDB(docs, v, fp_precision="float16", metadata_keys=keys, device_precision=p),
            TorchDB(docs, v, fp_precision="float16", metadata_keys=keys,
                    device_precision=p, device="cpu"),
        )
    return out


def _same(jres, tres, rtol, atol, near_ties=False):
    """Ids identical, scores within tolerance. With ``near_ties``, two
    results of one query may trade places where their scores agree within
    the tolerance (each package's f32 sum order decides such a pair)."""
    (ji, js), (ti, ts) = jres, tres
    np.testing.assert_allclose(ts, js, rtol=rtol, atol=atol)
    if not near_ties:
        np.testing.assert_array_equal(ti, ji)
        return
    for r, p in zip(*np.nonzero(ti != ji)):
        (where,) = np.nonzero(ji[r] == ti[r, p])
        assert where.size == 1, f"query {r}: id {ti[r, p]} is not among the reference's"
        np.testing.assert_allclose(js[r, where[0]], js[r, p], rtol=rtol, atol=atol)


KWARGS = {
    "plain": {},
    "filter": {"filters": [("metadata", {"info.kind": "b"})]},
    "recency": {"recency_bias": 0.05, "timestamp_key": "ts"},
}


@pytest.mark.parametrize("how", list(KWARGS))
@pytest.mark.parametrize("metric", ["cosine_similarity", "dot_product"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("b", [256, 64])
def test_precisions_match_jax(dbs, precision, metric, b, how):
    """b = 256 is past the lowered epilogue budget (the int8 kernel route in
    the port), b = 64 is under it (the plain grouped int8 form)."""
    jdb, tdb = dbs[precision]
    q = _queries(b, seed=b)
    calls = []
    real = G.gmax_int8
    G.gmax_int8 = lambda *a: calls.append(1) or real(*a)
    try:
        tres = tdb.query_batch_arrays(q, top_k=10, metric=metric, **KWARGS[how])
    finally:
        G.gmax_int8 = real
    jres = jdb.query_batch_arrays(q, top_k=10, metric=metric, **KWARGS[how])
    assert tres[0].shape == (b, 10) and tres[0].dtype == np.int64
    if precision == "int8-pure":
        _same(jres, tres, rtol=1e-6, atol=1e-6)
    else:
        _same(jres, tres, rtol=0, atol=1e-5)
    assert len(calls) == (1 if precision != "auto" and b == 256 else 0)
    if how == "filter":
        assert (tres[0] % 3 == 1).all()


def test_int8_exact_matches_auto(dbs):
    """The flow of the JAX package's own int8 test: the rescored int8 mode
    returns the auto mode's ids; int8-pure finds the planted row."""
    _, v = _corpus()
    q = v[42].astype(np.float32) + 0.01
    r8 = dbs["int8"][1].query(q, top_k=5)
    ra = dbs["auto"][1].query(q, top_k=5)
    assert [r[2] for r in r8] == [r[2] for r in ra] and r8[0][2] == 42
    assert dbs["int8-pure"][1].query(v[7].astype(np.float32), top_k=3)[0][2] == 7
    rj = dbs["int8"][0].query(q, top_k=5)
    assert [r[2] for r in r8] == [r[2] for r in rj]


@pytest.mark.parametrize("metric", ["euclidean_metric", "manhattan_distance", "hamming_distance"])
def test_int8_pure_rejects_other_metrics(dbs, metric):
    jdb, tdb = dbs["int8-pure"]
    q = _queries(64, seed=1)
    with pytest.raises(ValueError) as jerr:
        jdb.query_batch_arrays(q, top_k=5, metric=metric)
    with pytest.raises(ValueError) as terr:
        tdb.query_batch_arrays(q, top_k=5, metric=metric)
    assert str(terr.value) == str(jerr.value)
    assert "int8-pure" in str(terr.value)


def _grouped_metric_case(jdb, tdb, metric, b, how):
    q = _queries(b, seed=3 * b)
    names = ("gmax_f_sub", "gmax_f", "gmax_jaccard")
    calls = []
    reals = {name: getattr(G, name) for name in names}
    for name, real in reals.items():
        setattr(G, name, lambda *a, _n=name, _r=real, **kw: calls.append(_n) or _r(*a, **kw))
    try:
        tres = tdb.query_batch_arrays(q, top_k=10, metric=metric, **KWARGS[how])
    finally:
        for name, real in reals.items():
            setattr(G, name, real)
    jres = jdb.query_batch_arrays(q, top_k=10, metric=metric, **KWARGS[how])
    if metric == "euclidean_metric":
        _same(jres, tres, rtol=1e-5, atol=1e-6, near_ties=True)
    elif metric == "pearson_correlation":
        _same(jres, tres, rtol=0, atol=1e-5)
        assert not (tres[0] == 21).any()  # the constant row never ranks
    else:
        _same(jres, tres, rtol=0, atol=1e-6 if how == "recency" else 0)
    kernel = "gmax_jaccard" if metric == "jaccard_similarity" else "gmax_f_sub"
    recency_plain = how == "recency" and metric != "pearson_correlation"
    assert calls == ([kernel] if b == 512 and not recency_plain else [])
    if how == "filter":
        assert (tres[0] % 3 == 1).all()


@pytest.mark.parametrize("how", list(KWARGS))
@pytest.mark.parametrize("metric", GROUPED)
@pytest.mark.parametrize("b", [512, 64])
def test_grouped_metrics_match_jax(dbs, metric, b, how):
    """b = 512 takes the port's kernel routes (gmax_f_sub for euclidean,
    hamming and pearson, gmax_jaccard for jaccard; the plain form with
    recency), b = 64 the plain grouped forms."""
    _grouped_metric_case(*dbs["auto"], metric, b, how)


@pytest.mark.parametrize("metric", GROUPED)
def test_grouped_metrics_on_int8_store(dbs, metric):
    """An int8 store keeps its float planes, so these metrics run on them
    exactly as in auto mode."""
    _grouped_metric_case(*dbs["int8"], metric, 512, "plain")


def test_pearson_constant_query_never_ranks_finite(dbs):
    jdb, tdb = dbs["auto"]
    q = np.full((64, D), 2.0, dtype=np.float32)
    ti, ts = tdb.query_batch_arrays(q, top_k=5, metric="pearson_correlation")
    _, js = jdb.query_batch_arrays(q, top_k=5, metric="pearson_correlation")
    assert ti.shape == (64, 5) and np.isneginf(ts).all() and np.isneginf(js).all()


def test_query_and_query_batch_surfaces(dbs):
    jdb, tdb = dbs["int8"]
    q = _queries(100, seed=5)  # padded to 128 by the batch bucketing
    for metric in ("cosine_similarity", "jaccard_similarity"):
        jrows = jdb.query_batch(q, top_k=5, metric=metric)
        trows = tdb.query_batch(q, top_k=5, metric=metric)
        for jr, tr in zip(jrows, trows):
            assert [t[2] for t in tr] == [t[2] for t in jr]
            np.testing.assert_allclose([t[1] for t in tr], [t[1] for t in jr], atol=1e-5)
        jq = jdb.query(q[1], top_k=7, metric=metric)
        tq = tdb.query(q[1], top_k=7, metric=metric)
        assert [t[2] for t in tq] == [t[2] for t in jq]


@pytest.mark.parametrize("precision", ["int8", "int8-pure"])
def test_from_state_carries_device_precision(precision):
    """A port DB built from a JAX DB's plain fields holds bit-equal int8
    planes and answers alike."""
    docs, v = _corpus(seed=8, n=4096)
    jdb = JaxDB(docs, v, fp_precision="float16", device_precision=precision, ann_metric="dot")
    state = {
        "vectors": np.asarray(jdb.vectors),
        "documents": list(jdb.documents),
        "source_indices": list(jdb.source_indices),
        "metadata_keys": list(jdb.metadata_keys),
        "fp_precision": np.dtype(jdb.fp_precision).name,
        "ann_metric": jdb.ann_metric,
        "device_precision": jdb._store.precision,
    }
    tdb = TorchDB.from_state(state, device="cpu")
    assert tdb._store.precision == precision
    jdv = jdb._store.device_view(jdb.source_indices)
    tdv = tdb._store.device_view(tdb.source_indices)
    for key in ("rows_q", "row_scales", "rowsn_q", "rown_scales"):
        np.testing.assert_array_equal(tdv[key].numpy(), np.asarray(jdv[key]))
    q = _queries(64, seed=10)
    for metric in ("cosine_similarity", "dot_product"):
        _same(
            jdb.query_batch_arrays(q, top_k=10, metric=metric),
            tdb.query_batch_arrays(q, top_k=10, metric=metric),
            rtol=1e-6, atol=1e-5,
        )


def test_device_precision_argument_and_environment(monkeypatch):
    docs, v = _corpus(seed=1, n=32)
    with pytest.raises(ValueError) as terr:
        TorchDB(docs, v, device="cpu", device_precision="fp4")
    with pytest.raises(ValueError) as jerr:
        JaxDB(docs, v, device_precision="fp4")
    assert str(terr.value) == str(jerr.value)
    monkeypatch.setenv("HYPERDB_DEVICE_PRECISION", "int8-pure")
    assert TorchDB(docs, v, device="cpu")._store.precision == "int8-pure"
    assert TorchDB(docs, v, device="cpu", device_precision="auto")._store.precision == "auto"


def test_unported_branches_still_raise(monkeypatch, tmp_path):
    """Nothing raises any more: an int8-pure corpus at the projscan
    threshold builds the index (``tests/test_torch_projscan.py`` holds it in
    full), the other branches answer."""
    from hyperdb_tpu_torch.index.projscan import ProjScanIndex

    docs, v = _corpus(seed=1, n=64)
    monkeypatch.setattr(TORCH_CONFIG, "projscan_threshold", 16)
    pure = TorchDB(docs, v, device="cpu", device_precision="int8-pure")
    assert isinstance(pure.ann_index, ProjScanIndex) and pure.ann_index.d_prime == D
    # projscan is int8-pure only
    assert TorchDB(docs, v, device="cpu", device_precision="int8").ann_index.state()["kind"] == "flat"
    monkeypatch.setattr(TORCH_CONFIG, "grouped_topk_min_rows", 32)
    monkeypatch.setattr(TORCH_CONFIG, "host_path_max_cells", 0)
    db = TorchDB(docs, v, device="cpu")
    # manhattan over a large corpus is ported: it answers instead of raising
    ids, _ = db.query_batch_arrays(_queries(4, 0), top_k=3, metric="manhattan_distance")
    assert ids.shape == (4, 3)
    # persistence and text embedding are ported: they answer instead of raising
    db.save(tmp_path / "x.pkl.gz")
    db.add({"name": "x"})
    assert db.size() == 65 and db.split_info == {64: 1}
