"""The planar capacity route: ``hyperdb_tpu_torch`` against ``hyperdb_tpu``.

An unchunked corpus of more padded rows than ``CONFIG.plane_rows`` keeps
its float device planes split (``core/store.py``: ``plane_bounds``,
``rows_planes``, ``rows_norm_planes``), and the
engine's device branch ranks it plane by plane through
``ops/ranking.rank_top_k_planar``, which merges the per-plane winners.
These tests mirror ``tests/test_planar_engine.py`` and
``tests/test_ranking.py::TestRankTopKPlanar`` with both packages' configs
set alike: the port's planar route against its own one-plane route and
against the JAX planar route, on the same seeded numpy inputs (the port on
CPU tensors, so its kernel wrappers run their plain versions).

Tolerances: ids identical everywhere, ties to the lower global id. Scores:
planar against one plane in the same package rtol 1e-5 plus atol 1e-6 (the
JAX test's: the same plane rows, ranked by the same routes); the port
against the JAX package 1e-5 relative plus 1e-5 absolute (f32 sums of the
same products in other orders; euclidean's f64 expansion in the port). The
split planes are bit-equal to the one-plane build and to the JAX planes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperdb_tpu import HyperDB as JaxDB
from hyperdb_tpu.config import CONFIG as JAX_CONFIG
from hyperdb_tpu.core.store import VectorStore as JaxStore
from hyperdb_tpu.ops import ranking as JR
from hyperdb_tpu_torch import HyperDB as TorchDB
from hyperdb_tpu_torch.config import CONFIG as TORCH_CONFIG
from hyperdb_tpu_torch.core.store import VectorStore as TorchStore
from hyperdb_tpu_torch.ops import gmax as G
from hyperdb_tpu_torch.ops import l1 as L
from hyperdb_tpu_torch.ops import ranking as TR
from hyperdb_tpu_torch.ops.metrics import METRICS

N_ROWS, DIM, PLANE = 6144, 16, 2048  # three planes when planar
TIE = PLANE + 5  # a copy of row 3 in the second plane
# scores of 0/1 rows: many rows tie at every rank
TIED_METRICS = ("hamming_distance", "jaccard_similarity")


def _set(monkeypatch, **knobs):
    for config in (JAX_CONFIG, TORCH_CONFIG):
        for name, value in knobs.items():
            monkeypatch.setattr(config, name, value)


@pytest.fixture
def device_route(monkeypatch):
    """Both packages take the device branch and the grouped routes."""
    _set(monkeypatch, host_path_max_cells=0, grouped_topk_min_rows=512)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    v = rng.standard_normal((N_ROWS, DIM)).astype(np.float32)
    v[7] = 1.0  # constant row: pearson's NaN case
    v[TIE] = v[3]
    docs = [
        {"i": int(i), "grp": ["a", "b", "c"][i % 3], "ts": float(i % 5)}
        for i in range(N_ROWS)
    ]
    qs = rng.standard_normal((4, DIM)).astype(np.float32)
    qs[0] = v[3]  # rows 3 and TIE tie at the top across planes
    return docs, v, qs


@pytest.fixture(scope="module")
def dbs(corpus):
    docs, v, _ = corpus
    keys = ["grp", "ts"]
    jdb = JaxDB(documents=docs, vectors=v, metadata_keys=keys)
    tdb = TorchDB(documents=docs, vectors=v, metadata_keys=keys, device="cpu")
    return jdb, tdb


def _same(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(
        np.asarray(got[1], dtype=np.float64), np.asarray(want[1], dtype=np.float64),
        rtol=rtol, atol=atol,
    )


def _hits(rows):
    """(ids, scores) of a ``query``/``query_batch`` answer."""
    rows = rows if rows and isinstance(rows[0], list) else [rows]
    return (
        [[r[0]["i"] for r in res] for res in rows],
        [[r[1] for r in res] for res in rows],
    )


# --------------------------------------------------------------------------
# the engine (tests/test_planar_engine.py)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("metric", METRICS)
def test_planar_matches_one_plane_and_jax(dbs, corpus, device_route, monkeypatch, metric):
    """Every metric the device branch serves: the port's planar answer is
    the JAX planar answer and its own one-plane answer (for hamming and
    jaccard, whose one-plane grouped route breaks the many ties by group
    rank, the same scores: as in the JAX package, which pins the planar
    route to one plane on the other five metrics)."""
    jdb, tdb = dbs
    _, _, qs = corpus
    _set(monkeypatch, plane_rows=0)
    assert not tdb._store.is_planar(N_ROWS)
    one = tdb.query_batch_arrays(qs, top_k=9, metric=metric)
    _set(monkeypatch, plane_rows=PLANE)
    assert tdb._store.is_planar(N_ROWS) and jdb._store.is_planar(N_ROWS)
    got = tdb.query_batch_arrays(qs, top_k=9, metric=metric)
    _same(got, jdb.query_batch_arrays(qs, top_k=9, metric=metric))
    if metric in TIED_METRICS:
        # the one-plane grouped route orders ties by (group rank, position)
        np.testing.assert_array_equal(got[1], one[1])
    else:
        _same(got, one, rtol=1e-5, atol=1e-6)
    if metric in ("cosine_similarity", "euclidean_metric", "manhattan_distance"):
        assert list(got[0][0, :2]) == [3, TIE]  # the cross-plane tie
    dv = tdb._store.device_view(tdb.source_indices)
    key = "rows_norm_planes" if metric == "cosine_similarity" else "rows_planes"
    assert len(dv[key]) == 3


@pytest.mark.parametrize(
    "metric", ["cosine_similarity", "euclidean_metric", "manhattan_distance"]
)
def test_planar_with_filter_and_recency(dbs, corpus, device_route, monkeypatch, metric):
    jdb, tdb = dbs
    _, _, qs = corpus
    kwargs = dict(
        top_k=7,
        metric=metric,
        filters=[("metadata", {"grp": "b"})],
        recency_bias=1.5,
        timestamp_key="ts",
    )
    _set(monkeypatch, plane_rows=0)
    one = _hits(tdb.query(qs[1], **kwargs))
    tdb.clear_cache()
    _set(monkeypatch, plane_rows=PLANE)
    got = _hits(tdb.query(qs[1], **kwargs))
    want = _hits(jdb.query(qs[1], **kwargs))
    tdb.clear_cache()
    jdb.clear_cache()
    _same(got, one, rtol=1e-5, atol=1e-6)
    _same(got, want)
    assert all(i % 3 == 1 for i in got[0][0])
    # the batch form with the same filter and recency
    kwargs.pop("top_k")
    got = tdb.query_batch_arrays(qs, top_k=7, **kwargs)
    _same(got, jdb.query_batch_arrays(qs, top_k=7, **kwargs))


def test_planar_after_mutation(corpus, device_route, monkeypatch):
    """Mutations invalidate the split planes like every other plane: an
    added row is ranked, and a removal takes it back out."""
    docs, v, qs = corpus
    _set(monkeypatch, plane_rows=PLANE)
    jdb = JaxDB(documents=docs, vectors=v, metadata_keys=["grp", "ts"])
    tdb = TorchDB(documents=docs, vectors=v, metadata_keys=["grp", "ts"], device="cpu")
    before = tdb.query(qs[1], top_k=3, metric="dot_product")
    planes = tdb._store.device_view(tdb.source_indices)["rows_planes"]
    new_vec = np.asarray(qs[1] * 10.0, dtype=np.float32)
    for db in (jdb, tdb):
        db.add_document({"i": N_ROWS, "grp": "z", "ts": 0.0}, vectors=new_vec)
        db.commit_pending()
        db.clear_cache()
    after = tdb.query(qs[1], top_k=3, metric="dot_product")
    assert after[0][0]["i"] == N_ROWS and before[0][0]["i"] != N_ROWS
    assert tdb._store.device_view(tdb.source_indices)["rows_planes"] is not planes
    _same(_hits(after), _hits(jdb.query(qs[1], top_k=3, metric="dot_product")))
    _same(
        tdb.query_batch_arrays(qs, top_k=5, metric="cosine_similarity"),
        jdb.query_batch_arrays(qs, top_k=5, metric="cosine_similarity"),
    )
    for db in (jdb, tdb):
        db.remove_document(N_ROWS)
        db.clear_cache()
    _same(_hits(tdb.query(qs[1], top_k=3, metric="dot_product")), _hits(before), 0, 0)


def test_planar_routes_per_plane(corpus, device_route, monkeypatch):
    """The planar branch sits where the JAX engine has it: over float16
    (bf16) planes a cosine batch of 512 takes ``gmax_f_sub`` once per plane
    and manhattan at b = 64 the L1 route once per plane, while euclidean at
    b = 512 takes the plain per-plane scores, not its grouped kernel route.
    The answers are the JAX planar answers."""
    docs, v, _ = corpus
    _set(monkeypatch, plane_rows=PLANE)
    v16 = v.astype(np.float16)
    jdb = JaxDB(documents=docs, vectors=v16, fp_precision="float16")
    tdb = TorchDB(documents=docs, vectors=v16, fp_precision="float16", device="cpu")
    calls = []
    for mod, name in ((G, "gmax_f_sub"), (G, "gmax_f"), (G, "gmax_jaccard"),
                      (L, "gmax_l1"), (L, "gmax_l1t")):
        real = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _real=real, _name=name, **kw: calls.append(_name) or _real(*a, **kw)
        )
    rng = np.random.default_rng(3)
    cases = (
        ("cosine_similarity", 512, ["gmax_f_sub"] * 3),
        ("euclidean_metric", 512, []),
        ("jaccard_similarity", 512, []),
        ("manhattan_distance", 64, ["gmax_l1t"] * 3),
    )
    for metric, b, want_calls in cases:
        q = rng.standard_normal((b, DIM)).astype(np.float32)
        calls.clear()
        got = tdb.query_batch_arrays(q, top_k=10, metric=metric)
        assert calls == want_calls, metric
        _same(got, jdb.query_batch_arrays(q, top_k=10, metric=metric))


def test_preload_builds_the_split_planes(tmp_path, corpus, monkeypatch):
    docs, v, qs = corpus
    _set(monkeypatch, plane_rows=PLANE)
    db = TorchDB(documents=docs, vectors=v, device="cpu")
    db.save(str(tmp_path / "c"), format="checkpoint")
    again = TorchDB(device="cpu")
    again.load(str(tmp_path / "c"), format="checkpoint", preload_ann_into_memory=True)
    dv = again._store._device
    assert {"rows_norm_planes", "rows_planes"} <= set(dv)
    assert not {"rows", "rows_norm"} & set(dv)


@pytest.mark.parametrize("fmt, name", [("pickle", "db.pkl"), ("checkpoint", "ckpt")])
@pytest.mark.parametrize("direction", ["torch_to_torch", "torch_to_jax", "jax_to_torch"])
def test_planar_persistence_round_trip(tmp_path, corpus, device_route, monkeypatch,
                                       fmt, name, direction):
    """The files of a planar DB are the files of any DB: a loaded DB splits
    its planes again and answers as the saver did."""
    docs, v, qs = corpus
    _set(monkeypatch, plane_rows=PLANE)
    src, dst = direction.split("_to_")
    make = {
        "jax": lambda **kw: JaxDB(**kw),
        "torch": lambda **kw: TorchDB(device="cpu", **kw),
    }
    saver = make[src](documents=docs, vectors=v.astype(np.float16), fp_precision="float16",
                      metadata_keys=["grp"])
    path = tmp_path / name
    saver.save(str(path), format=fmt)
    loaded = make[dst](fp_precision="float16", metadata_keys=["grp"])
    loaded.load(str(path), format=fmt)
    assert loaded._store.is_planar(N_ROWS)
    np.testing.assert_array_equal(np.asarray(loaded.vectors), np.asarray(saver.vectors))
    for metric in ("cosine_similarity", "manhattan_distance"):
        _same(
            loaded.query_batch_arrays(qs, top_k=8, metric=metric),
            saver.query_batch_arrays(qs, top_k=8, metric=metric),
        )
    filters = [("metadata", {"grp": "c"})]
    _same(loaded.query_batch_arrays(qs, top_k=8, filters=filters),
          saver.query_batch_arrays(qs, top_k=8, filters=filters))


# --------------------------------------------------------------------------
# the store (tests/test_planar_engine.py::TestStorePlanes)
# --------------------------------------------------------------------------


def test_plane_bounds_remainder_folds(monkeypatch):
    _set(monkeypatch, plane_rows=1024)
    s = TorchStore(np.float32, device="cpu")
    assert s.plane_bounds(1024) == [0, 1024]  # not planar at the cap
    assert s.plane_bounds(3072) == [0, 1024, 2048, 3072]
    assert s.plane_bounds(2112) == [0, 1024, 2112]  # a 64-row remainder folds
    assert s.plane_bounds(2176) == [0, 1024, 2048, 2176]  # 128 = cap // 8 does not
    for n_pad in (8, 1000, 1025, 4096, 5000, 9000, 1 << 16):
        assert s.plane_bounds(n_pad) == JaxStore.plane_bounds(n_pad)
        assert s.is_planar(n_pad) == JaxStore(np.float32).is_planar(n_pad)
    _set(monkeypatch, plane_rows=0)
    assert s.plane_bounds(1 << 26) == [0, 1 << 26]  # 0 disables


def _bits(x):
    """A plane's raw bits as a numpy array (bf16 planes viewed as int16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
@pytest.mark.parametrize("key", ["rows", "rows_norm"])
def test_split_planes_reassemble_bitwise(monkeypatch, key, dtype):
    """The split planes concatenate to the one-plane build bit for bit, in
    both keys, and equal the JAX package's split planes; ``row_valid``
    sliced at the bounds (the engine's per-plane masks) equals the JAX
    package's ``plane_row_valid``. 1500 rows pad to 1536: three planes of
    512, the last with padding (and a zero row, whose norm is taken as 1)."""
    _set(monkeypatch, plane_rows=512)
    rng = np.random.default_rng(5)
    v = rng.standard_normal((1500, 8)).astype(dtype)
    v[600] = 0.0
    t, j = TorchStore(dtype, device="cpu"), JaxStore(dtype)
    for s in (t, j):
        s.set(v)
    tdv, jdv = t.device_view(range(1500)), j.device_view(list(range(1500)))
    n_pad = tdv["n_pad"]
    assert n_pad == jdv["n_pad"] and t.is_planar(n_pad)
    bounds = t.plane_bounds(n_pad)
    planes = tdv[key + "_planes"]
    assert [p.shape[0] for p in planes] == [b - a for a, b in zip(bounds, bounds[1:])]
    one = _bits(tdv[key])
    np.testing.assert_array_equal(np.concatenate([_bits(p) for p in planes]), one)
    np.testing.assert_array_equal(one, _bits(jdv[key]))
    for tp, jp in zip(planes, jdv[key + "_planes"]):
        np.testing.assert_array_equal(_bits(tp), _bits(jp))
    valid = tdv["row_valid"].numpy()
    assert len(jdv["plane_row_valid"]) == len(bounds) - 1
    for (a, b), jm in zip(zip(bounds, bounds[1:]), jdv["plane_row_valid"]):
        np.testing.assert_array_equal(valid[a:b], np.asarray(jm))


@pytest.mark.parametrize("threads", [1, 3])
def test_chunked_build_matches_one_chunk(monkeypatch, threads):
    """Plane builds and the ``row_sq`` pass over many chunks (7 rows each,
    a ragged last one) on 1 and 3 threads equal the one-chunk build bit for
    bit, and the unit-norm planes equal the JAX package's; a zero row takes
    norm 1."""
    from hyperdb_tpu_torch.core import store as S

    _set(monkeypatch, plane_rows=512)
    rng = np.random.default_rng(6)
    v = rng.standard_normal((1500, 24)).astype(np.float16)
    v[7] = 0.0
    one = TorchStore(np.float16, device="cpu")
    one.set(v)
    want = one.device_view(range(1500))
    monkeypatch.setattr(S, "_BUILD_CHUNK_ELEMS", 24 * 7)
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        t = TorchStore(np.float16, device="cpu")
        t.set(v)
        got = t.device_view(range(1500))
        for key in ("rows", "rows_norm", "row_sq"):
            np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]))
        for key in ("rows_planes", "rows_norm_planes"):
            for g, w in zip(got[key], want[key]):
                np.testing.assert_array_equal(_bits(g), _bits(w))
    finally:
        torch.set_num_threads(before)
    j = JaxStore(np.float16)
    j.set(v)
    np.testing.assert_array_equal(
        _bits(got["rows_norm"]), _bits(j.device_view(list(range(1500)))["rows_norm"])
    )


def test_int8_pure_has_no_split_planes(monkeypatch):
    _set(monkeypatch, plane_rows=512)
    s = TorchStore(np.float32, precision="int8-pure", device="cpu")
    s.set(np.ones((1500, 16), dtype=np.float32))
    with pytest.raises(KeyError):
        s.device_view(range(1500))["rows_norm_planes"]


# --------------------------------------------------------------------------
# the route (tests/test_ranking.py::TestRankTopKPlanar)
# --------------------------------------------------------------------------


def _split(v, cuts):
    bounds = [0, *cuts, v.shape[0]]
    return [v[a:b] for a, b in zip(bounds, bounds[1:])]


def _both_planar(q, v, cuts, k, **kw):
    """(port, JAX) rank_top_k_planar over the same planes, each as (ids,
    values); ``row_masks`` and ``recencies`` are split alike."""
    kw_t, kw_j = {}, {}
    for name in ("row_masks", "recencies"):
        if name in kw:
            parts = _split(kw.pop(name), cuts)
            kw_t[name] = [torch.from_numpy(p) for p in parts]
            kw_j[name] = [jnp.asarray(p) for p in parts]
    tv, ti = TR.rank_top_k_planar(
        torch.from_numpy(q), [torch.from_numpy(p) for p in _split(v, cuts)], k, **kw, **kw_t
    )
    jv, ji = JR.rank_top_k_planar(
        jnp.asarray(q), [jnp.asarray(p) for p in _split(v, cuts)], k, **kw, **kw_j
    )
    return (ti, tv), (ji, jv)


def _one_plane(q, v, k, row_mask=None, recency=None, **kw):
    """The port's router over the whole corpus, as (ids, values)."""
    vals, ids = TR.rank_top_k(
        torch.from_numpy(q), torch.from_numpy(v), k,
        row_mask=None if row_mask is None else torch.from_numpy(row_mask),
        recency=None if recency is None else torch.from_numpy(recency), **kw,
    )
    return ids, vals


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_route_matches_one_plane_all_metrics(metric):
    rng = np.random.default_rng(21)
    v = rng.standard_normal((96, 16)).astype(np.float32)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    if metric in ("jaccard_similarity", "hamming_distance"):
        v, q = (v > 0).astype(np.float32), (q > 0).astype(np.float32)
    got, want = _both_planar(q, v, [32, 64], 7, metric=metric)
    one = _one_plane(q, v, 7, metric=metric)
    _same(got, one, rtol=1e-5, atol=1e-6)
    _same(got, want)


def test_route_uneven_planes_masks_and_recency():
    rng = np.random.default_rng(22)
    v = rng.standard_normal((80, 8)).astype(np.float32)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    mask = rng.random(80) > 0.3
    mask[:2] = True
    rec = TR.recency_scores(rng.random(80), 1.5)
    cuts = [16, 57]  # 16 / 41 / 23 rows
    got, want = _both_planar(q, v, cuts, 6, metric="dot_product", row_masks=mask,
                             recencies=rec)
    one = _one_plane(q, v, 6, metric="dot_product", row_mask=mask, recency=rec)
    _same(got, one, rtol=1e-5, atol=1e-6)
    _same(got, want)
    assert mask[got[0].numpy()].all()


def test_route_cross_plane_tie_prefers_lower_global_index():
    v = np.zeros((16, 4), dtype=np.float32)
    v[3] = v[10] = [1, 0, 0, 0]
    q = np.array([[1.0, 0, 0, 0]], dtype=np.float32)
    got, want = _both_planar(q, v, [8], 3, metric="dot_product")
    assert got[0][0, :2].tolist() == [3, 10]
    _same(got, want)
    # the first row of the second plane against the last of the first
    v[3], v[10], v[7], v[8] = 0.0, 0.0, [1, 0, 0, 0], [1, 0, 0, 0]
    got, _ = _both_planar(q, v, [8], 2, metric="dot_product")
    assert got[0][0].tolist() == [7, 8]


def test_route_k_exceeding_plane_rows_clamps():
    rng = np.random.default_rng(23)
    v = rng.standard_normal((10, 4)).astype(np.float32)
    q = rng.standard_normal((2, 4)).astype(np.float32)
    got, want = _both_planar(q, v, [3, 6], 8, metric="dot_product")  # 3 / 3 / 4 rows
    _same(got, _one_plane(q, v, 8, metric="dot_product"), rtol=1e-5, atol=1e-6)
    _same(got, want)
    got, _ = _both_planar(q, v, [3, 6], 20, metric="dot_product")
    assert got[0].shape == (2, 10)  # k clamps to the corpus


def test_route_single_plane_passthrough(monkeypatch):
    rng = np.random.default_rng(24)
    v = rng.standard_normal((32, 8)).astype(np.float32)
    q = rng.standard_normal((2, 8)).astype(np.float32)
    merges = []
    real = TR._merge_plane_topk
    monkeypatch.setattr(TR, "_merge_plane_topk", lambda *a: merges.append(1) or real(*a))
    got, want = _both_planar(q, v, [], 4)
    one = _one_plane(q, v, 4)
    assert merges == []
    _same(got, one, 0, 0)
    _same(got, want)
    with pytest.raises(ValueError):
        TR.rank_top_k_planar(torch.from_numpy(q), [], 4)


def test_ops_package_exports_the_route():
    from hyperdb_tpu_torch.ops import rank_top_k_planar

    assert rank_top_k_planar is TR.rank_top_k_planar


def test_no_survivor_index_pass_without_recency(dbs, corpus, device_route, monkeypatch):
    """As in the JAX engine, the surviving documents' index array is made
    only for recency (at 2^24 documents it and a survivor sum took 67 ms of
    a 98 ms cosine batch of 512 on an H100's host)."""
    _, tdb = dbs
    _, _, qs = corpus
    passes = []
    real = np.flatnonzero
    monkeypatch.setattr(np, "flatnonzero", lambda a: passes.append(a.shape) or real(a))
    tdb.query_batch_arrays(qs, top_k=5)
    tdb.query(qs[0], top_k=5, metric="dot_product")
    assert passes == []
    tdb.query_batch_arrays(qs, top_k=5, recency_bias=1.0, timestamp_key="ts")
    assert passes == [(N_ROWS,)]
