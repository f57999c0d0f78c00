"""Faults of the port against the JAX package, each pinned against both.

1. ``HyperDB.commit_pending`` rolls back as the reference does: a failure
   prints "Error occurred during commit: ... Rolling back transaction." and
   returns with the state unchanged and the staged buffers kept.
2. ``HyperDB`` has the reference's helper methods (``validate_keys``,
   ``collect_document_keys``, ``get_nested_value``, ``_filter_by_metadata``,
   ``_apply_filters``, ``_generate_and_validate_query_vector``,
   ``_handle_timestamps``, ``_execute_query``, ``_cached_query``).
3. The package exports what the JAX package exports (``METRICS``,
   ``rank_top_k``, ``ranking_algorithm_sort``, ``recency_scores``,
   ``scores``).
4. The plain euclidean route keeps a self-match at 1.0: the expanded form
   runs in float64 (it lost 2.8e-3 to f32 cancellation).
5. ``HyperDB.vectors`` has the JAX setter (over ``VectorStore.set``; the
   LRU cache and the index stay as they are), in both classes.
6. ``load`` wraps a failed index restore in JAX's ``RuntimeError`` text.
7. A failed preload prints JAX's ``INFO:`` line and stays lazy.
8. ``ops.metrics.normalize`` takes ``axis``; ``native.server.available()``
   is a bool and never raises; ``__version__`` is the JAX package's.

Tolerances: ranking scores over f32 inputs, 1e-6 absolute (the same f32
products summed in another order); the euclidean self-match within 1e-4 of
the JAX package's, as ``tests/test_host_path.py`` holds JAX's two paths;
``normalize`` within 1e-6 (the CPU norms differ in the last f32 ulp).
"""

import copy
import tomllib
from pathlib import Path

import numpy as np
import pytest

import hyperdb
import hyperdb_torch
import hyperdb_tpu
import hyperdb_tpu_torch
from hyperdb_tpu import HyperDB as JaxDB
from hyperdb_tpu.config import CONFIG as JAX_CONFIG
from hyperdb_tpu_torch import HyperDB as TorchDB
from hyperdb_tpu_torch.config import CONFIG as TORCH_CONFIG

PACKAGES = ("jax", "torch")


def _db(pkg, **kw):
    return JaxDB(**kw) if pkg == "jax" else TorchDB(device="cpu", **kw)


# ---------------------------------------------------------------- 1. commit


@pytest.mark.parametrize("pkg", PACKAGES)
def test_commit_mixed_dimensions_soft_rolls_back(pkg, capsys):
    rng = np.random.default_rng(2)
    db = _db(pkg)
    db.add_document({"i": 0}, vectors=rng.standard_normal((1, 8)).astype(np.float32))
    db.add_document({"i": 1}, vectors=rng.standard_normal((1, 16)).astype(np.float32))
    db.commit_pending()  # prints and rolls back, never raises
    assert "Error occurred during commit" in capsys.readouterr().out
    assert len(db.documents) == 0 and len(db.pending_documents) == 2


@pytest.mark.parametrize("pkg", PACKAGES)
def test_commit_pending_metadata_failure_rolls_back_cleanly(pkg, capsys):
    db = _db(pkg, metadata_keys=["info.type"])

    class Boom(dict):
        def __contains__(self, key):  # the metadata probe of literal keys
            raise RuntimeError("boom")

    db.pending_documents.append(Boom({"name": "x", "info": {"type": "t"}}))
    db.pending_vectors.append(np.ones((1, 4), dtype=np.float32))
    db.pending_source_indices.append(0)
    db._pending_splits.append((1, False))
    db.commit_pending()
    assert "Rolling back transaction" in capsys.readouterr().out
    assert db.documents == [] and db.source_indices == [] and db._metadata_index == {}
    assert db.vectors is None or db.vectors.shape[0] == 0
    # the stage is intact, and a repaired commit applies exactly once
    db.pending_documents[0] = {"name": "x", "info": {"type": "t"}}
    db.commit_pending()
    assert len(db.documents) == 1 and db.vectors.shape[0] == 1
    assert db._metadata_index == {0: {"info.type": "t"}}


@pytest.mark.parametrize("form", ["dict", "list"])
def test_add_of_another_dimension_prints_and_keeps_the_stage(form, capsys):
    """``add`` of a 16-d row to an 8-d DB: both packages print the commit's
    rollback and keep one staged document; the DB is unchanged."""
    rng = np.random.default_rng(3)
    v = rng.standard_normal((4, 8)).astype(np.float32)
    seen = {}
    for pkg in PACKAGES:
        db = _db(pkg, documents=[{"i": i} for i in range(4)], vectors=v)
        doc = {"i": 4}
        db.add(doc if form == "dict" else [doc], vectors=np.ones((1, 16), np.float32))
        out = capsys.readouterr().out
        assert "Error occurred during commit" in out and "Rolling back transaction" in out
        seen[pkg] = (len(db.documents), len(db.pending_documents), db.vectors.shape)
        assert len(db.query(v[1], top_k=2)) == 2
    assert seen["torch"] == seen["jax"] == (4, 1, (4, 8))


# ---------------------------------------------------------------- 2. helpers


def _helper_dbs():
    docs = [
        {"name": "Abra", "hp": 160, "info": {"type": "psychic",
         "description": "Sleeps 18 hours a day."}},
        {"name": "Arcanine", "hp": 290, "info": {"type": "fire",
         "description": "A legendary creature with a grand mane."}},
        {"name": "Arbok", "hp": 230, "info": {"type": "poison",
         "description": "Ferocious warning markings on its belly."}},
    ]
    vectors = np.stack([np.full(8, k, dtype=np.float32) for k in (1, 2, 3)])
    return {
        pkg: _db(pkg, documents=copy.deepcopy(docs), vectors=vectors, metadata_keys=["info.type"])
        for pkg in PACKAGES
    }


def test_filter_by_metadata_helper():
    for pkg, db in _helper_dbs().items():
        vecs, docs = db._filter_by_metadata({"info.type": "fire"}, db.vectors, db.documents)
        assert [d["name"] for d in docs] == ["Arcanine"] and vecs.shape == (1, 8), pkg
        with pytest.raises(ValueError):
            db._filter_by_metadata({"bogus": 1}, db.vectors, db.documents)


def test_apply_filters_helper():
    got = {}
    for pkg, db in _helper_dbs().items():
        vecs, docs = db._apply_filters(
            [("metadata", {"info.type": "psychic"}), ("sentence", ["sleeps"])]
        )
        got[pkg] = ([d["name"] for d in docs], [np.asarray(v).tolist() for v in vecs])
        with pytest.raises(ValueError):
            db._apply_filters([("nope", 1)])
    assert got["torch"] == got["jax"] == (["Abra"], [[1.0] * 8])


def test_handle_timestamps_helper():
    got = {}
    for pkg, db in _helper_dbs().items():
        db.metadata_keys.append("hp")
        rec = db._handle_timestamps(1.0, "hp", db.documents)
        assert rec.shape == (3,) and rec[1] == pytest.approx(1.0)
        assert db._handle_timestamps(0, "hp", db.documents) is None
        with pytest.raises(ValueError):
            db._handle_timestamps(1.0, "not_declared", db.documents)
        # an equal but distinct copy is found by equality
        got[pkg] = db._handle_timestamps(2.0, "hp", [copy.deepcopy(db.documents[2])])
    np.testing.assert_array_equal(got["torch"], got["jax"])


def test_key_and_nested_helpers():
    keys = {}
    for pkg, db in _helper_dbs().items():
        assert db.get_nested_value(db.documents[1], ["info.type"]) == "fire", pkg
        keys[pkg] = db.collect_document_keys(db.documents)
        db.validate_keys(["info.type"], db.metadata_keys, "a", "b")
        with pytest.raises(ValueError):
            db.validate_keys(["nope"], db.metadata_keys, "a", "b")
    assert keys["torch"] == keys["jax"] and "info.type" in keys["torch"]


def test_vector_shape():
    for pkg in PACKAGES:
        db = _db(pkg, documents=[{"name": n} for n in ("Abra", "Arbok")],
                 vectors=np.stack([np.full(384, k, np.float32) for k in (1, 2)]))
        qv = db._generate_and_validate_query_vector("Abra")
        assert qv.ndim == 1 and qv.shape[0] == db.vectors.shape[1], pkg


def test_index_mapping_for_chunked_document():
    for pkg in PACKAGES:
        db = _db(pkg)
        db.add({"text": "word " * 100})
        db.add({"text": "word " * 505 + " uniqueword " + "word " * 100})
        db.add({"text": "word " * 200})
        results = db._execute_query(
            "uniqueword", top_k=1, filters=[("sentence", "uniqueword")],
            return_similarities=True,
        )
        assert results, pkg
        _, _, returned_index = results[0]
        assert db.source_indices[returned_index] == 1


def test_cached_query_helper():
    rng = np.random.default_rng(4)
    v = rng.standard_normal((20, 8)).astype(np.float32)
    answers = {}
    for pkg in PACKAGES:
        db = _db(pkg, documents=[{"i": i} for i in range(20)], vectors=v)
        args = (v[3], 4, True, None, 0, None, "cosine_similarity", 5)
        key = db._hashable_key(*args)
        first = db._cached_query(key, args)
        again = db._cached_query(key, args)
        assert again is first and (db.cache_hits, db.cache_misses) == (1, 1), pkg
        # without args the key is executed as the call (a list query)
        lkey = db._hashable_key(v[5].tolist(), *args[1:])
        answers[pkg] = ([r[2] for r in first], [r[2] for r in db._cached_query(lkey)])
    assert answers["torch"] == answers["jax"]
    assert answers["torch"][0][0] == 3 and answers["torch"][1][0] == 5


# ---------------------------------------------------------------- 3. exports


def test_package_exports_match():
    assert set(hyperdb_tpu_torch.__all__) == set(hyperdb_tpu.__all__)
    for name in ("METRICS", "rank_top_k", "ranking_algorithm_sort", "recency_scores", "scores"):
        assert hasattr(hyperdb_tpu_torch, name), name
    assert tuple(hyperdb_tpu_torch.METRICS) == tuple(hyperdb_tpu.METRICS)


def _sort_both(*args, **kw):
    j = hyperdb_tpu.ranking_algorithm_sort(*args, **kw)
    t = hyperdb_tpu_torch.ranking_algorithm_sort(*args, device="cpu", **kw)
    return [np.asarray(x) for x in j], [np.asarray(x) for x in t]


@pytest.mark.parametrize(
    "metric, recency_bias, expected_indices",
    [
        ("cosine_similarity", 0, [0, 2, 1]),
        ("cosine_similarity", 1, [2, 0, 1]),
        ("euclidean_metric", 0, [0, 2, 1]),
        ("manhattan_distance", 0, [0, 2, 1]),
        ("jaccard_similarity", 0, [0, 2, 1]),
        ("pearson_correlation", 0, [0, 1, 2]),
        ("hamming_distance", 0, [0, 2, 1]),
    ],
)
def test_ranking_algorithm_sort_orderings(metric, recency_bias, expected_indices):
    v = np.array([[1, 0], [0, 1], [0.5, 0.5]])
    timestamps = [1627825200.0, 1627911600.0, 1627998000.0]
    (ji, jv), (ti, tv) = _sort_both(
        v, np.array([1, 0]), metric=metric, timestamps=timestamps, recency_bias=recency_bias
    )
    assert list(ti) == list(ji) == expected_indices
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)


def test_ranking_algorithm_sort_contract(capsys):
    v2 = np.array([[1, 0], [0, 1]])
    for fn, kw in ((hyperdb_tpu.ranking_algorithm_sort, {}),
                   (hyperdb_tpu_torch.ranking_algorithm_sort, {"device": "cpu"})):
        with pytest.raises(ValueError):
            fn(v2, np.array([1, 0]), metric="unknown_metric", **kw)
        with pytest.raises(ValueError):
            fn(np.array([1, 0]), np.array([1, 0]), metric="euclidean_metric", **kw)
        with pytest.raises(ValueError):
            fn(np.array([[1, 0], [np.nan, 0]]), np.array([1, 0]), **kw)
        idx, vals = fn(np.eye(3), np.array([1.0, 0, 0]), top_k=10, **kw)
        assert len(idx) == 3 and len(vals) == 3
        idx, vals = fn(np.array([[1.0, 0.0]]), np.array([1.0, 0.0]), top_k=5, **kw)
        assert list(idx) == [0] and np.asarray(vals).shape == (1, 1)
        np.testing.assert_allclose(vals, [[1.0]], atol=1e-6)
        assert "Info: Only one document left." in capsys.readouterr().out
    # pearson: a constant row scores NaN -> -inf, last
    (ji, jv), (ti, tv) = _sort_both(
        np.array([[1.0, 1.0], [0.0, 1.0], [2.0, 1.0]]), np.array([0.0, 1.0]),
        top_k=3, metric="pearson_correlation",
    )
    assert list(ti) == list(ji) and ti[-1] == 0 and tv[-1] == -np.inf
    # the compat surface's example
    (ji, _), (ti, _) = _sort_both(np.array([[1.0, 0.0], [0.0, 1.0], [0.5, 0.5]]),
                                  np.array([1.0, 0.0]), top_k=2)
    assert list(ti) == list(ji) == [0, 2]


def test_ranking_algorithm_sort_matches_rank_top_k():
    rng = np.random.default_rng(7)
    v = rng.normal(size=(64, 16)).astype(np.float32)
    q = rng.normal(size=(4, 16)).astype(np.float32)
    for b in range(4):
        (ji, jv), (ti, tv) = _sort_both(v, q[b], top_k=5)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)


def test_recency_scores():
    for t in (np.array([0.0, 0.0, 5.0]), np.random.default_rng(22).random(80), np.zeros(0)):
        got = hyperdb_tpu_torch.recency_scores(t, 1.5)
        want = hyperdb_tpu.recency_scores(t, 1.5)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    rec = hyperdb_tpu_torch.recency_scores(np.array([0.0, 0.0, 5.0]), 2.0)
    import torch

    _, idx = hyperdb_tpu_torch.rank_top_k(
        torch.tensor([[1.0, 0.0, 0.0]]), torch.eye(3), k=3, recency=torch.from_numpy(rec)
    )
    assert int(idx[0][0]) == 2  # +2.0 of recency beats a cosine of 1


# ---------------------------------------------------------------- 4. euclidean


@pytest.mark.parametrize("fp", ["float32", "float16"])
def test_euclidean_self_match(monkeypatch, fp):
    """The input of the fault: 300 x 24 standard normal rows, query row 17,
    top_k 7, host path off. On the float32 DB JAX scores row 17 at 1.0 and
    the port's device route gave 0.99724555; it must now agree within 1e-4.
    On the float16 DB (bf16 plane, f32 query) the exact score is the
    difference form over the plane's rows: the port must give it within
    1e-6, where JAX's f32 expansion is 2.7e-4 off it (0.99300718)."""
    import torch

    monkeypatch.setattr(JAX_CONFIG, "host_path_max_cells", 0)
    monkeypatch.setattr(TORCH_CONFIG, "host_path_max_cells", 0)
    rng = np.random.default_rng(0)
    v = rng.standard_normal((300, 24)).astype(np.float32)
    docs = [{"i": int(i)} for i in range(300)]
    got = {}
    for pkg in PACKAGES:
        db = _db(pkg, documents=docs, vectors=v, fp_precision=fp)
        got[pkg] = db.query(v[17], top_k=7, metric="euclidean_metric")
    ids = [r[2] for r in got["torch"]]
    assert ids == [r[2] for r in got["jax"]] and ids[0] == 17
    scores = np.array([r[1] for r in got["torch"]])
    if fp == "float32":
        assert abs(scores[0] - got["jax"][0][1]) <= 1e-4
        assert scores[0] == pytest.approx(1.0, abs=1e-6)
        np.testing.assert_allclose(scores, [r[1] for r in got["jax"]], rtol=1e-5, atol=1e-6)
    else:
        plane = torch.from_numpy(v.astype(np.float16)).float().bfloat16().double()
        q = torch.from_numpy(v[17]).double()
        exact = 1.0 / (1.0 + torch.sqrt(((plane[ids] - q) ** 2).sum(-1)))
        np.testing.assert_allclose(scores, exact.numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------- 5. vectors setter


def _fifty_rows(seed=0):
    """The faults' input: 50 x 8 standard normal float32 rows, one dict
    document each."""
    v = np.random.default_rng(seed).standard_normal((50, 8)).astype(np.float32)
    return [{"i": i} for i in range(50)], v


SETTER_CLASSES = {
    "hyperdb_tpu_torch": (JaxDB, TorchDB),
    "hyperdb_torch": (hyperdb.HyperDB, hyperdb_torch.HyperDB),
}


def _pair(name, docs, v):
    jax_cls, torch_cls = SETTER_CLASSES[name]
    return jax_cls(documents=docs, vectors=v), torch_cls(documents=docs, vectors=v, device="cpu")


@pytest.mark.parametrize("cls", sorted(SETTER_CLASSES))
def test_vectors_setter_takes_the_rows(cls):
    docs, v = _fifty_rows()
    j, t = _pair(cls, docs, v)
    new = v[:10] * 2
    j.vectors = new
    t.vectors = new
    assert t.vectors.shape == j.vectors.shape == (10, 8)
    assert t.vectors.dtype == j.vectors.dtype == np.float32
    np.testing.assert_array_equal(t.vectors, j.vectors)
    t.vectors = None
    j.vectors = None
    assert t.vectors is None and j.vectors is None


@pytest.mark.parametrize("cls", sorted(SETTER_CLASSES))
def test_query_after_vectors_setter_matches_jax(cls):
    """A corpus of the same shape assigned through the setter: a fresh
    batch ranks the new rows as JAX does, and a repeated single query
    returns what the LRU cache held before the assignment (the JAX setter
    clears neither the cache nor the index)."""
    docs, v = _fifty_rows()
    _, v2 = _fifty_rows(seed=1)
    j, t = _pair(cls, docs, v)
    before = {"jax": j.query(v[3], top_k=3), "torch": t.query(v[3], top_k=3)}
    index = t.ann_index
    j.vectors = v2
    t.vectors = v2
    assert t.ann_index is index
    ji, jv = j.query_batch_arrays(v2[:4], top_k=3)
    ti, tv = t.query_batch_arrays(v2[:4], top_k=3)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
    assert list(ti[:, 0]) == [0, 1, 2, 3]
    assert t.query(v[3], top_k=3) == before["torch"]
    assert j.query(v[3], top_k=3) == before["jax"]
    assert [r[2] for r in before["torch"]] == [r[2] for r in before["jax"]]


# ---------------------------------------------------------------- 6-7. load


def _saved(pkg, tmp_path):
    docs, v = _fifty_rows()
    path = tmp_path / f"{pkg}.pickle"
    _db(pkg, documents=docs, vectors=v).save(str(path))
    return path, v


def test_bogus_index_sidecar_raises_jax_runtime_error(tmp_path):
    """An npz sidecar that is not an index: JAX raises ``RuntimeError:
    An exception occurred during ANN index load: 'metric'`` (the port gave
    a bare ``KeyError``)."""
    raised = {}
    for pkg in PACKAGES:
        path, _ = _saved(pkg, tmp_path)
        with open(f"{path}.ann", "wb") as f:
            np.savez(f, kind="bogus")
        with pytest.raises(Exception) as err:
            _db(pkg).load(str(path))
        raised[pkg] = (type(err.value), str(err.value))
    assert raised["torch"] == raised["jax"] == (
        RuntimeError, "An exception occurred during ANN index load: 'metric'"
    )


def test_failed_preload_stays_lazy(tmp_path, monkeypatch, capsys):
    """``load(..., preload_ann_into_memory=True)`` with the store's
    ``device_view`` failing as a card out of memory would: both packages
    print the ``INFO:`` line and return; the next batch builds the view
    and answers JAX's ids."""

    def out_of_memory(*args, **kw):
        raise RuntimeError("simulated out of device memory")

    seen = {}
    for pkg in PACKAGES:
        path, v = _saved(pkg, tmp_path)
        db = _db(pkg)
        with monkeypatch.context() as m:
            m.setattr(db._store, "device_view", out_of_memory)
            db.load(str(path), preload_ann_into_memory=True)
        printed = capsys.readouterr().out
        ids, _ = db.query_batch_arrays(v[:2], top_k=3)
        seen[pkg] = (printed, ids.tolist())
    assert seen["torch"] == seen["jax"] == (
        "INFO: preload_ann_into_memory failed, staying lazy: simulated out of device memory\n",
        [[0, 44, 4], [1, 35, 13]],
    )


# ---------------------------------------------------------------- 8. names


def test_normalize_takes_axis():
    import torch

    from hyperdb_tpu.ops import metrics as JM
    from hyperdb_tpu_torch.ops import metrics as TM

    x = np.random.default_rng(3).standard_normal((6, 5)).astype(np.float32)
    x[:, 2] = 0.0  # a zero column: its norm is treated as 1
    for axis in (0, 1, -1):
        got = TM.normalize(torch.from_numpy(x), axis=axis).numpy()
        want = np.asarray(JM.normalize(x, axis=axis))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=str(axis))
    assert (TM.normalize(torch.from_numpy(x), axis=0)[:, 2] == 0).all()


def test_native_server_available_is_a_bool():
    from hyperdb_tpu_torch.native import server as S

    assert S.available() in (True, False)


def test_native_server_available_without_a_library(monkeypatch):
    """A build that fails (no compiler, a compiler error): ``available()``
    is False, never a raise."""
    from hyperdb_tpu_torch.native import server as S
    from hyperdb_tpu_torch.native import tokenizer as NT

    def no_compiler():
        raise RuntimeError("no C++ compiler ('g++' not on PATH)")

    monkeypatch.setattr(NT, "_LIB", None)
    monkeypatch.setattr(NT, "build", no_compiler)
    assert S.available() is False


def test_version_matches_jax_and_pyproject():
    root = Path(__file__).resolve().parents[1]
    with open(root / "pyproject.toml", "rb") as f:
        version = tomllib.load(f)["project"]["version"]
    assert hyperdb_tpu_torch.__version__ == hyperdb_tpu.__version__ == version == "0.1.0"
