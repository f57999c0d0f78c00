"""The ``hyperdb_torch`` drop-in package: the reference's import paths and
call shapes over the port, held against the JAX package's ``hyperdb``.

The first six tests are those of ``tests/test_compat.py`` and
``tests/test_migration_claims.py::test_compat_import_surface`` with
``hyperdb`` rewritten to ``hyperdb_torch`` and ``device="cpu"``. The parity
tests feed the same seeded numpy inputs (300 x 24 with a zero row, and a
0/1 matrix) to each of the ten ranking names of both packages. Tolerances
(both sides score in float32; only the summation order differs):

- ``get_norm_vector``, ``jaccard_similarity``, ``hamming_distance`` and
  ``check_and_binarize_vectors``: equal (NumPy f64, or exact integer counts
  and one IEEE division);
- ``dot_product`` 1e-5 absolute (sums of 24 products of magnitude <= 20);
  ``cosine_similarity`` and ``pearson_correlation`` 1e-6 (NaN where the
  JAX layer has NaN); ``manhattan_distance`` 1e-7 (scores ~0.05);
- ``euclidean_metric``: the port expands in float64, the JAX layer in
  float32, so scores agree within 1e-7 and distances within 1e-6
  relative; the port's distances lie within 2e-7 relative of NumPy's f64
  difference form;
- ``hyperDB_ranking_algorithm_sort``: ids equal over the Gaussian matrix
  for all seven metrics and over the 0/1 matrix for jaccard and hamming;
  tie-aware (scores within the metric's tolerance) where a 0/1 matrix
  gives exact ties that the two float32 roundings order differently.
"""

import numpy as np
import pytest

import hyperdb
import hyperdb.ranking_algorithm as JR
import hyperdb_torch
import hyperdb_torch.ranking_algorithm as TR
import hyperdb_tpu
import hyperdb_tpu_torch

SEEDS = (0, 1, 2)
SCORE_ATOL = {
    "dot_product": 1e-5,
    "cosine_similarity": 1e-6,
    "euclidean_metric": 1e-7,
    "manhattan_distance": 1e-7,
    "jaccard_similarity": 0.0,
    "pearson_correlation": 1e-6,
    "hamming_distance": 0.0,
}
EXACT_BINARY = ("jaccard_similarity", "hamming_distance")


def test_reference_import_path():
    from hyperdb_torch import HyperDB

    db = HyperDB(documents=[{"a": "x"}, {"a": "y"}],
                 vectors=np.eye(2, dtype=np.float32), device="cpu")
    assert len(db.query(np.array([1.0, 0.0]), top_k=1)) == 1


def test_ranking_module_surface():
    from hyperdb_torch.ranking_algorithm import (
        cosine_similarity,
        dot_product,
        euclidean_metric,
        get_norm_vector,
        hamming_distance,
        hyperDB_ranking_algorithm_sort,
        jaccard_similarity,
        manhattan_distance,
        pearson_correlation,
    )

    v = np.array([[1.0, 0.0], [0.0, 1.0], [0.5, 0.5]])
    q = np.array([1.0, 0.0])
    cpu = {"device": "cpu"}

    np.testing.assert_allclose(cosine_similarity(v, q, **cpu)[:2], [1.0, 0.0], atol=1e-6)
    assert dot_product(v, q, **cpu).shape == (3,)
    assert euclidean_metric(v, q, **cpu).shape == (3,)
    dist = euclidean_metric(v, q, get_similarity_score=False, **cpu)
    np.testing.assert_allclose(dist, np.linalg.norm(v - q, axis=1), atol=1e-5)
    assert manhattan_distance(v, q, **cpu).shape == (3,)
    np.testing.assert_array_equal(jaccard_similarity(v, q, **cpu), [1.0, 0.0, 0.5])
    assert pearson_correlation(v, q, **cpu).shape == (3,)
    assert hamming_distance(v, q, **cpu).shape == (3,)
    assert get_norm_vector(np.array([[0.0, 0.0], [3.0, 4.0]]))[1, 1] == pytest.approx(0.8)

    idx, scores = hyperDB_ranking_algorithm_sort(v, q, top_k=2, **cpu)
    assert list(idx) == [0, 2]


def test_binarize_is_pure():
    from hyperdb_torch.ranking_algorithm import check_and_binarize_vectors

    v = np.array([[2.0, -1.0]])
    out = check_and_binarize_vectors(v)
    np.testing.assert_array_equal(out, [[1.0, 0.0]])
    np.testing.assert_array_equal(v, [[2.0, -1.0]])  # input untouched


def test_compat_module_level_surface():
    """The reference's module path and constants, and the package-level
    re-exports, as ``hyperdb`` has them."""
    import hyperdb_torch.hyperdb as mod

    assert mod.MAX_LENGTH == 510
    assert mod.NESTED_PATTERN.split("a.b[0].c") == ["a", "b", "0", "", "c"]
    assert mod.EMBEDDING_MODEL is None and mod.tokenizer is None
    # the ranking module alias
    assert mod.ranking is TR
    assert hasattr(mod.ranking, "hyperDB_ranking_algorithm_sort")
    # package-level re-exports match
    assert hyperdb_torch.MAX_LENGTH == 510
    assert hyperdb_torch.HyperDB is mod.HyperDB
    assert issubclass(mod.HyperDB, hyperdb_tpu_torch.HyperDB)


def test_compat_constructor_metadata_quirk():
    """Bug-for-bug reference parity: the compat class leaves the metadata
    index EMPTY on the precomputed-vectors constructor branch, so a
    metadata filter returns nothing; ``hyperdb_tpu_torch.HyperDB`` keeps
    the fix."""
    docs = [{"name": "a", "info": {"type": "psychic"}},
            {"name": "b", "info": {"type": "fire"}}]
    vecs = np.eye(2, dtype=np.float32)

    compat = hyperdb_torch.HyperDB(documents=[dict(d) for d in docs], vectors=vecs,
                                   metadata_keys=["info.type"], device="cpu")
    assert compat._metadata_index == {}
    out = compat.query(np.array([1.0, 0.0]),
                       filters=[("metadata", {"info.type": "psychic"})])
    assert out == []  # vacuous-empty, exactly like the reference

    fixed = hyperdb_tpu_torch.HyperDB(documents=[dict(d) for d in docs], vectors=vecs,
                                      metadata_keys=["info.type"], device="cpu")
    assert fixed._metadata_index == {0: {"info.type": "psychic"},
                                     1: {"info.type": "fire"}}
    out = fixed.query(np.array([1.0, 0.0]),
                      filters=[("metadata", {"info.type": "psychic"})])
    assert len(out) == 1 and out[0][0]["info"]["type"] == "psychic"

    # the add() path stores metadata in both
    compat.add({"name": "c", "info": {"type": "water"}},
               vectors=np.array([[0.5, 0.5]], dtype=np.float32))
    assert compat._metadata_index.get(2) == {"info.type": "water"}


def test_compat_import_surface():
    # docs/MIGRATION.md, "Imports": reference code keeps working
    from hyperdb_torch import EMBEDDING_MODEL, MAX_LENGTH, HyperDB  # noqa: F401
    from hyperdb_torch.ranking_algorithm import (  # noqa: F401
        cosine_similarity,
        euclidean_metric,
        hyperDB_ranking_algorithm_sort,
    )

    assert MAX_LENGTH == 510
    db = HyperDB([{"t": "hello world"}], device="cpu")
    # reference methods live on the instance
    assert callable(db.text_to_chunks)
    assert callable(db.get_embedding)


def test_public_names_equal_the_jax_packages():
    def public(mod):
        return sorted(n for n in dir(mod) if not n.startswith("_"))

    assert public(hyperdb_torch) == public(hyperdb)
    assert hyperdb_torch.hyperdb.__all__ == hyperdb.hyperdb.__all__
    fns = [n for n in public(JR) if callable(getattr(JR, n)) and getattr(JR, n).__module__ == JR.__name__]
    assert len(fns) == 10
    assert fns == [n for n in public(TR) if callable(getattr(TR, n))
                   and getattr(TR, n).__module__ == TR.__name__]


# ---------------------------------------------------------------- parity


def _inputs(seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((300, 24))
    v[7] = 0.0  # a zero row: cosine's unit norm, pearson's NaN
    q = rng.standard_normal(24)
    vb = (rng.random((300, 24)) < 0.4).astype(np.float64)
    vb[11] = 0.0  # an empty row
    qb = (rng.random(24) < 0.4).astype(np.float64)
    return v, q, vb, qb


def _close(got, want, atol):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if atol == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(SCORE_ATOL))
def test_scoring_functions_match_jax(seed, name):
    v, q, vb, qb = _inputs(seed)
    for vv, qq in ((v, q), (vb, qb)):
        want = getattr(JR, name)(vv, qq)
        got = getattr(TR, name)(vv, qq, device="cpu")
        _close(got, want, SCORE_ATOL[name])
        # the inputs are left as they were
        np.testing.assert_array_equal(vv, _inputs(seed)[0 if vv is v else 2])


@pytest.mark.parametrize("seed", SEEDS)
def test_euclidean_distance_form_matches_jax(seed):
    v, q, _, _ = _inputs(seed)
    want = JR.euclidean_metric(v, q, get_similarity_score=False)
    got = TR.euclidean_metric(v, q, get_similarity_score=False, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, np.linalg.norm(v - q, axis=1), rtol=2e-7)
    for bad in (v[0], v[None]):
        with pytest.raises(ValueError, match="2D"):
            TR.euclidean_metric(bad, q, device="cpu")
        with pytest.raises(ValueError, match="2D"):
            JR.euclidean_metric(bad, q)


@pytest.mark.parametrize("seed", SEEDS)
def test_get_norm_vector_matches_jax(seed, capsys):
    v, _, vb, _ = _inputs(seed)
    for x in (v, vb):
        np.testing.assert_array_equal(TR.get_norm_vector(x), JR.get_norm_vector(x))
    nan = v.copy()
    nan[3, 5] = np.nan
    capsys.readouterr()
    want = JR.get_norm_vector(nan)
    want_out = capsys.readouterr().out
    got = TR.get_norm_vector(nan)
    assert capsys.readouterr().out == want_out
    assert want_out.startswith("Warning: Vectors at indices (array([3]), array([5])) contain NaN")
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


@pytest.mark.parametrize("seed", SEEDS)
def test_binarizer_matches_jax(seed):
    v, _, vb, _ = _inputs(seed)
    for x in (v, vb, v.astype(np.float32)):
        got, want = TR.check_and_binarize_vectors(x), JR.check_and_binarize_vectors(x)
        assert got.dtype == want.dtype == x.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("metric", sorted(SCORE_ATOL))
def test_sort_matches_jax(seed, metric):
    v, q, vb, qb = _inputs(seed)
    ts = np.random.default_rng(seed + 10).random(300)
    for vv, qq, exact_ids in ((v, q, True), (vb, qb, metric in EXACT_BINARY)):
        for kw in ({}, {"timestamps": ts, "recency_bias": 0.05}):
            want_ids, want_vals = JR.hyperDB_ranking_algorithm_sort(vv, qq, top_k=10, metric=metric, **kw)
            got_ids, got_vals = TR.hyperDB_ranking_algorithm_sort(
                vv, qq, top_k=10, metric=metric, device="cpu", **kw
            )
            want_ids, want_vals = np.asarray(want_ids), np.asarray(want_vals)
            _close(np.asarray(got_vals), want_vals, max(SCORE_ATOL[metric], 1e-7))
            if exact_ids:
                np.testing.assert_array_equal(got_ids, want_ids)
            else:  # tie-aware: a swapped id scores as the JAX id at that rank
                scores = getattr(JR, metric)(vv, qq)
                np.testing.assert_allclose(scores[got_ids], scores[want_ids], rtol=0, atol=1e-6)
                assert len(set(got_ids.tolist())) == 10


def test_sort_single_row_and_errors_match_jax(capsys):
    v = np.array([[0.3, -0.2, 0.9]])
    q = np.array([0.1, 0.4, 0.2])
    capsys.readouterr()
    want = JR.hyperDB_ranking_algorithm_sort(v, q)
    want_out = capsys.readouterr().out
    got = TR.hyperDB_ranking_algorithm_sort(v, q, device="cpu")
    assert capsys.readouterr().out == want_out == "Info: Only one document left.\n"
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]), atol=1e-6)
    for args, kw in (((np.full((2, 3), np.nan), q), {}), ((v, q), {"metric": "nope"})):
        with pytest.raises(ValueError):
            JR.hyperDB_ranking_algorithm_sort(*args, **kw)
        with pytest.raises(ValueError):
            TR.hyperDB_ranking_algorithm_sort(*args, device="cpu", **kw)


# ---------------------------------------------------------------- the classes


def _quirk_docs():
    return [{"name": "a", "info": {"type": "psychic"}},
            {"name": "b", "info": {"type": "fire"}}]


@pytest.mark.parametrize("cls,kw,indexed", [
    (hyperdb.HyperDB, {}, False),
    (hyperdb_torch.HyperDB, {"device": "cpu"}, False),
    (hyperdb_tpu.HyperDB, {}, True),
    (hyperdb_tpu_torch.HyperDB, {"device": "cpu"}, True),
], ids=["hyperdb", "hyperdb_torch", "hyperdb_tpu", "hyperdb_tpu_torch"])
def test_constructor_metadata_quirk_in_all_four_classes(cls, kw, indexed):
    """The two compat classes leave the constructor's metadata index empty;
    the two engines index both rows. The switch is a class attribute, True
    on the engines."""
    db = cls(documents=_quirk_docs(), vectors=np.eye(2, dtype=np.float32),
             metadata_keys=["info.type"], **kw)
    assert cls._index_constructor_metadata is indexed
    if indexed:
        assert db._metadata_index == {0: {"info.type": "psychic"}, 1: {"info.type": "fire"}}
    else:
        assert db._metadata_index == {}
    out = db.query(np.array([1.0, 0.0]), filters=[("metadata", {"info.type": "psychic"})])
    assert [r[0]["name"] for r in out] == (["a"] if indexed else [])


def _text_docs():
    rng = np.random.default_rng(4)
    words = "sleeps day fire cave water swims ghost night giant tiny burns".split()
    docs = [{"name": f"mon{i}", "info": {"type": ("fire", "water")[i % 2],
                                         "description": " ".join(rng.choice(words, 10))}}
            for i in range(24)]
    docs[3]["info"]["description"] = "swims " * 900  # several chunks
    return docs


def _answers(db):
    out = []
    for text in ("a fire in the cave", "swims at night"):
        out.append([(r[0]["name"], r[1], r[2]) for r in db.query(text, top_k=5)])
        out.append([(r[0]["name"], r[1], r[2]) for r in db.query(
            text, top_k=3, filters=[("metadata", {"info.type": "water"})])])
    return out


def _same_answers(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [(n, i) for n, _, i in g] == [(n, i) for n, _, i in w]
        np.testing.assert_allclose([s for _, s, _ in g], [s for _, s, _ in w], atol=1e-6)


@pytest.mark.parametrize("name", ["db.pickle.gz", "db.pkl"])
@pytest.mark.parametrize("writer", ["hyperdb", "hyperdb_torch"])
def test_compat_pickles_cross_between_packages(tmp_path, writer, name):
    """A pickle written by either package's compat class loads in the
    other's (and in the engine of the other package), with the same state
    and the same answers."""
    path = str(tmp_path / name)
    vectors = np.random.default_rng(5).standard_normal((6, 8)).astype(np.float32)
    make = {
        "hyperdb": lambda **kw: hyperdb.HyperDB(**kw),
        "hyperdb_torch": lambda **kw: hyperdb_torch.HyperDB(device="cpu", **kw),
    }
    reader = "hyperdb_torch" if writer == "hyperdb" else "hyperdb"
    # a text corpus (chunks, split info, the metadata index of add())
    src = make[writer](documents=_text_docs(), metadata_keys=["info.type"])
    src.save(path)
    dst = make[reader](metadata_keys=["info.type"])  # the file holds no keys
    dst.load(path)
    assert dst.documents == src.documents
    assert dst.source_indices == src.source_indices
    assert dst.split_info == src.split_info
    assert dst._metadata_index == src._metadata_index and src._metadata_index
    np.testing.assert_array_equal(np.asarray(dst.vectors), np.asarray(src.vectors))
    _same_answers(_answers(dst), _answers(src))
    engine = (hyperdb_tpu.HyperDB(metadata_keys=["info.type"]) if reader == "hyperdb"
              else hyperdb_tpu_torch.HyperDB(metadata_keys=["info.type"], device="cpu"))
    engine.load(path)
    _same_answers(_answers(engine), _answers(src))
    # a vectors corpus: the quirk's empty metadata index travels as it is
    src = make[writer](documents=[{"i": i, "info": {"type": "x"}} for i in range(6)],
                       vectors=vectors, metadata_keys=["info.type"])
    src.save(path)
    dst = make[reader]()
    dst.load(path)
    assert dst._metadata_index == src._metadata_index == {}
    for row in (0, 3, 5):
        got = dst.query(vectors[row], top_k=3)
        want = src.query(vectors[row], top_k=3)
        assert [r[2] for r in got] == [r[2] for r in want] and got[0][2] == row
        np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want], atol=1e-6)
