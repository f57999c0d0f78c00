"""ShardedHyperDB: ``hyperdb_tpu_torch.parallel.sharded_db`` against
``hyperdb_tpu.parallel.sharded_db`` on the CPU, one twin for each test of
``tests/test_sharded_db.py`` (same names).

Each twin runs the JAX test's steps through both packages on the same
seeded inputs (the JAX package on its 8-device CPU mesh, the port on an
8-shard ``cpu`` mesh) and holds the port's answers to the JAX package's:
document ids and documents identical, scores within ``rel 1e-5`` (f32
scans summing in other orders). The JAX test's own checks (the
single-device engine as the oracle, lifecycle invariants, errors) are kept
on the port's side. Where a step has no JAX counterpart (the port's upload
counter) the twin holds the port to its own single-device ``HyperDB``.

On the bf16 planes of a float16 master the port's sharded cosine scores
the single-device engine's operand (the unit query rounded to bf16), where
the JAX sharded path rounds the raw query and divides by its norm: there
the twins hold the port's sharded cosine to the JAX package's
SINGLE-device engine over the same DB (``rel 1e-4``: the same bf16
operands, f32 sums in other orders) and to the port's own (``rel 1e-5``).
The port's pearson plane is centred on the float16 master before its bf16
rounding (the single-device store's plane), the JAX package's on the bf16
rows: ids equal, scores within ``rel 5e-3`` (bf16 rounding).
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperdb_tpu import HyperDB as JaxDB
from hyperdb_tpu.config import CONFIG as JAX_CONFIG
from hyperdb_tpu.parallel import distributed as JD
from hyperdb_tpu.parallel import make_mesh as jax_make_mesh
from hyperdb_tpu.parallel.sharded_db import ShardedHyperDB as JaxSharded
from hyperdb_tpu_torch import HyperDB as TorchDB
from hyperdb_tpu_torch.config import CONFIG as TORCH_CONFIG
from hyperdb_tpu_torch.parallel import make_mesh
from hyperdb_tpu_torch.parallel import sharded_db as TS
from hyperdb_tpu_torch.parallel.sharded_db import ShardedHyperDB

REL, ABS = 1e-5, 1e-6


@pytest.fixture(scope="module")
def pkgs():
    assert len(jax.devices()) >= 8
    jax_pkg = SimpleNamespace(
        name="jax", DB=JaxDB, Sharded=JaxSharded, mesh=jax_make_mesh(8), config=JAX_CONFIG,
    )
    torch_pkg = SimpleNamespace(
        name="torch", DB=lambda *a, **kw: TorchDB(*a, device="cpu", **kw),
        Sharded=ShardedHyperDB, mesh=make_mesh(8, device="cpu"), config=TORCH_CONFIG,
    )
    return jax_pkg, torch_pkg


@pytest.fixture(autouse=True, scope="module")
def fresh_jax_programs():
    yield
    JD._sharded_topk_program.cache_clear()
    JD._sharded_topk_int8_program.cache_clear()


def both(pkgs, body):
    """Run ``body(pkg)`` for the JAX package, then the port; returns the
    pair of results."""
    return body(pkgs[0]), body(pkgs[1])


def same_rows(got, want, rel=REL, abs_=ABS):
    """Result rows of one package against the other's (or an oracle's)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [r[2] for r in g] == [r[2] for r in w]
        assert [r[0] for r in g] == [r[0] for r in w]
        for (_, gs, _), (_, ws, _) in zip(g, w):
            assert gs == pytest.approx(ws, rel=rel, abs=abs_)


def same_pairs(pairs, rel=REL, abs_=ABS):
    j, t = pairs
    if isinstance(j, tuple):
        for a, b in zip(t, j):
            same_pairs((b, a), rel, abs_)
        return
    same_rows(t, j, rel, abs_)


def ids(rows):
    return [[r[2] for r in row] for row in rows]


def _base_db(P):
    rng = np.random.default_rng(0)
    v = rng.standard_normal((200, 16)).astype(np.float32)
    docs = [{"i": int(i), "parity": "even" if i % 2 == 0 else "odd",
             "text": f"document number {i}"} for i in range(len(v))]
    return P.DB(documents=docs, vectors=v, metadata_keys=["parity"])


def test_matches_single_chip(pkgs):
    def body(P):
        db = _base_db(P)
        q = np.random.default_rng(1).standard_normal((4, 16)).astype(np.float32)
        got = P.Sharded(db, P.mesh).query_batch(q, top_k=5)
        same_rows(got, db.query_batch(q, top_k=5), rel=1e-4)
        return got

    same_pairs(both(pkgs, body))


def test_filters_on_sharded_path(pkgs):
    def body(P):
        sdb = P.Sharded(_base_db(P), P.mesh)
        q = np.random.default_rng(2).standard_normal((2, 16)).astype(np.float32)
        got = sdb.query_batch(q, top_k=5, filters=[("metadata", {"parity": "even"}), ("skip_doc", 10)])
        for row in got:
            assert all(doc["parity"] == "even" for doc, *_ in row)
            assert all(idx >= 10 for *_, idx in row)
        return got

    same_pairs(both(pkgs, body))


def test_chunked_dedup(pkgs):
    def body(P):
        db = P.DB()
        db.add([{"text": "word " * 700}, {"text": "other " * 100}, {"text": "word " * 600}])
        sdb = P.Sharded(db, P.mesh)
        q = np.random.default_rng(3).standard_normal((1, db.dim)).astype(np.float32)
        results = sdb.query_batch(q, top_k=3)
        got = [idx for *_, idx in results[0]]
        assert len(got) == len(set(got)) == 3  # every document once
        return results

    same_pairs(both(pkgs, body))


def test_recency_matches_single_chip(pkgs):
    def body(P):
        rng = np.random.default_rng(7)
        v = rng.standard_normal((160, 16)).astype(np.float32)
        docs = [{"i": int(i), "ts": float(i % 37), "parity": "even" if i % 2 == 0 else "odd"}
                for i in range(len(v))]
        db = P.DB(documents=docs, vectors=v, metadata_keys=["ts", "parity"])
        sdb = P.Sharded(db, P.mesh)
        q = rng.standard_normal((3, 16)).astype(np.float32)
        out = []
        for bias in (2.0, -1.5):
            got = sdb.query_batch(q, top_k=5, recency_bias=bias, timestamp_key="ts")
            want = db.query_batch(q, top_k=5, recency_bias=bias, timestamp_key="ts")
            same_rows(got, want, rel=1e-4, abs_=1e-5)
            out.append(got)
        kw = dict(top_k=4, recency_bias=1.0, timestamp_key="ts",
                  filters=[("metadata", {"parity": "odd"})])
        got = sdb.query_batch(q, **kw)
        assert ids(got) == ids(db.query_batch(q, **kw))
        return tuple(out + [got])

    same_pairs(both(pkgs, body), abs_=1e-5)


def test_recency_requires_metadata_key(pkgs):
    def body(P):
        sdb = P.Sharded(_base_db(P), P.mesh)
        with pytest.raises(ValueError):
            sdb.query_batch(np.zeros((1, 16), dtype=np.float32), top_k=2,
                            recency_bias=1.0, timestamp_key="absent")

    both(pkgs, body)


def test_many_chunks_per_doc_exact(pkgs):
    """A document with far more chunks than chunk_slack must not displace
    distinct documents: the refill loop keeps the dedup exact."""
    def body(P):
        rng = np.random.default_rng(8)
        db = P.DB()
        target = rng.standard_normal(12).astype(np.float32)
        db.add_document({"i": 0}, vectors=(target[None, :] + 0.01 * rng.standard_normal((40, 12)))
                        .astype(np.float32))
        for i in range(1, 30):
            c = int(rng.integers(1, 3))
            db.add_document({"i": int(i)}, vectors=(0.3 * target[None, :]
                                                    + rng.standard_normal((c, 12))).astype(np.float32))
        db.commit_pending()
        db._build_ann_index()
        sdb = P.Sharded(db, P.mesh, chunk_slack=2)
        got = sdb.query_batch(target[None, :], top_k=10)
        want = db.query_batch(target[None, :], top_k=10)
        assert ids(got) == ids(want) and len(set(ids(got)[0])) == 10
        same_rows(got, want, rel=1e-4)
        return got

    same_pairs(both(pkgs, body))


def test_sharded_query_uses_shared_lru(pkgs):
    def body(P):
        db = _base_db(P)
        sdb = P.Sharded(db, P.mesh)
        db.clear_cache()
        q = np.random.default_rng(9).standard_normal(16).astype(np.float32)
        r1 = sdb.query(q, top_k=3)
        assert db.cache_misses == 1 and db.cache_hits == 0
        r2 = sdb.query(q, top_k=3)
        assert db.cache_hits == 1 and ids([r1]) == ids([r2])
        db.query(q, top_k=3)  # sharded and single-device results are keyed apart
        assert db.cache_misses == 2
        db.add({"i": 999, "parity": "even", "text": "new"})  # a mutation clears the cache
        assert len(db.lru_cache) == 0
        return [r1]

    same_pairs(both(pkgs, body))


def test_from_checkpoint_sharded_vectors(pkgs, tmp_path):
    """A sharded checkpoint straight onto the mesh: answers equal a
    host-built ShardedHyperDB's; the document state round-trips too."""
    def body(P):
        db = _base_db(P)
        path = str(tmp_path / f"ckpt_{P.name}")
        db.save(path, format="checkpoint", rows_per_shard=64)
        assert sorted(os.listdir(os.path.join(path, "vectors"))) == [
            f"shard_{i:05d}.npy" for i in range(4)]  # 200 / 64
        sdb = P.Sharded.from_checkpoint(path, P.mesh)
        assert sdb.n == 200
        q = np.random.default_rng(5).standard_normal((3, 16)).astype(np.float32)
        got = sdb.query_batch(q, top_k=5)
        same_rows(got, P.Sharded(db, P.mesh).query_batch(q, top_k=5), rel=1e-4)
        fres = sdb.query_batch(q[:1], top_k=5, filters=[("metadata", {"parity": "odd"})])
        assert fres[0] and all(doc["parity"] == "odd" for doc, *_ in fres[0])
        return got, fres

    same_pairs(both(pkgs, body))


def test_from_checkpoint_monolithic_vectors(pkgs, tmp_path):
    def body(P):
        db = _base_db(P)
        path = str(tmp_path / f"mono_{P.name}")
        db.save(path, format="checkpoint")
        sdb = P.Sharded.from_checkpoint(path, P.mesh)
        q = np.random.default_rng(6).standard_normal((2, 16)).astype(np.float32)
        got = sdb.query_batch(q, top_k=3)
        assert ids(got) == ids(db.query_batch(q, top_k=3))
        return got

    same_pairs(both(pkgs, body))


def test_int8_pure_matches_single_chip_int8(pkgs, monkeypatch):
    """Sharded int8-pure == the single-device engine with
    device_precision='int8-pure' (the same per-row quantization)."""
    def body(P):
        rng = np.random.default_rng(30)
        v = rng.standard_normal((512, 32)).astype(np.float32)
        docs = [{"i": int(i)} for i in range(len(v))]
        host = P.DB(documents=docs, vectors=v, device_precision="int8-pure")
        sdb = P.Sharded(P.DB(documents=docs, vectors=v), P.mesh, precision="int8-pure")
        q = rng.standard_normal((4, 32)).astype(np.float32)
        got = sdb.query_batch(q, top_k=6)
        monkeypatch.setattr(P.config, "host_path_max_cells", 0)  # the device int8 path
        same_rows(got, host.query_batch(q, top_k=6), rel=1e-4)
        return got

    same_pairs(both(pkgs, body))


def test_int8_pure_recency_and_metric_guard(pkgs):
    def body(P):
        rng = np.random.default_rng(31)
        v = rng.standard_normal((256, 16)).astype(np.float32)
        docs = [{"i": int(i), "timestamp": float(i % 10)} for i in range(len(v))]
        sdb = P.Sharded(P.DB(documents=docs, vectors=v, metadata_keys=["timestamp"]),
                        P.mesh, precision="int8-pure")
        q = rng.standard_normal((2, 16)).astype(np.float32)
        out = sdb.query_batch(q, top_k=5, recency_bias=0.4)
        assert all(len(row) == 5 for row in out)
        with pytest.raises(ValueError):
            sdb.query_batch(q, top_k=5, metric="euclidean_metric")
        return out, sdb.query_batch(q, top_k=5)

    same_pairs(both(pkgs, body))


def test_top_k_beyond_shard_capacity_is_exact(pkgs):
    """top_k above one shard's rows: per-shard candidates are clamped and
    the merge stays exact."""
    def body(P):
        rng = np.random.default_rng(41)
        n, d, k = 256, 16, 100  # 8 shards -> 32 rows per shard << k
        v = rng.standard_normal((n, d)).astype(np.float32)
        base = P.DB(documents=[{"i": int(i)} for i in range(n)], vectors=v)
        q = rng.standard_normal(d).astype(np.float32)
        got = P.Sharded(base, P.mesh).query(q, top_k=k)
        want = base.query(q, top_k=k)
        assert len(got) == k == len(want)
        same_rows([got], [want], rel=1e-4)
        return [got]

    same_pairs(both(pkgs, body))


def test_empty_filter_with_recency_returns_empty(pkgs):
    def body(P):
        rng = np.random.default_rng(42)
        v = rng.standard_normal((128, 8)).astype(np.float32)
        docs = [{"i": int(i), "grp": "x", "ts": float(i)} for i in range(128)]
        sdb = P.Sharded(P.DB(documents=docs, vectors=v, metadata_keys=["grp", "ts"]), P.mesh)
        out = sdb.query_batch(rng.standard_normal(8).astype(np.float32)[None], top_k=3,
                              filters=[("metadata", {"grp": "nomatch"})],
                              recency_bias=0.5, timestamp_key="ts")
        assert out == [[]]
        return out

    same_pairs(both(pkgs, body))


def test_multiple_skip_doc_filters_match_engine(pkgs):
    """Only the FIRST skip_doc applies (the reference's rule)."""
    def body(P):
        rng = np.random.default_rng(43)
        v = rng.standard_normal((128, 8)).astype(np.float32)
        base = P.DB(documents=[{"i": int(i)} for i in range(128)], vectors=v)
        q = rng.standard_normal(8).astype(np.float32)
        filters = [("skip_doc", 2), ("skip_doc", -3)]
        got = P.Sharded(base, P.mesh).query(q, top_k=6, filters=filters)
        assert ids([got]) == ids([base.query(q, top_k=6, filters=filters)])
        return [got]

    same_pairs(both(pkgs, body))


def test_mutation_after_sharding_raises(pkgs):
    def body(P):
        rng = np.random.default_rng(44)
        v = rng.standard_normal((64, 8)).astype(np.float32)
        base = P.DB(documents=[{"i": int(i)} for i in range(64)], vectors=v)
        sdb = P.Sharded(base, P.mesh)
        base.add_document({"i": 64}, vectors=rng.standard_normal((1, 8)).astype(np.float32))
        base.commit_pending()
        with pytest.raises(RuntimeError, match="mutated after sharding"):
            sdb.query_batch(rng.standard_normal((1, 8)).astype(np.float32), top_k=3)

    both(pkgs, body)


def test_query_dim_mismatch_raises(pkgs):
    def body(P):
        rng = np.random.default_rng(45)
        v = rng.standard_normal((64, 8)).astype(np.float32)
        sdb = P.Sharded(P.DB(documents=[{"i": int(i)} for i in range(64)], vectors=v), P.mesh)
        with pytest.raises(ValueError, match="dimension of the query vectors"):
            sdb.query_batch(rng.standard_normal((2, 12)).astype(np.float32), top_k=3)

    both(pkgs, body)


# --------------------------------------------------------------------------
# the incremental serving lifecycle and key filters
# --------------------------------------------------------------------------


def test_incremental_add_matches_rebuild(pkgs):
    """add() writes into reserved capacity in place; answers equal a fresh
    ShardedHyperDB over the mutated corpus."""
    def body(P):
        rng = np.random.default_rng(10)
        v = rng.standard_normal((100, 16)).astype(np.float32)
        db = P.DB(documents=[{"i": int(i)} for i in range(100)], vectors=v)
        sdb = P.Sharded(db, P.mesh, capacity_rows=4096)
        assert sdb.capacity_remaining >= 3996
        sdb.add([{"i": 100 + j} for j in range(7)],
                vectors=rng.standard_normal((7, 16)).astype(np.float32))
        assert sdb.n == 107 and len(db.documents) == 107
        q = rng.standard_normal((3, 16)).astype(np.float32)
        got = sdb.query_batch(q, top_k=6)
        same_rows(got, P.Sharded(db, P.mesh).query_batch(q, top_k=6), rel=1e-4)
        return got

    same_pairs(both(pkgs, body))


def test_incremental_remove_tombstones(pkgs):
    def body(P):
        rng = np.random.default_rng(11)
        v = rng.standard_normal((64, 16)).astype(np.float32)
        db = P.DB(documents=[{"i": int(i)} for i in range(64)], vectors=v)
        sdb = P.Sharded(db, P.mesh, capacity_rows=2048)
        sdb.remove_document([3, 10, 60])
        assert len(db.documents) == 61
        q = rng.standard_normal((2, 16)).astype(np.float32)
        got = sdb.query_batch(q, top_k=8)
        assert ids(got) == ids(P.Sharded(db, P.mesh).query_batch(q, top_k=8))
        assert not ({3, 10, 60} & {doc["i"] for row in got for doc, *_ in row})
        return got

    same_pairs(both(pkgs, body))


def test_remove_invalid_index_mutates_nothing(pkgs):
    """An out-of-range document id raises BEFORE any state moves."""
    def body(P):
        rng = np.random.default_rng(17)
        v = rng.standard_normal((32, 16)).astype(np.float32)
        db = P.DB(documents=[{"i": int(i)} for i in range(32)], vectors=v)
        sdb = P.Sharded(db, P.mesh, capacity_rows=1024)
        before = (list(db.documents), sdb.row_docs.copy(), sdb._base_valid.copy())
        with pytest.raises(IndexError):
            sdb.remove_document([5, 99])
        assert db.documents == before[0]
        np.testing.assert_array_equal(sdb.row_docs, before[1])
        np.testing.assert_array_equal(sdb._base_valid, before[2])
        got = sdb.query_batch((v[5] + 0.01).astype(np.float32)[None, :], top_k=1)
        assert got[0][0][0]["i"] == 5
        return got

    same_pairs(both(pkgs, body))


def test_incremental_mixed_lifecycle_chunked(pkgs):
    """Adds and removes interleaved over a CHUNKED corpus stay exact."""
    def body(P):
        db = P.DB()
        db.add([{"text": "word " * 700, "i": 0}, {"text": "alpha beta", "i": 1}])
        sdb = P.Sharded(db, P.mesh, capacity_rows=4096)
        sdb.add([{"text": "word " * 600, "i": 2}])  # 2 chunks
        sdb.remove_document(0)
        sdb.add([{"text": "gamma delta", "i": 3}])
        q = np.random.default_rng(12).standard_normal((2, db.dim)).astype(np.float32)
        got = sdb.query_batch(q, top_k=3)
        want = P.Sharded(db, P.mesh).query_batch(q, top_k=3)
        assert ids(got) == ids(want)
        assert [[d["i"] for d, *_ in r] for r in got] == [[d["i"] for d, *_ in r] for r in want]
        return got

    same_pairs(both(pkgs, body))


def test_capacity_overflow_auto_compacts_and_grows(pkgs):
    """add() past the reserved capacity compacts into a grown capacity (one
    rebuild) and keeps serving the whole corpus."""
    def body(P):
        rng = np.random.default_rng(13)
        v = rng.standard_normal((128, 16)).astype(np.float32)
        db = P.DB(documents=[{"i": int(i)} for i in range(128)], vectors=v)
        sdb = P.Sharded(db, P.mesh)
        old_pad = sdb.n_pad
        too_many = sdb.capacity_remaining + 1
        sdb.add([{"i": 1000 + j} for j in range(too_many)],
                vectors=rng.standard_normal((too_many, 16)).astype(np.float32))
        assert len(db.documents) == sdb.n == 128 + too_many
        assert sdb.n_pad >= old_pad * 2
        q = rng.standard_normal((2, 16)).astype(np.float32)
        got = sdb.query_batch(q, top_k=7)
        assert ids(got) == ids(P.Sharded(db, P.mesh).query_batch(q, top_k=7))
        return got

    same_pairs(both(pkgs, body))


def test_capacity_exhaustion_device_rows_raises_and_rolls_back(pkgs, tmp_path):
    """A from_checkpoint corpus has no host vectors to rebuild from: an
    overflow raises AFTER rolling the host db back."""
    def body(P):
        rng = np.random.default_rng(13)
        v = rng.standard_normal((128, 16)).astype(np.float32)
        db = P.DB(documents=[{"i": int(i)} for i in range(128)], vectors=v)
        path = str(tmp_path / f"cap_{P.name}")
        db.save(path, format="checkpoint")
        sdb = P.Sharded.from_checkpoint(path, P.mesh)
        marker = np.zeros((1, 16), dtype=np.float32)
        marker[0, 0] = 100.0
        sdb.add([{"i": 500}], vectors=marker)  # in capacity: the host matrix's tail
        hit = sdb.query_batch(marker, top_k=1)[0][0]
        assert hit[0]["i"] == 500
        docs_before = len(sdb.db.documents)
        too_many = sdb.capacity_remaining + 1
        with pytest.raises(RuntimeError, match="capacity"):
            sdb.add([{"i": 1000 + j} for j in range(too_many)],
                    vectors=rng.standard_normal((too_many, 16)).astype(np.float32))
        assert len(sdb.db.documents) == docs_before
        out = sdb.query_batch(rng.standard_normal((1, 16)).astype(np.float32), top_k=5)
        assert len(out[0]) == 5
        return out

    same_pairs(both(pkgs, body))


def test_direct_db_mutation_still_requires_rebuild(pkgs):
    def body(P):
        db = _base_db(P)
        sdb = P.Sharded(db, P.mesh)
        db.add({"i": 999, "parity": "odd", "text": "x"}, vectors=np.zeros((1, 16), dtype=np.float32))
        with pytest.raises(RuntimeError, match="mutated"):
            sdb.query_batch(np.zeros((1, 16), dtype=np.float32), top_k=1)

    both(pkgs, body)


def _fake_embed_words(d):
    def fake_embed(texts):
        out = np.zeros((len(texts), d), dtype=np.float32)
        for j, t in enumerate(texts):
            for w in str(t).split():
                out[j, hash(w) % d] += 1.0
        return out

    return fake_embed


def test_key_filter_on_sharded_path(pkgs):
    """Key filters ride the mesh: the per-document override block is scored
    row-sharded; the oracle is the single-device key-filter path."""
    def body(P):
        rng = np.random.default_rng(14)
        docs = [{"name": f"thing {i}", "desc": f"describes item {i} in words", "i": i}
                for i in range(40)]
        v = rng.standard_normal((40, 32)).astype(np.float32)
        embed = _fake_embed_words(32)
        db = P.DB(documents=docs, vectors=v, embedding_function=embed, metadata_keys=["i"])
        sdb = P.Sharded(db, P.mesh)
        q = embed(["describes item 7"])
        out = []
        for filters in ([("key", "desc")], [("key", ["name", "desc"]), ("metadata", {"i": 7})]):
            got = sdb.query_batch(q, top_k=5, filters=filters)
            same_rows(got, db.query_batch(q, top_k=5, filters=filters), rel=1e-4)
            out.append(got)
        return tuple(out)

    same_pairs(both(pkgs, body))


def test_key_filter_override_device_cache(pkgs, monkeypatch):
    """Repeated key-filter serving places ONE override block: the sharded
    (rows, mask) blocks are cached per (filter spec, corpus version) and a
    mutation drops them. JAX counts ``jax.device_put``; the port counts its
    ``shard_rows`` placements."""
    def body(P):
        rng = np.random.default_rng(21)
        docs = [{"name": f"item {i}", "i": i} for i in range(24)]
        v = rng.standard_normal((24, 16)).astype(np.float32)

        def fake_embed(texts):
            out = np.zeros((len(texts), 16), dtype=np.float32)
            for j, t in enumerate(texts):
                out[j, len(str(t)) % 16] = 1.0
            return out

        db = P.DB(documents=docs, vectors=v, embedding_function=fake_embed, metadata_keys=["i"])
        sdb = P.Sharded(db, P.mesh)
        q = rng.standard_normal((2, 16)).astype(np.float32)
        puts = []
        if P.name == "jax":
            mod, name = jax, "device_put"
        else:
            mod, name = TS, "shard_rows"
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, **k: (puts.append(1), real(*a, **k))[1])
        filters = [("key", "name")]
        first = sdb.query_batch(q, top_k=3, filters=filters)
        n_first = len(puts)
        assert n_first > 0 and len(sdb._override_cache) == 1
        second = sdb.query_batch(q, top_k=3, filters=filters)
        assert len(puts) == n_first  # a cache hit places nothing
        assert ids(first) == ids(second)
        sdb.query_batch(q, top_k=3, filters=[("metadata", {"i": 7}), ("key", "name")])
        assert len(sdb._override_cache) == 2
        monkeypatch.undo()
        sdb.add([{"name": "item 99", "i": 99}], vectors=rng.standard_normal((1, 16)).astype(np.float32))
        assert not sdb._override_cache
        third = sdb.query_batch(q, top_k=3, filters=filters)
        assert len(third[0]) == 3
        return first, third

    same_pairs(both(pkgs, body))


def test_key_filter_single_query_cache(pkgs):
    def body(P):
        rng = np.random.default_rng(15)
        docs = [{"name": f"n{i}"} for i in range(16)]
        v = rng.standard_normal((16, 8)).astype(np.float32)

        def fake_embed(texts):
            out = np.zeros((len(texts), 8), dtype=np.float32)
            for j, t in enumerate(texts):
                out[j, len(str(t)) % 8] = 1.0
            return out

        db = P.DB(documents=docs, vectors=v, embedding_function=fake_embed)
        sdb = P.Sharded(db, P.mesh)
        q = np.ones(8, dtype=np.float32)
        r1 = sdb.query(q, top_k=3, filters=[("key", "name")])
        r2 = sdb.query(q, top_k=3, filters=[("key", "name")])
        assert ids([r1]) == ids([r2]) and db.cache_hits >= 1
        return [r1]

    same_pairs(both(pkgs, body))


def test_remove_last_document_keeps_serving(pkgs):
    """Tombstoned rows never carry a document id equal to the new document
    count (removing the LAST document)."""
    def body(P):
        rng = np.random.default_rng(20)
        v = rng.standard_normal((64, 16)).astype(np.float32)
        db = P.DB(documents=[{"i": int(i)} for i in range(64)], vectors=v)
        sdb = P.Sharded(db, P.mesh, capacity_rows=1024)
        sdb.remove_document(63)
        q = rng.standard_normal((1, 16)).astype(np.float32)
        got = sdb.query_batch(q, top_k=5)
        assert ids(got) == ids(P.Sharded(db, P.mesh).query_batch(q, top_k=5))
        assert all(doc["i"] != 63 for doc, *_ in got[0])
        sdb.remove_document(list(range(len(db.documents))))
        assert sdb.query_batch(q, top_k=3) == [[]]
        return got

    same_pairs(both(pkgs, body))


def test_model_based_incremental_lifecycle(pkgs):
    """Random interleavings of add/remove/query against a fresh
    ShardedHyperDB over the same mutated host db."""
    def body(P):
        rng = np.random.default_rng(42)
        v = rng.standard_normal((40, 16)).astype(np.float32)
        db = P.DB(documents=[{"i": int(i)} for i in range(40)], vectors=v)
        sdb = P.Sharded(db, P.mesh, capacity_rows=2048)
        next_id = 40
        out = []
        for step in range(12):
            op = rng.choice(["add", "remove", "query"])
            if op == "add":
                m = int(rng.integers(1, 4))
                sdb.add([{"i": next_id + j} for j in range(m)],
                        vectors=rng.standard_normal((m, 16)).astype(np.float32))
                next_id += m
            elif op == "remove" and len(db.documents) > 5:
                sdb.remove_document(sorted(set(rng.integers(0, len(db.documents), size=2).tolist())))
            else:
                q = rng.standard_normal((2, 16)).astype(np.float32)
                got = sdb.query_batch(q, top_k=4)
                assert ids(got) == ids(P.Sharded(db, P.mesh).query_batch(q, top_k=4)), step
                out.append(got)
        q = rng.standard_normal((3, 16)).astype(np.float32)
        got = sdb.query_batch(q, top_k=5)
        assert ids(got) == ids(P.Sharded(db, P.mesh).query_batch(q, top_k=5))
        return tuple(out + [got])

    same_pairs(both(pkgs, body))


def test_remove_negative_ids_normalize_or_raise(pkgs):
    def body(P):
        rng = np.random.default_rng(23)
        v = rng.standard_normal((16, 16)).astype(np.float32)
        db = P.DB(documents=[{"i": int(i)} for i in range(16)], vectors=v)
        sdb = P.Sharded(db, P.mesh, capacity_rows=1024)
        sdb.remove_document(-1)  # the last document
        assert len(db.documents) == 15
        got = sdb.query_batch((v[7] + 0.01)[None, :], top_k=1)
        assert got[0][0][0]["i"] == 7
        assert 15 not in {d["i"] for row in sdb.query_batch(v[:1], top_k=15) for d, _, _ in row}
        before = (list(db.documents), sdb.row_docs.copy())
        with pytest.raises(IndexError):
            sdb.remove_document([3, -40])
        assert db.documents == before[0]
        np.testing.assert_array_equal(sdb.row_docs, before[1])
        return got

    same_pairs(both(pkgs, body))


def test_sharded_batch_bucketing_pads_and_slices(pkgs):
    """A 3-query block is padded to a bucket and cut back to 3 rows, with
    and without a key-filter override."""
    def body(P):
        rng = np.random.default_rng(31)
        v = rng.standard_normal((64, 16)).astype(np.float32)

        def embed(texts):
            if isinstance(texts, str):
                texts = [texts]
            return np.stack([np.random.default_rng(abs(hash(t)) % (1 << 31))
                             .standard_normal(16).astype(np.float32) for t in texts])

        db = P.DB(documents=[{"i": int(i), "t": f"doc {i}"} for i in range(64)], vectors=v,
                  embedding_function=embed)
        sdb = P.Sharded(db, P.mesh)
        q = (v[[5, 11, 40]] + 0.01).astype(np.float32)
        res = sdb.query_batch(q, top_k=2)
        assert len(res) == 3 and [row[0][0]["i"] for row in res] == [5, 11, 40]
        res_f = sdb.query_batch(q, top_k=1, filters=[("key", "t")])
        assert len(res_f) == 3 and all(len(row) == 1 for row in res_f)
        return res, res_f

    same_pairs(both(pkgs, body))


def test_sharded_f16_query_block_matches_f32(pkgs):
    """An f16 query block gives the ids of its f32 twin and near scores."""
    def body(P):
        rng = np.random.default_rng(31)
        v16 = rng.standard_normal((1024, 16)).astype(np.float16)
        db = P.DB(documents=[{"i": int(i)} for i in range(1024)], vectors=v16.astype(np.float32),
                  fp_precision="float16")
        sdb = P.Sharded(db, P.mesh)
        q16 = v16[[7, 333, 900]]
        r16 = sdb.query_batch(q16, top_k=5)
        r32 = sdb.query_batch(q16.astype(np.float32), top_k=5)
        assert ids(r16) == ids(r32)
        for row16, row32 in zip(r16, r32):
            for a, b in zip(row16, row32):
                assert abs(a[1] - b[1]) < 2e-3
        got_ids, _ = sdb.query_batch_arrays(q16, top_k=5)
        assert got_ids[0][0] == 7 and got_ids[1][0] == 333 and got_ids[2][0] == 900
        if P.name == "jax":  # the single-device engine's operands (module note)
            return db.query_batch(q16, top_k=5), db.query_batch(q16.astype(np.float32), top_k=5)
        return r16, r32

    same_pairs(both(pkgs, body), rel=1e-4)


def test_compact_reclaims_tombstoned_capacity(pkgs):
    def body(P):
        rng = np.random.default_rng(40)
        v = rng.standard_normal((100, 16)).astype(np.float32)
        db = P.DB(documents=[{"i": int(i)} for i in range(100)], vectors=v)
        sdb = P.Sharded(db, P.mesh, capacity_rows=2048)
        cap = sdb.n_pad
        sdb.remove_document(list(range(0, 40)))
        assert sdb.tombstoned_rows == 40
        free_before = sdb.capacity_remaining
        sdb.compact()
        assert sdb.tombstoned_rows == 0 and sdb.n == 60 and sdb.n_pad == cap
        assert sdb.capacity_remaining == free_before + 40
        q = rng.standard_normal((3, 16)).astype(np.float32)
        got = sdb.query_batch(q, top_k=7)
        same_rows(got, P.Sharded(db, P.mesh, capacity_rows=2048).query_batch(q, top_k=7), rel=1e-4)
        sdb.add([{"i": 1000 + j} for j in range(5)],
                vectors=rng.standard_normal((5, 16)).astype(np.float32))
        assert sdb.n == 65
        return got

    same_pairs(both(pkgs, body))


def test_compact_resyncs_after_direct_db_mutation(pkgs):
    def body(P):
        rng = np.random.default_rng(41)
        v = rng.standard_normal((64, 16)).astype(np.float32)
        db = P.DB(documents=[{"i": int(i)} for i in range(64)], vectors=v)
        sdb = P.Sharded(db, P.mesh, capacity_rows=1024)
        db.add([{"i": 64}], vectors=rng.standard_normal((1, 16)).astype(np.float32))
        q = rng.standard_normal((2, 16)).astype(np.float32)
        with pytest.raises(RuntimeError, match="compact"):
            sdb.query_batch(q, top_k=3)
        sdb.compact()
        got = sdb.query_batch(q, top_k=5)
        assert ids(got) == ids(P.Sharded(db, P.mesh).query_batch(q, top_k=5))
        return got

    same_pairs(both(pkgs, body))


def test_compact_int8_pure_and_shrink(pkgs):
    def body(P):
        rng = np.random.default_rng(42)
        v = rng.standard_normal((256, 16)).astype(np.float32)
        db = P.DB(documents=[{"i": int(i)} for i in range(256)], vectors=v)
        sdb = P.Sharded(db, P.mesh, capacity_rows=4096, precision="int8-pure")
        sdb.remove_document(list(range(200, 256)))
        sdb.compact(capacity_rows=256)
        assert sdb.precision == "int8-pure" and hasattr(sdb, "rows_q")
        assert sdb.n == 200 and sdb.n_pad < 4096
        q = rng.standard_normal((2, 16)).astype(np.float32)
        got = sdb.query_batch(q, top_k=6)
        assert ids(got) == ids(P.Sharded(db, P.mesh, precision="int8-pure").query_batch(q, top_k=6))
        return got

    same_pairs(both(pkgs, body))


def test_compact_device_rows_corpus_raises(pkgs, tmp_path):
    from hyperdb_tpu.persist.checkpoint import save_checkpoint as jax_save
    from hyperdb_tpu_torch.persist.checkpoint import save_checkpoint as torch_save

    def body(P):
        db = _base_db(P)
        path = str(tmp_path / f"dev_{P.name}")
        (jax_save if P.name == "jax" else torch_save)(db, path, rows_per_shard=64)
        sdb = P.Sharded.from_checkpoint(path, P.mesh)
        with pytest.raises(RuntimeError, match="host"):
            sdb.compact()

    both(pkgs, body)


def test_pearson_matches_single_chip(pkgs):
    """Sharded pearson rides the centered unit-norm plane as dot; answers
    equal the single-device engine's, with the constant-row NaN -> -inf
    contract and recency."""
    def body(P):
        rng = np.random.default_rng(30)
        v = rng.standard_normal((256, 16)).astype(np.float32)
        v[9] = -1.5  # a constant row: pearson NaN, never ranked
        docs = [{"i": int(i), "ts": float(i % 19)} for i in range(len(v))]
        db = P.DB(documents=docs, vectors=v, metadata_keys=["ts"])
        sdb = P.Sharded(db, P.mesh)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        got = sdb.query_batch(q, top_k=6, metric="pearson_correlation")
        same_rows(got, db.query_batch(q, top_k=6, metric="pearson_correlation"), rel=1e-4)
        assert all(r[2] != 9 for row in got for r in row)
        kw = dict(top_k=6, metric="pearson_correlation", recency_bias=1.5, timestamp_key="ts")
        got_r = sdb.query_batch(q, **kw)
        same_rows(got_r, db.query_batch(q, **kw), rel=1e-4)
        return got, got_r

    same_pairs(both(pkgs, body))


def test_pearson_constant_query_returns_empty(pkgs):
    """A constant query scores NaN -> -inf everywhere: the sharded assembly
    drops non-finite candidates, so the answer is EMPTY in both packages."""
    def body(P):
        rng = np.random.default_rng(31)
        v = rng.standard_normal((128, 16)).astype(np.float32)
        sdb = P.Sharded(P.DB(documents=[{"i": int(i)} for i in range(len(v))], vectors=v), P.mesh)
        res = sdb.query_batch(np.full((1, 16), 3.0, dtype=np.float32), top_k=4,
                              metric="pearson_correlation")
        assert res == [[]]
        return res

    same_pairs(both(pkgs, body))


def test_pearson_plane_tracks_incremental_add(pkgs):
    """The lazily built plane follows appends: a perfectly correlated new
    row ranks first with pearson 1."""
    def body(P):
        rng = np.random.default_rng(32)
        v = rng.standard_normal((100, 16)).astype(np.float32)
        db = P.DB(documents=[{"i": int(i)} for i in range(100)], vectors=v)
        sdb = P.Sharded(db, P.mesh, capacity_rows=4096)
        q = rng.standard_normal((1, 16)).astype(np.float32)
        sdb.query_batch(q, top_k=3, metric="pearson_correlation")  # builds the plane
        assert hasattr(sdb, "rows_pearson")
        sdb.add([{"i": 100}], vectors=(2.5 * q[0] + 0.7).astype(np.float32)[None])
        res = sdb.query_batch(q, top_k=3, metric="pearson_correlation")
        assert res[0][0][2] == 100 and res[0][0][1] == pytest.approx(1.0, abs=1e-4)
        got = sdb.query_batch(q, top_k=5, metric="pearson_correlation")
        assert ids(got) == ids(P.Sharded(db, P.mesh).query_batch(q, top_k=5,
                                                                 metric="pearson_correlation"))
        return res, got

    same_pairs(both(pkgs, body))


def test_pearson_plane_dropped_on_compact(pkgs):
    def body(P):
        rng = np.random.default_rng(33)
        v = rng.standard_normal((96, 16)).astype(np.float32)
        sdb = P.Sharded(P.DB(documents=[{"i": int(i)} for i in range(96)], vectors=v), P.mesh)
        q = rng.standard_normal((1, 16)).astype(np.float32)
        base = sdb.query_batch(q, top_k=4, metric="pearson_correlation")
        assert hasattr(sdb, "rows_pearson")
        sdb.compact()
        assert not hasattr(sdb, "rows_pearson")
        again = sdb.query_batch(q, top_k=4, metric="pearson_correlation")
        assert ids(again) == ids(base)
        return again

    same_pairs(both(pkgs, body))


def test_compact_empty_corpus_refused_before_dropping_shards(pkgs):
    def body(P):
        rng = np.random.default_rng(77)
        v = rng.standard_normal((32, 16)).astype(np.float32)
        db = P.DB(documents=[{"i": int(i)} for i in range(32)], vectors=v)
        sdb = P.Sharded(db, P.mesh)
        sdb.remove_document(list(range(32)))
        with pytest.raises(ValueError, match="every document was removed"):
            sdb.compact()
        q = rng.standard_normal((1, 16)).astype(np.float32)
        assert sdb.query_batch(q, top_k=3) == [[]]
        sdb.add([{"i": 100}], vectors=rng.standard_normal((1, 16)).astype(np.float32))
        got = sdb.query_batch(q, top_k=3)
        assert [doc["i"] for doc, *_ in got[0]] == [100]
        return got

    same_pairs(both(pkgs, body))


def test_compact_rebuild_failure_leaves_explicit_state(pkgs, monkeypatch):
    """A rebuild that dies after the old shards went leaves a descriptive
    needs-rebuild error on every later call; a successful retry serves."""
    def body(P):
        rng = np.random.default_rng(78)
        v = rng.standard_normal((32, 16)).astype(np.float32)
        sdb = P.Sharded(P.DB(documents=[{"i": int(i)} for i in range(32)], vectors=v), P.mesh)
        q = rng.standard_normal((1, 16)).astype(np.float32)
        want = ids(sdb.query_batch(q, top_k=5))

        def boom(self, capacity_rows):
            raise MemoryError("simulated device OOM")

        monkeypatch.setattr(P.Sharded, "_build_host_shards", boom)
        with pytest.raises(MemoryError):
            sdb.compact()
        with pytest.raises(RuntimeError, match="rebuild failed"):
            sdb.query_batch(q, top_k=5)
        with pytest.raises(RuntimeError, match="rebuild failed"):
            sdb.add([{"i": 99}], vectors=rng.standard_normal((1, 16)).astype(np.float32))
        monkeypatch.undo()
        sdb.compact()
        got = sdb.query_batch(q, top_k=5)
        assert ids(got) == want
        return got

    same_pairs(both(pkgs, body))


def test_f16_master_low_precision_plane_dtype_rules(pkgs):
    """An f16 master's shards are bf16; cosine and pearson queries are cast
    to the plane dtype, an f16 dot wire to bf16 per shard, and an f32 dot
    wire scores in f32."""
    def body(P):
        rng = np.random.default_rng(79)
        v16 = rng.standard_normal((512, 16)).astype(np.float16)
        db = P.DB(documents=[{"i": int(i)} for i in range(512)], vectors=v16.astype(np.float32),
                  fp_precision="float16")
        sdb = P.Sharded(db, P.mesh)
        assert sdb.rows.dtype == (jnp.bfloat16 if P.name == "jax" else torch.bfloat16)
        q16 = v16[[3, 400]]
        out = {}
        for metric in ("cosine_similarity", "dot_product", "pearson_correlation"):
            r16 = sdb.query_batch(q16, top_k=5, metric=metric)
            r32 = sdb.query_batch(q16.astype(np.float32), top_k=5, metric=metric)
            if metric != "dot_product":
                assert r16[0][0][0]["i"] == 3 and r16[1][0][0]["i"] == 400
                assert r32[0][0][0]["i"] == 3 and r32[1][0][0]["i"] == 400
            for row16, row32 in zip(r16, r32):
                for a, b in zip(row16, row32):
                    assert abs(a[1] - b[1]) < 1e-2 + 4e-3 * abs(b[1])
            if metric == "cosine_similarity":
                # the single-device engine's operands (module note)
                single = (db.query_batch(q16, top_k=5, metric=metric),
                          db.query_batch(q16.astype(np.float32), top_k=5, metric=metric))
                if P.name == "jax":
                    r16, r32 = single
                else:
                    same_rows(r16, single[0], rel=1e-5)
                    same_rows(r32, single[1], rel=1e-5)
            out[metric] = (r16, r32)
        return out

    j, t = both(pkgs, body)
    for metric in j:
        # pearson: the port centres the float16 master before the bf16
        # rounding, the JAX package the bf16 rows (module note)
        same_pairs((j[metric], t[metric]), rel=5e-3 if metric == "pearson_correlation" else 1e-4)
