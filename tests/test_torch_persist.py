"""Persistence: files cross between ``hyperdb_tpu`` and ``hyperdb_tpu_torch``
in both directions, in every format (pickle, pickle.gz, json, sqlite, and
the checkpoint directory, whole and in row shards).

After a load the state must be equal to the saver's (documents,
source_indices, split_info, metadata index, vectors bit for bit) and the
answers the same as the saving package's: ids identical, scores within
``ATOL`` (bit-equal f32 rows, two summation orders). Index sidecars: a
flat ``.ann`` round-trips, a foreign one warns and rebuilds, and the JAX
package's IVF and projscan states load (``tests/test_torch_ivf.py`` and
``tests/test_torch_projscan.py`` cross them both ways and compare answers).
"""

import numpy as np
import pytest

from hyperdb_tpu import HyperDB as JaxDB
from hyperdb_tpu.core import db as JDB_MODULE
from hyperdb_tpu_torch import HyperDB as TorchDB

ATOL = 1e-6
KEYS = ["info.type"]
FORMATS = {
    "pickle": ("pickle", "db.pkl", {}),
    "pickle_gz": ("pickle", "db.pickle.gz", {}),
    "json": ("json", "db.json", {}),
    "sqlite": ("sqlite", "db.sqlite", {}),
    "checkpoint": ("checkpoint", "ckpt", {}),
    "checkpoint_shards": ("checkpoint", "ckpt", {"rows_per_shard": 7}),
}
QUERIES = ["sleeps all day", "a fire in the cave", "word " * 600]


def _docs(n=30):
    rng = np.random.default_rng(0)
    words = "sleeps day fire cave water swims ghost night giant tiny burns".split()
    docs = [
        {"name": f"mon{i}", "info": {"type": ("fire", "water", "ghost")[i % 3],
                                     "description": " ".join(rng.choice(words, 12))}}
        for i in range(n)
    ]
    docs[5]["info"]["description"] = "swims " * 1100  # a document of several chunks
    return docs


def _make(pkg, **kw):
    if pkg == "jax":
        return JaxDB(**kw)
    return TorchDB(device="cpu", **kw)


def _same_state(a, b):
    assert a.documents == b.documents
    assert a.source_indices == b.source_indices
    assert a.split_info == b.split_info
    assert a._metadata_index == b._metadata_index
    assert a.vectors_normalized == b.vectors_normalized
    assert np.asarray(a.vectors).dtype == np.asarray(b.vectors).dtype
    np.testing.assert_array_equal(np.asarray(a.vectors), np.asarray(b.vectors))


def _same_answers(a, b):
    for q in QUERIES:
        ha, hb = a.query(q, top_k=6), b.query(q, top_k=6)
        assert [h[2] for h in ha] == [h[2] for h in hb]
        np.testing.assert_allclose([h[1] for h in ha], [h[1] for h in hb], rtol=0, atol=ATOL)
    filters = [("metadata", {"info.type": "ghost"})]
    assert [h[2] for h in a.query(QUERIES[0], filters=filters)] == [
        h[2] for h in b.query(QUERIES[0], filters=filters)
    ]


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("name", sorted(FORMATS))
def test_files_cross_packages(tmp_path, name, direction):
    fmt, fname, kw = FORMATS[name]
    src_pkg, dst_pkg = ("jax", "torch") if direction == "jax_to_torch" else ("torch", "jax")
    saver = _make(src_pkg, documents=_docs(), metadata_keys=list(KEYS))
    path = tmp_path / fname
    saver.save(str(path), format=fmt, **kw)
    loaded = _make(dst_pkg, metadata_keys=list(KEYS))
    loaded.load(str(path), format=fmt)
    _same_state(saver, loaded)
    assert loaded.split_info[5] > 1  # the chunked document
    assert loaded.ann_index.state() == {"kind": "flat", "metric": "cosine", "dim": 384}
    _same_answers(saver, loaded)
    if name == "checkpoint_shards":
        assert len(list((path / "vectors").iterdir())) == 5


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_restores_config(tmp_path, direction):
    """A float16 checkpoint (dot index, metadata keys) restores its own
    config into a DB constructed with the defaults."""
    src_pkg, dst_pkg = ("jax", "torch") if direction == "jax_to_torch" else ("torch", "jax")
    rng = np.random.default_rng(1)
    vectors = rng.standard_normal((40, 16)).astype(np.float16)
    saver = _make(src_pkg, documents=_docs(40), vectors=vectors, fp_precision="float16",
                  metadata_keys=list(KEYS), ann_metric="dot")
    saver.save(str(tmp_path / "c"), format="checkpoint")
    loaded = _make(dst_pkg)
    loaded.load(str(tmp_path / "c"), format="checkpoint", preload_ann_into_memory=True)
    _same_state(saver, loaded)
    assert np.dtype(loaded.fp_precision) == np.float16
    assert (loaded.metadata_keys, loaded.ann_metric) == (KEYS, "dot")
    q = rng.standard_normal((3, 16)).astype(np.float32)
    for metric in ("dot_product", "cosine_similarity"):
        ia, sa = saver.query_batch_arrays(q, top_k=5, metric=metric)
        ib, sb = loaded.query_batch_arrays(q, top_k=5, metric=metric)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_allclose(sa, sb, rtol=0, atol=1e-5)


def test_port_round_trip_and_sidecars(tmp_path, capsys):
    db = TorchDB(_docs(), metadata_keys=list(KEYS), device="cpu")
    path = tmp_path / "db.pkl"
    db.save(str(path))
    with np.load(str(path) + ".ann", allow_pickle=False) as f:
        assert {k: f[k].item() for k in f} == {"kind": "flat", "metric": "cosine", "dim": 384}
    again = TorchDB(metadata_keys=list(KEYS), device="cpu")
    again.load(str(path), preload_ann_into_memory=True)
    _same_state(db, again)
    assert again._store._device is not None  # the planes were built at load
    # a foreign sidecar (the reference writes an Annoy forest there) warns and rebuilds
    (tmp_path / "db.pkl.ann").write_bytes(b"\x00annoy-forest\x01" * 40)
    fresh = TorchDB(metadata_keys=list(KEYS), device="cpu")
    fresh.load(str(path))
    assert "could not parse ANN index sidecar" in capsys.readouterr().out
    assert fresh.ann_index.state()["kind"] == "flat"
    _same_answers(db, fresh)
    # no sidecar: the index is built from the loaded vectors
    db.save(str(tmp_path / "bare.pkl"), save_ann_index=False)
    bare = TorchDB(device="cpu")
    bare.load(str(tmp_path / "bare.pkl"))
    assert bare.ann_index is not None
    empty = TorchDB(device="cpu")
    empty.save(str(tmp_path / "empty.pkl"))
    assert "Nothing to save" in capsys.readouterr().out


def test_ivf_and_projscan_states_raise(tmp_path, monkeypatch):
    """The JAX package's IVF sidecar and checkpoint index used to raise in
    the port; they now load as the same IVF state, never a flat index."""
    monkeypatch.setattr(JDB_MODULE, "IVF_THRESHOLD", 16)
    jdb = JaxDB(_docs(40))
    want = jdb.ann_index.state()
    assert want["kind"] == "ivf"
    jdb.save(str(tmp_path / "ivf.pkl"))
    jdb.save(str(tmp_path / "ivf_ckpt"), format="checkpoint")
    for path, fmt in ((tmp_path / "ivf.pkl", "pickle"), (tmp_path / "ivf_ckpt", "checkpoint")):
        tdb = TorchDB(device="cpu")
        tdb.load(str(path), format=fmt)
        got = tdb.ann_index.state()
        assert got["kind"] == "ivf" and tdb._ivf_built_rows == len(tdb.vectors) > 40
        for key in ("centroids", "row_order", "offsets"):
            np.testing.assert_array_equal(got[key], want[key])
    # the same file loads when its index is declined
    db = TorchDB(device="cpu")
    db.load(str(tmp_path / "ivf.pkl"), load_ann_index=False)
    assert db.ann_index is None and db.size() == 40
