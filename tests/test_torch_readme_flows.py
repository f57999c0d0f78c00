"""The reference README's usage flows through the ``hyperdb_torch`` drop-in
package on the CPU, each held against the JAX package's ``hyperdb``.

The eight flows are those of ``tests/test_reference_readme_flows.py``:
ingest/save/load/query, ``select_keys``, the key filter, the sentence
filter's single survivor (with its Warning and Info lines), the metadata
filter, ``skip_doc`` over string documents, combined filters, and the
"Only one document left." rule for chunks against the key filter. Each flow
runs once through ``hyperdb.HyperDB`` and once through
``hyperdb_torch.HyperDB(device="cpu")`` on the same demo documents (the
test configuration's hash embedder, exact in both packages). Held equal:
the documents returned and their order, their indices, and every line the
flow printed; scores within 1e-5 (float32 sums in different orders).
Then each test keeps the original flow's own assertions on the port's
answer.
"""

import contextlib
import functools
import io
import json
import os

import numpy as np
import pytest

import hyperdb
import hyperdb_torch

DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "demo", "creatures.jsonl")
SCORE_ATOL = 1e-5

JAX_DB = hyperdb.HyperDB
TORCH_DB = functools.partial(hyperdb_torch.HyperDB, device="cpu")


def _demo_documents():
    with open(DEMO, "r") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def documents():
    return _demo_documents()


def _run(flow, tmp_path, documents):
    """Each package's answers and printed text for ``flow(HyperDB, dir, docs)``."""
    out = {}
    for name, cls in (("jax", JAX_DB), ("torch", TORCH_DB)):
        where = tmp_path / name
        where.mkdir()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            results = flow(cls, where, [json.loads(json.dumps(d)) for d in documents])
        out[name] = (results, buf.getvalue())
    (want, want_out), (got, got_out) = out["jax"], out["torch"]
    assert got_out == want_out
    assert len(got) == len(want)
    for g_rows, w_rows in zip(got, want):
        assert [(r[0], r[2]) for r in g_rows] == [(r[0], r[2]) for r in w_rows]
        for r in g_rows:
            assert isinstance(r, tuple) and len(r) == 3 and isinstance(r[1], float)
        np.testing.assert_allclose([r[1] for r in g_rows], [r[1] for r in w_rows],
                                   rtol=0, atol=SCORE_ATOL)
    return got, got_out


def _saved_and_loaded(db, path):
    db.save(str(path))
    db.load(str(path))
    return db


def test_basic_ingest_save_load_query(documents, tmp_path):
    def flow(HyperDB, where, docs):
        db = _saved_and_loaded(HyperDB(docs), where / "creatures_hyperdb.pickle.gz")
        return [db.query("Likes to sleep.", top_k=3)]

    (results,), _ = _run(flow, tmp_path, documents)
    assert len(results) == 3
    for document, similarity, index in results:
        assert isinstance(document, dict) and "name" in document
        assert 0 <= index < len(documents)


def test_select_keys_partial_embedding(documents, tmp_path):
    def flow(HyperDB, where, docs):
        db = _saved_and_loaded(HyperDB(docs, select_keys="name"), where / "sel_hyperdb.pickle.gz")
        return [db.query(docs[0]["name"], top_k=3)]

    (results,), _ = _run(flow, tmp_path, documents)
    assert len(results) == 3
    assert set(results[0][0].keys()) == {"name"}


def test_key_filter_query(documents, tmp_path):
    def flow(HyperDB, where, docs):
        db = _saved_and_loaded(HyperDB(docs), where / "key_hyperdb.pickle.gz")
        return [db.query(docs[0]["name"], top_k=3, filters=[("key", "info.description")])]

    (results,), _ = _run(flow, tmp_path, documents)
    assert len(results) == 3
    for document, similarity, index in results:
        assert "info" in document


def test_sentence_filter_single_survivor_messages(tmp_path):
    docs = [
        {"name": "A", "info": {"description": "Zanzibar's favorite thing."}},
        {"name": "B", "info": {"description": "A plain description."}},
        {"name": "C", "info": {"description": "Another plain description."}},
    ]

    def flow(HyperDB, where, docs):
        db = HyperDB(docs)
        return [db.query("thing", top_k=3, filters=[("sentence", "Zanzibar's")])]

    (results,), out = _run(flow, tmp_path, docs)
    assert (
        "Warning: top_k (3) is greater than the number of filtered "
        "documents (1). Setting top_k to 1." in out
    )
    assert "Info: Only one document left." in out
    assert len(results) == 1 and results[0][0]["name"] == "A"


def test_metadata_filter_query(documents, tmp_path):
    weakness = documents[0]["info"]["weakness"]

    def flow(HyperDB, where, docs):
        db = _saved_and_loaded(HyperDB(docs, metadata_keys=["info.weakness"]),
                               where / "meta_hyperdb.pickle.gz")
        return [db.query("creature", top_k=3, filters=[("metadata", {"info.weakness": weakness})])]

    (results,), _ = _run(flow, tmp_path, documents)
    expect = sum(1 for d in documents if d["info"]["weakness"] == weakness)
    assert len(results) == min(3, expect)
    for document, similarity, index in results:
        assert document["info"]["weakness"] == weakness


def test_skip_doc_on_string_documents(tmp_path):
    def flow(HyperDB, where, docs):
        db = HyperDB()
        db.add(["Document 1", "Document 2", "Document 3", "Document 4", "Document 5"])
        return [
            db.query("Some query text", top_k=2, filters=[("skip_doc", 2)]),
            db.query("Some query text", top_k=2, filters=[("skip_doc", -2)]),
            db.query("Some query text", top_k=2),
        ]

    (result_1, result_2, result_3), _ = _run(flow, tmp_path, [])
    assert len(result_1) == 2
    assert {r[0] for r in result_1} <= {"Document 3", "Document 4", "Document 5"}
    assert len(result_2) == 2
    assert {r[0] for r in result_2} <= {"Document 1", "Document 2", "Document 3"}
    assert len(result_3) == 2


def test_combined_filters(documents, tmp_path):
    weakness = documents[0]["info"]["weakness"]

    def flow(HyperDB, where, docs):
        db = _saved_and_loaded(HyperDB(docs, metadata_keys=["info.weakness"]),
                               where / "combo_hyperdb.pickle.gz")
        return [db.query("creature", top_k=3, filters=[
            ("metadata", {"info.weakness": weakness}),
            ("sentence", "creature"),
            ("key", "info.description"),
        ])]

    (results,), _ = _run(flow, tmp_path, documents)
    assert 1 <= len(results) <= 3
    for document, similarity, index in results:
        assert document["info"]["weakness"] == weakness
        assert "creature" in document["info"]["description"].lower()


def test_single_survivor_info_chunk_vs_key_filter(tmp_path):
    """The "Only one document left." line follows one score row: chunk rows on the
    plain path (a chunked survivor is silent), one averaged vector per
    document under the key filter (which prints)."""
    long_text = " ".join(f"word{i}" for i in range(1200)) + " zanzibar"
    docs = [
        {"name": "A", "info": {"description": long_text}},
        {"name": "B", "info": {"description": "plain text here"}},
    ]
    marker = "-- key filter --"

    def flow(HyperDB, where, docs):
        db = HyperDB(docs)
        assert len(db.source_indices) > len(db.documents)  # doc A chunked
        plain = db.query("zanzibar", top_k=1, filters=[("sentence", "zanzibar")])
        print(marker)
        keyed = db.query("zanzibar", top_k=1, filters=[
            ("sentence", "zanzibar"), ("key", "info.description")
        ])
        return [plain, keyed]

    (_, keyed), out = _run(flow, tmp_path, docs)
    before, after = out.split(marker)
    assert "Info: Only one document left." not in before
    assert "Info: Only one document left." in after
    assert keyed[0][0]["name"] == "A"
