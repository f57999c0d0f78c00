"""The port's stdlib HTTP server (``hyperdb_tpu_torch/server.py``) against
the JAX package's, over the same documents and vectors.

Each request goes to a JAX ``make_server`` and a port ``make_server``
(``device="cpu"``) over the same seeded corpus: statuses equal, ids and
documents equal, scores within ``ATOL`` (cosine over an f32 DB: the same
f32 rows summed in two orders). Error payloads need only the same status.
Every server binds port 0 and is closed by its fixture; every request and
join has a timeout. Sharded serving wraps a ``ShardedHyperDB`` over the
port's 8-shard CPU mesh beside the JAX one over its 8-device mesh.
"""

import concurrent.futures
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from hyperdb_tpu import HyperDB as JaxDB
from hyperdb_tpu.server import make_server as jax_make_server
from hyperdb_tpu_torch import HyperDB as TorchDB
from hyperdb_tpu_torch.query import engine as TENG
from hyperdb_tpu_torch.server import _DynamicBatcher
from hyperdb_tpu_torch.server import make_server

ATOL = 1e-6
TIMEOUT = 30


class _Served:
    """One stdlib server over a DB, on an ephemeral port, in a thread."""

    def __init__(self, factory, db, **kw):
        self.db = db
        self.httpd = factory(db, port=0, **kw)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        if self.httpd.batcher is not None:
            self.httpd.batcher.close()
        self.httpd.server_close()
        self.thread.join(timeout=TIMEOUT)
        assert not self.thread.is_alive()


def _pair(docs, vectors, metadata_keys=None, embedding_function=None, **kw):
    """A JAX and a port server over the same corpus: (jax, port)."""
    jdb = JaxDB(documents=[dict(d) for d in docs], vectors=vectors,
                metadata_keys=metadata_keys, embedding_function=embedding_function)
    tdb = TorchDB(documents=[dict(d) for d in docs], vectors=vectors,
                  metadata_keys=metadata_keys, embedding_function=embedding_function,
                  device="cpu")
    return _Served(jax_make_server, jdb, **kw), _Served(make_server, tdb, **kw)


def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=TIMEOUT) as resp:
        return resp.status, json.loads(resp.read())


def _post_binary(base, path, body):
    req = urllib.request.Request(
        base + path, data=body,
        headers={"Content-Type": "application/octet-stream"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _same_rows(got, want):
    """Result rows of one query: ids and documents equal, scores within ATOL."""
    assert [r["index"] for r in got] == [r["index"] for r in want]
    assert [r["document"] for r in got] == [r["document"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                               rtol=0, atol=ATOL)


def _both(pair, path, payload, method="POST"):
    """Send one request to both servers: ((status, body) jax, (status, body) port)."""
    if method == "GET":
        return _get(pair[0].base, path), _get(pair[1].base, path)
    return _post(pair[0].base, path, payload), _post(pair[1].base, path, payload)


@pytest.fixture(scope="module")
def served():
    rng = np.random.default_rng(0)
    n, d = 64, 16
    v = rng.standard_normal((n, d)).astype(np.float32)
    docs = [{"i": int(i), "grp": ["a", "b"][i % 2]} for i in range(n)]
    pair = _pair(docs, v, metadata_keys=["grp"])
    yield {"pair": pair, "db": pair[1].db, "base": pair[1].base, "vectors": v}
    for s in pair:
        s.close()


def test_healthz_and_stats(served):
    (js, jb), (ts, tb) = _both(served["pair"], "/healthz", None, "GET")
    assert js == ts == 200 and jb == tb == {"ok": True}
    (js, jb), (ts, tb) = _both(served["pair"], "/stats", None, "GET")
    assert js == ts == 200
    assert tb["documents"] == 64 and tb["dim"] == 16
    for key in ("documents", "chunks", "dim", "ann_metric", "index", "sharded"):
        assert tb[key] == jb[key], key
    assert "cache" in tb and "timers" in tb
    assert tb["cache"]["cache_info"].keys() == jb["cache"]["cache_info"].keys()


def test_query_matches_library(served):
    q = served["vectors"][7].tolist()
    (js, jb), (ts, tb) = _both(served["pair"], "/query", {"vector": q, "top_k": 5})
    assert js == ts == 200
    _same_rows(tb["results"], jb["results"])
    want = served["db"].query(np.asarray(q, dtype=np.float32), top_k=5)
    assert [r["index"] for r in tb["results"]] == [r[2] for r in want]
    assert tb["results"][0]["index"] == 7  # self-match first


def test_query_with_metadata_filter(served):
    q = served["vectors"][8].tolist()
    payload = {"vector": q, "top_k": 4, "filters": [["metadata", {"grp": "a"}]]}
    (js, jb), (ts, tb) = _both(served["pair"], "/query", payload)
    assert js == ts == 200
    _same_rows(tb["results"], jb["results"])
    assert all(r["document"]["grp"] == "a" for r in tb["results"])


def test_query_batch(served):
    qs = served["vectors"][:3].tolist()
    (js, jb), (ts, tb) = _both(served["pair"], "/query_batch", {"vectors": qs, "top_k": 3})
    assert js == ts == 200 and len(tb["results"]) == 3
    for i, (trow, jrow) in enumerate(zip(tb["results"], jb["results"])):
        _same_rows(trow, jrow)
        assert trow[0]["index"] == i  # each self-match wins its row


def test_error_paths(served):
    (js, jb), (ts, tb) = _both(served["pair"], "/query", {"top_k": 3})
    assert js == ts == 400 and "missing field" in tb["error"] and tb == jb
    (js, _), (ts, tb) = _both(served["pair"], "/query",
                              {"vector": [0.0] * 16, "metric": "bogus"})
    assert js == ts == 400
    (js, _), (ts, _) = _both(served["pair"], "/stats", None, "GET")
    assert js == ts == 200  # both still alive after errors


def test_query_ann_percent_passthrough(served):
    q = served["vectors"][5].tolist()
    (js, jb), (ts, tb) = _both(served["pair"], "/query",
                               {"vector": q, "top_k": 3, "ann_percent": 20})
    assert js == ts == 200
    _same_rows(tb["results"], jb["results"])
    assert tb["results"][0]["index"] == 5


def test_concurrent_queries(served):
    """8 threads x 4 queries: the engine lock serializes correctly and every
    response matches the JAX server's answer to its own query vector."""
    v = served["vectors"]
    jbase = served["pair"][0].base
    want = {i: _post(jbase, "/query", {"vector": v[i].tolist(), "top_k": 4})[1]["results"]
            for i in range(8)}

    def one(i):
        status, body = _post(served["base"], "/query", {"vector": v[i].tolist(), "top_k": 4})
        assert status == 200
        return i, body["results"]

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        futures = [pool.submit(one, i % 8) for i in range(32)]
        for fut in concurrent.futures.as_completed(futures, timeout=120):
            i, got = fut.result()
            _same_rows(got, want[i])


def test_sharded_serving_matches_host_db(served):
    """The server duck-types ShardedHyperDB: /stats says sharded, and
    /query answers as the single-device DB and the JAX sharded server do."""
    import jax
    from jax.sharding import Mesh

    from hyperdb_tpu.parallel.sharded_db import ShardedHyperDB as JaxSharded
    from hyperdb_tpu_torch.parallel import make_mesh
    from hyperdb_tpu_torch.parallel.sharded_db import ShardedHyperDB

    jdb, tdb = served["pair"][0].db, served["pair"][1].db
    pair = (
        _Served(jax_make_server, JaxSharded(jdb, Mesh(np.array(jax.devices()), ("data",)))),
        _Served(make_server, ShardedHyperDB(tdb, make_mesh(8, device="cpu"))),
    )
    try:
        (js, jb), (ts, tb) = _both(pair, "/stats", None, "GET")
        assert js == ts == 200 and jb["sharded"] is True and tb["sharded"] is True
        assert tb["documents"] == jb["documents"] == 64
        q = served["vectors"][11].tolist()
        (js, jb), (ts, tb) = _both(pair, "/query", {"vector": q, "top_k": 5})
        assert js == ts == 200
        _same_rows(tb["results"], jb["results"])
        want = tdb.query(np.asarray(q, dtype=np.float32), top_k=5)
        assert [r["index"] for r in tb["results"]] == [r[2] for r in want]
    finally:
        for s in pair:
            s.close()


@pytest.fixture()
def batched_server(served):
    srv = _Served(make_server, served["db"], dynamic_batch_ms=15.0, max_batch=16)
    yield {"httpd": srv.httpd, "base": srv.base}
    srv.close()


def test_dynamic_batching_coalesces_and_is_correct(served, batched_server, monkeypatch):
    """Concurrent identical-parameter vector queries coalesce into fewer
    query_batch calls AND each request gets the JAX engine's own answer."""
    db = served["db"]
    jdb = served["pair"][0].db
    calls = []
    real = db.query_batch

    def counting(q, **kw):
        calls.append(np.asarray(q).shape[0])
        return real(q, **kw)

    monkeypatch.setattr(db, "query_batch", counting)
    v = served["vectors"]
    want = {i: [r[2] for r in jdb.query(v[i], top_k=4)] for i in range(12)}
    base = batched_server["base"]

    def one(i):
        status, body = _post(base, "/query", {"vector": v[i].tolist(), "top_k": 4})
        assert status == 200
        return i, [r["index"] for r in body["results"]]

    with concurrent.futures.ThreadPoolExecutor(max_workers=12) as pool:
        futures = [pool.submit(one, i) for i in range(12)]
        for fut in concurrent.futures.as_completed(futures, timeout=120):
            i, got = fut.result()
            assert got == want[i], i
    assert sum(calls) >= 12
    assert len(calls) < 12, calls
    # mixed top_k values share a batch: queried at the max, sliced exactly
    status, body = _post(base, "/query", {"vector": v[0].tolist(), "top_k": 2})
    assert status == 200 and [r["index"] for r in body["results"]] == want[0][:2]


def test_dynamic_batching_mixed_top_k(served, batched_server):
    """Requests differing only in top_k coalesce and each gets its own
    exact prefix of the JAX engine's answer."""
    jdb = served["pair"][0].db
    v = served["vectors"]
    ks = [2, 4, 6, 3, 5, 4, 2, 6]
    want = {i: [r[2] for r in jdb.query(v[i], top_k=ks[i])] for i in range(8)}

    def one(i):
        status, body = _post(batched_server["base"], "/query",
                             {"vector": v[i].tolist(), "top_k": ks[i]})
        assert status == 200
        return i, [r["index"] for r in body["results"]]

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        for fut in concurrent.futures.as_completed(
            [pool.submit(one, i) for i in range(8)], timeout=120
        ):
            i, got = fut.result()
            assert got == want[i], (i, ks[i])


def test_dynamic_batching_error_propagates(batched_server, served):
    status, body = _post(batched_server["base"], "/query", {"vector": [0.0] * 99, "top_k": 2})
    jstatus, jbody = _post(served["pair"][0].base, "/query", {"vector": [0.0] * 99, "top_k": 2})
    assert status == jstatus == 400 and "dimension" in body["error"]
    status, _ = _get(batched_server["base"], "/healthz")
    assert status == 200


def test_null_top_k_returns_400(served):
    """{"top_k": null} (int(None) -> TypeError) is a 400, not a dropped
    connection, in both packages."""
    (js, _), (ts, _) = _both(served["pair"], "/query", {"vector": [0.0] * 16, "top_k": None})
    assert js == ts == 400
    status, _ = _get(served["base"], "/stats")
    assert status == 200


def test_batcher_submit_after_close_serves_directly(served):
    """A submit() racing past close() falls back to a direct query instead
    of waiting forever on an event nobody sets."""
    db = served["db"]
    batcher = _DynamicBatcher(db, threading.Lock(), max_batch=64, window_ms=2.0)
    batcher.close()
    v = served["vectors"][3]
    result = batcher.submit(v, 4, "cosine_similarity", None, 0, None)
    expected = served["pair"][0].db.query_batch(v[None, :], top_k=4)[0]
    assert [r[2] for r in result] == [r[2] for r in expected]


def test_binary_query_matches_json(served):
    """POST /query with a raw f32 body returns the JSON surface's ids and
    scores without documents, in both packages."""
    v = served["vectors"]
    for base in (served["pair"][0].base, served["base"]):
        status, want = _post(base, "/query", {"vector": v[9].tolist(), "top_k": 4})
        assert status == 200
        status, got = _post_binary(base, "/query?top_k=4", v[9].tobytes())
        assert status == 200
        assert got["ids"] == [r["index"] for r in want["results"]]
        np.testing.assert_allclose(got["scores"], [r["score"] for r in want["results"]],
                                   rtol=0, atol=ATOL)
        # wrong byte count -> 400, not a crash or a hung connection
        status, err = _post_binary(base, "/query?top_k=4", v[9].tobytes()[:-4])
        assert status == 400 and "error" in err
    jgot = _post_binary(served["pair"][0].base, "/query?top_k=4", v[9].tobytes())[1]
    tgot = _post_binary(served["base"], "/query?top_k=4", v[9].tobytes())[1]
    assert tgot["ids"] == jgot["ids"]
    np.testing.assert_allclose(tgot["scores"], jgot["scores"], rtol=0, atol=ATOL)


def test_binary_query_through_dynamic_batcher():
    rng = np.random.default_rng(5)
    v = rng.standard_normal((32, 8)).astype(np.float32)
    pair = _pair([{"i": int(i)} for i in range(32)], v, dynamic_batch_ms=2.0)
    try:
        outs = [_post_binary(s.base, "/query?top_k=1", v[3].tobytes()) for s in pair]
        assert outs[0][0] == outs[1][0] == 200
        assert outs[1][1]["ids"] == outs[0][1]["ids"] == [3]
    finally:
        for s in pair:
            s.close()


def _concurrently(fn, n):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)


def test_text_queries_batch_through_dynamic_batcher():
    """Text /query requests coalesce: one encoder pass per flush, answers
    exact per request, and text and vector requests share a device batch."""
    rng = np.random.default_rng(9)
    n, d = 64, 12
    v = rng.standard_normal((n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    calls = []

    def fake_embed(texts):
        calls.append(len(texts))
        return np.stack([v[int(t.split()[-1])] for t in texts]), list(range(len(texts))), {}

    tdb = TorchDB(documents=[{"i": int(i)} for i in range(n)], vectors=v,
                  embedding_function=fake_embed, device="cpu")
    srv = _Served(make_server, tdb, dynamic_batch_ms=20.0, max_batch=32)
    try:
        results = {}

        def one(i):
            payload = ({"vector": v[i].tolist(), "top_k": 1} if i % 3 == 0
                       else {"text": f"doc {i}", "top_k": 1})
            results[i] = _post(srv.base, "/query", payload)

        _concurrently(one, 12)
        for i in range(12):
            status, out = results[i]
            assert status == 200 and out["results"][0]["index"] == i
        n_text = sum(1 for i in range(12) if i % 3 != 0)
        assert sum(calls) == n_text
        assert len(calls) < n_text
    finally:
        srv.close()


def test_text_dim_mismatch_fails_only_that_entry():
    """A text query whose embedding has the wrong dimension gets a 400 alone;
    vector requests sharing its coalesced group still answer."""
    rng = np.random.default_rng(17)
    n, d = 32, 12
    v = rng.standard_normal((n, d)).astype(np.float32)

    def bad_embed(texts):
        return np.zeros((len(texts), d + 5), dtype=np.float32), list(range(len(texts))), {}

    tdb = TorchDB(documents=[{"i": int(i)} for i in range(n)], vectors=v,
                  embedding_function=bad_embed, device="cpu")
    srv = _Served(make_server, tdb, dynamic_batch_ms=30.0, max_batch=8)
    try:
        results = {}

        def one(i):
            payload = ({"text": "anything", "top_k": 1} if i == 0
                       else {"vector": v[i].tolist(), "top_k": 1})
            results[i] = _post(srv.base, "/query", payload)

        _concurrently(one, 4)
        status0, out0 = results[0]
        assert status0 == 400 and "dimension" in out0["error"]
        for i in range(1, 4):
            status, out = results[i]
            assert status == 200 and out["results"][0]["index"] == i
    finally:
        srv.close()


def test_add_and_remove_over_http():
    """/add and /remove mutate the corpus the same way in both packages;
    queries see the change."""
    rng = np.random.default_rng(23)
    n, d = 16, 8
    v = rng.standard_normal((n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pair = _pair([{"i": int(i)} for i in range(n)], v)
    try:
        new_vec = rng.standard_normal(d).astype(np.float32)
        new_vec /= np.linalg.norm(new_vec)
        (js, jb), (ts, tb) = _both(pair, "/add", {"documents": [{"i": 999}],
                                                  "vectors": [new_vec.tolist()]})
        assert js == ts == 200 and tb == jb == {"added": 1, "documents": n + 1}
        (js, jb), (ts, tb) = _both(pair, "/query", {"vector": new_vec.tolist(), "top_k": 3})
        assert js == ts == 200 and tb["results"][0]["document"]["i"] == 999
        _same_rows(tb["results"], jb["results"])
        (js, jb), (ts, tb) = _both(pair, "/remove", {"indices": [n]})
        assert js == ts == 200 and tb == jb == {"documents": n}
        (js, jb), (ts, tb) = _both(pair, "/query", {"vector": new_vec.tolist(), "top_k": 3})
        assert tb["results"][0]["document"]["i"] != 999
        _same_rows(tb["results"], jb["results"])
    finally:
        for s in pair:
            s.close()


def test_add_over_http_native_front_end():
    from hyperdb_tpu_torch.native.server import NativeQueryServer

    import http.client

    rng = np.random.default_rng(29)
    n, d = 16, 8
    v = rng.standard_normal((n, d)).astype(np.float32)
    db = TorchDB(documents=[{"i": int(i)} for i in range(n)], vectors=v, device="cpu")
    with NativeQueryServer(db, port=0) as srv:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=TIMEOUT)
        vec = rng.standard_normal(d).astype(np.float32)
        payload = json.dumps({"documents": [{"i": 777}], "vectors": [vec.tolist()]}).encode()
        conn.request("POST", "/add", payload, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = json.loads(resp.read())
        conn.close()
    assert resp.status == 200 and out["documents"] == n + 1
    assert db.documents[-1] == {"i": 777}


def test_remove_negative_and_out_of_range():
    """-1 removes the last document with consistent chunk bookkeeping;
    out of range is a 400, not a dropped connection (both packages)."""
    rng = np.random.default_rng(31)
    n, d = 6, 8
    v = rng.standard_normal((n, d)).astype(np.float32)
    pair = _pair([{"i": int(i)} for i in range(n)], v)
    try:
        (js, jb), (ts, tb) = _both(pair, "/remove", {"indices": [-1]})
        assert js == ts == 200 and tb == jb == {"documents": n - 1}
        db = pair[1].db
        assert len(db.documents) == n - 1
        assert db.source_indices == list(range(n - 1)) == pair[0].db.source_indices
        (js, _), (ts, tb) = _both(pair, "/remove", {"indices": [99]})
        assert js == ts == 400 and "out of range" in tb["error"]
        assert len(db.documents) == n - 1
    finally:
        for s in pair:
            s.close()


def test_add_validation_and_failure_surface():
    """Wrong-dimension or miscounted vectors get a 400 before anything
    mutates, in both packages."""
    rng = np.random.default_rng(37)
    n, d = 4, 6
    v = rng.standard_normal((n, d)).astype(np.float32)
    pair = _pair([{"i": int(i)} for i in range(n)], v)
    try:
        (js, jb), (ts, tb) = _both(pair, "/add", {"documents": [{"i": 10}],
                                                  "vectors": [[1.0, 2.0]]})
        assert js == ts == 400 and "dimension" in tb["error"] and tb == jb
        (js, jb), (ts, tb) = _both(pair, "/add", {"documents": [{"i": 10}, {"i": 11}],
                                                  "vectors": [np.zeros(d).tolist()]})
        assert js == ts == 400 and "does not match 2 document" in tb["error"] and tb == jb
        assert len(pair[1].db.documents) == n == len(pair[0].db.documents)
    finally:
        for s in pair:
            s.close()


def test_text_query_through_the_hash_embedder():
    """Text /query against DBs built from text with the default embedder
    (the hash encoder in the tests): the same documents, ids and scores."""
    docs = [{"name": f"n{i}", "text": f"topic {i} about {['fire', 'water', 'grass'][i % 3]}"}
            for i in range(24)]
    jdb = JaxDB(documents=[dict(d) for d in docs])
    tdb = TorchDB(documents=[dict(d) for d in docs], device="cpu")
    np.testing.assert_array_equal(np.asarray(tdb.vectors), np.asarray(jdb.vectors))
    for kw in ({}, {"dynamic_batch_ms": 5.0}):
        pair = (_Served(jax_make_server, jdb, **kw), _Served(make_server, tdb, **kw))
        try:
            for text in ("topic 5 about grass", "water"):
                (js, jb), (ts, tb) = _both(pair, "/query", {"text": text, "top_k": 5})
                assert js == ts == 200
                _same_rows(tb["results"], jb["results"])
        finally:
            for s in pair:
                s.close()


def test_f16_wire_on_a_float16_db():
    """A float16 DB flips the batcher to float16 query blocks in both
    packages; the block rounds f32 -> f16 -> bf16 as in JAX, so answers
    equal the JAX server's."""
    rng = np.random.default_rng(41)
    n, d = 2048, 16
    v = rng.standard_normal((n, d)).astype(np.float16).astype(np.float32)
    q = rng.standard_normal((6, d)).astype(np.float32)
    jdb = JaxDB(documents=[{"i": i} for i in range(n)], vectors=v, fp_precision="float16")
    tdb = TorchDB(documents=[{"i": i} for i in range(n)], vectors=v, fp_precision="float16",
                  device="cpu")
    pair = (_Served(jax_make_server, jdb, dynamic_batch_ms=2.0),
            _Served(make_server, tdb, dynamic_batch_ms=2.0))
    try:
        assert pair[1].httpd.batcher._wire_f16 and pair[0].httpd.batcher._wire_f16
        for row in q:
            jgot = _post_binary(pair[0].base, "/query?top_k=5", row.tobytes())[1]
            tgot = _post_binary(pair[1].base, "/query?top_k=5", row.tobytes())[1]
            assert tgot["ids"] == jgot["ids"]
            np.testing.assert_allclose(tgot["scores"], jgot["scores"], rtol=0, atol=1e-5)
    finally:
        for s in pair:
            s.close()


def test_batcher_all_text_flush_takes_device_path(monkeypatch):
    """Twin of test_text_device_path.py's case: an all-text flush over a DB
    that embeds through the default pipeline chains the encoder's block
    into the scan (generate_query_vectors_batch_device + n_valid), with no
    host embedding pass; each query's top-1 is its own document."""
    from hyperdb_tpu_torch.core import chunker
    from hyperdb_tpu_torch.models.embedder import make_embedding_function
    from hyperdb_tpu_torch.models.minilm import EncoderConfig, MiniLMEmbedder

    corpus = ["alpha beta gamma", "delta epsilon zeta", "eta theta iota",
              "kappa lambda mu", "nu xi omicron", "pi rho sigma"]
    enc = MiniLMEmbedder(config=EncoderConfig(hidden=64, layers=1, heads=2, intermediate=128),
                         device="cpu")
    db = TorchDB(documents=list(corpus),
                 embedding_function=make_embedding_function(enc, chunker.default_tokenizer()),
                 device="cpu")
    calls = {"device": 0, "host": 0}
    real_dev, real_host = TENG.generate_query_vectors_batch_device, TENG.generate_query_vectors_batch

    def spy_dev(d, texts):
        calls["device"] += 1
        return real_dev(d, texts)

    def spy_host(d, texts):
        calls["host"] += 1
        return real_host(d, texts)

    monkeypatch.setattr(TENG, "generate_query_vectors_batch_device", spy_dev)
    monkeypatch.setattr(TENG, "generate_query_vectors_batch", spy_host)
    batcher = _DynamicBatcher(db, threading.Lock(), max_batch=3, window_ms=50)
    try:
        results = [None] * 3

        def run(i):
            results[i] = batcher.submit(None, 2, "cosine_similarity", None, 0.0, None,
                                        text=corpus[i])

        _concurrently(run, 3)
        assert calls["device"] >= 1 and calls["host"] == 0
        for i, rows in enumerate(results):
            assert rows is not None and len(rows) == 2
            assert rows[0][2] == i
    finally:
        batcher.close()
