"""The port's native epoll front end (``hyperdb_tpu_torch/native/server.cc``
+ ``native/server.py``) against the JAX package's, over the same corpus.

The whole wire surface runs against a live port engine on the CPU: the
binary hot path (JSON and binary responses), batching under real
concurrency (answers must equal the exact oracle however requests
coalesced), the shared JSON dispatcher on the generic path, error mapping,
keep-alive and pipelining, and clean shutdown. Where a request has one
answer, the JAX native server over the same DB gets the same request: ids
equal, scores within ``ATOL`` (the C++ side prints JSON scores with
``%.7g``, and the two engines sum the same f32 rows in different orders).
A ``ShardedHyperDB`` over the port's 8-shard CPU mesh is served the same
way, beside the JAX one over its 8-device mesh.
"""

import http.client
import json
import socket
import struct
import threading

import numpy as np
import pytest

from hyperdb_tpu import HyperDB as JaxDB
from hyperdb_tpu.native import server as jax_native_server
from hyperdb_tpu.query import engine as JENG
from hyperdb_tpu_torch import HyperDB as TorchDB
from hyperdb_tpu_torch.native import server as native_server
from hyperdb_tpu_torch.native import tokenizer as native_lib
from hyperdb_tpu_torch.query import engine as TENG

N, D = 4096, 32
ATOL = 1e-6
TIMEOUT = 30


@pytest.fixture(scope="module")
def served():
    rng = np.random.default_rng(7)
    v = rng.standard_normal((N, D)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    docs = [{"i": int(i), "grp": ["a", "b"][i % 2]} for i in range(N)]
    db = TorchDB(documents=[dict(d) for d in docs], vectors=v, metadata_keys=["grp"], device="cpu")
    jdb = JaxDB(documents=[dict(d) for d in docs], vectors=v, metadata_keys=["grp"])
    srv = native_server.NativeQueryServer(db, port=0, max_batch=32, window_ms=2.0)
    jsrv = jax_native_server.NativeQueryServer(jdb, port=0, max_batch=32, window_ms=2.0)
    yield {"db": db, "srv": srv, "vectors": v, "port": srv.port, "jax_port": jsrv.port}
    srv.close()
    jsrv.close()


def _conn(port):
    return http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)


def _binary_query(conn, vec, top_k=5, metric=None, binary_out=False):
    path = f"/query?top_k={top_k}"
    if metric:
        path += f"&metric={metric}"
    headers = {"Content-Type": "application/octet-stream"}
    if binary_out:
        headers["Accept"] = "application/octet-stream"
    conn.request("POST", path, vec.astype(np.float32).tobytes(), headers)
    resp = conn.getresponse()
    body = resp.read()
    if resp.status != 200:
        return resp.status, json.loads(body)
    if binary_out:
        k = struct.unpack("<I", body[:4])[0]
        ids = np.frombuffer(body[4:4 + 8 * k], dtype=np.int64)
        scores = np.frombuffer(body[4 + 8 * k:], dtype=np.float32)
        return 200, {"ids": ids.tolist(), "scores": scores.tolist()}
    return 200, json.loads(body)


def _both_binary(served, vec, **kw):
    """One binary query on a fresh connection to each server: (port, jax)."""
    out = []
    for port in (served["port"], served["jax_port"]):
        conn = _conn(port)
        out.append(_binary_query(conn, vec, **kw))
        conn.close()
    return out


def _same(got, want):
    assert got[0] == want[0] == 200, (got, want)
    assert got[1]["ids"] == want[1]["ids"]
    np.testing.assert_allclose(got[1]["scores"], want[1]["scores"], rtol=0, atol=ATOL)


def _oracle_ids(v, q, k):
    qn = q / np.linalg.norm(q)
    return np.argsort(-(v @ qn), kind="stable")[:k]


def _read_responses(sock, count):
    """Read ``count`` pipelined responses: [(status, body bytes)]."""
    buf, out = b"", []
    for _ in range(count):
        while b"\r\n\r\n" not in buf:
            chunk = sock.recv(65536)
            assert chunk, "server closed mid-pipeline"
            buf += chunk
        head, rest = buf.split(b"\r\n\r\n", 1)
        clen = 0
        for line in head.split(b"\r\n")[1:]:
            if line[:15].lower() == b"content-length:":
                clen = int(line[15:])
        while len(rest) < clen:
            chunk = sock.recv(65536)
            assert chunk
            rest += chunk
        out.append((int(head.split(b" ", 2)[1]), rest[:clen]))
        buf = rest[clen:]
    return out


def _pipeline(port, requests):
    sock = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        sock.sendall(b"".join(requests))
        return _read_responses(sock, len(requests))
    finally:
        sock.close()


def _req(path, body, ctype="application/octet-stream"):
    return (
        f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Type: {ctype}\r\n"
        f"Content-Length: {len(body)}\r\n\r\n"
    ).encode() + body


def test_healthz_inline(served):
    conn = _conn(served["port"])
    conn.request("GET", "/healthz")
    resp = conn.getresponse()
    assert resp.status == 200 and json.loads(resp.read()) == {"ok": True}
    assert resp.getheader("Server") == "hyperdb-tpu-torch-native"
    conn.close()


def test_binary_query_json_response(served):
    q = served["vectors"][11] + 0.01
    got, want = _both_binary(served, q, top_k=7)
    _same(got, want)
    assert got[1]["ids"] == _oracle_ids(served["vectors"], q, 7).tolist()
    assert got[1]["scores"] == sorted(got[1]["scores"], reverse=True)


def test_binary_query_binary_response(served):
    q = served["vectors"][42] + 0.01
    got, want = _both_binary(served, q, top_k=5, binary_out=True)
    _same(got, want)
    assert got[1]["ids"] == _oracle_ids(served["vectors"], q, 5).tolist()
    rows = served["db"].query_batch(q[None, :], top_k=5)[0]
    np.testing.assert_array_equal(got[1]["scores"], np.float32([r[1] for r in rows]))


def test_keep_alive_reuse(served):
    conn = _conn(served["port"])
    for i in (3, 1000, 2048):
        q = served["vectors"][i] + 0.01
        status, out = _binary_query(conn, q, top_k=1)
        assert status == 200 and out["ids"][0] == _oracle_ids(served["vectors"], q, 1)[0]
    conn.close()


def test_generic_json_paths(served):
    q = served["vectors"][9].tolist()
    outs = []
    for port in (served["port"], served["jax_port"]):
        conn = _conn(port)
        got = []
        for payload in ({"vector": q, "top_k": 3},
                        {"vector": q, "top_k": 3, "filters": [["metadata", {"grp": "a"}]]}):
            conn.request("POST", "/query", json.dumps(payload).encode(),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            got.append((resp.status, json.loads(resp.read())))
        conn.request("GET", "/stats")
        resp = conn.getresponse()
        got.append((resp.status, json.loads(resp.read())))
        conn.close()
        outs.append(got)
    (plain, filtered, stats), (jplain, jfiltered, jstats) = outs
    assert plain[0] == filtered[0] == stats[0] == 200
    assert [r["index"] for r in plain[1]["results"]] == _oracle_ids(
        served["vectors"], np.asarray(q), 3).tolist()
    assert all(r["document"]["grp"] == "a" for r in filtered[1]["results"])
    for mine, theirs in ((plain, jplain), (filtered, jfiltered)):
        assert [r["index"] for r in mine[1]["results"]] == [r["index"] for r in theirs[1]["results"]]
        assert [r["document"] for r in mine[1]["results"]] == [
            r["document"] for r in theirs[1]["results"]]
        np.testing.assert_allclose([r["score"] for r in mine[1]["results"]],
                                   [r["score"] for r in theirs[1]["results"]], atol=ATOL)
    assert stats[1]["documents"] == N and stats[1]["dim"] == D
    # the JAX block, plus the time the port's worker spends handing a
    # flush's answers back to the C++ side
    assert set(jstats[1]["native"]) == {
        "flushes", "queries", "mean_flush", "max_flush", "engine_ms_per_flush",
        "engine_s", "idle_s"}
    assert set(stats[1]["native"]) == set(jstats[1]["native"]) | {"complete_ms_per_flush"}
    assert stats[1]["native"]["flushes"] > 0 and stats[1]["native"]["complete_ms_per_flush"] >= 0


def test_error_mapping(served):
    q = served["vectors"][0]
    for port in (served["port"], served["jax_port"]):
        conn = _conn(port)
        conn.request("POST", "/query?top_k=5", b"xyz",
                     {"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        assert resp.status == 400 and b"corpus dimension" in resp.read()
        status, out = _binary_query(conn, q, top_k=5, metric="bogus")
        assert status == 400 and "Invalid metric" in out["error"]
        conn.request("POST", "/query?top_k=0", q.tobytes(),
                     {"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        assert resp.status == 400 and b"top_k" in resp.read()
        conn.request("POST", "/query", b"{oops", {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 400 and b"bad JSON" in resp.read()
        conn.request("GET", "/nope")
        resp = conn.getresponse()
        assert resp.status == 404
        resp.read()
        conn.close()


def test_concurrent_batching_matches_oracle(served):
    """32 threads x 8 requests with mixed top_k: every response is the exact
    per-query answer however the C++ batcher grouped them."""
    v = served["vectors"]
    errors = []

    def worker(tid):
        rng = np.random.default_rng(3 + tid)
        try:
            conn = _conn(served["port"])
            for j in range(8):
                q = v[int(rng.integers(0, N))] + 0.01
                k = [1, 3, 5, 9][(tid + j) % 4]
                status, out = _binary_query(conn, q, top_k=k, binary_out=j % 2 == 0)
                assert status == 200, out
                assert out["ids"] == _oracle_ids(v, q, k).tolist(), (tid, j, k)
            conn.close()
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert served["srv"].max_flush > 1  # requests did coalesce


def test_mixed_metrics_are_not_coalesced(served):
    """Concurrent requests with different metrics never share a batch;
    both come back correct and equal to the JAX server's."""
    v = served["vectors"]
    q = v[77] + 0.01
    out = {}

    def ask(metric):
        out[metric] = _both_binary(served, q, top_k=3, metric=metric)

    threads = [threading.Thread(target=ask, args=(m,))
               for m in ("cosine_similarity", "dot_product")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for m in out:
        _same(*out[m])
    assert out["cosine_similarity"][0][1]["ids"] == _oracle_ids(v, q, 3).tolist()
    assert out["dot_product"][0][1]["ids"] == np.argsort(-(v @ q), kind="stable")[:3].tolist()


def test_close_unblocks_and_is_idempotent():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((256, 8)).astype(np.float32)
    db = TorchDB(documents=[{"i": int(i)} for i in range(256)], vectors=v, device="cpu")
    srv = native_server.NativeQueryServer(db, port=0)
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
    conn.request("GET", "/healthz")
    assert conn.getresponse().status == 200
    conn.close()
    srv.close()
    srv.close()  # a second close is a no-op
    assert not srv._worker.is_alive()


def test_failed_library_build_raises(monkeypatch):
    """No quiet fallback: a host library that cannot be built makes the
    server's constructor raise with the build's error."""
    rng = np.random.default_rng(1)
    v = rng.standard_normal((16, 8)).astype(np.float32)
    db = TorchDB(documents=[{"i": i} for i in range(16)], vectors=v, device="cpu")

    def broken():
        raise RuntimeError("building the native host library failed: test")

    monkeypatch.setattr(native_lib, "load", broken)
    with pytest.raises(RuntimeError, match="native host library failed"):
        native_server.NativeQueryServer(db, port=0)


def test_port_in_use_raises():
    rng = np.random.default_rng(2)
    v = rng.standard_normal((16, 8)).astype(np.float32)
    db = TorchDB(documents=[{"i": i} for i in range(16)], vectors=v, device="cpu")
    with native_server.NativeQueryServer(db, port=0) as srv:
        with pytest.raises(OSError, match="could not bind"):
            native_server.NativeQueryServer(db, port=srv.port)


def test_native_server_wraps_sharded_db():
    """The native front end serves a ShardedHyperDB through its
    query_batch_arrays; answers equal the oracle and the JAX sharded
    server's, and /stats says sharded."""
    import jax
    from jax.sharding import Mesh

    from hyperdb_tpu.parallel.sharded_db import ShardedHyperDB as JaxSharded
    from hyperdb_tpu_torch.parallel import make_mesh
    from hyperdb_tpu_torch.parallel.sharded_db import ShardedHyperDB

    rng = np.random.default_rng(5)
    v = rng.standard_normal((512, 16)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    docs = [{"i": int(i)} for i in range(512)]
    sdb = ShardedHyperDB(TorchDB(documents=docs, vectors=v, device="cpu"),
                         make_mesh(8, device="cpu"))
    jsdb = JaxSharded(JaxDB(documents=[dict(d) for d in docs], vectors=v),
                      Mesh(np.array(jax.devices()), ("data",)))
    srv = native_server.NativeQueryServer(sdb, port=0, max_batch=8)
    jsrv = jax_native_server.NativeQueryServer(jsdb, port=0, max_batch=8)
    try:
        q = v[33] + 0.01
        got, want = _both_binary({"port": srv.port, "jax_port": jsrv.port}, q, top_k=4)
        _same(got, want)
        assert got[1]["ids"] == _oracle_ids(v, q, 4).tolist()
        conn = _conn(srv.port)
        conn.request("GET", "/stats")
        st = json.loads(conn.getresponse().read())
        assert st["sharded"] is True and st["documents"] == 512
        conn.close()
    finally:
        srv.close()
        jsrv.close()


# ---------------------------------------------------------------------------
# text/plain hot path (tag 3): one encoder pass per flush, then the same
# array-level engine call as the binary path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served_text():
    rng = np.random.default_rng(11)
    v = rng.standard_normal((512, 24)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    calls = []  # one entry per encoder pass -> proves batching

    def fake_embed(texts):
        calls.append(len(texts))
        return np.stack([v[int(t.split()[-1])] for t in texts]), list(range(len(texts))), {}

    db = TorchDB(documents=[{"i": int(i)} for i in range(512)], vectors=v,
                 embedding_function=fake_embed, device="cpu")
    srv = native_server.NativeQueryServer(db, port=0, max_batch=16, window_ms=4.0)
    yield {"db": db, "srv": srv, "vectors": v, "port": srv.port, "calls": calls}
    srv.close()


def _text_query(conn, text, top_k=5, binary_out=False):
    headers = {"Content-Type": "text/plain"}
    if binary_out:
        headers["Accept"] = "application/octet-stream"
    conn.request("POST", f"/query?top_k={top_k}", text.encode(), headers)
    resp = conn.getresponse()
    body = resp.read()
    if resp.status != 200:
        return resp.status, json.loads(body)
    if binary_out:
        k = struct.unpack("<I", body[:4])[0]
        ids = np.frombuffer(body[4:4 + 8 * k], dtype=np.int64)
        return 200, {"ids": ids.tolist()}
    return 200, json.loads(body)


def test_text_query_roundtrip(served_text):
    v = served_text["vectors"]
    conn = _conn(served_text["port"])
    status, out = _text_query(conn, "doc 37", top_k=3)
    assert status == 200 and out["ids"] == _oracle_ids(v, v[37], 3).tolist()
    status, out = _text_query(conn, "doc 99", top_k=2, binary_out=True)
    assert status == 200 and out["ids"][0] == 99
    conn.close()


def test_text_queries_coalesce_one_encoder_pass(served_text):
    """Concurrent text queries flush together: fewer encoder calls than
    requests, and every answer exact."""
    served_text["calls"].clear()
    results = {}

    def one(i):
        conn = _conn(served_text["port"])
        results[i] = _text_query(conn, f"doc {i}", top_k=1)
        conn.close()

    threads = [threading.Thread(target=one, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for i in range(12):
        status, out = results[i]
        assert status == 200 and out["ids"][0] == i
    assert len(served_text["calls"]) < 12
    assert sum(served_text["calls"]) == 12


def test_text_query_errors(served_text):
    conn = _conn(served_text["port"])
    conn.request("POST", "/query?top_k=3", b"", {"Content-Type": "text/plain"})
    resp = conn.getresponse()
    assert resp.status == 400
    resp.read()
    status, out = _text_query(conn, "not a number")  # the embedder fails: 400 the batch
    assert status == 400 and "error" in out
    status, out = _text_query(conn, "doc 5", top_k=1)
    assert status == 200 and out["ids"] == [5]
    conn.close()


def test_generate_query_vectors_batch_chunk_mean():
    """Multi-chunk query embeddings average their chunks, as in JAX."""
    d = 8

    def fake_embed(texts):
        rows, src = [], []
        for i, t in enumerate(texts):
            if t == "b":
                rows += [np.full(d, 2.0), np.full(d, 4.0)]
                src += [i, i]
            else:
                rows.append(np.ones(d))
                src.append(i)
        return np.stack(rows).astype(np.float32), src, {}

    class FakeDB:
        dim = d
        embedding_function = staticmethod(fake_embed)

    out = TENG.generate_query_vectors_batch(FakeDB, ["a", "b", "a"])
    assert out.shape == (3, d)
    np.testing.assert_array_equal(out, JENG.generate_query_vectors_batch(FakeDB, ["a", "b", "a"]))
    np.testing.assert_allclose(out[1], np.full(d, 3.0))


def test_f16_wire_auto_on_f16_store_exact():
    """A float16 store flips the server to float16 wire blocks; with
    f16-representable corpus and queries the answers stay exact and equal
    the JAX server's."""
    rng = np.random.default_rng(21)
    v16 = rng.standard_normal((1024, 32)).astype(np.float16)
    v = v16.astype(np.float32)
    docs = [{"i": int(i)} for i in range(1024)]
    db = TorchDB(documents=docs, vectors=v, fp_precision="float16", device="cpu")
    jdb = JaxDB(documents=docs, vectors=v, fp_precision="float16")
    srv = native_server.NativeQueryServer(db, port=0, max_batch=8)
    jsrv = jax_native_server.NativeQueryServer(jdb, port=0, max_batch=8)
    try:
        assert srv.wire_f16 is True and jsrv.wire_f16 is True
        for i in (5, 700):
            q = v16[i].astype(np.float32)
            conns = _conn(srv.port), _conn(jsrv.port)
            got, want = (_binary_query(c, q, top_k=5) for c in conns)
            for c in conns:
                c.close()
            assert got[1]["ids"][0] == i
            assert got[1]["ids"] == want[1]["ids"]
            np.testing.assert_allclose(got[1]["scores"], want[1]["scores"], atol=1e-5)
    finally:
        srv.close()
        jsrv.close()


def test_f32_store_keeps_f32_wire():
    rng = np.random.default_rng(22)
    v = rng.standard_normal((64, 16)).astype(np.float32)
    db = TorchDB(documents=[{"i": int(i)} for i in range(64)], vectors=v, device="cpu")
    with native_server.NativeQueryServer(db, port=0) as srv:
        assert srv.wire_f16 is False
    with native_server.NativeQueryServer(db, port=0, wire_dtype="float16") as srv:
        assert srv.wire_f16 is True
    with pytest.raises(ValueError, match="wire_dtype"):
        native_server.NativeQueryServer(db, port=0, wire_dtype="bfloat16")


def test_engine_accepts_f16_block():
    """query_batch_arrays keeps a float16 block float16 and matches the f32
    block when it is f16-representable; on a block that is not, it rounds
    f32 -> f16 -> bf16 as the JAX package does: the port's f16 answers
    equal JAX's f16 answers."""
    rng = np.random.default_rng(23)
    v16 = rng.standard_normal((2048, 16)).astype(np.float16)
    v = v16.astype(np.float32)
    docs = [{"i": int(i)} for i in range(2048)]
    db = TorchDB(documents=docs, vectors=v, fp_precision="float16", device="cpu")
    jdb = JaxDB(documents=docs, vectors=v, fp_precision="float16")
    q16 = v16[[3, 900, 1500]]
    ids16, sc16 = db.query_batch_arrays(q16, top_k=4)
    ids32, sc32 = db.query_batch_arrays(q16.astype(np.float32), top_k=4)
    np.testing.assert_array_equal(ids16, ids32)
    np.testing.assert_allclose(sc16, sc32, rtol=2e-3)
    free = rng.standard_normal((64, 16)).astype(np.float32).astype(np.float16)
    ids, sc = db.query_batch_arrays(free, top_k=6)
    jids, jsc = jdb.query_batch_arrays(free, top_k=6)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_allclose(sc, np.asarray(jsc), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# HTTP/1.1 pipelining: many requests in flight per connection, responses in
# request order even when they complete in different flushes
# ---------------------------------------------------------------------------


def test_pipelined_requests_ordered_and_exact(served):
    v = served["vectors"]
    qids = np.random.default_rng(77).integers(0, N, size=40)
    reqs = [_req("/query?top_k=3", v[int(i)].astype(np.float32).tobytes()) for i in qids]
    got = _pipeline(served["port"], reqs)
    want = _pipeline(served["jax_port"], reqs)
    for i, (status, body), (jstatus, jbody) in zip(qids, got, want):
        assert status == jstatus == 200
        out, jout = json.loads(body), json.loads(jbody)
        assert out["ids"] == _oracle_ids(v, v[int(i)], 3).tolist() == jout["ids"]
        np.testing.assert_allclose(out["scores"], jout["scores"], atol=ATOL)


def test_pipelined_mixed_metrics_stay_ordered(served):
    v = served["vectors"]
    ids = [3, 7, 11, 19, 23, 42]
    reqs = [
        _req(f"/query?top_k=1&metric={'cosine_similarity' if j % 2 == 0 else 'dot_product'}",
             v[i].astype(np.float32).tobytes())
        for j, i in enumerate(ids)
    ]
    got = [json.loads(body)["ids"][0] for _, body in _pipeline(served["port"], reqs)]
    assert got == ids  # unit rows: each query's top-1 is itself, in order


def test_pipelined_error_midstream_keeps_order(served):
    """A 400 (wrong byte count) in the middle of a pipeline comes back in
    position and leaves the connection usable for the rest."""
    v = served["vectors"]
    reqs = [_req("/query?top_k=1", v[5].astype(np.float32).tobytes()),
            _req("/query?top_k=1", v[6].astype(np.float32).tobytes()[:-4]),
            _req("/query?top_k=1", v[9].astype(np.float32).tobytes())]
    out = _pipeline(served["port"], reqs)
    assert [s for s, _ in out] == [200, 400, 200]
    bodies = [json.loads(b) for _, b in out]
    assert bodies[0]["ids"][0] == 5 and "error" in bodies[1] and bodies[2]["ids"][0] == 9


def test_text_with_nul_byte_embeds_full_body(served_text):
    """NUL bytes in a text body reach the embedder intact."""
    conn = _conn(served_text["port"])
    conn.request("POST", "/query?top_k=1", b"doc\x00ignored 44", {"Content-Type": "text/plain"})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    assert resp.status == 200 and out["ids"][0] == 44
    conn.close()


def test_control_byte_metric_rejected(served):
    """A %01 byte in the metric parameter is a 400, not a forged text-batch
    group marker."""
    conn = _conn(served["port"])
    vec = served["vectors"][0].astype(np.float32).tobytes()
    conn.request("POST", "/query?top_k=3&metric=cosine_similarity%01t", vec,
                 {"Content-Type": "application/octet-stream"})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    assert resp.status == 400 and "invalid" in out["error"]
    conn.close()


def test_mutation_amid_pipelined_queries():
    """/add lands between pipelined query flushes (one worker serializes
    them); queries before and after both answer, counts stay consistent."""
    rng = np.random.default_rng(51)
    n, d = 256, 16
    v = rng.standard_normal((n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    db = TorchDB(documents=[{"i": int(i)} for i in range(n)], vectors=v, device="cpu")
    with native_server.NativeQueryServer(db, port=0, max_batch=16, window_ms=2.0) as srv:
        add_body = json.dumps({"documents": [{"i": 1000}],
                               "vectors": [(-v[0]).tolist()]}).encode()
        reqs = [_req("/query?top_k=1", v[i].astype(np.float32).tobytes()) for i in (3, 4)]
        reqs.append(_req("/add", add_body, "application/json"))
        reqs.append(_req("/query?top_k=1", (-v[0]).astype(np.float32).tobytes()))
        out = _pipeline(srv.port, reqs)
    assert all(s == 200 for s, _ in out)
    outs = [json.loads(b) for _, b in out]
    assert outs[0]["ids"][0] == 3 and outs[1]["ids"][0] == 4
    assert outs[2] == {"added": 1, "documents": n + 1}
    assert outs[3]["ids"][0] == n  # the freshly added document wins
