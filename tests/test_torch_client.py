"""The port's ``HyperDBClient`` against both of the port's serving front
ends, each beside the JAX package's front end of the same kind over the
same corpus.

Every call goes to the port's server and to the JAX one: ids equal, scores
within ``ATOL`` (cosine over an f32 DB: the same f32 rows summed in two
orders), and both equal the NumPy oracle where the query has a clear
answer. The servers bind port 0; the fixture closes them.
"""

import threading

import numpy as np
import pytest

from hyperdb_tpu import HyperDB as JaxDB
from hyperdb_tpu.client import HyperDBClient as JaxClient
from hyperdb_tpu.native import server as jax_native_server
from hyperdb_tpu.server import make_server as jax_make_server
from hyperdb_tpu_torch import HyperDB as TorchDB
from hyperdb_tpu_torch.client import HyperDBClient
from hyperdb_tpu_torch.native.server import NativeQueryServer
from hyperdb_tpu_torch.server import make_server

N, D = 1024, 24
ATOL = 1e-6


def _corpus():
    rng = np.random.default_rng(13)
    v = rng.standard_normal((N, D)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)

    def fake_embed(texts):
        return np.stack([v[int(t.split()[-1])] for t in texts]), list(range(len(texts))), {}

    docs = [{"i": int(i), "grp": ["a", "b"][i % 2]} for i in range(N)]
    return docs, v, fake_embed


def _oracle(v, q, k):
    qn = q / np.linalg.norm(q)
    return np.argsort(-(v @ qn), kind="stable")[:k]


class _Endpoint:
    def __init__(self, kind, db, jax):
        self.kind = kind
        if kind == "native":
            cls = jax_native_server.NativeQueryServer if jax else NativeQueryServer
            self.srv = cls(db, port=0, max_batch=64, window_ms=2.0)
            self.port = self.srv.port
        else:
            self.srv = (jax_make_server if jax else make_server)(db, port=0, dynamic_batch_ms=2.0)
            self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
            self.thread.start()
            self.port = self.srv.server_address[1]

    def close(self):
        if self.kind == "native":
            self.srv.close()
            return
        self.srv.shutdown()
        self.srv.batcher.close()
        self.srv.server_close()
        self.thread.join(timeout=30)


@pytest.fixture(scope="module", params=["python", "native"])
def endpoint(request):
    docs, v, embed = _corpus()
    tdb = TorchDB(documents=[dict(d) for d in docs], vectors=v, embedding_function=embed,
                  metadata_keys=["grp"], device="cpu")
    jdb = JaxDB(documents=[dict(d) for d in docs], vectors=v, embedding_function=embed,
                metadata_keys=["grp"])
    port_ep = _Endpoint(request.param, tdb, jax=False)
    jax_ep = _Endpoint(request.param, jdb, jax=True)
    yield {"port": port_ep.port, "jax_port": jax_ep.port, "vectors": v, "kind": request.param}
    port_ep.close()
    jax_ep.close()


def _both(endpoint, call):
    """``call(client)`` against the port's server and the JAX one."""
    with HyperDBClient("127.0.0.1", endpoint["port"], timeout=30) as c:
        got = call(c)
    with HyperDBClient("127.0.0.1", endpoint["jax_port"], timeout=30) as c:
        want = call(c)
    return got, want


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=ATOL)


def test_vector_query(endpoint):
    v = endpoint["vectors"]
    got, want = _both(endpoint, lambda c: c.query(v[42], top_k=5))
    _same(got, want)
    assert got[0].tolist() == _oracle(v, v[42], 5).tolist()
    assert got[1][0] == pytest.approx(1.0, abs=1e-3)


def test_text_query(endpoint):
    v = endpoint["vectors"]
    got, want = _both(endpoint, lambda c: c.query("doc 99", top_k=3))
    _same(got, want)
    assert got[0].tolist() == _oracle(v, v[99], 3).tolist()


def test_query_batch_pipelined(endpoint):
    v = endpoint["vectors"]
    qids = [3, 77, 500, 900]
    got, want = _both(endpoint, lambda c: c.query_batch(v[qids], top_k=4))
    assert got[0].shape == (4, 4) and got[1].shape == (4, 4)
    _same(got, want)
    for row, i in zip(got[0], qids):
        assert row.tolist() == _oracle(v, v[i], 4).tolist()


def test_stats_and_healthz(endpoint):
    got, want = _both(endpoint, lambda c: (c.healthz(), c.stats()))
    assert got[0] == want[0] == {"ok": True}
    assert got[1]["documents"] == N and got[1]["dim"] == D
    for key in ("documents", "chunks", "dim", "ann_metric", "index", "sharded"):
        assert got[1][key] == want[1][key], key
    if endpoint["kind"] == "native":
        assert set(got[1]["native"]) == set(want[1]["native"]) | {
            "complete_ms_per_flush", "queue_ms_per_request"}


def test_error_maps_to_exception(endpoint):
    v = endpoint["vectors"]
    for port in (endpoint["port"], endpoint["jax_port"]):
        with HyperDBClient("127.0.0.1", port, timeout=30) as c:
            with pytest.raises(RuntimeError, match="400|dimension"):
                c.query(np.zeros(D + 3, dtype=np.float32), top_k=3)
            ids, _ = c.query(v[1], top_k=1)  # connection still usable
            assert ids[0] == 1


def test_query_batch_error_leaves_connection_usable(endpoint):
    """A failing batch drains every pipelined response before raising; the
    next call on the same connection answers correctly."""
    v = endpoint["vectors"]
    for port in (endpoint["port"], endpoint["jax_port"]):
        with HyperDBClient("127.0.0.1", port, timeout=30) as c:
            with pytest.raises(RuntimeError):
                c.query_batch(v[[1, 2, 3]], top_k=2, metric="bogus_metric")
            ids, _ = c.query_batch(v[[7, 8]], top_k=1)
            assert ids[:, 0].tolist() == [7, 8]


def test_query_batch_larger_than_window(endpoint):
    """B > _PIPELINE_WINDOW exercises the sliding send/read window."""
    v = endpoint["vectors"]
    qids = list(range(0, 300, 2))[:150]
    assert len(qids) > HyperDBClient._PIPELINE_WINDOW
    got, want = _both(endpoint, lambda c: c.query_batch(v[qids], top_k=1))
    _same(got, want)
    assert got[0][:, 0].tolist() == qids


def test_query_batch_texts(endpoint):
    texts = [f"doc {i}" for i in (4, 40, 400)]
    got, want = _both(endpoint, lambda c: c.query_batch(texts, top_k=2))
    assert got[0].shape == (3, 2)
    _same(got, want)
    assert got[0][:, 0].tolist() == [4, 40, 400]


def test_filters_on_hot_path(endpoint):
    """A metadata filter rides the query string; the native server batches
    filtered queries per (metric, filters) group — results respect it."""
    v = endpoint["vectors"]
    flt = [("metadata", {"grp": "a"})]
    got, want = _both(endpoint, lambda c: c.query(v[3], top_k=6, filters=flt))
    _same(got, want)
    assert len(got[0]) == 6 and all(i % 2 == 0 for i in got[0])
    got, want = _both(endpoint, lambda c: c.query_batch(v[[4, 8]], top_k=4, filters=flt))
    _same(got, want)
    assert (got[0] % 2 == 0).all() and got[0][0, 0] == 4 and got[0][1, 0] == 8


def test_recency_on_hot_path():
    """recency_bias / timestamp_key ride the query string and batch on the
    native hot path; results match the library's recency ranking and the
    JAX native server's."""
    rng = np.random.default_rng(41)
    n, d = 128, 8
    v = rng.standard_normal((n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    docs = [{"i": int(i), "ts": float(i)} for i in range(n)]
    tdb = TorchDB(documents=[dict(x) for x in docs], vectors=v, metadata_keys=["ts"], device="cpu")
    jdb = JaxDB(documents=[dict(x) for x in docs], vectors=v, metadata_keys=["ts"])
    srv = NativeQueryServer(tdb, port=0, max_batch=16)
    jsrv = jax_native_server.NativeQueryServer(jdb, port=0, max_batch=16)
    try:
        q = v[10]
        want_ids, want_scores = tdb.query_batch_arrays(q[None, :], top_k=5, recency_bias=2.0,
                                                       timestamp_key="ts")
        with HyperDBClient("127.0.0.1", srv.port, timeout=30) as c:
            ids, scores = c.query(q, top_k=5, recency_bias=2.0, timestamp_key="ts")
        with JaxClient("127.0.0.1", jsrv.port, timeout=30) as c:
            jids, jscores = c.query(q, top_k=5, recency_bias=2.0, timestamp_key="ts")
        assert ids.tolist() == want_ids[0].tolist() == jids.tolist()
        np.testing.assert_allclose(scores, want_scores[0], rtol=1e-6)
        np.testing.assert_allclose(scores, jscores, rtol=0, atol=ATOL)
        plain, _ = tdb.query_batch_arrays(q[None, :], top_k=5)
        assert ids.tolist() != plain[0].tolist()  # recency reordered
    finally:
        srv.close()
        jsrv.close()


def test_jax_client_against_the_port_server(endpoint):
    """The two clients are copies: the JAX package's client gets the same
    answers from the port's server as the port's client does."""
    v = endpoint["vectors"]
    with JaxClient("127.0.0.1", endpoint["port"], timeout=30) as c:
        jids, jscores = c.query_batch(v[[5, 6, 7]], top_k=3)
        assert c.healthz() == {"ok": True}
    with HyperDBClient("127.0.0.1", endpoint["port"], timeout=30) as c:
        ids, scores = c.query_batch(v[[5, 6, 7]], top_k=3)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(scores, jscores)
