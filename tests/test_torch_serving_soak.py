"""End-to-end mutation-under-load soak through the port's two front ends
(twin of ``tests/test_serving_soak.py``, same sizes).

The serving front-ends serialize engine calls behind one lock, but the
cache/device-view invalidation that a mutation triggers crosses flush
boundaries — this drives concurrent /add + /remove + query traffic through
a real HTTP front-end and asserts MONOTONIC CONSISTENCY: no query response
ever observes a half-applied mutation.

Protocol: a single mutator thread runs generations; generation t adds
THREE documents whose vectors all sit within 0.02 of a fresh random unit
marker m_t (one atomic /add), then removes all three (one atomic /remove).
Query threads hammer top-3 marker queries for random started generations
the whole time. Because the corpus' background vectors are far from every
marker (cos < ~0.7 at 64 dims) while gen vectors score > 0.99, the top-3
hit count at score > 0.95 must be exactly 0 or 3 — 1 or 2 means a query
saw a torn add or remove. Stale-cache serving is covered too: markers
repeat, so an un-invalidated LRU row would resurface deleted documents.

Runs against the port's python front end and its native C++ epoll front
end (both wrap the same engine lock discipline; server.py/api_response is
shared), on a port DB on the CPU.
"""

from __future__ import annotations

import http.client
import json
import threading

import numpy as np

from hyperdb_tpu_torch import HyperDB
from hyperdb_tpu_torch.client import HyperDBClient

D = 64
BASE = 192
GENS = 24


def _build_db():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((BASE, D)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return HyperDB(documents=[{"i": int(i)} for i in range(BASE)], vectors=v, device="cpu")


def _post_json(port, path, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", path, json.dumps(payload).encode(),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read() or b"{}")
    finally:
        conn.close()


def _soak(port):
    rng = np.random.default_rng(7)
    markers: list[np.ndarray] = []
    started = threading.Event()
    done = threading.Event()
    errors: list[str] = []

    def mutator():
        try:
            for t in range(GENS):
                m = rng.standard_normal(D).astype(np.float32)
                m /= np.linalg.norm(m)
                vecs = m[None, :] + 0.01 * rng.standard_normal(
                    (3, D)
                ).astype(np.float32)
                vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
                markers.append(m)
                started.set()
                status, resp = _post_json(port, "/add", {
                    "documents": [{"gen": t, "j": j} for j in range(3)],
                    "vectors": vecs.tolist(),
                })
                assert status == 200 and resp["added"] == 3, (status, resp)
                after = resp["documents"]
                # the three gen docs are the appended tail; no other
                # mutation runs between this add and this remove
                status, resp = _post_json(port, "/remove", {
                    "indices": [after - 3, after - 2, after - 1],
                })
                assert status == 200, (status, resp)
                assert resp["documents"] == after - 3, resp
        except Exception as e:  # noqa: BLE001 — surface in the main thread
            errors.append(f"mutator: {e!r}")
        finally:
            done.set()
            started.set()

    def querier(seed):
        q_rng = np.random.default_rng(seed)
        try:
            with HyperDBClient("127.0.0.1", port, timeout=30) as client:
                started.wait(10)
                while not done.is_set():
                    if not markers:
                        continue
                    t = int(q_rng.integers(0, len(markers)))
                    ids, scores = client.query(markers[t], top_k=3)
                    hits = int(np.sum(np.asarray(scores) > 0.95))
                    if hits not in (0, 3):
                        errors.append(
                            f"torn mutation visible: gen {t} query saw "
                            f"{hits}/3 gen docs (scores {list(scores)})"
                        )
                        done.set()
                        return
        except Exception as e:  # noqa: BLE001
            if not done.is_set():
                errors.append(f"querier: {e!r}")

    threads = [threading.Thread(target=mutator)] + [
        threading.Thread(target=querier, args=(100 + s,)) for s in range(2)
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    # final state: every generation fully removed, corpus back to BASE
    with HyperDBClient("127.0.0.1", port, timeout=30) as client:
        st = client.stats()
        assert st["documents"] == BASE, st
        for t in (0, GENS // 2, GENS - 1):
            _, scores = client.query(markers[t], top_k=3)
            assert float(np.max(scores)) < 0.95, (t, scores)


def test_soak_python_front_end():
    from hyperdb_tpu_torch.server import make_server

    db = _build_db()
    httpd = make_server(db, port=0, dynamic_batch_ms=2.0, max_batch=16)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        _soak(httpd.server_address[1])
    finally:
        httpd.shutdown()
        httpd.batcher.close()
        httpd.server_close()
        th.join(timeout=30)


def test_soak_native_front_end():
    from hyperdb_tpu_torch.native.server import NativeQueryServer

    db = _build_db()
    srv = NativeQueryServer(db, port=0, max_batch=16, window_ms=2.0)
    try:
        _soak(srv.port)
    finally:
        srv.close()
