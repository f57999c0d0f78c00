"""Minimal production serving endpoint over a loaded corpus.

Counterpart of ``hyperdb_tpu/server.py``. The reference stops at a Python
library; a deployable engine needs a serving surface. This is a
dependency-free stdlib HTTP server wrapping one
:class:`~hyperdb_tpu_torch.HyperDB`:

  GET  /healthz              -> {"ok": true}
  GET  /stats                -> corpus + cache statistics (CLI `stats` dict)
  POST /query                -> one query
  POST /query_batch          -> a (B, d) block of vector queries

Request bodies are JSON. /query accepts the full public query surface::

    {"text": "...", "top_k": 5, "metric": "cosine_similarity",
     "filters": [["metadata", {"info.type": "fire"}]],
     "recency_bias": 0.0, "timestamp_key": null}

or ``{"vector": [...]}`` in place of ``text``. /query_batch accepts
``{"vectors": [[...], ...], "top_k": k, "metric": ...}``.

Concurrency model: HTTP handling is threaded (keeps slow clients from
serializing each other) but engine calls run under one lock — the engine's
LRU/state mutation is not thread-safe, and one device user at a time keeps
each flush's scan whole on the card. Start with ``python -m hyperdb_tpu_torch serve --db corpus.hdb``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def _result_rows(results):
    rows = []
    for res in results:
        if len(res) == 3:
            doc, score, idx = res
        else:  # Q4 2-tuple arity on the ANN+recency path
            doc, score, idx = res[0], res[1], None
        rows.append(
            {"document": doc, "score": float(score), "index": idx}
        )
    return rows


class _DynamicBatcher:
    """Aggregate concurrent single-vector queries into one device batch.

    Production serving with many clients issues lots of small /query calls;
    the engine's batched scan amortizes the corpus read across the batch
    (one read of the corpus plane serves every query of a flush), so
    grouping concurrent requests is nearly free throughput. Requests are
    grouped by an exact compatibility key — (metric, filters, recency,
    timestamp_key); mixed top_k values share a batch (queried at the max,
    sliced per request) — and each group flushes when either
    ``max_batch`` requests are waiting or ``window_ms`` elapsed since the
    group opened. Per-request results are distributed back through events;
    an engine error fails every request of its group with the message.
    """

    def __init__(self, db, lock, max_batch: int = 64, window_ms: float = 4.0,
                 host_db=None, wire_dtype: str = "auto"):
        self._db = db
        self._host_db = host_db if host_db is not None else db
        self._lock = lock
        # f16 flush blocks for low-precision corpora: halves the
        # host->device upload (the device math already rounds/quantizes the
        # query — see native/server.py)
        low = getattr(
            getattr(self._host_db, "_store", None),
            "low_precision_device",
            False,
        )
        self._wire_f16 = wire_dtype == "float16" or (
            wire_dtype == "auto" and low
        )
        self.max_batch = max_batch
        self.window_ms = window_ms
        self._mutex = threading.Lock()
        self._groups: dict = {}  # key -> list of pending dicts
        self._wake = threading.Condition(self._mutex)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._stop = False
        self._thread.start()

    def close(self):
        with self._mutex:
            self._stop = True
            self._wake.notify_all()
        self._thread.join(timeout=5.0)

    def submit(self, vector, top_k, metric, filters, recency_bias,
               timestamp_key, text=None):
        import numpy as np

        # top_k is NOT part of the grouping key: the flush queries at the
        # group's max top_k and slices each request's prefix — identical
        # results, wider coalescing under mixed-k workloads. Text and
        # vector requests share a group: texts embed in ONE encoder pass
        # at flush time, then join the same scored block.
        fkey = json.dumps(filters, sort_keys=True) if filters else None
        key = (metric, fkey, float(recency_bias), timestamp_key)
        entry = {
            "vector": None if text is not None
            else np.asarray(vector, dtype=np.float32),
            "text": text,
            "top_k": int(top_k),
            "event": threading.Event(),
            "result": None,
            "error": None,
            "params": (metric, filters, recency_bias, timestamp_key),
        }
        with self._mutex:
            stopping = self._stop
            if not stopping:
                group = self._groups.setdefault(key, [])
                group.append(entry)
                flush_now = len(group) >= self.max_batch
                self._wake.notify_all()
        if stopping:
            # close() may already have run its final flush pass; an entry
            # appended now would never be flushed and this handler thread
            # would wait forever. Serve it directly instead.
            metric, filters, recency_bias, timestamp_key = entry["params"]
            vec = entry["vector"]
            if vec is None:
                from hyperdb_tpu_torch.query.engine import (
                    generate_query_vectors_batch,
                )

                vec = generate_query_vectors_batch(
                    self._host_db, [entry["text"]]
                )[0]
            with self._lock:
                rows = self._db.query_batch(
                    vec[None, :], top_k=entry["top_k"],
                    metric=metric, filters=filters,
                    recency_bias=recency_bias, timestamp_key=timestamp_key,
                )
            return rows[0][: entry["top_k"]]
        if flush_now:
            self._flush(key)
        entry["event"].wait()
        if entry["error"] is not None:
            raise entry["error"]
        return entry["result"]

    def _run(self):
        import time

        while True:
            with self._mutex:
                while not self._groups and not self._stop:
                    self._wake.wait()
                stopping = self._stop
                keys = list(self._groups) if stopping else None
            if stopping:
                for key in keys:
                    self._flush(key)
                return
            # let the window elapse so concurrent arrivals coalesce, then
            # flush whatever accumulated (max_batch flushes happen inline
            # in submit and simply leave nothing for this pass to pop)
            time.sleep(self.window_ms / 1000.0)
            with self._mutex:
                keys = [k for k, g in self._groups.items() if g]
            for key in keys:
                self._flush(key)

    def _flush(self, key):
        import numpy as np

        with self._mutex:
            group = self._groups.pop(key, None)
        if not group:
            return
        metric, filters, recency_bias, timestamp_key = group[0]["params"]
        try:
            text_entries = [e for e in group if e["vector"] is None]
            block = None
            n_valid = None
            if (
                text_entries
                and len(text_entries) == len(group)
                and self._db is self._host_db
            ):
                # All-text flush on the single-device engine: chain the
                # encoder output into the scan on the device — the block is
                # never read back to the host and uploaded again (engine.
                # generate_query_vectors_batch_device; None -> host path)
                from hyperdb_tpu_torch.query.engine import (
                    generate_query_vectors_batch_device,
                )

                with self._lock:
                    dev = generate_query_vectors_batch_device(
                        self._host_db, [e["text"] for e in group]
                    )
                if dev is not None:
                    dim = getattr(self._host_db, "dim", None)
                    if dim and dev.shape[1] != dim:
                        err = ValueError(
                            f"embedded query dimension {dev.shape[1]} does "
                            f"not match corpus dimension {dim}"
                        )
                        for e in group:
                            e["error"] = err
                        return  # finally: sets every event
                    block = dev
                    n_valid = len(group)
            if block is None and text_entries:
                from hyperdb_tpu_torch.query.engine import (
                    generate_query_vectors_batch,
                )

                with self._lock:  # one device user at a time (encoder too)
                    embs = generate_query_vectors_batch(
                        self._host_db, [e["text"] for e in text_entries]
                    )
                dim = getattr(self._host_db, "dim", None)
                rejected = []
                for e, v in zip(text_entries, embs):
                    if dim and v.shape[0] != dim:
                        # fail THIS entry only: one bad text query must not
                        # 400 the vector requests sharing its group (the
                        # vector path validates dim before coalescing)
                        e["error"] = ValueError(
                            f"embedded query dimension {v.shape[0]} does "
                            f"not match corpus dimension {dim}"
                        )
                        e["event"].set()
                        rejected.append(id(e))
                    else:
                        e["vector"] = v
                if rejected:
                    group = [e for e in group if id(e) not in rejected]
                    if not group:
                        return
            if block is None:
                block = np.stack([e["vector"] for e in group])
                if self._wire_f16:
                    block = block.astype(np.float16)
            k_max = max(e["top_k"] for e in group)
            with self._lock:
                rows = self._db.query_batch(
                    block, top_k=k_max, metric=metric, filters=filters,
                    recency_bias=recency_bias, timestamp_key=timestamp_key,
                    n_valid=n_valid,
                )
            for entry, result in zip(group, rows):
                entry["result"] = result[: entry["top_k"]]
        except Exception as e:  # noqa: BLE001 - delivered per request
            for entry in group:
                entry["error"] = e
        finally:
            for entry in group:
                entry["event"].set()


def api_response(db, host_db, lock, batcher, method, path, body):
    """Shared JSON API dispatcher -> ``(status, payload_dict)``.

    One implementation of the endpoint semantics for BOTH serving
    front-ends: the stdlib handler below and the native C++ epoll server's
    generic-request path (native/server.py). ``body`` is raw request bytes;
    the binary octet-stream hot path is NOT handled here (each front-end
    owns its own fast path)."""
    bare = path.partition("?")[0]
    if method == "GET":
        if bare == "/healthz":
            return 200, {"ok": True}
        if bare == "/stats":
            with lock:
                return 200, {
                    "documents": host_db.size(),
                    "chunks": len(host_db.source_indices),
                    "dim": host_db.dim,
                    "ann_metric": host_db.ann_metric,
                    "index": type(host_db.ann_index).__name__
                    if host_db.ann_index
                    else None,
                    "sharded": db is not host_db,
                    "cache": host_db.get_cache_size_and_info(),
                    "timers": host_db.stats.snapshot(),
                }
        return 404, {"error": f"unknown path {path}"}

    if method != "POST":
        return 404, {"error": f"unsupported method {method}"}
    try:
        req = json.loads(body or b"{}")
    except (ValueError, json.JSONDecodeError) as e:
        return 400, {"error": f"bad JSON: {e}"}
    try:
        if bare == "/query":
            query_input = req["text"] if "text" in req else req["vector"]
            filters = req.get("filters")
            if filters:
                filters = [tuple(f) for f in filters]
            batchable_text = (
                "text" in req
                and isinstance(req["text"], str)
                and req["text"]
            )
            if (
                batcher is not None
                and (batchable_text or "text" not in req)
                and "ann_percent" not in req  # not in the batch key
            ):
                import numpy as np

                vec = None
                if not batchable_text:
                    vec = np.asarray(req["vector"], dtype=np.float32)
                    dim = getattr(host_db, "dim", None)
                    if vec.ndim != 1 or (dim and vec.shape[0] != dim):
                        # reject BEFORE coalescing: one malformed vector
                        # must not 400 a whole group of valid requests
                        return 400, {
                            "error": (
                                f"query vector shape {vec.shape} does not "
                                f"match corpus dimension {dim}"
                            )
                        }
                result = batcher.submit(
                    vec,
                    int(req.get("top_k", 5)),
                    req.get("metric", "cosine_similarity"),
                    filters,
                    req.get("recency_bias", 0) or 0,
                    req.get("timestamp_key"),
                    text=req["text"] if batchable_text else None,
                )
                return 200, {"results": _result_rows(result)}
            kwargs = {}
            if "ann_percent" in req and hasattr(db, "ann_metric"):
                # Q12 candidate budget — single-device engine only (a
                # sharded path has no ANN pre-filter)
                kwargs["ann_percent"] = int(req["ann_percent"])
            with lock:
                results = db.query(
                    query_input,
                    top_k=int(req.get("top_k", 5)),
                    metric=req.get("metric", "cosine_similarity"),
                    filters=filters,
                    recency_bias=req.get("recency_bias", 0) or 0,
                    timestamp_key=req.get("timestamp_key"),
                    **kwargs,
                )
            return 200, {"results": _result_rows(results)}
        if bare == "/query_batch":
            import numpy as np

            vectors = np.asarray(req["vectors"], dtype=np.float32)
            with lock:
                rows = db.query_batch(
                    vectors,
                    top_k=int(req.get("top_k", 5)),
                    metric=req.get("metric", "cosine_similarity"),
                )
            return 200, {"results": [_result_rows(r) for r in rows]}
        if bare == "/add":
            # reference add() over HTTP (hyperdb.py:548-566): documents
            # embed server-side unless precomputed vectors ride along.
            # Single-device stores re-upload the device view lazily at the
            # next query.
            # The library's print-and-rollback ingest semantics become
            # proper HTTP statuses here: validation 400s BEFORE mutating,
            # and a rollback that still swallows docs reports 500 rather
            # than a misleading 200.
            import numpy as np

            documents = req["documents"]
            expected = len(documents) if isinstance(documents, list) else 1
            vectors = req.get("vectors")
            vec = None
            if vectors is not None:
                vec = np.asarray(vectors, dtype=np.float32)
                if vec.ndim == 1:
                    vec = vec[None, :]
                if vec.ndim != 2 or vec.shape[0] != expected:
                    return 400, {
                        "error": f"vectors shape {vec.shape} does not match "
                                 f"{expected} document(s)"
                    }
                dim = getattr(host_db, "dim", None)
                if dim and vec.shape[1] != dim:
                    return 400, {
                        "error": f"vector dimension {vec.shape[1]} does not "
                                 f"match corpus dimension {dim}"
                    }
            with lock:
                before = host_db.size()
                db.add(documents, vectors=vec,
                       add_timestamp=bool(req.get("add_timestamp", False)))
                after = host_db.size()
            added = after - before
            if added != expected:
                # the library printed + rolled back (reference parity);
                # surface it instead of a silent 200
                return 500, {
                    "error": "ingest failed and was rolled back "
                             "(see server log)",
                    "added": added,
                }
            return 200, {"added": added, "documents": after}
        if bare == "/remove":
            # reference remove_document() over HTTP (hyperdb.py:692-766)
            with lock:
                db.remove_document(req["indices"])
                return 200, {"documents": host_db.size()}
    except KeyError as e:
        return 400, {"error": f"missing field {e}"}
    except (ValueError, TypeError, IndexError) as e:
        # engine validation errors (bad metric, dim mismatch, index out of
        # range, ...) plus malformed-but-JSON-valid payloads like
        # {"top_k": null} (int(None) raises TypeError) — the client should
        # get a 400, not a dropped connection
        return 400, {"error": str(e)}
    except Exception as e:  # noqa: BLE001 — the socket must get an answer
        # operational faults (shard capacity exhausted, device errors):
        # 500 with a payload beats a dead connection, on BOTH front-ends
        return 500, {"error": str(e)}
    return 404, {"error": f"unknown path {path}"}


def make_server(db, host: str = "127.0.0.1", port: int = 8901,
                dynamic_batch_ms: float = 0.0, max_batch: int = 64,
                wire_dtype: str = "auto"):
    """Build (but do not start) a ThreadingHTTPServer serving ``db``.

    ``db`` is a :class:`~hyperdb_tpu_torch.HyperDB`, or a wrapper with the
    same query surface that exposes the host db as ``.db`` (corpus
    statistics come from it), such as a ``ShardedHyperDB``.

    ``dynamic_batch_ms`` > 0 enables dynamic batching: concurrent /query
    requests with identical parameters coalesce for up to that many
    milliseconds (or ``max_batch`` requests) into one ``query_batch`` device
    call; text requests in a group embed together in one encoder pass.
    0 keeps the direct per-request path."""
    lock = threading.Lock()
    host_db = getattr(db, "db", db)  # a wrapper DB exposes the host store
    batcher = (
        _DynamicBatcher(db, lock, max_batch=max_batch,
                        window_ms=dynamic_batch_ms, host_db=host_db,
                        wire_dtype=wire_dtype)
        if dynamic_batch_ms > 0
        else None
    )

    class Handler(BaseHTTPRequestHandler):
        server_version = "hyperdb-tpu"
        # keep-alive: the BaseHTTPRequestHandler default is HTTP/1.0, which
        # closes the connection after EVERY response — each request then
        # pays a TCP connect plus a fresh handler thread spawn, and a
        # serving benchmark measures the socket churn instead of the
        # engine. Every _send sets Content-Length, which 1.1 keep-alive
        # requires.
        protocol_version = "HTTP/1.1"
        # TCP_NODELAY (a StreamRequestHandler attribute): on keep-alive
        # connections Nagle + delayed ACK adds ~40 ms to every small
        # response
        disable_nagle_algorithm = True

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            return self._send(
                *api_response(db, host_db, lock, batcher, "GET", self.path,
                              b"")
            )

        def do_POST(self):
            # Binary fast path: JSON dominates the stdlib stack's Python
            # time per request (parsing a 384-float vector, building the
            # doc-bearing response). `POST /query?top_k=K&metric=M` with
            # Content-Type: application/octet-stream takes the raw
            # little-endian f32 vector as the body (np.frombuffer)
            # and answers {"ids": [...], "scores": [...]} without
            # documents (ids are stable handles; bulk hydration stays on
            # the JSON path). Same engine, same dynamic batcher.
            path, _, qs = self.path.partition("?")
            if (
                path == "/query"
                and self.headers.get("Content-Type") == "application/octet-stream"
            ):
                import numpy as np
                from urllib.parse import parse_qs

                try:
                    length = int(self.headers.get("Content-Length", 0))
                    vec = np.frombuffer(self.rfile.read(length),
                                        dtype=np.float32)
                    params = parse_qs(qs)
                    top_k = int(params.get("top_k", ["5"])[0])
                    metric = params.get("metric", ["cosine_similarity"])[0]
                    filters = None
                    if "filters" in params:
                        filters = [
                            tuple(f)
                            for f in json.loads(params["filters"][0])
                        ] or None
                    recency = float(params.get("recency_bias", ["0"])[0])
                    tskey = params.get("timestamp_key", [None])[0]
                except (ValueError, TypeError) as e:
                    return self._send(400, {"error": str(e)})
                dim = getattr(host_db, "dim", None)
                if dim and vec.shape[0] != dim:
                    return self._send(400, {
                        "error": f"query vector has {vec.shape[0]} floats, "
                                 f"corpus dimension is {dim}"
                    })
                try:
                    if batcher is not None:
                        rows = batcher.submit(vec, top_k, metric, filters,
                                              recency, tskey)
                    else:
                        with lock:
                            rows = db.query_batch(
                                vec[None, :], top_k=top_k, metric=metric,
                                filters=filters, recency_bias=recency,
                                timestamp_key=tskey,
                            )[0]
                except (ValueError, TypeError) as e:
                    return self._send(400, {"error": str(e)})
                return self._send(200, {
                    "ids": [r[2] for r in rows],
                    "scores": [float(r[1]) for r in rows],
                })
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "") or ""
            if path == "/query" and ctype.startswith("text/plain"):
                # text hot path parity with the native front-end: the raw
                # body IS the query text; top_k/metric ride the query
                # string. Reuses the JSON dispatcher (and its batcher).
                from urllib.parse import parse_qs

                params = parse_qs(qs)
                try:
                    payload = {
                        "text": body.decode("utf-8", "replace"),
                        "top_k": int(params.get("top_k", ["5"])[0]),
                        "metric": params.get(
                            "metric", ["cosine_similarity"])[0],
                    }
                    if "filters" in params:
                        payload["filters"] = json.loads(
                            params["filters"][0]
                        )
                    if "recency_bias" in params:
                        payload["recency_bias"] = float(
                            params["recency_bias"][0]
                        )
                    if "timestamp_key" in params:
                        payload["timestamp_key"] = params[
                            "timestamp_key"][0]
                    body = json.dumps(payload).encode()
                except (ValueError, TypeError) as e:
                    return self._send(400, {"error": str(e)})
                return self._send(
                    *api_response(db, host_db, lock, batcher, "POST",
                                  "/query", body)
                )
            return self._send(
                *api_response(db, host_db, lock, batcher, "POST", self.path,
                              body)
            )

    class _Server(ThreadingHTTPServer):
        daemon_threads = True
        # default listen backlog is 5: hundreds of clients connecting at
        # once (or reconnecting after an idle period) see connection
        # resets under load
        request_queue_size = 1024

    httpd = _Server((host, port), Handler)
    httpd.batcher = batcher  # for clean shutdown / tests
    return httpd


def serve(db, host: str = "127.0.0.1", port: int = 8901,
          dynamic_batch_ms: float = 0.0, wire_dtype: str = "auto"):
    """Serve ``db`` until interrupted (the CLI `serve` entrypoint)."""
    httpd = make_server(db, host, port, dynamic_batch_ms=dynamic_batch_ms,
                        wire_dtype=wire_dtype)
    print(f"serving on http://{host}:{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if httpd.batcher is not None:
            httpd.batcher.close()
        httpd.server_close()
    return 0
