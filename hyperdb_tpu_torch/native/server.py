"""ctypes driver for the native epoll serving front end (server.cc).

Counterpart of ``hyperdb_tpu/native/server.py``. The C++ side owns the I/O
plane (sockets, HTTP parsing, dynamic batching, response formatting); this
module runs the single worker thread that pulls batches out of it and
enters the engine once per BATCH:

    tag = hdb_srv_next()          # blocks in C (GIL released: ctypes.CDLL)
    tag == 1: db.query_batch_arrays(...) -> hdb_srv_batch_complete(ids, sc)
    tag == 2: server.api_response(...)   -> hdb_srv_req_respond(...)
    tag == 3: one encoder pass + query_batch_arrays -> hdb_srv_batch_complete

Why: the stdlib ThreadingHTTPServer spends GIL-serialized Python on every
request (HTTP parsing, JSON, a thread switch); here Python runs once per
flush — the same work a benchmark harness does.

One worker thread by design: it is the only user of the wrapped db and of
its device, so additional workers would only contend for the engine lock.
Mutating the db while the server runs requires holding ``server.lock``.
"""

from __future__ import annotations

import ctypes
import json
import threading
import time

import numpy as np
import torch

from hyperdb_tpu_torch.native import tokenizer as _host_lib

_P_FLOAT = ctypes.POINTER(ctypes.c_float)
_P_INT32 = ctypes.POINTER(ctypes.c_int32)
_P_LL = ctypes.POINTER(ctypes.c_longlong)


def _bind(lib) -> None:
    """Declare the server entry points on the host library."""
    lib.hdb_srv_create.restype = ctypes.c_void_p
    lib.hdb_srv_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong,
    ]
    lib.hdb_srv_port.restype = ctypes.c_int
    lib.hdb_srv_port.argtypes = [ctypes.c_void_p]
    lib.hdb_srv_next.restype = ctypes.c_int
    lib.hdb_srv_next.argtypes = [ctypes.c_void_p]
    lib.hdb_srv_batch_size.restype = ctypes.c_int
    lib.hdb_srv_batch_size.argtypes = [ctypes.c_void_p]
    lib.hdb_srv_batch_vecs.restype = _P_FLOAT
    lib.hdb_srv_batch_vecs.argtypes = [ctypes.c_void_p]
    lib.hdb_srv_batch_topks.restype = _P_INT32
    lib.hdb_srv_batch_topks.argtypes = [ctypes.c_void_p]
    for fn in ("hdb_srv_batch_metric", "hdb_srv_batch_filters",
               "hdb_srv_batch_recency", "hdb_srv_batch_tskey"):
        getattr(lib, fn).restype = ctypes.c_char_p
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    # returns a pointer (NOT c_char_p): text bodies may legally contain
    # NUL bytes, so the worker reads (ptr, len) via ctypes.string_at
    lib.hdb_srv_batch_text.restype = ctypes.c_void_p
    lib.hdb_srv_batch_text.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.hdb_srv_batch_complete.restype = None
    lib.hdb_srv_batch_complete.argtypes = [
        ctypes.c_void_p, _P_LL, _P_FLOAT, ctypes.c_int,
    ]
    lib.hdb_srv_batch_fail.restype = None
    lib.hdb_srv_batch_fail.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
    ]
    for fn in ("hdb_srv_req_method", "hdb_srv_req_path", "hdb_srv_req_ctype"):
        getattr(lib, fn).restype = ctypes.c_char_p
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.hdb_srv_req_body.restype = ctypes.c_void_p
    lib.hdb_srv_req_body.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.hdb_srv_req_respond.restype = None
    lib.hdb_srv_req_respond.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_longlong,
    ]
    lib.hdb_srv_stop.restype = None
    lib.hdb_srv_stop.argtypes = [ctypes.c_void_p]
    lib.hdb_srv_destroy.restype = None
    lib.hdb_srv_destroy.argtypes = [ctypes.c_void_p]


class NativeQueryServer:
    """Serve ``db`` over HTTP through the C++ epoll front-end.

    Endpoint surface matches :mod:`hyperdb_tpu_torch.server` (shared dispatcher
    ``server.api_response`` handles /stats and the JSON paths); the binary
    ``POST /query`` octet-stream path is parsed, batched, and answered
    entirely in C++ around one ``query_batch_arrays`` call per flush.
    """

    def __init__(self, db, host: str = "127.0.0.1", port: int = 8901,
                 max_batch: int = 256, window_ms: float = 2.0,
                 wire_dtype: str = "auto"):
        lib = _host_lib.load()  # raises with the compiler's output
        _bind(lib)
        self._lib = lib
        self.db = db
        self.host_db = getattr(db, "db", db)  # a wrapper DB exposes the host db
        self.dim = int(self.host_db.dim)
        self.lock = threading.Lock()  # hold this to mutate db while serving
        # Low-precision wire: "auto" sends float16 query blocks when the
        # corpus itself is low precision (a float16 store scans bf16 planes
        # and int8 stores quantize the query, so the device math rounds the
        # query anyway; f32 -> f16 -> bf16 as in the JAX package), halving
        # the upload. Full-precision stores keep the f32 wire.
        if wire_dtype not in ("auto", "float32", "float16"):
            raise ValueError(f"invalid wire_dtype {wire_dtype!r}")
        low = getattr(
            getattr(self.host_db, "_store", None),
            "low_precision_device",
            False,
        )
        self.wire_f16 = wire_dtype == "float16" or (
            wire_dtype == "auto" and low
        )
        self._srv = lib.hdb_srv_create(
            host.encode(), int(port), self.dim, int(max_batch),
            int(window_ms * 1000), 8 << 20,
        )
        if not self._srv:
            raise OSError(f"could not bind {host}:{port}")
        self.port = lib.hdb_srv_port(self._srv)
        # per-flush accounting (reported under /stats -> "native"): where a
        # serving second goes — engine wall per flush vs everything else —
        # and how big flushes actually are. Written only by the worker
        # thread; /stats reads without locking (approximate is fine).
        self.flushes = 0
        self.flushed_queries = 0
        self.engine_s = 0.0
        # in hdb_srv_batch_complete: the C++ side formats every response
        # of the flush and hands each to the I/O thread
        self.complete_s = 0.0
        self.idle_s = 0.0  # blocked in hdb_srv_next (no work pending)
        self.max_flush = 0
        self._worker = threading.Thread(
            target=self._run, daemon=True, name="hyperdb-native-serve"
        )
        self._worker.start()

    # ------------------------------------------------------------------
    def close(self):
        if self._srv is None:
            return
        self._lib.hdb_srv_stop(self._srv)
        self._worker.join(timeout=10.0)
        self._lib.hdb_srv_destroy(self._srv)
        self._srv = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def serve_forever(self):
        """Block until the worker exits (the CLI entrypoint)."""
        try:
            while self._worker.is_alive():
                self._worker.join(timeout=1.0)
        except KeyboardInterrupt:
            pass
        finally:
            self.close()

    # ------------------------------------------------------------------
    def _run(self):
        lib, srv = self._lib, self._srv
        device = getattr(self.host_db, "device", None)
        if device is not None and device.type == "cuda":
            torch.cuda.set_device(device)  # the db's card, in this thread too
        while True:
            t0 = time.perf_counter()
            tag = lib.hdb_srv_next(srv)  # blocks; GIL released in ctypes
            self.idle_s += time.perf_counter() - t0
            if tag == 0:
                return
            if tag == 1:
                self._handle_batch(lib, srv)
            elif tag == 3:
                self._handle_text_batch(lib, srv)
            else:
                self._handle_generic(lib, srv)

    def _run_flush(self, lib, srv, n, engine_call):
        """Shared tail of both hot-batch handlers: run the engine call,
        fail the flush on error (400 for validation errors, 500 for
        engine/device faults — clients must not be blamed for server-side
        failures), else account and hand (ids, scores) back to C++."""
        t0 = time.perf_counter()
        try:
            with self.lock:
                ids, scores = engine_call()
        except Exception as e:  # noqa: BLE001 — delivered per request
            status = 400 if isinstance(e, (ValueError, TypeError)) else 500
            lib.hdb_srv_batch_fail(srv, status, str(e).encode())
            return
        self.engine_s += time.perf_counter() - t0
        self.flushes += 1
        self.flushed_queries += n
        self.max_flush = max(self.max_flush, n)
        k = int(ids.shape[1])
        ids64 = np.ascontiguousarray(ids, dtype=np.int64)
        sc32 = np.ascontiguousarray(scores, dtype=np.float32)
        t0 = time.perf_counter()
        lib.hdb_srv_batch_complete(
            srv,
            ids64.ctypes.data_as(_P_LL),
            sc32.ctypes.data_as(_P_FLOAT),
            k,
        )
        self.complete_s += time.perf_counter() - t0

    @staticmethod
    def _batch_params(lib, srv):
        """The flush's shared query parameters (from the query string; part
        of the C++ group key, so one parse covers the whole batch):
        (filters, recency_bias, timestamp_key)."""
        filters = None
        raw = lib.hdb_srv_batch_filters(srv)
        if raw:
            spec = json.loads(raw.decode())
            filters = [tuple(f) for f in spec] if spec else None
        raw = lib.hdb_srv_batch_recency(srv)
        recency = float(raw) if raw else 0.0
        raw = lib.hdb_srv_batch_tskey(srv)
        tskey = raw.decode() if raw else None
        return filters, recency, tskey

    def _handle_batch(self, lib, srv):
        n = lib.hdb_srv_batch_size(srv)
        vecs = np.ctypeslib.as_array(
            lib.hdb_srv_batch_vecs(srv), shape=(n, self.dim)
        )
        topks = np.ctypeslib.as_array(lib.hdb_srv_batch_topks(srv), shape=(n,))
        metric = lib.hdb_srv_batch_metric(srv).decode()
        block = np.array(vecs)  # own the buffer before the C++ side reuses it
        if self.wire_f16:
            block = block.astype(np.float16)
        top_k = int(topks.max())

        filters, recency, tskey = self._batch_params(lib, srv)

        def call():
            return self.db.query_batch_arrays(
                block, top_k=top_k, metric=metric, filters=filters,
                recency_bias=recency, timestamp_key=tskey,
            )

        self._run_flush(lib, srv, n, call)

    def _handle_text_batch(self, lib, srv):
        """tag == 3: a flush of text/plain queries — ONE encoder pass embeds
        the whole batch, then the same array-level engine call as tag 1."""
        from hyperdb_tpu_torch.query.engine import generate_query_vectors_batch

        n = lib.hdb_srv_batch_size(srv)
        texts = []
        tlen = ctypes.c_longlong(0)
        for i in range(n):
            ptr = lib.hdb_srv_batch_text(srv, i, ctypes.byref(tlen))
            raw = ctypes.string_at(ptr, tlen.value) if tlen.value else b""
            texts.append(raw.decode("utf-8", "replace"))
        topks = np.ctypeslib.as_array(lib.hdb_srv_batch_topks(srv), shape=(n,))
        metric = lib.hdb_srv_batch_metric(srv).decode()
        top_k = int(topks.max())

        filters, recency, tskey = self._batch_params(lib, srv)

        def call():
            if self.db is self.host_db:
                # single-device engine: chain the encoder output into the
                # scan on the device — the block is never read back and
                # uploaded again (None -> host path below; a sharded db
                # re-uploads per shard, so it gains nothing here)
                from hyperdb_tpu_torch.query.engine import (
                    generate_query_vectors_batch_device,
                )

                dev = generate_query_vectors_batch_device(self.host_db, texts)
                if dev is not None:
                    return self.db.query_batch_arrays(
                        dev, top_k=top_k, metric=metric, filters=filters,
                        recency_bias=recency, timestamp_key=tskey,
                        n_valid=len(texts),
                    )
            q_block = generate_query_vectors_batch(self.host_db, texts)
            if self.wire_f16:
                q_block = q_block.astype(np.float16)
            return self.db.query_batch_arrays(
                q_block, top_k=top_k, metric=metric, filters=filters,
                recency_bias=recency, timestamp_key=tskey,
            )

        self._run_flush(lib, srv, n, call)

    def _handle_generic(self, lib, srv):
        from hyperdb_tpu_torch.server import api_response

        method = lib.hdb_srv_req_method(srv).decode()
        path = lib.hdb_srv_req_path(srv).decode()
        blen = ctypes.c_longlong(0)
        bptr = lib.hdb_srv_req_body(srv, ctypes.byref(blen))
        body = ctypes.string_at(bptr, blen.value) if blen.value else b""
        try:
            status, payload = api_response(
                self.db, self.host_db, self.lock, None, method, path, body
            )
        except Exception as e:  # noqa: BLE001 — must answer the socket
            status, payload = 500, {"error": str(e)}
        if status == 200 and path.partition("?")[0] == "/stats":
            f = max(1, self.flushes)
            payload["native"] = {
                "flushes": self.flushes,
                "queries": self.flushed_queries,
                "mean_flush": round(self.flushed_queries / f, 1),
                "max_flush": self.max_flush,
                "engine_ms_per_flush": round(1e3 * self.engine_s / f, 2),
                "engine_s": round(self.engine_s, 3),
                "complete_ms_per_flush": round(1e3 * self.complete_s / f, 2),
                "idle_s": round(self.idle_s, 3),
            }
        data = json.dumps(payload).encode()
        lib.hdb_srv_req_respond(
            srv, status, b"application/json", data, len(data)
        )
