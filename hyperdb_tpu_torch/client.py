"""HTTP client for the serving front-ends (`python -m hyperdb_tpu_torch serve`).

Speaks the wire protocols the servers expose (server.py and
native/server.cc): the binary hot path (octet-stream f32 request,
optionally binary response `[u32 k][k x i64 ids][k x f32 scores]`), the
text/plain hot path, the JSON endpoints, and — against the native
front-end — HTTP/1.1 pipelining, so :meth:`query_batch` keeps a whole
block of queries in flight on ONE connection and the server coalesces
them into one device flush.

    from hyperdb_tpu_torch.client import HyperDBClient

    with HyperDBClient("127.0.0.1", 8901) as c:
        ids, scores = c.query(vec, top_k=10)
        ids, scores = c.query("what likes to sleep?", top_k=5)
        ids2d, scores2d = c.query_batch(vec_block, top_k=10)  # pipelined
        c.stats()

Everything is stdlib + numpy; one socket, keep-alive, reconnect on error.
A copy of ``hyperdb_tpu/client.py``: it speaks to either package's servers.
"""

from __future__ import annotations

import json
import socket
import struct
from urllib.parse import quote

import numpy as np


class HyperDBClient:
    """Keep-alive client for a hyperdb-tpu serving endpoint."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8901,
                 timeout: float = 120.0, binary_responses: bool = True):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.binary_responses = binary_responses
        self._sock: socket.socket | None = None
        self._buf = b""

    # ------------------------------------------------------------- wire
    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection((self.host, self.port),
                                         timeout=self.timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
            self._buf = b""
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
                self._buf = b""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _request_bytes(self, method: str, path: str, body: bytes,
                       ctype: str, accept: str | None) -> bytes:
        head = (f"{method} {path} HTTP/1.1\r\nHost: {self.host}\r\n"
                f"Content-Type: {ctype}\r\n"
                + (f"Accept: {accept}\r\n" if accept else "")
                + f"Content-Length: {len(body)}\r\n\r\n")
        return head.encode() + body

    def _read_response(self) -> tuple[int, str, bytes]:
        """-> (status, content_type, body); raises ConnectionError on EOF."""
        sock = self._sock
        assert sock is not None
        while True:
            hdr_end = self._buf.find(b"\r\n\r\n")
            if hdr_end >= 0:
                break
            chunk = sock.recv(262144)
            if not chunk:
                raise ConnectionError("server closed the connection")
            self._buf += chunk
        head = self._buf[:hdr_end]
        status = int(head.split(b" ", 2)[1])
        clen, ctype = 0, ""
        for line in head.split(b"\r\n")[1:]:
            low = line.lower()
            if low.startswith(b"content-length:"):
                clen = int(line[15:])
            elif low.startswith(b"content-type:"):
                ctype = line[13:].strip().decode()
        total = hdr_end + 4 + clen
        while len(self._buf) < total:
            chunk = sock.recv(262144)
            if not chunk:
                raise ConnectionError("server closed mid-body")
            self._buf += chunk
        body = self._buf[hdr_end + 4:total]
        self._buf = self._buf[total:]
        return status, ctype, body

    def _roundtrip(self, method, path, body, ctype, accept=None):
        try:
            sock = self._connect()
            sock.sendall(self._request_bytes(method, path, body, ctype,
                                             accept))
            return self._read_response()
        except (OSError, ConnectionError):
            # one reconnect: keep-alive sockets die idly under NAT/timeouts
            self.close()
            sock = self._connect()
            sock.sendall(self._request_bytes(method, path, body, ctype,
                                             accept))
            return self._read_response()

    @staticmethod
    def _parse_result(status, ctype, body):
        if status != 200:
            try:
                msg = json.loads(body).get("error", body[:200])
            except ValueError:
                msg = body[:200]
            raise RuntimeError(f"server returned {status}: {msg}")
        if ctype == "application/octet-stream":
            (k,) = struct.unpack("<I", body[:4])
            ids = np.frombuffer(body[4:4 + 8 * k], dtype="<i8").copy()
            scores = np.frombuffer(body[4 + 8 * k:4 + 12 * k],
                                   dtype="<f4").copy()
            return ids, scores
        out = json.loads(body)
        if "ids" in out:
            return (np.asarray(out["ids"], dtype=np.int64),
                    np.asarray(out["scores"], dtype=np.float32))
        rows = out["results"]  # stdlib-server JSON shape
        return (
            np.asarray([r["index"] for r in rows], dtype=np.int64),
            np.asarray([r["score"] for r in rows], dtype=np.float32),
        )

    # ------------------------------------------------------------ public
    @staticmethod
    def _query_path(top_k, metric, filters, recency_bias=0,
                    timestamp_key=None):
        # metric is quoted too: a space/&/# in a bad metric must arrive as
        # a clean server-side 400, not a malformed request line
        path = f"/query?top_k={int(top_k)}&metric={quote(str(metric), safe='')}"
        if filters:
            spec = json.dumps([list(f) for f in filters],
                              separators=(",", ":"))
            path += "&filters=" + quote(spec, safe="")
        if recency_bias:
            path += f"&recency_bias={float(recency_bias)}"
        if timestamp_key:
            path += "&timestamp_key=" + quote(str(timestamp_key), safe="")
        return path

    def query(self, query_input, top_k: int = 5,
              metric: str = "cosine_similarity", filters=None,
              recency_bias: float = 0, timestamp_key=None):
        """One query: a (d,) float vector or a text string ->
        (ids (k,), scores (k,)). ``filters`` is the engine's
        [(name, params), ...] spec; it rides the query string so filtered
        queries still batch on the native hot path."""
        accept = "application/octet-stream" if self.binary_responses else None
        path = self._query_path(top_k, metric, filters, recency_bias,
                                timestamp_key)
        if isinstance(query_input, str):
            status, ctype, body = self._roundtrip(
                "POST", path, query_input.encode(), "text/plain", accept)
        else:
            vec = np.ascontiguousarray(query_input, dtype="<f4")
            if vec.ndim != 1:
                raise ValueError("query() takes one (d,) vector; use "
                                 "query_batch() for blocks")
            status, ctype, body = self._roundtrip(
                "POST", path, vec.tobytes(), "application/octet-stream",
                accept)
        return self._parse_result(status, ctype, body)

    # In-flight cap for query_batch: below the native front-end's
    # per-connection pipelining limit (kMaxInflight=256), and small enough
    # that write-side and read-side buffers never mutually fill against a
    # server that handles one request at a time (the stdlib front-end).
    _PIPELINE_WINDOW = 128

    def query_batch(self, queries, top_k: int = 5,
                    metric: str = "cosine_similarity", filters=None,
                    recency_bias: float = 0, timestamp_key=None):
        """Pipeline a (B, d) float block OR a list of B text strings on one
        connection -> ((B, k) ids, (B, k) scores). The native front-end
        answers in request order and coalesces the in-flight block into one
        device flush (texts: one encoder pass per flush). Keeps at most
        ``_PIPELINE_WINDOW`` requests outstanding (sliding window), so
        arbitrary B neither deadlocks a sequential server on full socket
        buffers nor trips the native front-end's in-flight cap.

        On a non-200 response the remaining in-flight responses are
        DRAINED before raising, so the keep-alive connection stays usable
        (no stale responses bleeding into later calls)."""
        accept = "application/octet-stream" if self.binary_responses else None
        path = self._query_path(top_k, metric, filters, recency_bias,
                                timestamp_key)
        if (isinstance(queries, (list, tuple)) and queries
                and all(isinstance(t, str) for t in queries)):
            n_queries = len(queries)
            reqs = [
                self._request_bytes("POST", path, t.encode(), "text/plain",
                                    accept)
                for t in queries
            ]
        else:
            block = np.ascontiguousarray(queries, dtype="<f4")
            if block.ndim != 2:
                raise ValueError(
                    "query_batch() takes a (B, d) block or a list of strings"
                )
            n_queries = block.shape[0]
            reqs = [
                self._request_bytes("POST", path, row.tobytes(),
                                    "application/octet-stream", accept)
                for row in block
            ]
        sock = self._connect()
        ids_rows, score_rows = [], []
        first_error = None
        sent = received = 0
        try:
            while received < len(reqs):
                while (sent < len(reqs)
                       and sent - received < self._PIPELINE_WINDOW):
                    sock.sendall(reqs[sent])
                    sent += 1
                status, ctype, body = self._read_response()
                received += 1
                try:
                    ids, scores = self._parse_result(status, ctype, body)
                except RuntimeError as e:
                    if first_error is None:
                        first_error = e
                    continue  # keep draining: connection must stay in sync
                ids_rows.append(ids)
                score_rows.append(scores)
        except (OSError, ConnectionError):
            self.close()  # desynced: don't reuse the socket
            raise
        if first_error is not None:
            raise first_error
        k = min((len(r) for r in ids_rows), default=0)
        return (
            np.stack([r[:k] for r in ids_rows]) if k else
            np.zeros((n_queries, 0), dtype=np.int64),
            np.stack([r[:k] for r in score_rows]) if k else
            np.zeros((n_queries, 0), dtype=np.float32),
        )

    def _get_json(self, path: str) -> dict:
        status, _, body = self._roundtrip("GET", path, b"",
                                          "application/json")
        out = json.loads(body)
        if status != 200:
            raise RuntimeError(f"server returned {status}: {out}")
        return out

    def stats(self) -> dict:
        return self._get_json("/stats")

    def healthz(self) -> dict:
        return self._get_json("/healthz")
