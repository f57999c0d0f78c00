"""Closed-loop HTTP load client for the serving front ends: one process,
several keep-alive connections, each with a fixed number of pipelined
requests in flight.

    python3 hyperdb_tpu_torch/tools/serve_load.py --port 8901 --mode binary \
        --payloads queries.npy --out result.npz [--conns 4 --depth 32 \
        --warmup 1 --seconds 5 --top-k 10]

Run it by path: it imports only the standard library and NumPy (never the
package, torch or a device), so several copies start in well under a
second beside a server that holds the card. ``--mode``:

- ``binary``: ``POST /query`` with a raw little-endian f32 vector body,
  binary responses (``[u32 k][k x i64 ids][k x f32 scores]``); payloads
  are a ``(P, d)`` float32 ``.npy``;
- ``json``: ``POST /query`` with ``{"vector": [...], "top_k": k}``, JSON
  responses (the stdlib front end's JSON path); same payloads;
- ``text``: ``POST /query`` with a ``text/plain`` body, binary responses;
  payloads are a JSON list of strings.

Connection ``c`` of ``--conns`` sends payloads ``c, c + conns, ...`` and
wraps around at the end. Every connection connects first, waits for
``--start-at`` (a ``time.time()`` value; default: now), sends for
``--warmup`` + ``--seconds`` seconds, then drains its in-flight requests.
Responses received in the measured window (the last ``--seconds``) count
toward the rate, their latencies (send to receipt, per request) toward the
percentiles, and the first ``--sample`` of them per connection are kept
with their payload index. ``--unique`` keeps only samples of a payload's
first send (for payloads whose answers depend on what they were batched
with, such as texts). The result ``.npz`` holds ``count`` (responses in the
window), ``lat_ms``, ``errors`` (non-200 responses), ``sample_idx``,
``sample_ids``, ``sample_scores``, ``cpu_s`` (this process's CPU seconds
from the start of sending to the end of draining) and ``first_error``.
"""

from __future__ import annotations

import argparse
import json
import socket
import struct
import threading
import time
from collections import deque

import numpy as np


def _request(path: str, body: bytes, ctype: str, binary_out: bool) -> bytes:
    accept = "Accept: application/octet-stream\r\n" if binary_out else ""
    return (
        f"POST {path} HTTP/1.1\r\nHost: localhost\r\nContent-Type: {ctype}\r\n"
        f"{accept}Content-Length: {len(body)}\r\n\r\n"
    ).encode() + body


def build_requests(mode: str, payloads, top_k: int) -> list[bytes]:
    path = f"/query?top_k={top_k}"
    if mode == "binary":
        return [_request(path, np.ascontiguousarray(p, "<f4").tobytes(),
                         "application/octet-stream", True) for p in payloads]
    if mode == "json":
        return [_request("/query", json.dumps({"vector": p.tolist(), "top_k": top_k}).encode(),
                         "application/json", False) for p in payloads]
    if mode == "text":
        return [_request(path, t.encode("utf-8"), "text/plain", True) for t in payloads]
    raise ValueError(f"unknown mode {mode!r}")


def parse_result(body: bytes, binary: bool):
    """(ids, scores) of one 200 response."""
    if binary:
        (k,) = struct.unpack_from("<I", body)
        ids = np.frombuffer(body, dtype="<i8", count=k, offset=4)
        scores = np.frombuffer(body, dtype="<f4", count=k, offset=4 + 8 * k)
        return ids, scores
    rows = json.loads(body)["results"]
    return (np.array([r["index"] for r in rows], dtype=np.int64),
            np.array([r["score"] for r in rows], dtype=np.float32))


class _Conn:
    """One keep-alive connection with ``depth`` pipelined requests."""

    def __init__(self, port, reqs, first, stride, depth, binary, sample, unique):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=120)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.reqs, self.next, self.stride, self.depth = reqs, first, stride, depth
        self.binary, self.sample, self.unique = binary, sample, unique
        self.lat: list[float] = []
        self.count = self.errors = 0
        self.first_error = ""
        self.samples: list[tuple[int, np.ndarray, np.ndarray]] = []

    def _send(self, n: int, pending: deque) -> None:
        out = []
        for _ in range(n):
            i = self.next
            self.next += self.stride
            out.append(self.reqs[i % len(self.reqs)])
            pending.append((i, time.perf_counter()))
        self.sock.sendall(b"".join(out))

    def run(self, t0: float, t1: float, t2: float) -> None:
        """Send from wall time ``t0`` to ``t2``; count responses received in
        [t1, t2). Times are ``time.time()`` values."""
        pending: deque = deque()
        buf = b""
        self._send(self.depth, pending)
        while pending:
            chunk = self.sock.recv(1 << 20)
            if not chunk:
                raise ConnectionError("server closed the connection")
            buf += chunk
            now = time.time()
            done, pos = 0, 0
            while True:
                end = buf.find(b"\r\n\r\n", pos)
                if end < 0:
                    break
                head = buf[pos:end]
                at = head.find(b"Content-Length: ")
                eol = head.find(b"\r\n", at)
                clen = int(head[at + 16:eol if eol >= 0 else len(head)])
                if len(buf) < end + 4 + clen:
                    break
                status = int(head[9:12])
                body = buf[end + 4:end + 4 + clen]
                pos = end + 4 + clen
                i, sent = pending.popleft()
                done += 1
                if status != 200:
                    self.errors += 1
                    if not self.first_error:
                        self.first_error = f"{status}: {body[:300]!r}"
                    continue
                if t1 <= now < t2:
                    self.count += 1
                    self.lat.append((time.perf_counter() - sent) * 1e3)
                    first_send = i < len(self.reqs)
                    if len(self.samples) < self.sample and (first_send or not self.unique):
                        ids, scores = parse_result(body, self.binary)
                        self.samples.append((i % len(self.reqs), ids.copy(), scores.copy()))
            buf = buf[pos:]
            if done and time.time() < t2:
                self._send(done, pending)
        self.sock.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--mode", choices=("binary", "json", "text"), required=True)
    p.add_argument("--payloads", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--conns", type=int, default=4)
    p.add_argument("--depth", type=int, default=32)
    p.add_argument("--warmup", type=float, default=1.0)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--start-at", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--sample", type=int, default=16, help="samples kept per connection")
    p.add_argument("--unique", action="store_true",
                   help="sample only a payload's first send")
    args = p.parse_args(argv)

    if args.mode == "text":
        with open(args.payloads, encoding="utf-8") as f:
            payloads = json.load(f)
    else:
        payloads = np.load(args.payloads)
    reqs = build_requests(args.mode, payloads, args.top_k)
    conns = [
        _Conn(args.port, reqs, c, args.conns, args.depth, args.mode != "json",
              args.sample, args.unique)
        for c in range(args.conns)
    ]
    t0 = max(time.time(), args.start_at)
    t1, t2 = t0 + args.warmup, t0 + args.warmup + args.seconds
    time.sleep(max(0.0, t0 - time.time()))
    cpu0 = time.process_time()
    failures: list[str] = []

    def run(conn):
        try:
            conn.run(t0, t1, t2)
        except Exception as e:  # noqa: BLE001 — reported in the result file
            failures.append(repr(e))

    threads = [threading.Thread(target=run, args=(c,)) for c in conns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=args.warmup + args.seconds + 120)
    if any(t.is_alive() for t in threads):
        failures.append("a connection did not finish")
    cpu_s = time.process_time() - cpu0
    samples = [s for c in conns for s in c.samples]
    k = max((len(s[1]) for s in samples), default=0)
    np.savez(
        args.out,
        count=sum(c.count for c in conns),
        lat_ms=np.array([x for c in conns for x in c.lat], dtype=np.float64),
        errors=sum(c.errors for c in conns),
        sample_idx=np.array([s[0] for s in samples], dtype=np.int64),
        sample_ids=np.array([np.pad(s[1], (0, k - len(s[1])), constant_values=-1)
                             for s in samples], dtype=np.int64).reshape(len(samples), k),
        sample_scores=np.array([np.pad(s[2], (0, k - len(s[2])), constant_values=np.nan)
                                for s in samples], dtype=np.float32).reshape(len(samples), k),
        cpu_s=cpu_s,
        first_error="; ".join(failures) or next((c.first_error for c in conns if c.first_error), ""),
    )
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
