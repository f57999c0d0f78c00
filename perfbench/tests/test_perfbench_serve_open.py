"""The open-loop driver times each request from its due time: against a stub
server that stalls, the requests due during the stall read the stall, and
the sender keeps to its schedule."""

from __future__ import annotations

import socket
import struct
import threading
import time

import numpy as np

from perfbench.drivers.serve_open import load, parse_answer, schedule

STALL_AT, STALL_S = 0.3, 0.25


class StubServer:
    """Answers every binary ``POST /query`` with ids 0, 1, 2, except that
    nothing is answered from ``STALL_AT`` to ``STALL_AT + STALL_S`` seconds
    after ``t0`` (answers held back go out when the stall ends)."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen()
        self.port = self.sock.getsockname()[1]
        self.t0 = None
        self.threads = []
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            self.threads.append(t)

    def _serve(self, conn):
        body = struct.pack("<I", 3) + np.arange(3, dtype="<i8").tobytes() + np.array([0.9, 0.8, 0.7], "<f4").tobytes()
        resp = (f"HTTP/1.1 200 OK\r\nContent-Type: application/octet-stream\r\n"
                f"Content-Length: {len(body)}\r\n\r\n").encode() + body
        buf = b""
        with conn:
            while True:
                chunk = conn.recv(1 << 16)
                if not chunk:
                    return
                buf += chunk
                while True:
                    end = buf.find(b"\r\n\r\n")
                    if end < 0:
                        break
                    head = buf[:end]
                    at = head.find(b"Content-Length: ")
                    clen = int(head[at + 16 :].split(b"\r\n")[0])
                    if len(buf) < end + 4 + clen:
                        break
                    buf = buf[end + 4 + clen :]
                    now = time.monotonic() - self.t0
                    if STALL_AT <= now < STALL_AT + STALL_S:
                        time.sleep(STALL_AT + STALL_S - now)
                    conn.sendall(resp)

    def close(self):
        self.sock.close()


def test_latency_counts_from_due_time_through_a_stall():
    srv = StubServer()
    rng = np.random.default_rng(3)
    due, payload = schedule(400.0, 0.8, 8, rng)
    pool = np.ones((8, 4), dtype=np.float32)
    start = time.monotonic() + 0.2
    srv.t0 = start
    try:
        r = load(srv.port, pool, due, payload, start, 2, 3, "cosine_similarity", {0, 5})
    finally:
        srv.close()
    assert (r["status"] == 200).all() and np.isfinite(r["done"]).all()
    lat = (r["done"] - (start + due)) * 1e3
    late = (r["sent"] - (start + due)) * 1e3
    in_stall = (due >= STALL_AT + 0.02) & (due < STALL_AT + STALL_S - 0.05)
    assert in_stall.sum() > 20
    # a request due inside the stall waits for the rest of it
    assert (lat[in_stall] >= (STALL_AT + STALL_S - due[in_stall]) * 1e3 - 5).all()
    # the sender did not wait for answers: it kept to the schedule
    assert np.median(late) < 5 and late.max() < 50
    after = due > STALL_AT + STALL_S + 0.1
    assert np.median(lat[after]) < 20
    ids, scores = parse_answer(r["bodies"][5])
    assert ids.tolist() == [0, 1, 2] and scores.tolist() == [np.float32(0.9), np.float32(0.8), np.float32(0.7)]


def test_schedule_offers_the_same_work_for_every_seed():
    a, _ = schedule(1000.0, 3.0, 100, np.random.default_rng(1))
    b, _ = schedule(1000.0, 3.0, 100, np.random.default_rng(2))
    assert len(a) == len(b) == 3000 and (np.diff(a) >= 0).all() and a.max() < 3.0
