"""The open-loop driver times each request from its due time: against a stub
server that stalls, the requests due during the stall read the stall, and
the sender keeps to its schedule, with one load process or several, whose
shares of the schedule merge into one run's."""

from __future__ import annotations

import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

from perfbench.drivers.serve_open import deal, drive, merge, parse_answer, schedule, split_latency

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


@pytest.mark.parametrize("parts", [1, 2])
def test_latency_counts_from_due_time_through_a_stall(parts, tmp_path):
    srv = StubServer()
    traffic = {"warm_s": 0.0, "start_delay_s": 1.5, "sample_requests": 8, "client_processes": parts,
               "connections": 2}
    every = sorted(os.sched_getaffinity(0))
    place = {"server": every, "load": [every] * parts}

    def on_window(t1, t2):
        srv.t0 = t1

    pool = np.ones((8, 4), dtype=np.float32)
    try:
        r = drive(srv.port, pool, traffic, 400.0, 0.8, np.random.default_rng(3), tmp_path, 3,
                  "cosine_similarity", place, on_window)
    finally:
        srv.close()
    assert r["failed"] == 0 and len(r["usage"]) == parts
    due, lat, late = r["due_s"], r["lat_ms"], r["lateness_ms"]
    in_stall = (due >= STALL_AT + 0.02) & (due < STALL_AT + STALL_S - 0.05)
    assert in_stall.sum() > 20
    # a request due inside the stall waits for the rest of it
    assert (lat[in_stall] >= (STALL_AT + STALL_S - due[in_stall]) * 1e3 - 5).all()
    # the sender did not wait for answers: it kept to the schedule
    assert np.median(late) < 5 and late.max() < 50
    after = due > STALL_AT + STALL_S + 0.1
    assert np.median(lat[after]) < 20
    assert len(r["sample_idx"]) == 8 and (np.diff(r["sample_idx"]) > 0).all()
    assert (r["sample_ids"] == [0, 1, 2]).all()
    assert np.allclose(r["sample_scores"], np.array([0.9, 0.8, 0.7], np.float32))


def test_parse_answer_reads_the_binary_wire():
    body = struct.pack("<I", 3) + np.arange(3, dtype="<i8").tobytes() + np.array([0.9, 0.8, 0.7], "<f4").tobytes()
    ids, scores = parse_answer(body)
    assert ids.tolist() == [0, 1, 2] and scores.tolist() == [np.float32(0.9), np.float32(0.8), np.float32(0.7)]


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_dealing_is_a_partition_merged_like_one_process(parts):
    n = 103
    shares = deal(n, parts)
    every = np.concatenate(shares)
    assert len(every) == n and sorted(every.tolist()) == list(range(n))  # each request sent once
    assert all((np.diff(s) > 0).all() and (s % parts == p).all() for p, s in enumerate(shares))  # due order kept
    due = np.sort(np.random.default_rng(5).uniform(0, 1, n))
    sample = np.array([3, 40, 41, 99])
    results = []
    for idx in shares:  # what each load process saves: its own requests, in its own order
        mine = np.isin(idx, sample)
        results.append({"index": idx, "sent": due[idx] + 1e-4, "done": due[idx] + 0.03,
                        "status": np.full(len(idx), 200, np.int32), "sample_idx": idx[mine],
                        "sample_ids": np.array([np.arange(3) + j for j in idx[mine]], np.int64).reshape(-1, 3),
                        "sample_scores": np.tile(np.float32([0.9, 0.8, 0.7]), (int(mine.sum()), 1))})
    m = merge(n, results)
    assert np.array_equal(m["sent"], due + 1e-4) and np.array_equal(m["done"], due + 0.03)
    assert (m["status"] == 200).all()
    assert m["sample_idx"].tolist() == sample.tolist()
    assert m["sample_ids"][:, 0].tolist() == sample.tolist()


def test_schedule_offers_the_same_work_for_every_seed():
    a, _ = schedule(1000.0, 3.0, 100, np.random.default_rng(1))
    b, _ = schedule(1000.0, 3.0, 100, np.random.default_rng(2))
    assert len(a) == len(b) == 3000 and (np.diff(a) >= 0).all() and a.max() < 3.0
    # one set of gaps in another order
    gaps = lambda d: np.sort(np.diff(d, prepend=0.0, append=3.0))  # noqa: E731
    assert np.allclose(gaps(a), gaps(b), rtol=0, atol=1e-12) and not np.array_equal(a, b)


def test_split_gives_each_answer_the_flush_that_answered_it():
    # two flushes: [1.000, 1.020] and [1.020, 1.045]; answers 2 ms after each
    flushes = [(1.000, 1.020, 2), (1.020, 1.045, 1)]
    due = np.array([0.990, 0.995, 1.010])
    sent = due + 0.0005
    done = np.array([1.022, 1.022, 1.047])
    parts = split_latency(sent, done, due, flushes)
    assert np.allclose(parts["late"], 0.5) and np.allclose(parts["hand"], 2.0)
    assert np.allclose(parts["engine"], [20.0, 20.0, 25.0])
    assert np.allclose(parts["wait"], [9.5, 4.5, 9.5])
    total = parts["late"] + parts["wait"] + parts["engine"] + parts["hand"]
    assert np.allclose(total, (done - due) * 1e3)
    # no answer, or an answer before any flush ended: left out
    parts = split_latency(sent, np.array([np.nan, 1.010, 1.047]), due, flushes)
    assert np.allclose(parts["engine"], [25.0])
