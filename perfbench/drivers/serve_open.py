"""Open-loop serving: Poisson arrivals of one-vector ``POST /query`` requests
to ``hyperdb_tpu_torch.native.server.NativeQueryServer``.

The rate is fixed in the traffic file. The arrivals of one run are a
Poisson process over ``warm_s`` + the window, conditioned on its count: a
fixed number of requests (rate x duration) at sorted uniform times drawn
from the seed, so every seed offers the same work in another order. Each
request carries one query of the pool, drawn from the seed, as a raw
little-endian float32 body, and asks for a binary answer.

One load process (``connections`` keep-alive connections) runs this file as
a script: it imports the standard library and NumPy only. It runs on the
last ``client_cores`` cores of the host and the server's process on the
others, as clients on other hosts would: sharing cores, a stall of either is
read as the other's latency. It sends every request at its due time whatever
has come back, and times it from that due time to the last byte of its
response, so a stall raises the latency of every request due during it.
Requests due in the window's ``seconds`` after ``warm_s`` seconds of load
make the population of the percentiles; a request that gets no answer by
the end of the drain, or an answer other than 200, counts as failed. How
late the sender ran (send time minus due time) is printed on its own line.

    python3 perfbench/drivers/serve_open.py --port P --pool pool.npy \
        --schedule s.npz --start T --connections C --top-k K --out r.npz
"""

from __future__ import annotations

import argparse
import os
import selectors
import socket
import struct
import subprocess
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np

DRAIN_S = 60.0  # how long after the last due time answers are awaited
TAIL_S = 0.5  # window left after a traced run's profiled stretch


def schedule(rate: float, total_s: float, pool: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """(due offsets in seconds, pool index) of every request of a run."""
    count = int(round(rate * total_s))
    return np.sort(rng.uniform(0.0, total_s, count)), rng.integers(0, pool, count)


def _request(vec: np.ndarray, top_k: int, metric: str) -> bytes:
    body = np.ascontiguousarray(vec, dtype="<f4").tobytes()
    return (
        f"POST /query?top_k={top_k}&metric={metric} HTTP/1.1\r\nHost: localhost\r\n"
        f"Content-Type: application/octet-stream\r\nAccept: application/octet-stream\r\n"
        f"Content-Length: {len(body)}\r\n\r\n"
    ).encode() + body


def parse_answer(body: bytes) -> tuple[np.ndarray, np.ndarray]:
    """(ids, scores) of a binary answer ``[u32 k][k x i64][k x f32]``."""
    (k,) = struct.unpack_from("<I", body)
    ids = np.frombuffer(body, dtype="<i8", count=k, offset=4)
    scores = np.frombuffer(body, dtype="<f4", count=k, offset=4 + 8 * k)
    return ids, scores


def load(port: int, pool: np.ndarray, due: np.ndarray, payload: np.ndarray,
         start: float, connections: int, top_k: int, metric: str, sample: set) -> dict:
    """Send request ``j`` at ``start + due[j]`` (``time.monotonic``) over
    ``connections`` keep-alive connections, round robin, and collect their
    answers. Returns arrays ``sent``, ``done`` (NaN: no answer), ``status``
    and the bodies of the requests in ``sample``."""
    reqs: dict[int, bytes] = {}
    socks = []
    for _ in range(connections):
        s = socket.create_connection(("127.0.0.1", port), timeout=30)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        socks.append(s)
    sel = selectors.DefaultSelector()
    for c, s in enumerate(socks):
        sel.register(s, selectors.EVENT_READ, c)
    n = len(due)
    sent = np.full(n, np.nan)
    done = np.full(n, np.nan)
    status = np.zeros(n, dtype=np.int32)
    bodies: dict[int, bytes] = {}
    pending = [deque() for _ in socks]
    bufs = [bytearray() for _ in socks]
    nxt = outstanding = 0
    deadline = start + (float(due[-1]) if n else 0.0) + DRAIN_S
    try:
        while (nxt < n or outstanding) and time.monotonic() < deadline:
            now = time.monotonic()
            while nxt < n and start + due[nxt] <= now:
                c = nxt % connections
                p = int(payload[nxt])
                if p not in reqs:
                    reqs[p] = _request(pool[p], top_k, metric)
                socks[c].sendall(reqs[p])
                sent[nxt] = time.monotonic()
                pending[c].append(nxt)
                outstanding += 1
                nxt += 1
            wait = (start + due[nxt] - time.monotonic()) if nxt < n else 0.05
            for key, _ in sel.select(min(max(wait, 0.0), 0.05)):
                c = key.data
                chunk = socks[c].recv(1 << 20)
                if not chunk:
                    raise ConnectionError("the server closed a connection")
                t = time.monotonic()
                buf = bufs[c]
                buf += chunk
                pos = 0
                while True:
                    end = buf.find(b"\r\n\r\n", pos)
                    if end < 0:
                        break
                    head = bytes(buf[pos:end])
                    at = head.find(b"Content-Length: ")
                    eol = head.find(b"\r\n", at)
                    clen = int(head[at + 16 : eol if eol >= 0 else len(head)])
                    if len(buf) < end + 4 + clen:
                        break
                    j = pending[c].popleft()
                    outstanding -= 1
                    done[j] = t
                    status[j] = int(head[9:12])
                    if j in sample:
                        bodies[j] = bytes(buf[end + 4 : end + 4 + clen])
                    pos = end + 4 + clen
                del buf[:pos]
    finally:
        for s in socks:
            s.close()
    return {"sent": sent, "done": done, "status": status, "bodies": bodies}


def split_cores(client_cores: int) -> tuple[list[int], list[int]]:
    """(server cores, client cores): the last ``client_cores`` of this
    process's cores for the load, the rest for the server (all cores for
    both when ``client_cores`` is 0 or leaves the server none)."""
    cores = sorted(os.sched_getaffinity(0))
    if client_cores <= 0 or client_cores >= len(cores):
        return cores, cores
    return cores[:-client_cores], cores[-client_cores:]


def pin_process(cores) -> None:
    """Every thread of this process onto ``cores`` (threads made later inherit)."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cores)
        except (ProcessLookupError, PermissionError):
            pass  # a thread that has just ended, or one the host will not move


def _main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one load process of the open loop")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--pool", required=True)
    p.add_argument("--schedule", required=True)
    p.add_argument("--start", type=float, required=True)
    p.add_argument("--connections", type=int, required=True)
    p.add_argument("--top-k", type=int, required=True)
    p.add_argument("--metric", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--cores", default="", help="comma-separated cores to run on")
    a = p.parse_args(argv)
    if a.cores:
        pin_process([int(c) for c in a.cores.split(",")])
    pool = np.load(a.pool)
    with np.load(a.schedule) as s:
        due, payload, sample = s["due"], s["payload"], s["sample"]
    r = load(a.port, pool, due, payload, a.start, a.connections, a.top_k, a.metric,
             set(int(x) for x in sample))
    keys = sorted(r["bodies"])
    answers = [parse_answer(r["bodies"][i]) for i in keys]
    k = max((len(x[0]) for x in answers), default=0)
    np.savez(
        a.out, sent=r["sent"], done=r["done"], status=r["status"],
        sample_idx=np.array(keys, dtype=np.int64),
        sample_ids=np.array([np.pad(i, (0, k - len(i)), constant_values=-1) for i, _ in answers],
                            dtype=np.int64).reshape(len(keys), k),
        sample_scores=np.array([np.pad(s, (0, k - len(s)), constant_values=np.nan) for _, s in answers],
                               dtype=np.float32).reshape(len(keys), k),
    )
    return 0


def drive(port: int, pool: np.ndarray, traffic: dict, rate: float, seconds: float, rng, tmp: Path,
          top_k: int, metric: str, on_window=None) -> dict:
    """One open-loop run against a server on ``port``: ``traffic['warm_s']``
    seconds of load, then the window of ``seconds``. ``on_window(t1, t2)``
    (``time.monotonic`` bounds of the window) runs in this process while the
    load process sends. Returns per request of the window ``lat_ms`` (NaN:
    failed) and ``due_s`` (its due time from the window's start),
    ``lateness_ms`` of every request, ``attempted``, ``failed``, the
    due-ordered ``payload`` and the sampled answers."""
    warm = float(traffic["warm_s"])
    due, payload = schedule(rate, warm + seconds, len(pool), rng)
    window = np.flatnonzero(due >= warm)
    sample = np.sort(rng.choice(window, min(int(traffic["sample_requests"]), len(window)), replace=False))
    np.save(tmp / "pool.npy", pool)
    np.savez(tmp / "schedule.npz", due=due, payload=payload, sample=sample)
    _server_cores, client = split_cores(int(traffic["client_cores"]))
    start = time.monotonic() + float(traffic["start_delay_s"])
    cmd = [sys.executable, str(Path(__file__).resolve()), "--port", str(port),
           "--pool", str(tmp / "pool.npy"), "--schedule", str(tmp / "schedule.npz"),
           "--start", repr(start), "--connections", str(traffic["connections"]),
           "--top-k", str(top_k), "--metric", metric, "--out", str(tmp / "result.npz"),
           "--cores", ",".join(map(str, client))]
    with open(tmp / "load.log", "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        try:
            if on_window is not None:
                on_window(start + warm, start + warm + seconds)
            proc.wait(timeout=max(0.0, start + warm + seconds - time.monotonic()) + DRAIN_S + 30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if proc.returncode:
        raise RuntimeError(f"the load process failed:\n{(tmp / 'load.log').read_text()[-2000:]}")
    with np.load(tmp / "result.npz") as r:
        sent, done, status = r["sent"], r["done"], r["status"]
        got_idx, got_ids, got_scores = r["sample_idx"], r["sample_ids"], r["sample_scores"]
    abs_due = start + due
    ok = (status == 200) & np.isfinite(done)
    lat = np.where(ok, (done - abs_due) * 1e3, np.nan)[window]
    return {
        "lat_ms": lat,
        "lateness_ms": (sent - abs_due) * 1e3,
        "attempted": int(len(window)),
        "failed": int(np.count_nonzero(~ok[window])),
        "payload": payload,
        "sample_idx": got_idx,
        "sample_ids": got_ids if len(got_idx) else None,
        "sample_scores": got_scores if len(got_idx) else None,
        "due_s": due[window] - warm,
        "window_lat_first_last_s": _first_last(lat, due[window] - warm, seconds),
    }


def _first_last(lat: np.ndarray, t: np.ndarray, seconds: float) -> tuple[float, float]:
    """Median latency of the requests due in the window's first and last second."""
    first = lat[(t < 1.0) & np.isfinite(lat)]
    last = lat[(t >= seconds - 1.0) & np.isfinite(lat)]
    med = lambda x: float(np.median(x)) if x.size else float("nan")  # noqa: E731
    return med(first), med(last)


class _ProfiledDB:
    """The DB as the server sees it in a traced run. The server's worker
    thread makes every engine call, and only a profiler started in that
    thread records its operations and kernels, so the profiler starts at the
    first call after ``start_at`` and stops at the end of the first call
    that ends after ``stop_at`` (``time.perf_counter`` times). Stopping is
    all the worker does: the trace is exported and read afterwards, by
    :func:`perfbench.trace.summary` in the harness's own thread, so the
    server is not held up by it while requests wait."""

    def __init__(self, db, device):
        self.db = db
        self.device = device
        self.start_at = self.stop_at = float("inf")
        self.prof = None
        self.done = None
        self.start_cost_s = None

    def query_batch_arrays(self, *args, **kwargs):
        from perfbench.trace import Profile

        if self.prof is None and self.done is None and time.perf_counter() >= self.start_at:
            t0 = time.perf_counter()
            self.prof = Profile(self.device).__enter__()
            self.start_cost_s = time.perf_counter() - t0
        try:
            return self.db.query_batch_arrays(*args, **kwargs)
        finally:
            if self.prof is not None and time.perf_counter() >= self.stop_at:
                self.finish()

    def finish(self) -> None:
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.done, self.prof = self.prof, None


def run(ctx: dict) -> dict:
    """A run of a served cell, in the harness process: the DB, the server at
    the traffic's ``max_batch`` and ``window_ms``, warm-up of the batch
    shapes a flush can take, then :func:`drive` at ``rate_per_s``."""
    import tempfile

    import torch

    from hyperdb_tpu_torch.native.server import NativeQueryServer
    from perfbench import program
    from perfbench.data import sub_seed
    from perfbench.trace import summary, warm

    cfg, tr, dev = ctx["config"], ctx["traffic"], ctx["device"]
    k, metric = int(cfg["top_k"]), cfg["metric"]
    pool = ctx["pool"]
    pin_process(split_cores(int(tr["client_cores"]))[0])
    db, build_s = program.build_db(ctx["master"], pool[0], cfg, dev)
    served = db
    if ctx["trace"]:
        warm(dev)
        served = _ProfiledDB(db, dev)
    server = NativeQueryServer(served, host="127.0.0.1", port=0, max_batch=int(tr["max_batch"]),
                               window_ms=float(tr["window_ms"]))
    marks: dict = {}

    def counters():
        return {"flushes": server.flushes, "queries": server.flushed_queries,
                "engine_s": server.engine_s, "complete_s": server.complete_s, "idle_s": server.idle_s}

    # a traced run profiles ``profile_s`` seconds that end ``TAIL_S`` before
    # the window's end, so that the worker's next call ends the profile
    # inside the window; the counters' stretch ends where the profile begins
    profile_s = float(tr["profile_s"]) if ctx["trace"] else 0.0
    tail_s = TAIL_S if ctx["trace"] else 0.0

    def on_window(t1: float, t2: float) -> None:
        time.sleep(max(0.0, t1 - time.monotonic()))
        marks["window_start"] = time.perf_counter()
        marks["c1"] = counters()
        end = t2 - profile_s - tail_s
        if ctx["trace"]:
            served.start_at = time.perf_counter() + (end - time.monotonic())
            served.stop_at = served.start_at + profile_s
        time.sleep(max(0.0, end - time.monotonic()))
        marks["c2"] = counters()

    try:
        db.warmup(top_ks=(k,), metric=metric, max_batch=int(tr["max_batch"]),
                  dtypes=["float16" if server.wire_f16 else "float32"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rng = np.random.default_rng(sub_seed(ctx["seed"], "arrivals"))
        with tempfile.TemporaryDirectory(prefix="perfbench-serve-") as tmp:
            res = drive(server.port, pool, tr, float(tr["rate_per_s"]), ctx["seconds"], rng, Path(tmp),
                        k, metric, on_window)
    finally:
        server.close()
    if ctx["trace"]:
        if served.prof is not None:  # only the worker thread may stop its profiler
            raise RuntimeError("the server made no engine call after the profiled stretch")
        marks["trace"] = summary(served.done) if served.done is not None else None
        marks["profile_start_s"] = served.start_cost_s
    peak = program.memory_peak(dev)
    del db, server, served
    program.free(dev)

    lat = res["lat_ms"]
    fin = lat[np.isfinite(lat)]
    c1, c2 = marks["c1"], marks["c2"]
    flushes = c2["flushes"] - c1["flushes"]
    native = None
    if flushes > 0:
        native = {
            "flushes": flushes,
            "mean_flush": (c2["queries"] - c1["queries"]) / flushes,
            "engine_ms": 1e3 * (c2["engine_s"] - c1["engine_s"]) / flushes,
            "complete_ms": 1e3 * (c2["complete_s"] - c1["complete_s"]) / flushes,
        }
    late = res["lateness_ms"][np.isfinite(res["lateness_ms"])]
    lines = [
        f"load: {res['attempted']} requests due in the window at {tr['rate_per_s']} requests/s, "
        f"{res['failed']} failed; sender lateness median {float(np.median(late)):.4f} ms, "
        f"worst {float(np.max(late)):.4f} ms",
        "window median latency, first second / last second: %.4f / %.4f ms" % res["window_lat_first_last_s"],
    ]
    if ctx["trace"]:
        lo = ctx["seconds"] - profile_s - tail_s
        before = lat[(res["due_s"] < lo) & np.isfinite(lat)]
        inside = lat[(res["due_s"] >= lo) & (res["due_s"] < lo + profile_s) & np.isfinite(lat)]
        lines.append(
            f"traced: profiler started in {marks['profile_start_s']} s; median latency of requests due "
            f"before the profiled {profile_s} s / inside it: "
            f"{float(np.median(before)) if before.size else float('nan'):.4f} / "
            f"{float(np.median(inside)) if inside.size else float('nan'):.4f} ms")
    if native:
        lines.append("native counters from the window's start to its end (traced: to the profile's start): " + ", ".join(f"{a} {b}" for a, b in native.items()))
    ids = res["sample_ids"]
    return {
        "window_start": marks["window_start"],
        "e2e": {
            "p50_ms": float(np.percentile(fin, 50)) if fin.size else None,
            "p99_ms": float(np.percentile(fin, 99)) if fin.size else None,
        },
        "attempted": res["attempted"],
        "failed": res["failed"],
        "sample": (pool[res["payload"][res["sample_idx"]]], ids, res["sample_scores"]),
        "memory_peak_bytes": peak,
        "layer_ctx": {"trace": marks.get("trace"), "native": native, "store_build_s": build_s},
        "lines": lines,
    }


if __name__ == "__main__":
    raise SystemExit(_main())
