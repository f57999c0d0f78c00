"""Open-loop serving: Poisson arrivals of one-vector ``POST /query`` requests
to ``hyperdb_tpu_torch.native.server.NativeQueryServer``.

The rate is fixed in the traffic file. The arrivals of one run are a
Poisson process over ``warm_s`` + the window, conditioned on its count: a
fixed number of requests (rate x duration) at sorted uniform times. Their
gaps are one set, drawn once from :data:`ARRIVALS_SEED`, that the seed puts
in another order, so every seed offers the same work and the same arrivals
in another order. Each
request carries one query of the pool, drawn from the seed, as a raw
little-endian float32 body, and asks for a binary answer.

``client_processes`` load processes run this file as a script: it imports
the standard library and NumPy only. Process ``p`` sends request ``j``
wherever ``j mod client_processes == p``, at the same due time, over its
share of the ``connections`` keep-alive connections; the harness merges
their results by request. Each runs on a whole physical core of its own and
the server's process on the others, the load cores' SMT siblings left out
of the server's set (:func:`perfbench.hostmap.place`), as clients on other
hosts would: sharing a core, a stall of either is read as the other's
latency. A host that does not enforce affinity runs them where it will. Each sends every request at its due time whatever has
come back (polling, not sleeping, in the last ``SPIN_S`` before it), and
times it from that due time to the last byte of its response, so a stall
raises the latency of every request due during it. The due-time clock
starts ``start_delay_s`` after every load process has opened its
connections.
Requests due in the window's ``seconds`` after ``warm_s`` seconds of load
make the population of the percentiles; a request that gets no answer by
the end of the drain, or an answer other than 200, counts as failed. Each
run's lines say where the time went (sender lateness, the wait for a flush,
the engine, the hand-back), where each process ran and how much CPU each
load process used.

    python3 perfbench/drivers/serve_open.py --port P --pool pool.npy \
        --schedule s.npz --connections C --top-k K --out r.npz \
        [--part p --parts P --cores 6,7]

reads the first due time from standard input once it has printed ``ready``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import resource
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
# Closer than this to its next due time a load process polls its sockets
# instead of sleeping: waking from a sleep can take milliseconds on a
# virtualised host, and every such wake-up would make the send late.
SPIN_S = 0.002
# The one draw of arrival times whose gaps every seed's schedule reorders.
ARRIVALS_SEED = 20260418


def schedule(rate: float, total_s: float, pool: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """(due offsets in seconds, pool index) of every request of a run: the
    ``count + 1`` gaps of ``count`` sorted uniform times over ``total_s``,
    drawn once from :data:`ARRIVALS_SEED`, in an order drawn from ``rng``."""
    count = int(round(rate * total_s))
    base = np.sort(np.random.default_rng(ARRIVALS_SEED).uniform(0.0, total_s, count))
    gaps = np.diff(base, prepend=0.0, append=total_s)
    return np.cumsum(rng.permutation(gaps))[:count], rng.integers(0, pool, count)


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
         begin, connections: int, top_k: int, metric: str, sample: set) -> dict:
    """Open ``connections`` keep-alive connections, then call ``begin()``
    for the start (``time.monotonic``), send request ``j`` at ``start +
    due[j]`` over them, round robin, and collect their answers. Returns
    arrays ``sent``, ``done`` (NaN: no answer), ``status`` and the bodies of
    the requests in ``sample``."""
    reqs: dict[int, bytes] = {}
    socks = []
    for _ in range(connections):
        s = socket.create_connection(("127.0.0.1", port), timeout=30)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        socks.append(s)
    # select(2) takes its timeout in microseconds, epoll in whole
    # milliseconds: a request due 0.2 ms ahead would wait a millisecond
    sel = selectors.SelectSelector()
    for c, s in enumerate(socks):
        sel.register(s, selectors.EVENT_READ, c)
    start = begin()
    n = len(due)
    due_at = (start + np.asarray(due, dtype=np.float64)).tolist()
    sent = np.full(n, np.nan)
    done = np.full(n, np.nan)
    status = np.zeros(n, dtype=np.int32)
    bodies: dict[int, bytes] = {}
    pending = [deque() for _ in socks]
    bufs = [bytearray() for _ in socks]
    nxt = outstanding = 0
    deadline = (due_at[-1] if n else start) + DRAIN_S

    def send_due() -> None:
        nonlocal nxt, outstanding
        now = time.monotonic()
        while nxt < n and due_at[nxt] <= now:
            c = nxt % connections
            p = int(payload[nxt])
            if p not in reqs:
                reqs[p] = _request(pool[p], top_k, metric)
            socks[c].sendall(reqs[p])
            sent[nxt] = time.monotonic()
            pending[c].append(nxt)
            outstanding += 1
            nxt += 1

    try:
        while (nxt < n or outstanding) and time.monotonic() < deadline:
            send_due()
            wait = (due_at[nxt] - time.monotonic()) if nxt < n else 0.05
            for key, _ in sel.select(0.0 if wait <= SPIN_S else min(wait - SPIN_S, 0.05)):
                send_due()  # what fell due while answers were read goes out first
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


def _usage() -> tuple[float, float, int, int]:
    """(CPU seconds, wall seconds, voluntary and involuntary context
    switches) of this process so far."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime, time.monotonic(), ru.ru_nvcsw, ru.ru_nivcsw


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
    p.add_argument("--connections", type=int, required=True)
    p.add_argument("--top-k", type=int, required=True)
    p.add_argument("--metric", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--cores", default="", help="comma-separated cores to run on")
    p.add_argument("--part", type=int, default=0, help="this process's share: requests j with j mod parts == part")
    p.add_argument("--parts", type=int, default=1)
    a = p.parse_args(argv)
    if a.cores:
        pin_process([int(c) for c in a.cores.split(",")])
    pool = np.load(a.pool)
    with np.load(a.schedule) as s:
        due, payload, sample = s["due"], s["payload"], s["sample"]
    mine = deal(len(due), a.parts)[a.part]
    u0 = _usage()

    def begin() -> float:
        """Say that the connections are open; the harness answers with the
        first due time once every load process has said so."""
        print("ready", flush=True)
        return float(sys.stdin.readline())

    gc.disable()  # the loop makes no cycles; a collection would stall the sends
    r = load(a.port, pool, due[mine], payload[mine], begin, len(deal(a.connections, a.parts)[a.part]),
             a.top_k, a.metric, set(np.flatnonzero(np.isin(mine, sample)).tolist()))
    gc.enable()
    u1 = _usage()
    usage = {"cpu_s": u1[0] - u0[0], "wall_s": u1[1] - u0[1], "voluntary": u1[2] - u0[2],
             "involuntary": u1[3] - u0[3],
             "cpus": sorted(os.sched_getaffinity(0))}
    keys = sorted(r["bodies"])
    answers = [parse_answer(r["bodies"][i]) for i in keys]
    k = max((len(x[0]) for x in answers), default=0)
    np.savez(
        a.out, index=mine, sent=r["sent"], done=r["done"], status=r["status"], usage=json.dumps(usage),
        sample_idx=mine[np.array(keys, dtype=np.int64)],
        sample_ids=np.array([np.pad(i, (0, k - len(i)), constant_values=-1) for i, _ in answers],
                            dtype=np.int64).reshape(len(keys), k),
        sample_scores=np.array([np.pad(s, (0, k - len(s)), constant_values=np.nan) for _, s in answers],
                               dtype=np.float32).reshape(len(keys), k),
    )
    return 0


def deal(n: int, parts: int) -> list[np.ndarray]:
    """Indices ``0 .. n-1`` dealt to ``parts`` load processes: process ``p``
    takes every ``j`` with ``j mod parts == p``, in order."""
    return [np.arange(p, n, parts) for p in range(parts)]


def merge(n: int, shares: list[dict]) -> dict:
    """The load processes' results as one process's: ``sent``, ``done`` and
    ``status`` indexed by request, the sampled answers ordered by request."""
    sent, done = np.full(n, np.nan), np.full(n, np.nan)
    status = np.zeros(n, dtype=np.int32)
    for r in shares:
        sent[r["index"]], done[r["index"]], status[r["index"]] = r["sent"], r["done"], r["status"]
    idx = np.concatenate([r["sample_idx"] for r in shares])
    order = np.argsort(idx, kind="stable")
    k = max(r["sample_ids"].shape[1] for r in shares)
    pad = lambda a, v: np.pad(a, ((0, 0), (0, k - a.shape[1])), constant_values=v)  # noqa: E731
    return {
        "sent": sent, "done": done, "status": status, "sample_idx": idx[order],
        "sample_ids": np.concatenate([pad(r["sample_ids"], -1) for r in shares])[order],
        "sample_scores": np.concatenate([pad(r["sample_scores"], np.nan) for r in shares])[order],
    }


def placement(traffic: dict) -> dict:
    """Where a served run puts its processes (:func:`perfbench.hostmap.place`
    over this process's CPUs, read before anything is pinned): ``server``
    and ``load`` (one CPU list per load process), with the readings it was
    decided from."""
    from perfbench import hostmap

    affinity = sorted(os.sched_getaffinity(0))
    siblings = hostmap.smt_siblings(affinity)
    bus = hostmap.card_bus_id()
    node, node_cpus = hostmap.card_numa(bus)
    server, load = hostmap.place(affinity, siblings, int(traffic["client_processes"]))
    return {"server": server, "load": load, "siblings": siblings, "card_bus": bus, "card_node": node,
            "card_cpus": node_cpus}


def drive(port: int, pool: np.ndarray, traffic: dict, rate: float, seconds: float, rng, tmp: Path,
          top_k: int, metric: str, place: dict, on_window=None) -> dict:
    """One open-loop run against a server on ``port``: ``traffic['warm_s']``
    seconds of load, then the window of ``seconds``, sent by
    ``client_processes`` load processes on the CPUs of ``place['load']``
    (:func:`placement`). ``on_window(t1, t2)`` (``time.monotonic`` bounds of
    the window) runs in this process while the load processes send. Returns
    per request of the window ``lat_ms`` (NaN: failed), ``due_s`` (its due
    time from the window's start), ``sent``, ``done`` and ``abs_due``;
    ``lateness_ms`` of every request, ``attempted``, ``failed``, the
    due-ordered ``payload``, the sampled answers, each load process's
    ``usage`` and ``ready_s``, the seconds the processes took to start."""
    warm = float(traffic["warm_s"])
    parts = int(traffic["client_processes"])
    if not 1 <= parts <= int(traffic["connections"]):
        raise ValueError(f"client_processes {parts} needs 1 to connections ({traffic['connections']}) processes")
    due, payload = schedule(rate, warm + seconds, len(pool), rng)
    window = np.flatnonzero(due >= warm)
    sample = np.sort(rng.choice(window, min(int(traffic["sample_requests"]), len(window)), replace=False))
    np.save(tmp / "pool.npy", pool)
    np.savez(tmp / "schedule.npz", due=due, payload=payload, sample=sample)
    cmd = [sys.executable, str(Path(__file__).resolve()), "--port", str(port),
           "--pool", str(tmp / "pool.npy"), "--schedule", str(tmp / "schedule.npz"),
           "--connections", str(traffic["connections"]),
           "--top-k", str(top_k), "--metric", metric, "--parts", str(parts)]
    procs = []
    try:
        t_spawn = time.monotonic()
        for p in range(parts):
            with open(tmp / f"load{p}.log", "w") as log:
                procs.append(subprocess.Popen(
                    cmd + ["--part", str(p), "--out", str(tmp / f"result{p}.npz"),
                           "--cores", ",".join(map(str, place["load"][p]))],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=log, text=True))
        for p, proc in enumerate(procs):
            if proc.stdout.readline().strip() != "ready":
                proc.wait(timeout=30)
                raise RuntimeError(f"load process {p} failed:\n{(tmp / f'load{p}.log').read_text()[-2000:]}")
        ready_s = time.monotonic() - t_spawn
        # one due-time clock for every process, started once all are ready
        start = time.monotonic() + float(traffic["start_delay_s"])
        for proc in procs:
            proc.stdin.write(f"{start!r}\n")
            proc.stdin.close()
        if on_window is not None:
            on_window(start + warm, start + warm + seconds)
        for proc in procs:
            proc.wait(timeout=max(0.0, start + warm + seconds - time.monotonic()) + DRAIN_S + 30)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
    for p, proc in enumerate(procs):
        if proc.returncode:
            raise RuntimeError(f"load process {p} failed:\n{(tmp / f'load{p}.log').read_text()[-2000:]}")
    shares = []
    for p in range(parts):
        with np.load(tmp / f"result{p}.npz") as r:
            shares.append({key: r[key] for key in r.files})
    m = merge(len(due), shares)
    sent, done, status = m["sent"], m["done"], m["status"]
    abs_due = start + due
    ok = (status == 200) & np.isfinite(done)
    lat = np.where(ok, (done - abs_due) * 1e3, np.nan)[window]
    got_idx = m["sample_idx"]
    return {
        "lat_ms": lat,
        "lateness_ms": (sent - abs_due) * 1e3,
        "attempted": int(len(window)),
        "failed": int(np.count_nonzero(~ok[window])),
        "payload": payload,
        "sample_idx": got_idx,
        "sample_ids": m["sample_ids"] if len(got_idx) else None,
        "sample_scores": m["sample_scores"] if len(got_idx) else None,
        "due_s": due[window] - warm,
        "window_lat_first_last_s": _first_last(lat, due[window] - warm, seconds),
        "sent": sent[window], "done": done[window], "abs_due": abs_due[window],
        "usage": [json.loads(str(r["usage"])) for r in shares],
        "ready_s": ready_s,
    }


def _first_last(lat: np.ndarray, t: np.ndarray, seconds: float) -> tuple[float, float]:
    """Median latency of the requests due in the window's first and last second."""
    first = lat[(t < 1.0) & np.isfinite(lat)]
    last = lat[(t >= seconds - 1.0) & np.isfinite(lat)]
    med = lambda x: float(np.median(x)) if x.size else float("nan")  # noqa: E731
    return med(first), med(last)


class _ServedDB:
    """The DB as the server sees it. Every engine call's start and end
    (``time.monotonic``, the load processes' clock) and its batch are kept,
    so that each answered request can be given the flush that answered it.

    In a traced run it also profiles. The server's worker thread makes every
    engine call, and only a profiler started in that thread records its
    operations and kernels, so the profiler starts at the first call after
    ``start_at`` and stops at the end of the first call that ends after
    ``stop_at`` (``time.perf_counter`` times). Stopping is all the worker
    does: the trace is exported and read afterwards, by
    :func:`perfbench.trace.summary` in the harness's own thread, so the
    server is not held up by it while requests wait."""

    def __init__(self, db, device):
        self.db = db
        self.device = device
        self.start_at = self.stop_at = float("inf")
        self.prof = None
        self.done = None
        self.start_cost_s = None
        self.flushes: list[tuple[float, float, int]] = []

    def query_batch_arrays(self, *args, **kwargs):
        from perfbench.trace import Profile

        if self.prof is None and self.done is None and time.perf_counter() >= self.start_at:
            t0 = time.perf_counter()
            self.prof = Profile(self.device).__enter__()
            self.start_cost_s = time.perf_counter() - t0
        t0 = time.monotonic()
        try:
            return self.db.query_batch_arrays(*args, **kwargs)
        finally:
            self.flushes.append((t0, time.monotonic(), len(args[0])))
            if self.prof is not None and time.perf_counter() >= self.stop_at:
                self.finish()

    def finish(self) -> None:
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.done, self.prof = self.prof, None


def split_latency(sent, done, due, flushes) -> dict[str, np.ndarray]:
    """Each answered request's latency in four parts, ms: ``late`` (due to
    sent), ``wait`` (sent to the start of its flush), ``engine`` (the flush's
    engine call) and ``hand`` (the flush's end to the answer's receipt
    stamp). A request's flush is the last to end before its answer came;
    requests with no answer, or none such, are left out."""
    ok = np.isfinite(done)
    sent, done, due = sent[ok], done[ok], due[ok]
    if not len(flushes):
        empty = np.zeros(0)
        return {"late": empty, "wait": empty, "engine": empty, "hand": empty}
    f = np.asarray(flushes, dtype=np.float64)[:, :2]
    f = f[np.argsort(f[:, 1])]
    i = np.searchsorted(f[:, 1], done, side="right") - 1
    has = i >= 0
    i, sent, done, due = i[has], sent[has], done[has], due[has]
    start, end = f[i, 0], f[i, 1]
    return {"late": 1e3 * (sent - due), "wait": 1e3 * (start - sent), "engine": 1e3 * (end - start),
            "hand": 1e3 * (done - end)}


def _pcts(x: np.ndarray) -> str:
    if not x.size:
        return "none"
    p50, p99 = np.percentile(x, [50, 99])
    return f"p50 {p50:.4f}, p99 {p99:.4f}, worst {float(np.max(x)):.4f} ms"


def flush_lines(flushes, since: float) -> list[str]:
    """The engine's time a flush by the batch's power-of-two size (the
    engine pads to one), over the flushes that start after ``since``."""
    f = np.asarray([x for x in flushes if x[0] >= since], dtype=np.float64).reshape(-1, 3)
    pad = 2 ** np.ceil(np.log2(np.maximum(f[:, 2], 1)))
    parts = [f"{int(b)}: {int((pad == b).sum())} flushes, median {1e3 * float(np.median(np.diff(f[pad == b, :2]))):.4f} ms"
             for b in np.unique(pad)]
    return ["engine by flush size, padded: " + ("; ".join(parts) or "no flush")]


def split_lines(lat: np.ndarray, parts: dict[str, np.ndarray]) -> list[str]:
    """The run's lines on where a request's time went: each part of
    :func:`split_latency` over all answered requests, and its median over the
    requests within 1 ms of the window's p50 and over those at or above its
    p99."""
    fin = lat[np.isfinite(lat)]
    if not fin.size or not parts["late"].size:
        return ["split: no answered request"]
    p50, p99 = np.percentile(fin, [50, 99])
    total = parts["late"] + parts["wait"] + parts["engine"] + parts["hand"]
    lines = [f"split {name}: {_pcts(v)}" for name, v in parts.items()]
    for label, sel in (("near p50", np.abs(total - p50) <= 1.0), ("at or above p99", total >= p99)):
        med = {name: float(np.median(v[sel])) if sel.any() else float("nan") for name, v in parts.items()}
        lines.append(f"split of the {int(sel.sum())} requests {label} (medians, ms): "
                     + ", ".join(f"{n} {v:.4f}" for n, v in med.items()))
    return lines


def host_lines(res: dict, pl: dict) -> list[str]:
    """The run's lines on where the load and the server ran and how much
    CPU each load process used."""
    out = []
    for p, u in enumerate(res["usage"]):
        out.append(f"load process {p}: cpus {u['cpus']}, {u['cpu_s']:.4f} CPU s over {u['wall_s']:.4f} s, "
                   f"{u['voluntary']} voluntary / {u['involuntary']} involuntary switches")
    out.append(f"load processes: all ready {res['ready_s']:.4f} s after they were started")
    out.append(f"placement: server cpus {pl['server']}, load cpus {pl['load']}; SMT siblings "
               f"{ {c: sorted(s) for c, s in pl['siblings'].items()} }; card {pl['card_bus']} on NUMA node "
               f"{pl['card_node']}, its cpus {pl['card_cpus']}")
    return out


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
    place = placement(tr)
    pin_process(place["server"])
    db, build_s = program.build_db(ctx["master"], pool[0], cfg, dev)
    if ctx["trace"]:
        warm(dev)
    served = _ServedDB(db, dev)
    server = NativeQueryServer(served, host="127.0.0.1", port=0, max_batch=int(tr["max_batch"]),
                               window_ms=float(tr["window_ms"]))
    marks: dict = {}

    def counters():
        return {"flushes": server.flushes, "queries": server.flushed_queries,
                "engine_s": server.engine_s, "complete_s": server.complete_s, "idle_s": server.idle_s,
                "queue_s": server.queue_s, "queued": server.queued, "cpu_s": _usage()[0], "t": time.monotonic()}

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
                        k, metric, place, on_window)
    finally:
        server.close()
    if ctx["trace"]:
        if served.prof is not None:  # only the worker thread may stop its profiler
            raise RuntimeError("the server made no engine call after the profiled stretch")
        marks["trace"] = summary(served.done) if served.done is not None else None
        marks["profile_start_s"] = served.start_cost_s
    peak = program.memory_peak(dev)
    flush_times = served.flushes
    del db, server, served
    program.free(dev)

    lat = res["lat_ms"]
    fin = lat[np.isfinite(lat)]
    # a traced run's per-layer tail, like its counters, ends where the profile
    # begins: stopping the profiler holds the worker for seconds
    early = lat[(res["due_s"] < ctx["seconds"] - profile_s - tail_s) & np.isfinite(lat)]
    c1, c2 = marks["c1"], marks["c2"]
    flushes = c2["flushes"] - c1["flushes"]
    native = None
    if flushes > 0:
        native = {
            "flushes": flushes,
            "mean_flush": (c2["queries"] - c1["queries"]) / flushes,
            "engine_ms": 1e3 * (c2["engine_s"] - c1["engine_s"]) / flushes,
            "complete_ms": 1e3 * (c2["complete_s"] - c1["complete_s"]) / flushes,
            "queue_ms_per_request": 1e3 * (c2["queue_s"] - c1["queue_s"]) / max(1, c2["queued"] - c1["queued"]),
            "server_cpus_busy": (c2["cpu_s"] - c1["cpu_s"]) / (c2["t"] - c1["t"]),
        }
    lines = [
        f"load: {res['attempted']} requests due in the window at {tr['rate_per_s']} requests/s, "
        f"{res['failed']} failed; sender lateness of every request sent (warm load too): "
        f"{_pcts(res['lateness_ms'][np.isfinite(res['lateness_ms'])])}",
        f"window latency: {_pcts(fin)}",
        "window median latency, first second / last second: %.4f / %.4f ms" % res["window_lat_first_last_s"],
        *split_lines(lat, split_latency(res["sent"], res["done"], res["abs_due"], flush_times)),
        *flush_lines(flush_times, float(res["abs_due"][0]) if len(res["abs_due"]) else float("inf")),
        *host_lines(res, place),
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
        "e2e": {"p50_ms": float(np.percentile(fin, 50)) if fin.size else None},
        "attempted": res["attempted"],
        "failed": res["failed"],
        "sample": (pool[res["payload"][res["sample_idx"]]], ids, res["sample_scores"]),
        "memory_peak_bytes": peak,
        "layer_ctx": {"trace": marks.get("trace"), "native": native, "store_build_s": build_s,
                      "latency": {"p99_ms": float(np.percentile(early, 99))} if early.size else None},
        "lines": lines,
    }


if __name__ == "__main__":
    raise SystemExit(_main())
