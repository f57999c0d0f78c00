"""Multi-process SERVING check (``parallel/multihost_serve.py``).

    python3 hyperdb_tpu_torch/tools/multihost_serve_dryrun.py [--procs 2] [--device cuda|cpu]

``--procs`` ranks, spawned as processes of their own, form one mesh of
``--local-shards`` shards each over a ``torch.distributed`` group; every
rank places only its own rows (``build_sharded_rows``). Rank 0 is the
serving leader: it answers by relaying each query block over the control
channel and running the sharded scan; the other ranks park in
``serve_forever`` and follow.

1. The array surface: ``query_batch_arrays`` over ``--rows`` x ``--dim``
   rows at ``--batch`` queries, three times, against a NumPy oracle of the
   whole corpus (ids equal, or within ``--atol`` where scores tie); then
   the native C++ front end over the leader.
2. The document-level surface over a chunked corpus of ``--docs2``
   documents of 1-3 rows each: plain, a forced chunk refill
   (``chunk_slack=1``), metadata, sentence, both, skip_doc, recency, recency
   with a filter, two key-filter overrides and a repeated spec that must
   reuse its cached plane: 11 checks, each against the single-process
   engine (``HyperDB.query_batch`` on the leader's own host DB).
3. int8-pure serving over quantized shards against a NumPy oracle.

Exit code 0 when the leader's checks passed and every rank exited cleanly;
the launcher's last line is then ``MULTIHOST SERVE DRYRUN: OK (launcher)``.
Each rank prints its phase times. ``--backend`` defaults to nccl on the
card and gloo on the CPU; ranks that share one card need gloo. The ranks
run on the card (rank r on card r % count) unless ``--device cpu`` is
given; without a card the launcher raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

SEED = 7


def _emb_fn(d: int):
    """Deterministic bag-of-words embedding of width ``d`` (the same in
    every process: character sums, not the salted ``hash``)."""
    import numpy as np

    def emb(texts):
        out = np.zeros((len(texts), d), dtype=np.float32)
        for j, t in enumerate(texts):
            for w in str(t).split():
                out[j, sum(ord(c) for c in w) % d] += 1.0
        return out

    return emb


def chunk_counts(n_docs: int):
    import numpy as np

    return 1 + np.arange(n_docs) % 3


def chunked_rows(n_docs: int, d: int):
    """The chunked corpus's rows, the same in every process."""
    import numpy as np

    n_rows = int(chunk_counts(n_docs).sum())
    return np.random.default_rng(11).standard_normal((n_rows, d)).astype(np.float32)


def build_host_db(n_docs: int, d: int, device):
    """The leader's host DB over :func:`chunked_rows`: documents with a
    category, a timestamp, a name and a text, ``chunk_counts`` rows each."""
    import numpy as np

    from hyperdb_tpu_torch import HyperDB

    counts = chunk_counts(n_docs)
    docs = [{
        "name": f"item number {i}",
        "text": f"alpha item {i} " + ("beta" if i % 2 else "gamma"),
        "cat": "odd" if i % 2 else "even",
        "timestamp": float(1_000_000 + 60 * i),
    } for i in range(n_docs)]
    db = HyperDB.from_state({
        "vectors": chunked_rows(n_docs, d), "documents": docs,
        "source_indices": np.repeat(np.arange(n_docs), counts),
        "metadata_keys": ["cat", "timestamp"], "fp_precision": np.float32,
        "ann_metric": "cosine",
    }, device=device)
    db.embedding_function = _emb_fn(d)
    db.split_info = {i: int(c) for i, c in enumerate(counts) if c > 1}
    # document_keys comes from constructor documents only (a reference
    # quirk); collect it, so the key filters of both sides see the same keys
    db.document_keys = db.collect_document_keys(list(db.documents))
    return db


def _oracle_top_k(s, k: int):
    """Top-k of each row of ``s``, ties to the lower index (a partition
    first: the full sort of a (B, 1M) block takes a minute)."""
    import numpy as np

    part = np.argpartition(-s, k - 1, axis=1)[:, :k]
    ps = np.take_along_axis(s, part, axis=1)
    order = np.lexsort((part, -ps), axis=1)
    ids = np.take_along_axis(part, order, axis=1)
    return ids, np.take_along_axis(s, ids, axis=1)


def _tie_aware(name, ids, scores, want_ids, want_scores, atol):
    """Ids equal, or swapped only between scores within ``atol``; scores
    within ``atol`` (relative 1e-5 for exact-id checks)."""
    import numpy as np

    np.testing.assert_allclose(scores, want_scores, rtol=1e-5, atol=atol, err_msg=name)
    diff = ids != want_ids
    if diff.any() and (atol == 0 or not np.all(np.abs(scores[diff] - want_scores[diff]) <= atol)):
        raise AssertionError(f"{name}: ids differ beyond ties: {np.argwhere(diff)[:4].tolist()}")
    return int(diff.sum())


def worker(rank: int, args) -> int:
    import numpy as np

    from hyperdb_tpu_torch.ops.quantized import quantize_rows
    from hyperdb_tpu_torch.parallel.launch import init_group
    from hyperdb_tpu_torch.parallel.mesh import make_mesh
    from hyperdb_tpu_torch.parallel.multihost_serve import (
        MultihostQueryService,
        build_sharded_rows,
    )
    from hyperdb_tpu_torch.parallel.distributed import pad_rows_per_shard

    t0 = time.perf_counter()
    dev, group = init_group(rank, args.procs, args.port, args.backend, args.device)
    mesh = make_mesh(args.local_shards, device=dev, group=group)
    n_shards = mesh.shape["data"]
    n, d, b, k = args.rows, args.dim, args.batch, args.k

    # every process derives the same corpus, then places ONLY its slice
    rng = np.random.default_rng(SEED)
    n_pad = pad_rows_per_shard(n, n_shards) * n_shards
    full = np.zeros((n_pad, d), dtype=np.float32)
    full[:n] = rng.standard_normal((n, d), dtype=np.float32)
    local = n_pad // args.procs
    lo = rank * local
    rows, row_valid, got_pad = build_sharded_rows(mesh, full[lo:lo + local], num_rows=n)
    assert got_pad == n_pad
    svc = MultihostQueryService(mesh, rows, row_valid, num_rows=n)

    # phase 2: the chunked corpus behind the document-level surface
    rows2_full = chunked_rows(args.docs2, d)
    n2 = rows2_full.shape[0]
    n_pad2 = pad_rows_per_shard(n2, n_shards) * n_shards
    full2 = np.zeros((n_pad2, d), dtype=np.float32)
    full2[:n2] = rows2_full
    del rows2_full
    local2 = n_pad2 // args.procs
    rows2, valid2, _ = build_sharded_rows(mesh, full2[rank * local2:(rank + 1) * local2],
                                          num_rows=n2)
    host_db = build_host_db(args.docs2, d, dev) if rank == 0 else None
    svc2 = MultihostQueryService(mesh, rows2, valid2, num_rows=n2, host_db=host_db,
                                 chunk_slack=1)  # forces a relayed refill at top_k = 30

    # phase 3: int8-pure serving over quantized shards
    rows8, scales8, valid8, _ = build_sharded_rows(mesh, full[lo:lo + local], num_rows=n,
                                                    precision="int8")
    svc3 = MultihostQueryService(mesh, rows8, valid8, num_rows=n, row_scales=scales8)
    print(f"[rank {rank}] set-up {time.perf_counter() - t0:.2f} s", flush=True)

    if rank != 0:
        for phase, s in (("array", svc), ("document", svc2), ("int8", svc3)):
            s.connect()
            s.serve_forever()
            print(f"[rank {rank}] follower {phase} phase done", flush=True)
        return 0

    qs = full[:n][rng.integers(0, n, size=b)] + 0.05 * rng.standard_normal((b, d), dtype=np.float32)
    vn = full[:n] / np.linalg.norm(full[:n], axis=1, keepdims=True)
    qn = qs / np.linalg.norm(qs, axis=1, keepdims=True)
    want, want_s = _oracle_top_k(qn @ vn.T, k)  # exact cosine over the true rows

    svc.accept_followers()
    for trial in range(3):  # repeated queries go round the relay loop
        t = time.perf_counter()
        ids, scores = svc.query_batch_arrays(qs, top_k=k)
        dt = time.perf_counter() - t
        assert ids.shape == (b, k) and scores.shape == (b, k)
        swaps = _tie_aware(f"array trial {trial}", ids, scores, want, want_s, args.atol)
        print(f"array surface trial {trial}: {b} queries x {n} rows in {dt * 1e3:.2f} ms, "
              f"ids equal to the oracle ({swaps} tied swaps)", flush=True)
    _native_front_end(svc, qs[: min(b, 8)], want[: min(b, 8)], n)
    svc.close()

    # phase 2: the document-level surface, against the single-process engine
    svc2.accept_followers()
    q2 = _emb_fn(d)([f"alpha item {i}" for i in (3, 17, 30)])
    q2 = q2 + 0.01 * rng.standard_normal(q2.shape, dtype=np.float32)
    passed = []

    def check(name, filters=None, recency_bias=0, timestamp_key=None, top_k=5):
        t = time.perf_counter()
        got = svc2.query_batch(q2, top_k=top_k, filters=filters,
                               recency_bias=recency_bias, timestamp_key=timestamp_key)
        dt = time.perf_counter() - t
        ref = host_db.query_batch(q2, top_k=top_k, filters=filters,
                                  recency_bias=recency_bias, timestamp_key=timestamp_key)
        for i, (g, w) in enumerate(zip(got, ref)):
            assert [r[2] for r in g] == [r[2] for r in w], (name, i, [r[2] for r in g],
                                                           [r[2] for r in w])
            for (_, gs, _), (_, ws, _) in zip(g, w):
                assert abs(gs - ws) <= 1e-4 * max(1.0, abs(ws)), (name, i, gs, ws)
        passed.append(name)
        print(f"document surface {name}: OK ({dt * 1e3:.2f} ms)", flush=True)

    check("chunked plain")
    steps0 = svc2.collective_steps
    # chunk_slack = 1 at top_k = 31 first fetches 32 rows; a query at the sum
    # of one 3-row document's rows ranks those rows first, so the 32 rows
    # hold at most 30 documents: the leader must relay a deeper fetch
    starts = np.concatenate([[0], np.cumsum(chunk_counts(args.docs2))])
    q2_deep = np.stack([host_db.vectors[starts[i]:starts[i + 1]].sum(0) for i in (2, 5, 8)])
    q2, q2_plain = q2_deep.astype(np.float32), q2
    check("chunked deep (forced refill)", top_k=31)
    q2 = q2_plain
    assert svc2.collective_steps >= steps0 + 2, (steps0, svc2.collective_steps)
    print("refill relayed a deeper fetch: OK", flush=True)
    check("metadata filter", filters=[("metadata", {"cat": "odd"})])
    check("sentence filter", filters=[("sentence", "beta")])
    check("metadata+sentence", filters=[("metadata", {"cat": "odd"}), ("sentence", "beta")])
    check("skip_doc", filters=[("skip_doc", 10)])
    check("recency", recency_bias=2.0)
    check("recency+metadata", recency_bias=2.0, filters=[("metadata", {"cat": "even"})])
    check("key override", filters=[("key", "name")])
    check("key override + metadata", filters=[("metadata", {"cat": "odd"}), ("key", "name")])
    tokens_before = dict(svc2._plane_tokens)
    check("metadata filter (repeat)", filters=[("metadata", {"cat": "odd"})])
    assert dict(svc2._plane_tokens) == tokens_before, "a repeated spec relayed its plane again"
    print("plane cache reuse: OK", flush=True)
    svc2.close()
    print(f"DOCUMENT SURFACE: {len(passed)} checks + refill + plane reuse OK", flush=True)

    # phase 3: int8-pure, against the exact quantized oracle
    svc3.accept_followers()
    vq, vs = quantize_rows(vn)  # the shard-local quantization, whole
    qq, qsc = quantize_rows(qn)  # the scan quantizes the unit query alike
    ids8, scores8 = svc3.query_batch_arrays(qs, top_k=k)
    m = min(b, 16)
    # int8 products summed in f32 are exact integers below 2^24 (d <= 1040)
    inter = qq[:m].astype(np.float32) @ vq.astype(np.float32).T
    o = inter * (qsc[:m, None] * vs[None, :])
    w8, w8_s = _oracle_top_k(o, k)
    # quantized scores tie: hold the scores, and every id to its own score
    np.testing.assert_allclose(scores8[:m], w8_s, rtol=1e-5)
    np.testing.assert_allclose(scores8[:m], np.take_along_axis(o, ids8[:m], axis=1), rtol=1e-5)
    svc3.close()
    print("INT8 SERVING: OK", flush=True)
    print(f"leader total {time.perf_counter() - t0:.2f} s", flush=True)
    print("MULTIHOST SERVE DRYRUN: OK", flush=True)
    return 0


def _native_front_end(svc, qs, want, n) -> None:
    """The native C++ HTTP front end serving the whole mesh through the
    leader (its library builds with the host's C++ compiler)."""
    import numpy as np

    from hyperdb_tpu_torch.client import HyperDBClient
    from hyperdb_tpu_torch.native.server import NativeQueryServer

    srv = NativeQueryServer(svc, port=0, max_batch=8)
    try:
        with HyperDBClient("127.0.0.1", srv.port) as client:
            h_ids, _ = client.query_batch(qs, top_k=want.shape[1])
            assert np.array_equal(np.asarray(h_ids), want), (h_ids, want)
            assert client.stats()["documents"] == n
    finally:
        srv.close()
    print("HTTP over the multi-process mesh: OK", flush=True)


def main() -> int:
    from hyperdb_tpu_torch.parallel.launch import (
        default_backend, finish, free_port, launcher_device, spawn,
    )

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--procs", type=int, default=2)
    parser.add_argument("--local-shards", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="the ranks' device: the card unless cpu is named")
    parser.add_argument("--backend", default=None)
    parser.add_argument("--rows", type=int, default=1000)
    parser.add_argument("--dim", type=int, default=32)
    parser.add_argument("--batch", type=int, default=5)
    parser.add_argument("-k", type=int, default=4)
    parser.add_argument("--docs2", type=int, default=48)
    parser.add_argument("--atol", type=float, default=0.0,
                        help="score gap within which two ids may trade places (0: ids equal)")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--timeout", type=float, default=240.0)
    parser.add_argument("--worker", type=int, default=None)
    args = parser.parse_args()
    args.device = launcher_device(args.device)
    args.backend = args.backend or default_backend(args.device)
    if args.worker is not None:
        return worker(args.worker, args)

    argv = ["--procs", str(args.procs), "--local-shards", str(args.local_shards),
            "--device", args.device, "--backend", args.backend, "--rows", str(args.rows),
            "--dim", str(args.dim), "--batch", str(args.batch), "-k", str(args.k),
            "--docs2", str(args.docs2), "--atol", str(args.atol),
            "--port", str(args.port or free_port())]
    rc, ok = 0, False
    for rank, (code, out) in enumerate(finish(spawn(__file__, args.procs, argv, ROOT), args.timeout)):
        print(f"--- rank {rank} (rc={code}) ---\n{out[-3000:]}", flush=True)
        rc |= code if code is not None else 1
        ok |= "MULTIHOST SERVE DRYRUN: OK" in out
    if rc == 0 and ok:
        print("MULTIHOST SERVE DRYRUN: OK (launcher)", flush=True)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
