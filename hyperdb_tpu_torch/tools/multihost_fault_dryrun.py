"""Multi-process serving FAULT check: a hung follower must not hang the leader.

    python3 hyperdb_tpu_torch/tools/multihost_fault_dryrun.py [--device cuda|cpu]

A follower that CLOSES its control channel already raises on the leader; the
dangerous failure is one that HANGS: the process alive, the socket open, but
no longer reading (a wedged host, a stuck device call). Two ranks form a
mesh over a ``torch.distributed`` group; the follower serves ONE query and
then stops reading its control socket (``serve_forever(max_msgs=1)`` and a
sleep). The leader's second query must raise RuntimeError within the ack
deadline (``--ack-timeout``), BEFORE it enters the collective, instead of
deadlocking.

Exit code 0 when the first query matched the oracle and the second raised
within ``--raise-deadline`` seconds; the launcher's last line is then
``MULTIHOST FAULT DRYRUN: OK (launcher)``. The launcher kills the wedged
follower through its own process handle. The ranks run on the card unless
``--device cpu`` is given; without a card the launcher raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

N, D, B, K = 512, 32, 4, 4
SEED = 13


def worker(rank: int, args) -> int:
    import numpy as np

    from hyperdb_tpu_torch.parallel.launch import init_group
    from hyperdb_tpu_torch.parallel.mesh import make_mesh
    from hyperdb_tpu_torch.parallel.multihost_serve import (
        MultihostQueryService,
        build_sharded_rows,
    )

    dev, group = init_group(rank, args.procs, args.port, args.backend, args.device)
    mesh = make_mesh(args.local_shards, device=dev, group=group)
    rng = np.random.default_rng(SEED)
    full = rng.standard_normal((N, D)).astype(np.float32)
    local = N // args.procs
    rows, row_valid, _ = build_sharded_rows(mesh, full[rank * local:(rank + 1) * local],
                                            num_rows=N)
    svc = MultihostQueryService(mesh, rows, row_valid, num_rows=N,
                                ack_timeout_s=args.ack_timeout)
    if rank != 0:
        svc.connect()
        svc.serve_forever(max_msgs=1)  # one healthy query ...
        print(f"[rank {rank}] hanging: socket open, no longer reading", flush=True)
        time.sleep(600)  # ... then the hung host (the launcher kills it)
        return 0

    svc.accept_followers()
    qs = full[rng.integers(0, N, size=B)] + 0.05 * rng.standard_normal((B, D)).astype(np.float32)
    vn = full / np.linalg.norm(full, axis=1, keepdims=True)
    ids, _ = svc.query_batch_arrays(qs, top_k=K)
    for b in range(B):
        want = np.argsort(-(vn @ (qs[b] / np.linalg.norm(qs[b]))), kind="stable")[:K]
        assert ids[b].tolist() == want.tolist(), (b, ids[b], want)
    print("[leader] healthy query matched the oracle", flush=True)

    t0 = time.time()
    try:
        svc.query_batch_arrays(qs, top_k=K)
    except RuntimeError as e:
        dt = time.time() - t0
        assert dt < args.raise_deadline, f"raised, but after {dt:.1f} s"
        assert "follower" in str(e), e
        print(f"[leader] hung follower raised in {dt:.2f} s: {e}", flush=True)
        print("MULTIHOST FAULT DRYRUN: OK", flush=True)
        # no group teardown: the follower is wedged on purpose
        sys.stdout.flush()
        os._exit(0)
    raise AssertionError("the leader did not raise on the hung follower")


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
    parser.add_argument("--ack-timeout", type=float, default=5.0)
    parser.add_argument("--raise-deadline", type=float, default=30.0)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--timeout", type=float, default=180.0)
    parser.add_argument("--worker", type=int, default=None)
    args = parser.parse_args()
    args.device = launcher_device(args.device)
    args.backend = args.backend or default_backend(args.device)
    if args.worker is not None:
        return worker(args.worker, args)

    argv = ["--procs", str(args.procs), "--local-shards", str(args.local_shards),
            "--device", args.device, "--backend", args.backend,
            "--ack-timeout", str(args.ack_timeout), "--raise-deadline", str(args.raise_deadline),
            "--port", str(args.port or free_port())]
    procs = spawn(__file__, args.procs, argv, ROOT)
    # the leader decides; the follower is wedged by design and killed after
    (code, out), = finish(procs[:1], args.timeout)
    print(f"--- leader (rc={code}) ---\n{out[-1500:]}", flush=True)
    for p in procs[1:]:
        p.kill()
        p.communicate(timeout=30)
    if code == 0 and "MULTIHOST FAULT DRYRUN: OK" in out:
        print("MULTIHOST FAULT DRYRUN: OK (launcher)", flush=True)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
