"""Multi-process check of the distributed exact top-k.

    python3 hyperdb_tpu_torch/tools/multihost_dryrun.py [--procs 2] [--device cuda|cpu]

The launcher spawns ``--procs`` ranks as processes of their own; they join
one ``torch.distributed`` group at ``tcp://127.0.0.1:<port>`` (a port the
launcher bound), each holding ``--local-shards`` shards of one global mesh,
and every rank:

1. places ONLY its own rows of a seeded corpus (``local_rows``, the
   multi-process ingest pattern);
2. runs ``sharded_rank_top_k`` (f32, dot) and ``sharded_rank_top_k_int8``,
   whose candidates are gathered across the processes;
3. checks the merged answers against a NumPy oracle of the whole corpus.

Exit code 0 when every rank matched the oracle; the last line is then
``MULTIHOST DRYRUN: OK``. ``--backend`` defaults to nccl on the card and
gloo on the CPU; ranks that share one card need gloo. The ranks run on
the card (rank r on card r % count) unless ``--device cpu`` is given;
without a card the launcher raises.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

N, D, B, K = 4096, 64, 8, 5
SEED = 0


def worker(rank: int, args) -> int:
    import numpy as np

    from hyperdb_tpu_torch.ops.quantized import quantize_rows
    from hyperdb_tpu_torch.parallel.distributed import (
        local_rows,
        sharded_rank_top_k,
        sharded_rank_top_k_int8,
    )
    from hyperdb_tpu_torch.parallel.launch import init_group
    from hyperdb_tpu_torch.parallel.mesh import make_mesh

    dev, group = init_group(rank, args.procs, args.port, args.backend, args.device)
    mesh = make_mesh(args.local_shards, device=dev, group=group)
    assert mesh.shape["data"] == args.local_shards * args.procs, mesh

    # the same corpus in every process (one seed); each places ONLY its rows
    rng = np.random.default_rng(SEED)
    rows = rng.standard_normal((N, D)).astype(np.float32)
    valid = np.ones(N, dtype=bool)
    valid[-37:] = False  # the mask crosses a shard boundary
    queries = rng.standard_normal((B, D)).astype(np.float32)
    per_proc = N // args.procs
    lo, hi = rank * per_proc, (rank + 1) * per_proc

    vals, idx = sharded_rank_top_k(
        mesh, queries, local_rows(mesh, rows[lo:hi]), local_rows(mesh, valid[lo:hi]),
        k=K, metric="dot_product",
    )
    s = rows @ queries.T  # (N, B)
    s[~valid] = -np.inf
    want = np.argsort(-s, axis=0, kind="stable")[:K].T
    got = idx.cpu().numpy()
    assert (got == want).all(), (rank, got[0], want[0])
    print(f"rank {rank}: f32 sharded top-k matches the oracle", flush=True)

    # int8: per-row symmetric quantization, each process quantizes its rows
    q_i8, scales = quantize_rows(rows)
    vals8, idx8 = sharded_rank_top_k_int8(
        mesh, queries, local_rows(mesh, q_i8[lo:hi]), local_rows(mesh, scales[lo:hi]),
        local_rows(mesh, valid[lo:hi]), k=K,
    )
    # the oracle quantizes the query as the scan does on its device
    qq8, q_scale = quantize_rows(queries)
    s8 = (q_i8.astype(np.int32) @ qq8.astype(np.int32).T).astype(np.float32)
    s8 *= scales[:, None] * q_scale[None, :]
    s8[~valid] = -np.inf
    want8 = -np.sort(-s8, axis=0, kind="stable")[:K].T
    got8v, got8 = vals8.cpu().numpy(), idx8.cpu().numpy()
    # quantized scores tie across shards: hold the scores, and every id to
    # its own oracle score
    np.testing.assert_allclose(got8v, want8, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got8v, np.take_along_axis(s8.T, got8, axis=1), rtol=1e-4, atol=1e-4)
    print(f"rank {rank}: int8 sharded top-k matches the oracle", flush=True)

    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


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
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--timeout", type=float, default=240.0)
    parser.add_argument("--worker", type=int, default=None)
    args = parser.parse_args()
    args.device = launcher_device(args.device)
    args.backend = args.backend or default_backend(args.device)
    if args.worker is not None:
        return worker(args.worker, args)

    argv = ["--procs", str(args.procs), "--local-shards", str(args.local_shards),
            "--device", args.device, "--backend", args.backend,
            "--port", str(args.port or free_port())]
    rc = 0
    for rank, (code, out) in enumerate(finish(spawn(__file__, args.procs, argv, ROOT), args.timeout)):
        tail = "\n".join(out.strip().splitlines()[-8:])
        print(f"--- rank {rank} rc={code}\n{tail}")
        rc |= code or 0
    print("MULTIHOST DRYRUN:", "OK" if rc == 0 else "FAILED")
    return rc


if __name__ == "__main__":
    sys.exit(main())
