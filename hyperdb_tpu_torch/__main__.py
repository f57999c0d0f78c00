"""Command-line interface (counterpart of ``hyperdb_tpu/__main__.py``).

    python -m hyperdb_tpu_torch build  --input docs.jsonl --output corpus.ckpt
    python -m hyperdb_tpu_torch query  --db corpus.ckpt --text "likes to sleep" -k 5
    python -m hyperdb_tpu_torch stats  --db corpus.ckpt
    python -m hyperdb_tpu_torch bench  --db corpus.ckpt --batch 64
    python -m hyperdb_tpu_torch serve  --db corpus.ckpt [--native]

Every subcommand runs on the CUDA card unless ``--device cpu`` asks for the
CPU. JSONL input: one JSON document per line. Checkpoints use the binary
directory format (persist/checkpoint.py) unless the path ends in
.pkl/.pickle/.gz/.json/.db (reference-compatible formats); files cross
between the two packages both ways.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _format_of(path: str) -> str:
    p = path.lower()
    if p.endswith((".pkl", ".pickle", ".gz")):
        return "pickle"
    if p.endswith(".json"):
        return "json"
    if p.endswith((".db", ".sqlite")):
        return "sqlite"
    return "checkpoint"


def _load_db(path: str, device, metadata_keys=None):
    from hyperdb_tpu_torch import HyperDB

    db = HyperDB(metadata_keys=metadata_keys, device=device)
    db.load(path, format=_format_of(path))
    return db


def cmd_build(args):
    from hyperdb_tpu_torch import HyperDB

    def jsonl_docs():
        with open(args.input) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield json.loads(line)

    t0 = time.perf_counter()
    db = HyperDB(
        metadata_keys=args.metadata_keys.split(",") if args.metadata_keys else None,
        fp_precision=args.fp_precision,
        ann_metric=args.ann_metric,
        device=args.device,
    )
    # streaming ingest: the corpus never has to fit in memory twice (raw
    # JSONL + vectors); embedding overlaps commit/index work (add_stream)
    count = db.add_stream(
        jsonl_docs(),
        batch_size=args.batch_size,
        add_timestamp=args.add_timestamp,
        defer_index=True,
    )
    print(f"embedded + indexed {count} documents from {args.input} in "
          f"{time.perf_counter() - t0:.1f}s "
          f"({db.vectors.shape[0]} vectors, dim {db.dim})")
    out_format = _format_of(args.output)
    if args.rows_per_shard and out_format != "checkpoint":
        print(f"warning: --rows-per-shard only applies to the checkpoint "
              f"format; ignored for '{out_format}' output", file=sys.stderr)
    db.save(args.output, format=out_format, rows_per_shard=args.rows_per_shard)
    print(f"saved to {args.output}")


def cmd_selectembed(args):
    """Measure the candidate default encoders on the user's corpus: needs
    the training package's retrieval evaluation, not ported yet."""
    raise SystemExit(
        "selectembed is not ported yet: it needs models/localdata.py "
        "(ROADMAP.md queue 1, item 13)"
    )


def cmd_query(args):
    db = _load_db(args.db, args.device,
                  args.metadata_keys.split(",") if args.metadata_keys else None)
    filters = json.loads(args.filters) if args.filters else None
    if filters:
        filters = [tuple(f) for f in filters]
    t0 = time.perf_counter()
    results = db.query(args.text, top_k=args.k, filters=filters, metric=args.metric)
    dt = time.perf_counter() - t0
    for res in results:
        doc, score, idx = res if len(res) == 3 else (res[0], res[1], None)
        print(json.dumps({"score": round(float(score), 6), "index": idx, "document": doc}))
    print(f"# {len(results)} results in {dt * 1e3:.1f} ms", file=sys.stderr)


def cmd_stats(args):
    db = _load_db(args.db, args.device)
    info = {
        "documents": db.size(),
        "chunks": len(db.source_indices),
        "dim": db.dim,
        "dtype": str(db.vectors.dtype) if db.vectors is not None else None,
        "ann_metric": db.ann_metric,
        "index": type(db.ann_index).__name__ if db.ann_index else None,
        "metadata_keys": db.metadata_keys,
    }
    print(json.dumps(info, indent=2))


def cmd_bench(args):
    import numpy as np

    db = _load_db(args.db, args.device)
    rng = np.random.default_rng(0)
    queries = rng.standard_normal((args.batch, db.dim)).astype(np.float32)
    db.query_batch(queries, top_k=args.k)  # compile
    t0 = time.perf_counter()
    for _ in range(args.iters):
        db.query_batch(queries, top_k=args.k)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "qps": round(args.batch * args.iters / dt, 1),
        "ms_per_batch": round(dt / args.iters * 1e3, 2),
    }))


def cmd_serve(args):
    from hyperdb_tpu_torch.server import serve

    db = _load_db(args.db, args.device,
                  args.metadata_keys.split(",") if args.metadata_keys else None)
    if args.warmup:
        # warm the SERVING profile: every pow2 flush bucket up to the
        # batcher cap, in every wire dtype the server will use (device
        # planes, kernel builds and the encoder's first forwards happen
        # here instead of on the first request)
        from hyperdb_tpu_torch.ops.metrics import METRICS

        metrics = tuple(
            m.strip() for m in args.warmup_metrics.split(",") if m.strip()
        )
        bad = [m for m in metrics if m not in METRICS]
        if bad or not metrics:
            raise SystemExit(
                f"--warmup-metrics: unknown metric(s) {bad or ['(empty)']}; "
                f"choose from {sorted(METRICS)}"
            )
        db.warmup(top_ks=(5, 10), max_batch=args.max_batch,
                  metric=metrics,
                  text_max_batch=args.warmup_text or None)
    if args.sharded:
        from hyperdb_tpu_torch.parallel.mesh import make_mesh
        from hyperdb_tpu_torch.parallel.sharded_db import ShardedHyperDB

        # one shard per card of the db's device type (the CPU: one shard)
        db = ShardedHyperDB(db, make_mesh(device=db.device.type))
    if args.native:
        from hyperdb_tpu_torch.native.server import NativeQueryServer

        window = args.dynamic_batch_ms if args.dynamic_batch_ms > 0 else 2.0
        srv = NativeQueryServer(db, host=args.host, port=args.port,
                                max_batch=args.max_batch, window_ms=window,
                                wire_dtype=args.wire_dtype)
        print(f"serving (native) on http://{args.host}:{srv.port}",
              flush=True)
        srv.serve_forever()
        return 0
    return serve(db, host=args.host, port=args.port,
                 dynamic_batch_ms=args.dynamic_batch_ms,
                 wire_dtype=args.wire_dtype)


def _device_arg(p) -> None:
    p.add_argument("--device", default=None,
                   help="torch device of the database (default: the CUDA "
                        "card; 'cpu' runs the kernels' plain versions)")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="hyperdb_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("build", help="embed + index a JSONL corpus (streaming)")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--metadata-keys", default=None)
    p.add_argument("--fp-precision", default="float32",
                   choices=["float16", "float32", "float64"])
    p.add_argument("--ann-metric", default="cosine")
    p.add_argument("--add-timestamp", action="store_true")
    p.add_argument("--batch-size", type=int, default=1024,
                   help="streaming ingest batch (docs per embed/commit cycle)")
    p.add_argument("--rows-per-shard", type=int, default=None,
                   help="checkpoint format only: split vectors into shard "
                        "files for mesh-streaming loads")
    _device_arg(p)
    p.set_defaults(fn=cmd_build)

    p = sub.add_parser(
        "selectembed",
        help="measure which default encoder fits YOUR corpus (split-half "
             "self-eval; not ported yet: ROADMAP.md queue 1, item 13)",
    )
    p.add_argument("--input", required=True, help="JSONL corpus")
    p.add_argument("--text-key", default="text")
    p.add_argument("--max-docs", type=int, default=400)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_selectembed)

    p = sub.add_parser("query", help="query a saved corpus")
    p.add_argument("--db", required=True)
    p.add_argument("--text", required=True)
    p.add_argument("-k", "--top-k", dest="k", type=int, default=5)
    p.add_argument("--metric", default="cosine_similarity")
    p.add_argument("--filters", default=None,
                   help='JSON, e.g. [["metadata", {"info.type": "fire"}]]')
    p.add_argument("--metadata-keys", default=None)
    _device_arg(p)
    p.set_defaults(fn=cmd_query)

    p = sub.add_parser("stats", help="corpus statistics")
    p.add_argument("--db", required=True)
    _device_arg(p)
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser("serve", help="HTTP serving endpoint over a corpus")
    p.add_argument("--db", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8901)
    p.add_argument("--metadata-keys", default=None)
    p.add_argument("--warmup", action="store_true",
                   help="run every serving shape once before accepting "
                        "traffic (planes, kernel builds, encoder forwards)")
    p.add_argument("--warmup-metrics", default="cosine_similarity",
                   help="comma-separated metrics to warm with "
                        "--warmup; metrics with device planes (pearson, "
                        "hamming, jaccard) also prebuild them here instead "
                        "of on the first serving query. The TEXT hot path "
                        "(--warmup-text) warms with the FIRST metric listed")
    p.add_argument("--warmup-text", type=int, default=0, metavar="N",
                   help="with --warmup, also warm the TEXT hot path "
                        "(encoder device forwards + chained scan) for pow2 "
                        "flush buckets up to N (0 = skip)")
    p.add_argument("--sharded", action="store_true",
                   help="row-shard the corpus over every attached device "
                        "and serve the distributed path")
    p.add_argument("--dynamic-batch-ms", type=float, default=0.0,
                   help="coalesce concurrent identical vector queries for "
                        "this many ms into one device batch (0 = off)")
    p.add_argument("--native", action="store_true",
                   help="serve through the C++ epoll front-end (sockets, "
                        "HTTP, batching, and response formatting off the "
                        "GIL; one engine call per batch)")
    p.add_argument("--max-batch", type=int, default=256,
                   help="native front-end flush size cap")
    p.add_argument("--wire-dtype", default="auto",
                   choices=["auto", "float32", "float16"],
                   help="query-block upload dtype: auto casts f16 when the "
                        "corpus itself is low precision (f16/int8)")
    _device_arg(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("bench", help="batched-query throughput on a corpus")
    p.add_argument("--db", required=True)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("-k", type=int, default=10)
    _device_arg(p)
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
