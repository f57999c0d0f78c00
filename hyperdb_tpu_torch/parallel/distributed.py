"""The distributed (multi-device) exact top-k.

Counterpart of ``hyperdb_tpu/parallel/distributed.py``. The (N, d) corpus
is row-sharded over the mesh's 'data' axis and the queries are replicated.
Each shard scores its rows through the same routes as the single-device
router (``ops/ranking.rank_top_k``, under the JAX package's per-shard
rules), takes a LOCAL top-k, and only the (k scores, k global row ids) of
each shard are gathered: ``torch.stack`` over the shards of this process,
``torch.distributed.all_gather`` across processes. A final top-k over the
S * k merged candidates is exact, because top-k distributes over row
partitions. Shards are contiguous row blocks gathered in shard order and
:func:`~hyperdb_tpu_torch.ops.ranking.exact_top_k` keeps the earlier
position among equal scores, so ties go to the lower global row id, as
``lax.top_k`` does in the JAX program.

The shards of one process run one after another; the JAX package compiles
one SPMD program per configuration and caches it, which eager torch needs
not do.
"""

from __future__ import annotations

import numpy as np
import torch

from hyperdb_tpu_torch.config import CONFIG
from hyperdb_tpu_torch.ops.metrics import LOW_PRECISION, scores
from hyperdb_tpu_torch.ops.ranking import (
    _auto_group,
    _manhattan_tile,
    _scrub,
    _use_gmax,
    _use_l1,
    exact_top_k,
    rank_top_k_grouped,
    rank_top_k_manhattan_stream,
)


class ShardedRows:
    """This process's blocks of an array row-sharded over a mesh axis.

    Shard ``s`` (global index) holds rows ``[s * n_local, (s + 1) * n_local)``
    of the (n_pad, ...) array; ``shards`` are this process's, each on its
    mesh device, in shard order. ``shape`` and ``dtype`` are the global
    array's, as a sharded ``jax.Array`` reports them."""

    def __init__(self, shards: list[torch.Tensor], global_rows: int, first_shard: int = 0):
        self.shards = list(shards)
        self.shape = (int(global_rows),) + tuple(self.shards[0].shape[1:])
        self.dtype = self.shards[0].dtype
        self.first_shard = int(first_shard)  # global index of shards[0]

    def map(self, fn) -> "ShardedRows":
        """The same per-shard function on every block (row-local work only)."""
        return ShardedRows([fn(s) for s in self.shards], self.shape[0], self.first_shard)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def shard_rows(mesh, x, axis: str = "data", dtype=None) -> ShardedRows:
    """Place a GLOBAL (n_pad, ...) array on the mesh: this process keeps the
    row blocks of its own shards, each on its device (cast there to
    ``dtype`` if given). n_pad must divide evenly over the axis."""
    if isinstance(x, ShardedRows):
        return x
    x = _as_tensor(x)
    n_shards = mesh.shape[axis]
    if x.shape[0] % n_shards:
        raise ValueError(f"rows ({x.shape[0]}) must divide evenly over '{axis}' ({n_shards})")
    n_local = x.shape[0] // n_shards
    first = mesh.first_shard(axis)
    return ShardedRows([
        _place(x[(first + j) * n_local:(first + j + 1) * n_local], dev, dtype)
        for j, dev in enumerate(mesh.local_devices(axis))
    ], x.shape[0], first)


def local_rows(mesh, block, axis: str = "data", dtype=None) -> ShardedRows:
    """Place this process's contiguous row block (the rows of its own shards,
    in order) on the mesh: the counterpart of
    ``jax.make_array_from_process_local_data``, where no process ever holds
    the whole array."""
    block = _as_tensor(block)
    devs = mesh.local_devices(axis)
    if block.shape[0] % len(devs):
        raise ValueError(f"local rows ({block.shape[0]}) must divide over {len(devs)} shards")
    n_local = block.shape[0] // len(devs)
    return ShardedRows(
        [_place(block[j * n_local:(j + 1) * n_local], dev, dtype) for j, dev in enumerate(devs)],
        n_local * mesh.shape[axis], mesh.first_shard(axis),
    )


def _place(block: torch.Tensor, device, dtype) -> torch.Tensor:
    out = block.to(device)
    if dtype is not None:
        out = out.to(dtype)
    # every shard owns its storage: in-place writes to one never reach another
    return out.clone() if out.data_ptr() == block.data_ptr() else out.contiguous()


def _match_wire_dtype(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """An f16 query block against a bf16 shard (or the reverse) is cast to
    the shard's dtype, per shard, as the single-device router casts its dot
    route; f32 wires are left as they are (the caller decides whether the
    plane's dtype is the contract)."""
    if rows.dtype in LOW_PRECISION and q.dtype in LOW_PRECISION and q.dtype != rows.dtype:
        return q.to(rows.dtype)
    return q


def _local_top_k(shard: int, q, rows, valid, rec, k_local: int, metric: str):
    """One shard's exact top-k: the JAX package's per-shard program
    (``distributed.py:121-202``) over the port's routes. ``shard`` is the
    global shard index (the routes do not read it)."""
    del shard
    q = _match_wire_dtype(q, rows)
    b = int(q.shape[0])
    n_local = int(rows.shape[0])
    group = _auto_group(b)
    big = CONFIG.grouped_topk_min_rows > 0 and n_local >= CONFIG.grouped_topk_min_rows
    if metric == "dot_product" and big and n_local % group == 0:
        if _use_gmax(q, rows, k_local):
            from hyperdb_tpu_torch.ops.gmax import rank_top_k_grouped_gmax

            return rank_top_k_grouped_gmax(q, rows, k_local, row_mask=valid, recency=rec)
        return rank_top_k_grouped(q, rows, k_local, row_mask=valid, recency=rec, group=group)
    if metric == "manhattan_distance" and big:
        if rec is None and _use_l1(q, rows, k_local):
            from hyperdb_tpu_torch.ops.l1 import rank_top_k_manhattan_l1

            return rank_top_k_manhattan_l1(q, rows, k_local, row_mask=valid)
        tile = _manhattan_tile(b, n_local, k_local)
        if tile:
            return rank_top_k_manhattan_stream(
                q, rows, k_local, row_mask=valid, recency=rec, tile=tile
            )
    return exact_top_k(_scrub(scores(q, rows, metric), valid, rec), k_local)


def _local_top_k_int8(shard: int, q, rows_q, scales, valid, rec, k_local: int):
    """One int8 shard's top-k (``distributed.py:228-232``): the grouped int8
    scan, on ``gmax_int8`` where its route applies."""
    from hyperdb_tpu_torch.ops.quantized import rank_top_k_int8

    del shard
    return rank_top_k_int8(q, rows_q, scales, k=k_local, row_mask=valid, recency=rec)


def _replicas(queries, devices) -> dict:
    """The query block on every device of the mesh, uploaded once each."""
    q = _as_tensor(queries)
    return {dev: q.to(dev) for dev in dict.fromkeys(devices)}


def _shards_of(mesh, x, axis):
    return shard_rows(mesh, x, axis).shards if x is not None else None


def _merge(mesh, vals: list, gidx: list, k: int, axis: str):
    """Gather every shard's (B, k_local) candidates in shard order and take
    the exact top-k of the (B, S * k_local) merge. Returns (values, global
    row ids) on this process's first device."""
    dev = mesh.local_devices(axis)[0]
    all_vals = torch.stack([v.to(dev) for v in vals])  # (S_local, B, k_local)
    all_idx = torch.stack([i.to(dev) for i in gidx])
    if mesh.group is not None:  # a group of one rank gathers too: one code path
        all_vals = _all_gather(mesh.group, all_vals)
        all_idx = _all_gather(mesh.group, all_idx)
    b = all_vals.shape[1]
    all_vals = all_vals.transpose(0, 1).reshape(b, -1)
    all_idx = all_idx.transpose(0, 1).reshape(b, -1)
    merged_vals, pos = exact_top_k(all_vals, k)
    return merged_vals, torch.gather(all_idx, 1, pos)


def _all_gather(group, t: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's ``t`` along dim 0, in rank order. Under
    gloo a card tensor is staged through the host here (the candidates are
    B * k * 12 bytes); under nccl it stays on the card."""
    import torch.distributed as dist

    staged = t.cpu() if dist.get_backend(group) == "gloo" else t
    parts = [torch.empty_like(staged) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, staged.contiguous(), group=group)
    return torch.cat(parts).to(t.device)


def _check_rows(mesh, n: int, k: int, axis: str) -> tuple[int, int]:
    n_shards = mesh.shape[axis]
    if n % n_shards:
        raise ValueError(f"rows ({n}) must divide evenly over '{axis}' ({n_shards})")
    n_local = n // n_shards
    if k > n:
        raise ValueError(f"k ({k}) must be <= total rows ({n})")
    # with k_local = min(k, n_local) a shard contributes ALL its rows when
    # k >= n_local, so the S * k_local candidates always cover the top-k
    return n_local, min(k, n_local)


def sharded_rank_top_k(
    mesh,
    queries,
    rows,
    row_valid,
    k: int,
    metric: str = "cosine_similarity",
    recency=None,
    axis: str = "data",
):
    """Exact distributed top-k over a row-sharded corpus.

    Args:
        mesh: a :class:`~hyperdb_tpu_torch.parallel.mesh.Mesh` with an
            ``axis`` dimension.
        queries: (B, d) tensor or array, replicated to every shard.
        rows: (N, d) :class:`ShardedRows`, or a global array sharded here;
            N divisible by the axis size.
        row_valid: (N,) bool validity/filter mask, sharded likewise.
        k: top-k per query (<= N).
        recency: optional (N,) f32 additive term, sharded likewise.

    Returns:
        (values, global_row_indices): each (B, k), on this process's first
        mesh device (every process of a multi-process mesh gets the same).
    """
    rows = shard_rows(mesh, rows, axis)
    n_local, k_local = _check_rows(mesh, rows.shape[0], k, axis)
    valid = _shards_of(mesh, row_valid, axis)
    rec = _shards_of(mesh, recency, axis)
    devs = mesh.local_devices(axis)
    qs = _replicas(queries, devs)
    first = mesh.first_shard(axis)
    vals, gidx = [], []
    for j, dev in enumerate(devs):
        v, i = _local_top_k(
            first + j, qs[dev], rows.shards[j], valid[j],
            None if rec is None else rec[j], k_local, metric,
        )
        vals.append(v)
        gidx.append(i + (first + j) * n_local)
    return _merge(mesh, vals, gidx, k, axis)


def sharded_rank_top_k_int8(
    mesh,
    queries,
    rows_q,
    row_scales,
    row_valid,
    k: int,
    recency=None,
    axis: str = "data",
):
    """Exact distributed top-k over a row-sharded INT8 corpus (int8-pure:
    quantized scores, no rescore rows). Each shard runs
    ``ops/quantized.rank_top_k_int8`` (stage 1 on ``gmax_int8`` where that
    route applies) on its rows; the merge equals the unsharded int8 scan.
    Rows are quantized per row, so a shard's scales are its slice."""
    rows_q = shard_rows(mesh, rows_q, axis)
    n_local, k_local = _check_rows(mesh, rows_q.shape[0], k, axis)
    scales = _shards_of(mesh, row_scales, axis)
    valid = _shards_of(mesh, row_valid, axis)
    rec = _shards_of(mesh, recency, axis)
    devs = mesh.local_devices(axis)
    qs = _replicas(queries, devs)
    first = mesh.first_shard(axis)
    vals, gidx = [], []
    for j, dev in enumerate(devs):
        v, i = _local_top_k_int8(
            first + j, qs[dev], rows_q.shards[j], scales[j], valid[j],
            None if rec is None else rec[j], k_local,
        )
        vals.append(v)
        gidx.append(i + (first + j) * n_local)
    return _merge(mesh, vals, gidx, k, axis)


def pad_rows_per_shard(n: int, n_shards: int) -> int:
    """Rows per shard for ``n`` rows: equal counts, aligned to 128 (the
    grouped routes' and the kernels' group)."""
    per_shard = -(-n // n_shards)
    return -(-per_shard // 128) * 128


class DistributedCorpus:
    """A row-sharded device-resident corpus with an exact distributed query.

    The host-side HyperDB remains the source of truth; this wraps its vector
    matrix for mesh execution. ``precision="int8"`` serves the per-row
    quantized corpus (int8-pure semantics, cosine and dot only) at half the
    bytes per shard of bf16.
    """

    def __init__(self, mesh, vectors: np.ndarray, metric: str = "cosine_similarity",
                 axis: str = "data", precision: str = "auto"):
        if precision not in ("auto", "int8"):
            raise ValueError("precision must be 'auto' or 'int8'.")
        if precision == "int8" and metric not in ("cosine_similarity", "dot_product"):
            raise ValueError(
                "int8 distributed serving supports cosine_similarity and "
                f"dot_product only (got '{metric}')."
            )
        self.mesh = mesh
        self.metric = metric
        self.axis = axis
        self.precision = precision
        n, d = vectors.shape
        n_pad = pad_rows_per_shard(n, mesh.shape[axis]) * mesh.shape[axis]
        host = np.zeros((n_pad, d), dtype=vectors.dtype)
        host[:n] = vectors
        valid = np.zeros(n_pad, dtype=bool)
        valid[:n] = True
        self.n = n
        self.n_pad = n_pad
        if precision == "int8":
            from hyperdb_tpu_torch.ops.quantized import quantize_rows

            h32 = host.astype(np.float32)
            if metric == "cosine_similarity":
                norms = np.linalg.norm(h32, axis=1, keepdims=True)
                h32 = h32 / np.where(norms == 0, 1.0, norms)
            rows_q, row_scales = quantize_rows(h32)
            self.rows_q = shard_rows(mesh, rows_q, axis)
            self.row_scales = shard_rows(mesh, row_scales, axis)
        else:
            self.rows = shard_rows(mesh, host, axis)
        self.row_valid = shard_rows(mesh, valid, axis)

    def query(self, queries: np.ndarray, k: int):
        """(B, d) queries -> ((B, k) scores, (B, k) global row ids), NumPy."""
        q = np.asarray(queries, dtype=np.float32)
        if self.precision == "int8":
            if self.metric == "cosine_similarity":
                norms = np.linalg.norm(q, axis=1, keepdims=True)
                q = q / np.where(norms == 0, 1.0, norms)
            vals, idx = sharded_rank_top_k_int8(
                self.mesh, q, self.rows_q, self.row_scales, self.row_valid,
                k=k, axis=self.axis,
            )
        else:
            vals, idx = sharded_rank_top_k(
                self.mesh, q, self.rows, self.row_valid, k=k, metric=self.metric,
                axis=self.axis,
            )
        return vals.cpu().numpy(), idx.cpu().numpy()
