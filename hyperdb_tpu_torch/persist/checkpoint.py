"""Versioned binary checkpoint (the recommended fast format).

Counterpart of ``hyperdb_tpu/persist/checkpoint.py``, file-compatible with
it in both directions. A checkpoint is a directory with:

    manifest.json   — version, dtype, shapes, config echo (fp_precision,
                      ann_metric, metadata_keys, select_keys, add_timestamp)
    vectors.npy     — binary ndarray, exact dtype          (monolithic), or
    vectors/shard_XXXXX.npy — row-range shards             (sharded, v2)
    state.json      — documents, source_indices, split_info, metadata_index,
                      vectors_normalized
    index.npz       — ANN index state (optional)

The manifest carries the config, so a checkpoint is self-describing.
Shards (``rows_per_shard=...`` at save time) are written and read
independently, and :func:`load_sharded_vectors` places row ranges straight
onto a device mesh through memory-mapped reads: the full (N, d) matrix is
never one host array, and each mesh shard touches only the rows it owns.
"""

from __future__ import annotations

import json
import os

import numpy as np

FORMAT_VERSION = 2
_SUPPORTED_VERSIONS = (1, 2)


def _shard_paths(directory: str, num_shards: int) -> list[str]:
    return [
        os.path.join(directory, "vectors", f"shard_{i:05d}.npy")
        for i in range(num_shards)
    ]


def save_checkpoint(
    db,
    directory: str,
    save_ann_index: bool = True,
    rows_per_shard: int | None = None,
) -> None:
    os.makedirs(directory, exist_ok=True)
    if db.vectors is None or len(db.vectors) == 0 or not db.documents:
        print("Nothing to save. Exit.")
        return
    n = int(db.vectors.shape[0])
    shard_counts = None
    if rows_per_shard is not None and rows_per_shard > 0:
        shard_counts = [
            min(rows_per_shard, n - start) for start in range(0, n, rows_per_shard)
        ]
    manifest = {
        "version": FORMAT_VERSION,
        "dtype": str(np.dtype(db.fp_precision)),
        "num_rows": n,
        "dim": int(db.vectors.shape[1]),
        "fp_precision": str(np.dtype(db.fp_precision)),
        "ann_metric": db.ann_metric,
        "metadata_keys": list(db.metadata_keys),
        "select_keys": list(db.select_keys) if db.select_keys else None,
        "add_timestamp": bool(db.add_timestamp),
        "n_trees": db.n_trees,
        "vector_shards": shard_counts,
    }
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if shard_counts is None:
        np.save(os.path.join(directory, "vectors.npy"), db.vectors)
    else:
        os.makedirs(os.path.join(directory, "vectors"), exist_ok=True)
        start = 0
        for path, count in zip(_shard_paths(directory, len(shard_counts)), shard_counts):
            np.save(path, db.vectors[start : start + count])
            start += count
    state = {
        "documents": db.documents,
        "source_indices": db.source_indices,
        "split_info": {str(k): v for k, v in db.split_info.items()},
        "metadata_index": {str(k): v for k, v in db._metadata_index.items()},
        "vectors_normalized": db.vectors_normalized,
    }
    with open(os.path.join(directory, "state.json"), "w") as f:
        json.dump(state, f)
    index_path = os.path.join(directory, "index.npz")
    if save_ann_index and db.ann_index is not None:
        from hyperdb_tpu_torch.core.db import _flatten_state

        np.savez_compressed(index_path, **_flatten_state(db.ann_index.state()))
    elif os.path.exists(index_path):
        # overwriting a checkpoint without an index must not leave the
        # previous corpus's index behind for load() to pair with new vectors
        os.remove(index_path)


def read_manifest(directory: str) -> dict:
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("version") not in _SUPPORTED_VERSIONS:
        raise ValueError(f"Unsupported checkpoint version {manifest.get('version')}")
    return manifest


def _load_vectors_host(directory: str, manifest: dict) -> np.ndarray:
    shard_counts = manifest.get("vector_shards")
    if not shard_counts:
        return np.load(os.path.join(directory, "vectors.npy"))
    return np.concatenate(
        [np.load(p) for p in _shard_paths(directory, len(shard_counts))]
    )


def load_checkpoint(db, directory: str, load_ann_index: bool = True,
                    load_vectors: bool = True) -> None:
    """Restore ``db`` (config, vectors, bookkeeping and index) from a
    checkpoint directory.

    ``load_vectors=False`` restores documents, config and bookkeeping only:
    the vectors-beyond-host-RAM path, where the matrix goes straight to a
    device mesh through :func:`load_sharded_vectors`
    (``ShardedHyperDB.from_checkpoint``). It loads no index either."""
    manifest = read_manifest(directory)
    with open(os.path.join(directory, "state.json")) as f:
        state = json.load(f)

    db.fp_precision = np.dtype(manifest["fp_precision"]).type
    db._store.fp_dtype = np.dtype(manifest["fp_precision"])
    db.ann_metric = manifest["ann_metric"]
    db.metadata_keys = list(manifest.get("metadata_keys") or [])
    db.select_keys = manifest.get("select_keys")
    db.add_timestamp = bool(manifest.get("add_timestamp", False))
    db.n_trees = manifest.get("n_trees", 10)

    if load_vectors:
        db._store.set(_load_vectors_host(directory, manifest))
    db.ann_dim = int(manifest["dim"])
    db.documents = state["documents"]
    db.source_indices = [int(i) for i in state["source_indices"]]
    db.split_info = {int(k): v for k, v in state["split_info"].items()}
    db._metadata_index = {int(k): v for k, v in state["metadata_index"].items()}
    db.vectors_normalized = bool(state.get("vectors_normalized", False))
    db._on_mutation()
    db.clear_cache()

    index_path = os.path.join(directory, "index.npz")
    if not (load_ann_index and load_vectors):
        # a previous corpus's index on this db instance must not survive
        db.ann_index = None
        db._ivf_built_rows = 0
    elif os.path.exists(index_path):
        from hyperdb_tpu_torch.core.db import _unflatten_state

        with np.load(index_path, allow_pickle=False) as f:
            db._restore_index(_unflatten_state(dict(f.items())))
    else:
        db._build_ann_index()


def load_sharded_vectors(directory: str, mesh, axis: str = "data"):
    """Load checkpoint vectors straight onto a device mesh.

    Returns ``(rows, n)``: a (n_pad, d)
    :class:`~hyperdb_tpu_torch.parallel.distributed.ShardedRows` over
    ``mesh[axis]`` (zero rows pad each shard to a multiple of 128, the
    ShardedHyperDB layout) and the true row count. The files are opened
    with ``mmap_mode="r"`` and each shard reads only the row range it owns,
    so the host holds one shard's rows at a time, never the corpus. A
    float16 manifest gives bf16 device rows, anything else f32.
    """
    import torch

    from hyperdb_tpu_torch.parallel.distributed import ShardedRows, pad_rows_per_shard

    manifest = read_manifest(directory)
    n, d = int(manifest["num_rows"]), int(manifest["dim"])
    shard_counts = manifest.get("vector_shards")
    if shard_counts:
        mmaps = [np.load(p, mmap_mode="r") for p in _shard_paths(directory, len(shard_counts))]
        starts = np.concatenate([[0], np.cumsum(shard_counts)]).astype(np.int64)
    else:
        mmaps = [np.load(os.path.join(directory, "vectors.npy"), mmap_mode="r")]
        starts = np.array([0, n], dtype=np.int64)

    n_shards = mesh.shape[axis]
    per_shard = pad_rows_per_shard(n, n_shards)
    dev_dtype = torch.bfloat16 if np.dtype(manifest["dtype"]) == np.float16 else torch.float32

    def read_rows(lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of the padded matrix, touching only owning files."""
        out = np.zeros((hi - lo, d), dtype=np.float32)
        for i, m in enumerate(mmaps):
            s, e = int(starts[i]), int(starts[i + 1])
            a, b = max(lo, s), min(min(hi, n), e)
            if a < b:
                out[a - lo : b - lo] = m[a - s : b - s]
        return out

    first = mesh.first_shard(axis)
    shards = []
    for j, dev in enumerate(mesh.local_devices(axis)):
        lo = (first + j) * per_shard
        shards.append(torch.from_numpy(read_rows(lo, lo + per_shard)).to(dev).to(dev_dtype))
    return ShardedRows(shards, per_shard * n_shards, first), n
