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
independently; the JAX package also streams them straight onto a device
mesh (``load_sharded_vectors``), which belongs to the multi-device slice
and is not ported.
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


def load_checkpoint(db, directory: str, load_ann_index: bool = True) -> None:
    """Restore ``db`` (config, vectors, bookkeeping and index) from a
    checkpoint directory."""
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
    if not load_ann_index:
        # a previous corpus's index on this db instance must not survive
        db.ann_index = None
        db._ivf_built_rows = 0
    elif os.path.exists(index_path):
        from hyperdb_tpu_torch.core.db import _unflatten_state

        with np.load(index_path, allow_pickle=False) as f:
            db._restore_index(_unflatten_state(dict(f.items())))
    else:
        db._build_ann_index()
