"""Vector store: host master arrays + a padded view on the store's device.

Counterpart of ``hyperdb_tpu/core/store.py``. The host keeps the mutable
master copy (exact shapes, exact dtype); queries run against a cached,
padded device view:

- ``rows``      (N_pad, d)  corpus rows, padded with zeros
- ``rows_norm`` (N_pad, d)  unit-norm rows (cosine fast path)
- ``row_valid`` bool(N_pad) False on padding
- ``row_docs``  i32(N_pad)  chunk-row -> document index (source_indices)
- ``row_sq``    f32(N_pad)  per-row |v|^2

Padding snaps N to a small set of bucket sizes (both packages scan the
same shapes); masks make padding inert. float16 masters serve bfloat16
planes — the dtype the stage-1 kernels take — and float64 masters f32.
"""

from __future__ import annotations

import numpy as np
import torch


def bucket_size(n: int, minimum: int = 8) -> int:
    """Smallest padded size >= n from a ~12.5%-granularity bucket ladder."""
    if n <= minimum:
        return minimum
    # Buckets are multiples of 2^(floor(log2(n)) - 3): at most 8 shapes per
    # power of two, overhead bounded by 12.5%.
    step = max(minimum, 1 << max(0, (n - 1).bit_length() - 3))
    return -(-n // step) * step


_DEVICE_DTYPES = {
    # Rounding an f16 significand (10 bits) to bf16 (7 bits) moves scores at
    # the 3rd decimal digit; scoring accumulates in f32 either way.
    np.dtype(np.float16): torch.bfloat16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float32,
}


class _LazyDeviceView(dict):
    """Device view whose full-corpus float planes upload on first access
    (``dv["rows"]`` / ``dv["rows_norm"]``); a cosine-serving DB only ever
    touches ``rows_norm``. The view snapshots the host master it was built
    from (every mutation replaces ``store.vectors``)."""

    _LAZY_KEYS = ("rows", "rows_norm")

    def __init__(self, store: "VectorStore", vectors):
        super().__init__()
        self._store = store
        self._vectors = vectors

    def __missing__(self, key):
        if key in self._LAZY_KEYS:
            arr = self._store._materialize_plane(key, self["n_pad"], self._vectors)
            self[key] = arr
            return arr
        raise KeyError(key)


class VectorStore:
    """Host master arrays + lazily rebuilt padded device views.

    Only the 'auto' device representation is ported: bf16 planes for f16
    masters, f32 otherwise. int8, binary and pearson views are later
    slices. Every corpus is one device plane, however many rows it has."""

    def __init__(self, fp_dtype, device="cpu"):
        self.fp_dtype = np.dtype(fp_dtype)
        self.device = torch.device(device)
        self.vectors: np.ndarray | None = None  # (N, d) host master
        self._device: dict | None = None
        self._host: dict | None = None

    @property
    def num_rows(self) -> int:
        return 0 if self.vectors is None else int(self.vectors.shape[0])

    @property
    def dim(self) -> int | None:
        return None if self.vectors is None else int(self.vectors.shape[1])

    def set(self, vectors: np.ndarray | None) -> None:
        if vectors is None:
            self.vectors = None
        else:
            self.vectors = np.asarray(vectors, dtype=self.fp_dtype)
            if self.vectors.ndim == 1:
                self.vectors = self.vectors[None, :]
        self.invalidate()

    def append(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, dtype=self.fp_dtype)
        if rows.ndim == 1:
            rows = rows[None, :]
        if self.vectors is None or self.vectors.size == 0:
            self.vectors = rows
        else:
            self.vectors = np.concatenate([self.vectors, rows], axis=0)
        self.invalidate()

    def invalidate(self) -> None:
        self._device = None
        self._host = None

    def host_view(self) -> dict:
        """Cached host arrays for the tiny-corpus host ranking path: raw rows
        and unit-norm rows (f64 masters stay f64, others rank in f32)."""
        if self._host is None:
            host_dtype = np.float64 if self.fp_dtype == np.float64 else np.float32
            rows = np.ascontiguousarray(self.vectors, dtype=host_dtype)
            norms = np.linalg.norm(rows, axis=1, keepdims=True)
            norms[norms == 0] = 1.0
            self._host = {"rows": rows, "rows_norm": rows / norms}
        return self._host

    def _materialize_plane(self, key: str, n_pad: int, vectors=None):
        """Upload ONE plane ('rows'/'rows_norm'): one (n_pad, d) f32 host
        temp, normalized in place exactly as the JAX package does it on the
        host, then cast to the plane dtype on the device (round to nearest
        even, as ml_dtypes does)."""
        if vectors is None:
            vectors = self.vectors
        n, d = vectors.shape
        host = np.zeros((n_pad, d), dtype=np.float32)
        host[:n] = vectors.astype(np.float32, copy=False)
        if key == "rows_norm":
            norms = np.linalg.norm(host[:n], axis=1, keepdims=True)
            norms[norms == 0] = 1.0
            host[:n] /= norms
        dtype = _DEVICE_DTYPES.get(self.fp_dtype, torch.float32)
        return torch.from_numpy(host).to(self.device).to(dtype).contiguous()

    def device_view(self, source_indices) -> dict:
        """Padded device arrays for the current corpus; cached until the next
        mutation. ``source_indices`` must have one entry per row."""
        n = self.num_rows
        if n == 0:
            raise ValueError("Vector store is empty.")
        if self._device is not None and self._device["n"] == n:
            return self._device

        d = self.vectors.shape[1]
        n_pad = bucket_size(n)

        row_sq = np.zeros(n_pad, dtype=np.float32)
        step = max(1, (64 << 20) // max(1, d))
        for s in range(0, n, step):
            chunk = self.vectors[s : s + step].astype(np.float32, copy=False)
            row_sq[s : s + chunk.shape[0]] = np.sum(chunk * chunk, axis=1)

        row_valid = np.zeros(n_pad, dtype=bool)
        row_valid[:n] = True

        src = np.asarray(list(source_indices), dtype=np.int32)
        if src.shape[0] != n:
            raise ValueError(f"source_indices length {src.shape[0]} != row count {n}")
        # padding rows inherit the last doc id so row_docs stays non-decreasing
        row_docs = np.full(n_pad, src[-1], dtype=np.int32)
        row_docs[:n] = src

        dv = _LazyDeviceView(self, self.vectors)
        dv.update(
            n=n,
            n_pad=n_pad,
            dim=d,
            row_valid=torch.from_numpy(row_valid).to(self.device),
            row_docs=torch.from_numpy(row_docs).to(self.device),
            row_sq=torch.from_numpy(row_sq).to(self.device),
        )
        self._device = dv
        return self._device
