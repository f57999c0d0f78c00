"""Vector store: host master arrays + a padded view on the store's device.

Counterpart of ``hyperdb_tpu/core/store.py``. The host keeps the mutable
master copy (exact shapes, exact dtype); queries run against a cached,
padded device view:

- ``rows``      (N_pad, d)  corpus rows, padded with zeros
- ``rows_norm`` (N_pad, d)  unit-norm rows (cosine fast path)
- ``row_valid`` bool(N_pad) False on padding
- ``row_docs``  i32(N_pad)  chunk-row -> document index (source_indices)
- ``row_sq``    f32(N_pad)  per-row |v|^2
- ``rows_q`` / ``row_scales`` and ``rowsn_q`` / ``rown_scales``: int8 rows
  and per-row scales of the raw and the unit-norm plane (``precision`` in
  ``"int8"``, ``"int8-pure"``)
- ``rows_bin`` / ``row_bin_sum`` (:meth:`VectorStore.binary_view`) and
  ``rows_pearson`` (:meth:`VectorStore.pearson_view`), built on first use

Every plane is computed on the host in NumPy exactly as the JAX package
computes it, so the two packages' planes are bit-equal. Padding snaps N to a small set of bucket sizes (both packages scan the
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

    ``precision`` selects the device representation:
      - 'auto'      — bf16 for f16 hosts, f32 otherwise (exact parity)
      - 'int8'      — int8 scan + full-precision rows kept for re-scoring
                      (exact results at int8 scan bandwidth)
      - 'int8-pure' — int8 only: half the device memory of bf16; dot and
                      cosine only, approximate (quantized) scores

    Every corpus is one device plane, however many rows it has."""

    def __init__(self, fp_dtype, precision: str = "auto", device="cpu"):
        self.fp_dtype = np.dtype(fp_dtype)
        self.precision = precision
        self.device = torch.device(device)
        self.vectors: np.ndarray | None = None  # (N, d) host master
        self._device: dict | None = None
        self._host: dict | None = None

    @property
    def low_precision_device(self) -> bool:
        """True when the device plane is bf16/int8 — device math already
        rounds or quantizes queries below f32, so an f16 query wire costs no
        additional precision."""
        if self.precision in ("int8", "int8-pure"):
            return True
        return self.fp_dtype == np.float16

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

    def delete_rows(self, row_indices) -> None:
        if self.vectors is None:
            return
        keep = np.ones(self.vectors.shape[0], dtype=bool)
        keep[np.asarray(list(row_indices), dtype=np.int64)] = False
        self.vectors = self.vectors[keep]
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

    @staticmethod
    def _padded_raw(vectors: np.ndarray, n_pad: int) -> np.ndarray:
        """(n_pad, d) f32 host plane of the raw rows."""
        n, d = vectors.shape
        host = np.zeros((n_pad, d), dtype=np.float32)
        host[:n] = vectors.astype(np.float32, copy=False)
        return host

    def _padded_planes(self, n_pad: int):
        """(n_pad, d) f32 host planes: raw rows and unit-norm rows (the int8
        quantize path needs both at once)."""
        n = self.vectors.shape[0]
        host = self._padded_raw(self.vectors, n_pad)
        norms = np.linalg.norm(host[:n], axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        host_norm = np.zeros_like(host)
        host_norm[:n] = host[:n] / norms
        return host, host_norm

    def _upload_plane(self, host: np.ndarray, dtype=None):
        """An f32 host plane onto the device, cast there to the plane dtype
        (round to nearest even, as ml_dtypes does on the host)."""
        if dtype is None:
            dtype = _DEVICE_DTYPES.get(self.fp_dtype, torch.float32)
        return torch.from_numpy(host).to(self.device).to(dtype).contiguous()

    def _materialize_plane(self, key: str, n_pad: int, vectors=None):
        """Upload ONE plane ('rows'/'rows_norm'): one (n_pad, d) f32 host
        temp, normalized in place exactly as the JAX package does it on the
        host."""
        if self.precision == "int8-pure":
            raise KeyError(key)  # int8-pure never holds float planes
        if vectors is None:
            vectors = self.vectors
        n = vectors.shape[0]
        host = self._padded_raw(vectors, n_pad)
        if key == "rows_norm":
            norms = np.linalg.norm(host[:n], axis=1, keepdims=True)
            norms[norms == 0] = 1.0
            host[:n] /= norms
        return self._upload_plane(host)

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
        if self.precision in ("int8", "int8-pure"):
            from hyperdb_tpu_torch.ops.quantized import quantize_rows

            host, host_norm = self._padded_planes(n_pad)
            for plane, rows_key, scales_key in (
                (host, "rows_q", "row_scales"),
                (host_norm, "rowsn_q", "rown_scales"),
            ):
                q_rows, scales = quantize_rows(plane)
                dv[rows_key] = torch.from_numpy(q_rows).to(self.device)
                dv[scales_key] = torch.from_numpy(scales).to(self.device)
        self._device = dv
        return self._device

    def binary_view(self, source_indices) -> dict:
        """Binarized (x > 0) 0/1 rows + per-row popcounts for the hamming/
        jaccard grouped routes. Built lazily on the first binary-metric
        query (another (N_pad, d) device plane) and cached on the device
        view until the next mutation.

        Always bf16 whatever the master dtype: 0/1 operands are exact in
        bf16 and the product accumulates in f32 (exact integer counts to
        2^24), so the plane is half the bytes of f32 with identical scores,
        and it is the dtype the stage-1 kernels take."""
        dv = self.device_view(source_indices)
        if "rows_bin" not in dv:
            host_bin = (self.vectors.astype(np.float32) > 0).astype(np.float32)
            n, d = host_bin.shape
            padded = np.zeros((dv["n_pad"], d), dtype=np.float32)
            padded[:n] = host_bin
            dv["rows_bin"] = self._upload_plane(padded, torch.bfloat16)
            dv["row_bin_sum"] = torch.from_numpy(np.sum(padded, axis=1)).to(self.device)
        return dv

    def pearson_view(self, source_indices) -> dict:
        """Mean-centered unit-norm rows for the pearson grouped route.

        pearson(q, v) == dot(center(q)/|center(q)|, center(v)/|center(v)|)
        (ranking_algorithm.py:77-113 rearranged), so over this plane the
        metric IS dot_product and takes the grouped and kernel routes
        unchanged. Constant rows divide 0/0 -> NaN here ON PURPOSE: every
        ranking route scrubs NaN -> -inf right after its product, which is
        the reference's "any constant vector involved -> never ranked"
        contract. Built lazily on the first big-batch pearson query and
        cached on the device view until the next mutation; the dtype follows
        the rows plane (bf16 for f16 masters)."""
        dv = self.device_view(source_indices)
        if "rows_pearson" not in dv:
            from hyperdb_tpu_torch.ops.metrics import pearson_center_normalize

            # exactly ONE (n_pad, d) f32 host temp: cast-on-assign into the
            # staging buffer, transform in place
            n, d = self.vectors.shape
            padded = np.zeros((dv["n_pad"], d), dtype=np.float32)
            padded[:n] = self.vectors
            pearson_center_normalize(padded[:n])
            dv["rows_pearson"] = self._upload_plane(padded)
        return dv
