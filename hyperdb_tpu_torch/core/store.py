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
- ``rows_planes`` / ``rows_norm_planes``: the two float planes split at
  :meth:`VectorStore.plane_bounds` (a capacity corpus, past
  ``CONFIG.plane_rows``)

Every plane is computed on the host in NumPy exactly as the JAX package
computes it, so the two packages' planes are bit-equal. Padding snaps N to a small set of bucket sizes (both packages scan the
same shapes); masks make padding inert. float16 masters serve bfloat16
planes — the dtype the stage-1 kernels take — and float64 masters f32.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from hyperdb_tpu_torch.utils import trace as _trace


def bucket_size(n: int, minimum: int = 8) -> int:
    """Smallest padded size >= n from a ~12.5%-granularity bucket ladder."""
    if n <= minimum:
        return minimum
    # Buckets are multiples of 2^(floor(log2(n)) - 3): at most 8 shapes per
    # power of two, overhead bounded by 12.5%.
    step = max(minimum, 1 << max(0, (n - 1).bit_length() - 3))
    return -(-n // step) * step


# Elements per chunk of a host pass over the master (64 MiB of f32
# temporaries per chunk in flight).
_BUILD_CHUNK_ELEMS = 1 << 24


def _over_row_chunks(lo: int, hi: int, d: int, work, place) -> None:
    """Run ``work(s, e)`` on consecutive row ranges covering [lo, hi) of
    ``_BUILD_CHUNK_ELEMS`` elements each, on ``torch.get_num_threads()``
    threads, and ``place(s, out)`` on each result in the calling thread, in
    row order, with at most one range more than the threads in flight.
    ``work`` runs NumPy only (its element loops release the GIL), so
    torch's intra-op threads serve only ``place``, in the calling thread.
    An exception in either is raised here."""
    step = max(1, _BUILD_CHUNK_ELEMS // max(1, d))
    threads = max(1, torch.get_num_threads())
    with ThreadPoolExecutor(threads) as pool:
        pending = deque()
        for s in range(lo, hi, step):
            pending.append((s, pool.submit(work, s, min(hi, s + step))))
            if len(pending) > threads:
                s0, out = pending.popleft()
                place(s0, out.result())
        for s0, out in pending:
            place(s0, out.result())


def _host_rows(vectors: np.ndarray, s: int, e: int, normalize: bool) -> np.ndarray:
    """Master rows [s, e) in f32, normalized as the JAX store normalizes
    its whole f32 plane (the norm and the division are per row)."""
    chunk = vectors[s:e].astype(np.float32)  # a copy: normalized in place
    if normalize:
        norms = np.linalg.norm(chunk, axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        chunk /= norms
    return chunk


_DEVICE_DTYPES = {
    # Rounding an f16 significand (10 bits) to bf16 (7 bits) moves scores at
    # the 3rd decimal digit; scoring accumulates in f32 either way.
    np.dtype(np.float16): torch.bfloat16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float32,
}


class _LazyDeviceView(dict):
    """Device view whose full-corpus float planes upload on first access
    (``dv["rows"]`` / ``dv["rows_norm"]``, or split: ``dv["rows_planes"]`` /
    ``dv["rows_norm_planes"]``); a cosine-serving DB only ever touches the
    unit-norm one. The view snapshots the host master it was built from
    (every mutation replaces ``store.vectors``)."""

    _LAZY_KEYS = ("rows", "rows_norm")
    _LAZY_PLANE_KEYS = ("rows_planes", "rows_norm_planes")

    def __init__(self, store: "VectorStore", vectors):
        super().__init__()
        self._store = store
        self._vectors = vectors

    def __missing__(self, key):
        store, n_pad = self._store, self["n_pad"]
        if key in self._LAZY_KEYS:
            (value,) = store._materialize_planes(key, [0, n_pad], self._vectors)
        elif key in self._LAZY_PLANE_KEYS:
            value = store._materialize_planes(
                key.removesuffix("_planes"), store.plane_bounds(n_pad), self._vectors
            )
        else:
            raise KeyError(key)
        self[key] = value
        return value


class VectorStore:
    """Host master arrays + lazily rebuilt padded device views.

    ``precision`` selects the device representation:
      - 'auto'      — bf16 for f16 hosts, f32 otherwise (exact parity)
      - 'int8'      — int8 scan + full-precision rows kept for re-scoring
                      (exact results at int8 scan bandwidth)
      - 'int8-pure' — int8 only: half the device memory of bf16; dot and
                      cosine only, approximate (quantized) scores

    A corpus past ``CONFIG.plane_rows`` padded rows also has its float
    planes split (:meth:`plane_bounds`), which the engine's planar branch
    ranks plane by plane."""

    def __init__(self, fp_dtype, precision: str = "auto", device=None):
        from hyperdb_tpu_torch.core.db import resolve_device

        self.fp_dtype = np.dtype(fp_dtype)
        self.precision = precision
        self.device = resolve_device(device)  # the card unless the caller asks for the CPU
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

    def _upload_plane(self, host: np.ndarray, dtype=None):
        """An f32 host plane onto the device, cast to the plane dtype on the
        host first (torch's CPU cast rounds to nearest even, as ml_dtypes
        does), so no f32 copy of the plane reaches the device."""
        if dtype is None:
            dtype = _DEVICE_DTYPES.get(self.fp_dtype, torch.float32)
        return torch.from_numpy(host).to(dtype).to(self.device).contiguous()

    def _build_int8_plane(self, n_pad: int, normalize: bool):
        """The master's rows (unit-norm where ``normalize``) quantized per
        row to int8 on the host, as ``quantize_rows`` quantizes the JAX
        package's whole f32 plane, a chunk of rows at a time
        (:func:`_over_row_chunks`): (n_pad, d) int8 on the device, zero
        past the rows, and (n_pad,) f32 scales, 0 on padding."""
        from hyperdb_tpu_torch.ops.quantized import quantize_rows

        n, d = self.vectors.shape
        plane = torch.zeros((n_pad, d), dtype=torch.int8, device=self.device)
        scales = np.zeros(n_pad, dtype=np.float32)

        def place(s: int, out) -> None:
            q_rows, sc = out
            plane[s : s + sc.shape[0]].copy_(torch.from_numpy(q_rows))
            scales[s : s + sc.shape[0]] = sc

        _over_row_chunks(
            0, n, d, lambda s, e: quantize_rows(_host_rows(self.vectors, s, e, normalize)), place
        )
        return plane, torch.from_numpy(scales).to(self.device)

    def _build_plane(self, vectors: np.ndarray, lo: int, hi: int, rows: int,
                     normalize: bool) -> torch.Tensor:
        """Master rows [lo, hi) as one (rows, d) device plane, zero past
        ``hi - lo`` and unit-norm where ``normalize``, built a chunk of rows
        at a time (:func:`_over_row_chunks`): each chunk is made in f32 by
        :func:`_host_rows`, rounded to the plane dtype on the host (torch's
        CPU cast rounds to nearest even, as ml_dtypes does) and copied in.
        So the planes' bits are the JAX package's, and neither side ever
        holds an f32 copy of a plane."""
        d = vectors.shape[1]
        dtype = _DEVICE_DTYPES.get(self.fp_dtype, torch.float32)
        plane = torch.zeros((rows, d), dtype=dtype, device=self.device)

        def place(s: int, chunk: np.ndarray) -> None:
            plane[s - lo : s - lo + chunk.shape[0]].copy_(torch.from_numpy(chunk).to(dtype))

        _over_row_chunks(lo, hi, d, lambda s, e: _host_rows(vectors, s, e, normalize), place)
        return plane

    @staticmethod
    def plane_bounds(n_pad: int) -> list[int]:
        """Row boundaries of the capacity split, ``[0, ..., n_pad]``: planes
        of ``CONFIG.plane_rows`` rows, a remainder of under an eighth of
        that folded into the last. One pair means "not planar"."""
        from hyperdb_tpu_torch.config import CONFIG

        cap = CONFIG.plane_rows
        if cap <= 0 or n_pad <= cap:
            return [0, n_pad]
        bounds = list(range(0, n_pad, cap)) + [n_pad]
        if bounds[-1] - bounds[-2] < cap // 8:
            del bounds[-2]
        return bounds

    def is_planar(self, n_pad: int) -> bool:
        """True when this corpus' float device planes are split."""
        return len(self.plane_bounds(n_pad)) > 2

    def _materialize_planes(self, key: str, bounds, vectors: np.ndarray) -> tuple:
        """One float plane ('rows'/'rows_norm') as a tuple of device planes
        at ``bounds`` (``[0, n_pad]`` for one plane), each built from its
        own window of the master: the peak temporaries are those of a chunk,
        and split planes concatenate to the one plane bit for bit."""
        if self.precision == "int8-pure":
            raise KeyError(key)  # int8-pure never holds float planes
        n = vectors.shape[0]
        with _trace.setup_span("store.planes") as built:
            planes = tuple(
                self._build_plane(vectors, a, min(b, n), b - a, key == "rows_norm")
                for a, b in zip(bounds, bounds[1:])
            )
            built.attrs["rows"] = bounds[-1]
            built.attrs["planes"] = len(planes)
        return planes

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

        def squares(s: int, e: int) -> np.ndarray:
            chunk = self.vectors[s:e].astype(np.float32, copy=False)
            return np.sum(chunk * chunk, axis=1)

        def place(s: int, sums: np.ndarray) -> None:
            row_sq[s : s + sums.shape[0]] = sums

        _over_row_chunks(0, n, d, squares, place)

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
            for rows_key, scales_key, normalize in (
                ("rows_q", "row_scales", False),
                ("rowsn_q", "rown_scales", True),
            ):
                dv[rows_key], dv[scales_key] = self._build_int8_plane(n_pad, normalize)
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
            n, d = self.vectors.shape
            plane = torch.zeros((dv["n_pad"], d), dtype=torch.bfloat16, device=self.device)
            counts = np.zeros(dv["n_pad"], dtype=np.float32)

            def work(s: int, e: int):
                bits = self.vectors[s:e] > 0
                return bits, np.count_nonzero(bits, axis=1).astype(np.float32)

            def place(s: int, out) -> None:
                bits, c = out
                plane[s : s + c.shape[0]].copy_(torch.from_numpy(bits).to(torch.bfloat16))
                counts[s : s + c.shape[0]] = c

            _over_row_chunks(0, n, d, work, place)
            dv["rows_bin"] = plane
            dv["row_bin_sum"] = torch.from_numpy(counts).to(self.device)
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
