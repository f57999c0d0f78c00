"""ShardedHyperDB — serve one HyperDB's corpus across a device mesh.

Counterpart of ``hyperdb_tpu/parallel/sharded_db.py``. The host-side
HyperDB stays the source of truth (documents, filters, metadata); its
vector matrix is row-sharded over the mesh's 'data' axis and queries run as
per-shard scoring + local top-k + a gathered exact merge
(``parallel/distributed.py``). Filters are evaluated on the host exactly as
in the single-device engine and ride along as a sharded row mask.

Chunked corpora are exact: rows are ranked distributed, the chunk rows of a
document are deduplicated on the host from the merged candidates (the first
hit per document in exact score order is the single-device segment max),
and the fetch depth grows until every query holds ``top_k`` distinct
documents or the whole corpus was fetched (``chunk_slack`` only sets the
first overfetch). Recency and the shared query LRU match the single-device
engine. Key filters score a per-document override block, built on the host
as the single-device engine builds it and row-sharded over the same mesh
(one override row per document, identity row -> document map).

Serving lifecycle: the shards are CAPACITY-PADDED and carry a live-row
validity mask, so they absorb mutations without a re-shard: ``add`` /
``add_documents`` write new rows into reserved capacity in place (``copy_``
into each shard's tensor, no second copy of the corpus), and
``remove_document`` tombstones the victim's rows in the mask and renumbers
the host-side row -> document map (device rows never move). A direct
mutation of the wrapped db (bypassing these methods) demands a rebuild
(:meth:`ShardedHyperDB.compact`); a fingerprint check refuses queries until
then.

``precision="int8-pure"`` serves per-row-quantized int8 shards (cosine and
dot only, ops/quantized semantics) at half the bytes per shard of bf16.
"""

from __future__ import annotations

import numpy as np
import torch

from hyperdb_tpu_torch.config import CONFIG
from hyperdb_tpu_torch.ops import metrics as _metrics
from hyperdb_tpu_torch.ops.metrics import pearson_center_normalize
from hyperdb_tpu_torch.parallel.distributed import (
    ShardedRows,
    pad_rows_per_shard,
    shard_rows,
    sharded_rank_top_k,
    sharded_rank_top_k_int8,
)
from hyperdb_tpu_torch.query import engine as _engine
from hyperdb_tpu_torch.query import filters as _filters
from hyperdb_tpu_torch.utils.devio import fetch

_SHARD_NAMES = ("rows", "rows_norm", "rows_pearson", "rows_q", "row_scales",
                "rowsn_q", "rown_scales")


def _pearson_rows(rows: torch.Tensor) -> torch.Tensor:
    """Centered unit-norm rows of one shard (row-local, on its device).
    Constant and padding rows divide 0/0 -> NaN ON PURPOSE: the scans scrub
    NaN -> -inf after their product, the reference's constant-vector
    pearson contract."""
    f32 = rows.float()
    c = f32 - f32.mean(dim=1, keepdim=True)
    return (c / torch.linalg.vector_norm(c, dim=1, keepdim=True)).to(rows.dtype)


def _unit_rows(rows: torch.Tensor) -> torch.Tensor:
    """f32 unit-norm rows of one shard; zero rows stay zero."""
    f32 = rows.float()
    norms = torch.linalg.vector_norm(f32, dim=1, keepdim=True)
    return f32 / torch.where(norms == 0, torch.ones_like(norms), norms)


def _write_block(sharded: ShardedRows, block: torch.Tensor, offset: int) -> None:
    """Copy ``block`` into global rows [offset, offset + len) in place,
    shard by shard (this process's shards only)."""
    n_local = sharded.shards[0].shape[0]
    first = sharded.first_shard
    for j, shard in enumerate(sharded.shards):
        lo = (first + j) * n_local
        a, b = max(offset, lo), min(offset + block.shape[0], lo + n_local)
        if a < b:
            shard[a - lo:b - lo].copy_(block[a - offset:b - offset])


def compute_filter_row_mask(db, filters, base_valid, row_docs, n):
    """Host-side filter evaluation over a row-sharded layout: (row validity
    over base_valid's n_pad rows, (document mask, per-document override
    block or None)).

    Shared by :class:`ShardedHyperDB` and the multi-process serving leader
    (``parallel/multihost_serve.py``): both score row shards but evaluate
    filters per document on the host db, with the single-device engine's
    semantics (``query/filters.apply_filters``)."""
    num_docs = len(db.documents)
    if num_docs == 0:
        # every row is a tombstone: no document mask to gather through
        return np.zeros(base_valid.shape[0], dtype=bool), (np.zeros(0, dtype=bool), None)
    mask = np.ones(num_docs, dtype=bool)
    if not filters:
        return base_valid, (mask, None)  # callers never write the row mask
    for name, params in filters:
        if name not in _filters.FILTER_NAMES:
            raise ValueError(f"Invalid filter name {name}")
        if name == "skip_doc":
            mask &= _filters.skip_doc_mask(num_docs, params)
            break  # the reference applies only the FIRST skip_doc
    mask, override = _filters.apply_filters(db, filters, mask)
    rows = base_valid.copy()
    rows[:n] &= mask[row_docs[:n]]
    return rows, (mask, override)


def dedup_doc_candidates(vals, idx, row_docs, documents, top_k, k_fetch, n, n_pad,
                         return_similarities):
    """Host-side chunk -> document dedup of one exact candidate batch.

    Candidates arrive in exact global row-score order, so the first hit per
    document is its best chunk (segment-max semantics). Returns (per-query
    result rows, need_refill): refill means some query ran out of
    candidates before ``top_k`` distinct documents AND a deeper fetch can
    still help. Shared by ShardedHyperDB.query_batch and the multi-process
    leader's refill loop."""
    results = []
    need_refill = False
    for b in range(idx.shape[0]):
        row = []
        seen: set[int] = set()
        finite = 0
        for r, score in zip(idx[b], vals[b]):
            if r >= n or not np.isfinite(score):
                continue
            finite += 1
            doc_id = int(row_docs[r])
            if doc_id in seen:
                continue
            seen.add(doc_id)
            if len(row) < top_k:
                document = documents[doc_id]
                row.append((document, float(score), doc_id) if return_similarities else document)
        if len(row) < top_k and finite == k_fetch and k_fetch < n_pad:
            need_refill = True
        results.append(row)
    return results, need_refill


def doc_rows_to_arrays(rows):
    """Result rows -> ((B, k) int64 ids, (B, k) f32 scores), each row cut to
    the shortest (a filter can leave fewer than ``top_k`` documents)."""
    k = min((len(r) for r in rows), default=0)
    ids = np.array([[r[2] for r in row[:k]] for row in rows], dtype=np.int64)
    scores = np.array([[r[1] for r in row[:k]] for row in rows], dtype=np.float32)
    return ids.reshape(len(rows), k), scores.reshape(len(rows), k)


def refill_depth(k_fetch: int, top_k: int, split_info: dict, n_pad: int) -> int:
    """The next fetch depth of the chunked refill loop: one worst-case jump
    instead of repeated doublings (top_k * the most chunks of any document
    always holds top_k distinct documents)."""
    max_chunks = max(split_info.values(), default=1)
    worst = 1 << max(0, int(top_k * max_chunks - 1)).bit_length()
    return min(max(k_fetch * 2, worst), n_pad)


class ShardedHyperDB:
    """A HyperDB served over a device mesh.

    ``device_rows`` injects an already-sharded (n_pad, d)
    :class:`~hyperdb_tpu_torch.parallel.distributed.ShardedRows` (the
    from_checkpoint path, where the corpus never exists on the host);
    ``num_rows`` is its true row count. Without it the host db's vectors are
    padded and placed here. ``capacity_rows`` reserves rows beyond the
    current corpus so later :meth:`add` calls write in place.
    """

    def __init__(self, db, mesh, axis: str = "data", chunk_slack: int = 4,
                 device_rows: ShardedRows | None = None, num_rows: int | None = None,
                 precision: str = "auto", capacity_rows: int | None = None):
        if precision not in ("auto", "int8-pure"):
            raise ValueError("precision must be 'auto' or 'int8-pure'.")
        self.db = db
        self.mesh = mesh
        self.axis = axis
        self.chunk_slack = chunk_slack
        self.precision = precision

        if device_rows is not None:
            if num_rows is None:
                raise ValueError("num_rows is required with device_rows.")
            self.n = int(num_rows)
            self.n_pad = int(device_rows.shape[0])
            self.d = int(device_rows.shape[1])
            self._host_aligned = False  # the host holds no rows of this corpus
            unit = device_rows.map(_unit_rows)  # shard-local, zero pad rows stay 0
            if precision == "int8-pure":
                self._quantize_device_shards(device_rows.map(lambda r: r.float()), unit)
            else:
                self.rows = device_rows
                self.rows_norm = unit.map(lambda r: r.to(device_rows.dtype))
        else:
            self._build_host_shards(capacity_rows)
        self._reset_bookkeeping()

    def _build_host_shards(self, capacity_rows: int | None) -> None:
        """(Re)build the shards from the wrapped db's host vectors:
        capacity-padded, 128-row aligned per shard, the unit-norm twin for
        the cosine plane, int8 quantization when configured. Shared by the
        constructor and :meth:`compact`."""
        db = self.db
        if db.vectors is None or len(db.vectors) == 0:
            raise ValueError("Cannot shard an empty database.")
        self._host_aligned = True  # host row i is device row i until a removal
        n, d = db.vectors.shape
        self.d = int(d)
        n_shards = self.mesh.shape[self.axis]
        self.n = n
        self.n_pad = pad_rows_per_shard(max(n, int(capacity_rows or 0)), n_shards) * n_shards

        host = np.zeros((self.n_pad, d), dtype=np.float32)
        host[:n] = db.vectors.astype(np.float32, copy=False)
        norms = np.linalg.norm(host[:n], axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        host_norm = np.zeros_like(host)
        host_norm[:n] = host[:n] / norms

        if self.precision == "int8-pure":
            from hyperdb_tpu_torch.ops.quantized import quantize_rows

            q_raw, s_raw = quantize_rows(host)
            q_norm, s_norm = quantize_rows(host_norm)
            self.rows_q, self.row_scales = (shard_rows(self.mesh, x, self.axis) for x in (q_raw, s_raw))
            self.rowsn_q, self.rown_scales = (shard_rows(self.mesh, x, self.axis) for x in (q_norm, s_norm))
        else:
            dev_dtype = torch.bfloat16 if db.vectors.dtype == np.float16 else torch.float32
            self.rows = shard_rows(self.mesh, host, self.axis, dtype=dev_dtype)
            self.rows_norm = shard_rows(self.mesh, host_norm, self.axis, dtype=dev_dtype)

    def _reset_bookkeeping(self) -> None:
        db = self.db
        self.row_docs = np.zeros(self.n_pad, dtype=np.int64)
        self.row_docs[: self.n] = np.asarray(db.source_indices, dtype=np.int64)
        # live rows: tombstoned and not-yet-filled capacity rows are False
        self._base_valid = np.zeros(self.n_pad, dtype=bool)
        self._base_valid[: self.n] = True
        # key-filter override blocks per (filter spec, corpus version)
        self._override_cache = {}
        # the shards snapshot the corpus: queries check this fingerprint so
        # a direct mutation of the wrapped db cannot desynchronize row ids
        self._built_state = (len(db.documents), len(db.source_indices))

    def _quantize_device_shards(self, f32: ShardedRows, f32_norm: ShardedRows) -> None:
        """Quantize already-sharded rows shard-locally (per-row symmetric
        int8, no cross-shard traffic; the from_checkpoint path)."""
        from hyperdb_tpu_torch.ops.quantized import _quantize_device

        for raw, q_name, s_name in ((f32, "rows_q", "row_scales"),
                                     (f32_norm, "rowsn_q", "rown_scales")):
            pairs = [_quantize_device(s) for s in raw.shards]
            setattr(self, q_name, ShardedRows([p[0] for p in pairs], raw.shape[0], raw.first_shard))
            setattr(self, s_name, ShardedRows([p[1] for p in pairs], raw.shape[0], raw.first_shard))

    @classmethod
    def from_checkpoint(cls, directory: str, mesh, axis: str = "data",
                        chunk_slack: int = 4, precision: str = "auto") -> "ShardedHyperDB":
        """Serve a checkpoint whose vector matrix need not fit the host.

        Documents, config and bookkeeping load on the host; the vector matrix
        streams from the checkpoint's files straight onto the mesh
        (``persist/checkpoint.load_sharded_vectors``) and is never one host
        array. The host db lives on the mesh's first device."""
        from hyperdb_tpu_torch.core.db import HyperDB
        from hyperdb_tpu_torch.persist.checkpoint import load_checkpoint, load_sharded_vectors

        db = HyperDB(device=mesh.local_devices(axis)[0])
        load_checkpoint(db, directory, load_ann_index=False, load_vectors=False)
        rows, n = load_sharded_vectors(directory, mesh, axis=axis)
        return cls(db, mesh, axis=axis, chunk_slack=chunk_slack, device_rows=rows,
                   num_rows=n, precision=precision)

    # ------------------------------------------------------------------
    # incremental serving lifecycle
    # ------------------------------------------------------------------

    def _check_fingerprint(self):
        if self._built_state is None:
            raise RuntimeError(
                "The device shards are gone: a previous compact() dropped "
                "the old shard set and the rebuild failed. Call compact() "
                "again (after addressing its error) to restore serving."
            )
        if (len(self.db.documents), len(self.db.source_indices)) != self._built_state:
            raise RuntimeError(
                "The wrapped HyperDB was mutated after sharding; the device "
                "shards hold the construction-time corpus. Mutate through "
                "ShardedHyperDB.add/remove_document (in-place), or call "
                "compact() to rebuild the shards from the new state."
            )

    def _write_rows(self, new_f32: np.ndarray, offset: int) -> None:
        """Write (m, d) f32 host rows into the shards at global row
        ``offset``, in place (``copy_`` into each shard's tensor, no second
        corpus allocation)."""
        m = new_f32.shape[0]
        block = np.asarray(new_f32, dtype=np.float32)
        norms = np.linalg.norm(block, axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        block_norm = block / norms
        if self.precision == "int8-pure":
            from hyperdb_tpu_torch.ops.quantized import quantize_rows

            for plane, q_name, s_name in ((block, "rows_q", "row_scales"),
                                          (block_norm, "rowsn_q", "rown_scales")):
                q, s = quantize_rows(plane)
                _write_block(getattr(self, q_name), torch.from_numpy(q), offset)
                _write_block(getattr(self, s_name), torch.from_numpy(s), offset)
            return
        dt = self.rows.dtype
        _write_block(self.rows, torch.from_numpy(block).to(dt), offset)
        _write_block(self.rows_norm, torch.from_numpy(block_norm).to(dt), offset)
        if hasattr(self, "rows_pearson"):
            # keep the lazily built pearson plane in step with appends
            # (a tombstone only masks rows, so removals need nothing here)
            pblock = pearson_center_normalize(block[:m].copy())
            _write_block(self.rows_pearson, torch.from_numpy(pblock).to(dt), offset)

    def _pearson_plane(self) -> ShardedRows:
        """Sharded centered unit-norm rows: pearson(q, v) == dot over this
        plane with a centered unit-norm query, so pearson queries ride the
        per-shard dot routes (and kernels). Built lazily, cached until
        :meth:`compact` rebuilds the shards: from the host master while its
        rows still sit where the device rows do (no removal since the
        build), as the single-device store builds its plane, so a float16
        master is centred before the bf16 rounding; otherwise on the devices
        from the shards themselves (a checkpoint's rows, or after
        tombstones)."""
        if not hasattr(self, "rows_pearson"):
            vectors = self.db.vectors
            if self._host_aligned and vectors is not None and len(vectors) == self.n:
                host = np.zeros((self.n_pad, self.d), dtype=np.float32)
                host[: self.n] = vectors
                self.rows_pearson = shard_rows(self.mesh, pearson_center_normalize(host), self.axis,
                                               dtype=self.rows.dtype)
            else:
                self.rows_pearson = self.rows.map(_pearson_rows)
        return self.rows_pearson

    @property
    def capacity_remaining(self) -> int:
        return self.n_pad - self.n

    @property
    def tombstoned_rows(self) -> int:
        """Rows still occupying device capacity but masked out by removals."""
        return int(self.n - self._base_valid[: self.n].sum())

    def compact(self, capacity_rows: int | None = None) -> None:
        """Rebuild the shards from the wrapped db's live host state.

        Reclaims the capacity of tombstoned rows and re-synchronizes after a
        DIRECT mutation of the wrapped db. The old shards are dropped before
        the new ones are allocated, so the devices never hold two corpora.
        ``capacity_rows`` defaults to the current padded capacity (reserved
        headroom survives); a smaller value shrinks it, never below the live
        rows. A ``device_rows`` corpus (from_checkpoint) has no host vectors
        to rebuild from and raises."""
        db = self.db
        if db.vectors is None:
            raise RuntimeError(
                "compact() needs host-side vectors: this ShardedHyperDB was "
                "built from device_rows (e.g. from_checkpoint), so the "
                "corpus never existed host-side."
            )
        if len(db.vectors) == 0:
            # checked BEFORE the old shards go: tombstones already hide the
            # removed rows, so the live shard set stays serviceable
            raise ValueError(
                "Cannot compact to an empty database: every document was "
                "removed. The existing shards remain valid (tombstones mask "
                "removed rows); add documents before compacting."
            )
        if capacity_rows is None:
            capacity_rows = self.n_pad
        for name in _SHARD_NAMES:
            if hasattr(self, name):
                delattr(self, name)
        try:
            self._build_host_shards(capacity_rows)
        except BaseException:
            # the old shards are gone and the rebuild died: every later query
            # raises a descriptive error until compact() succeeds
            self._built_state = None
            raise
        self._reset_bookkeeping()
        db.clear_cache()  # cached entries carry results of the old shards

    def add(self, documents, vectors=None, add_timestamp=False) -> None:
        """Append documents to the wrapped db AND to the shards in place.
        New rows beyond the reserved capacity make the shards compact into a
        grown capacity (one rebuild, not an error); a ``device_rows`` corpus
        has no host vectors to rebuild from and raises after rolling the
        host db back."""
        self._check_fingerprint()
        db = self.db
        prev_docs = len(db.documents)
        prev_rows = len(db.source_indices)
        prev_vec = 0 if db.vectors is None else int(len(db.vectors))
        # a device_rows corpus holds on the host only the rows appended since
        # construction, so new rows are always the host matrix's TAIL
        host_backed = prev_vec == prev_rows
        db.add(documents, vectors=vectors, add_timestamp=add_timestamp)
        m = len(db.source_indices) - prev_rows
        if m:
            if self.n + m > self.n_pad:
                if not host_backed:
                    self._rollback_append(prev_docs, prev_rows, prev_vec)
                    raise RuntimeError(
                        f"Shard capacity exhausted ({self.n}+{m} > "
                        f"{self.n_pad} rows) and this corpus has no host "
                        "vectors to rebuild from (device_rows/"
                        "from_checkpoint): rebuild with a larger "
                        "capacity_rows."
                    )
                # grow with one rebuild (doubling amortizes repeated
                # overflows; compaction also reclaims tombstoned rows)
                live = int(self._base_valid[: self.n].sum())
                self.compact(capacity_rows=max(self.n_pad * 2, live + m))
                return
            self._write_rows(np.asarray(db.vectors[prev_vec:], dtype=np.float32), self.n)
            self.row_docs[self.n : self.n + m] = np.asarray(
                db.source_indices[prev_rows:], dtype=np.int64
            )
            self._base_valid[self.n : self.n + m] = True
            self.n += m
        self._built_state = (len(db.documents), len(db.source_indices))
        self._override_cache.clear()

    def _rollback_append(self, prev_docs, prev_rows, prev_vec) -> None:
        """Undo a just-committed append on the wrapped db by truncating its
        tail (``remove_document`` maps ids through source_indices, which for
        a vectors-less host db point past the appends-only host matrix)."""
        db = self.db
        del db.documents[prev_docs:]
        del db.source_indices[prev_rows:]
        if db.vectors is not None and len(db.vectors) > prev_vec:
            db._store.delete_rows(range(prev_vec, len(db.vectors)))
        for idx in [i for i in db.split_info if i >= prev_docs]:
            del db.split_info[idx]
        for idx in [i for i in db._metadata_index if i >= prev_docs]:
            del db._metadata_index[idx]
        db._on_mutation()
        db._build_ann_index()
        db.clear_cache()

    def add_documents(self, documents, vectors=None, add_timestamp=False):
        return self.add(documents, vectors=vectors, add_timestamp=add_timestamp)

    def remove_document(self, indices) -> None:
        """Tombstone: the victims' rows turn invalid in the row mask (device
        rows never move); the surviving row -> document ids renumber as
        HyperDB.remove_document renumbers the host state. Ids are
        normalized and checked before anything changes."""
        self._check_fingerprint()
        if isinstance(indices, int):
            indices = [indices]
        n_docs = len(self.db.documents)
        norm = set()
        for i in indices:
            i = int(i)
            if i < 0:
                i += n_docs
            if not 0 <= i < n_docs:
                raise IndexError(f"Document index {i} out of range for {n_docs} documents.")
            norm.add(i)
        removed = sorted(norm)
        self.db.remove_document(removed)
        removed_arr = np.asarray(removed, dtype=np.int64)
        rd = self.row_docs[: self.n]
        victims = np.isin(rd, removed_arr)
        self._host_aligned = self._host_aligned and not victims.any()
        self._base_valid[: self.n] &= ~victims
        renumbered = rd - np.searchsorted(removed_arr, rd, side="left")
        # a victim could keep an id equal to the new document count (removing
        # the last one); every row's id is gathered through, so pin it to 0
        renumbered[victims] = 0
        self.row_docs[: self.n] = renumbered
        self._built_state = (len(self.db.documents), len(self.db.source_indices))
        self._override_cache.clear()

    def _row_mask(self, filters):
        """(row validity mask, (document mask, override block or None))."""
        return compute_filter_row_mask(self.db, filters, self._base_valid, self.row_docs, self.n)

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------

    def query(self, query_input, top_k: int = 5, filters=None,
              metric: str = "cosine_similarity", return_similarities: bool = True,
              recency_bias: float = 0, timestamp_key=None):
        """One query, cached on the host db's LRU (shared counters, cleared
        by any db mutation), keyed apart from single-device results."""
        db = self.db
        key = ("sharded",) + db._hashable_key(
            query_input, top_k, return_similarities, filters,
            recency_bias, timestamp_key, metric, None,
        )
        if key in db.lru_cache:
            db.cache_hits += 1
            return db.lru_cache[key]
        db.cache_misses += 1
        result = self.query_batch(
            [query_input], top_k=top_k, filters=filters, metric=metric,
            return_similarities=return_similarities,
            recency_bias=recency_bias, timestamp_key=timestamp_key,
        )[0]
        db.lru_cache[key] = result
        return result

    def query_batch(self, query_inputs, top_k: int = 5, filters=None,
                    metric: str = "cosine_similarity", return_similarities: bool = True,
                    recency_bias: float = 0, timestamp_key=None,
                    n_valid: int | None = None):
        """Batched search over the shards: a list of per-query result lists.
        ``n_valid`` (the serving front ends' argument) keeps the first
        ``n_valid`` rows of the answer."""
        return self._search(query_inputs, top_k, filters, metric, return_similarities,
                            recency_bias, timestamp_key, n_valid, arrays=False)

    def query_batch_arrays(self, query_vectors, top_k: int = 5, filters=None,
                           recency_bias: float = 0, timestamp_key=None,
                           metric: str = "cosine_similarity", ann_percent: int = 5,
                           n_valid: int | None = None):
        """Array twin of :meth:`query_batch` (the contract of
        ``HyperDB.query_batch_arrays``), so the serving front ends can wrap
        a sharded corpus; rows are cut to the shortest when a filter leaves
        fewer than ``top_k`` documents for some query. There is no ANN
        index here: ``ann_percent`` is accepted and unused."""
        del ann_percent
        return self._search(query_vectors, top_k, filters, metric, True, recency_bias,
                            timestamp_key, n_valid, arrays=True)

    def _search(self, query_inputs, top_k, filters, metric, return_similarities,
                recency_bias, timestamp_key, n_valid, arrays: bool):
        """:meth:`query_batch` (result rows) or, with ``arrays``,
        :meth:`query_batch_arrays` ((ids, scores) arrays). An unchunked
        corpus's arrays come straight from the merged candidates, one row
        per document; everything else goes through the document rows."""
        db = self.db
        finish = doc_rows_to_arrays if arrays else (lambda rows: rows)
        self._check_fingerprint()
        if isinstance(query_inputs, torch.Tensor):
            query_inputs = query_inputs.float().cpu().numpy()
        if isinstance(query_inputs, np.ndarray) and query_inputs.ndim == 2:
            # f16 blocks pass through, as in the single-device engine
            q = query_inputs if query_inputs.dtype == np.float16 else query_inputs.astype(np.float32)
        else:
            q = np.stack([
                _engine.generate_and_validate_query_vector(db, qi) for qi in query_inputs
            ]).astype(np.float32)
        if n_valid is not None:
            q = q[:n_valid]
        if q.shape[1] != self.d:
            raise ValueError(
                f"The dimension of the query vectors ({q.shape[1]}) must "
                f"match the dimension of the vectors in the database "
                f"({self.d})."
            )

        # batch bucketing as in the single-device engine: pad rows repeat
        # row 0 and are cut from every answer through b_real
        b_real = q.shape[0]
        if CONFIG.batch_bucket:
            b_pad = _engine._pad_pow2(b_real)
            if b_pad != b_real:
                q = np.concatenate([q, np.repeat(q[:1], b_pad - b_real, axis=0)])

        row_mask, (doc_mask, override) = self._row_mask(filters)
        if override is not None:
            return finish(self._query_override(
                q, doc_mask, override, top_k, metric, return_similarities,
                recency_bias, timestamp_key, spec=_filters.hashable_filters(filters),
            )[:b_real])
        if not row_mask[: self.n].any():
            # filters emptied the corpus: empty result lists, as the engine
            return finish([[] for _ in range(b_real)])
        num_docs = len(db.documents)
        chunked = num_docs != self.n

        # recency: a document-level term over the surviving documents,
        # expanded to rows (a document scores max over its rows of row score
        # + its recency, the single-device order of operations)
        recency_rows = None
        if recency_bias != 0:
            surviving = np.zeros(num_docs, dtype=bool)
            surviving[np.unique(self.row_docs[: self.n][row_mask[: self.n]])] = True
            dense = _engine.handle_timestamps(
                db, recency_bias, timestamp_key, np.flatnonzero(surviving)
            )
            recency_rows = np.zeros(self.n_pad, dtype=np.float32)
            recency_rows[: self.n] = dense[self.row_docs[: self.n]]

        k_fetch = (1 << max(0, top_k * self.chunk_slack - 1).bit_length()) if chunked else top_k
        # the merge is exact for any k up to the whole corpus
        k_fetch = min(k_fetch, self.n_pad)

        prenorm = metric == "cosine_similarity"
        pearson = metric == "pearson_correlation"
        use_int8 = self.precision == "int8-pure"
        if use_int8 and metric not in ("cosine_similarity", "dot_product"):
            raise ValueError(
                "precision='int8-pure' supports cosine_similarity and "
                f"dot_product only on the sharded scan (got '{metric}')."
            )
        if use_int8:
            rows_dev = None
        elif prenorm:
            rows_dev = self.rows_norm
        elif pearson:
            # dot over the centered unit-norm plane IS pearson: recency
            # composes directly and the per-shard dot routes serve the scan;
            # the centred query stays f32 until the plane's cast, as in the
            # single-device engine
            rows_dev = self._pearson_plane()
            q = pearson_center_normalize(np.array(q, dtype=np.float32))
        else:
            rows_dev = self.rows
        dev_metric = "dot_product" if (prenorm or pearson) else metric

        q_dev = torch.from_numpy(np.ascontiguousarray(q))
        if use_int8 and prenorm:
            # unit rows were quantized for cosine: a unit query (normalized
            # on the host, as the single-device engine does before
            # quantizing) makes the scan score (quantized) cosine
            q32 = q.astype(np.float32)
            qn = np.linalg.norm(q32, axis=1, keepdims=True)
            qn[qn == 0] = 1.0
            q_dev = torch.from_numpy(np.ascontiguousarray((q32 / qn).astype(q.dtype)))
        elif prenorm:
            # the single-device engine's operand: the query normalized in
            # f32 on the device, cast to a low-precision plane's dtype; dot
            # over unit rows is then cosine, and recency adds to it directly
            q_dev = _metrics._match_low_precision(
                _metrics.normalize(q_dev.to(rows_dev.shards[0].device)), rows_dev.shards[0]
            )
        elif pearson and rows_dev.dtype == torch.bfloat16:
            q_dev = q_dev.to(torch.bfloat16)  # pearson scores in the plane's dtype

        # exact document-level results through refills: candidates arrive in
        # exact global row-score order, so the host dedup is exact once
        # enough rows were fetched; k_fetch == n_pad is exact by construction
        while True:
            if use_int8:
                vals, idx = sharded_rank_top_k_int8(
                    self.mesh, q_dev, self.rowsn_q if prenorm else self.rows_q,
                    self.rown_scales if prenorm else self.row_scales,
                    row_mask, k=k_fetch, recency=recency_rows, axis=self.axis,
                )
            else:
                vals, idx = sharded_rank_top_k(
                    self.mesh, q_dev, rows_dev, row_mask, k=k_fetch,
                    metric=dev_metric, recency=recency_rows, axis=self.axis,
                )
            vals, idx = fetch(vals, idx)
            if arrays and not chunked:
                # one row per document: no dedup and no refill, and the live
                # candidates are a prefix of each row (masked rows score
                # -inf): the document rows' arrays, without the rows
                vals, idx = vals[:b_real], idx[:b_real]
                k = min(top_k, int(np.isfinite(vals).sum(axis=1).min(initial=top_k)))
                return self.row_docs[idx[:, :k]], np.ascontiguousarray(vals[:, :k], dtype=np.float32)
            results, need_refill = dedup_doc_candidates(
                vals, idx, self.row_docs, db.documents, top_k, k_fetch,
                self.n, self.n_pad, return_similarities,
            )
            if not need_refill:
                return finish(results[:b_real])
            k_fetch = refill_depth(k_fetch, top_k, db.split_info, self.n_pad)

    def _query_override(self, q, doc_mask, override, top_k, metric, return_similarities,
                        recency_bias, timestamp_key, spec=None):
        """Key-filter scoring on the mesh: the per-document override block
        replaces the corpus vectors, so it is scored as its OWN row-sharded
        matrix (one row per document, no dedup or refill), with the
        single-device engine's masks, metric and document-level recency.
        The sharded (rows, mask) blocks are cached per (filter spec, corpus
        version): repeated key-filter serving uploads one block."""
        db = self.db
        if not doc_mask.any():
            return [[] for _ in range(q.shape[0])]
        num_docs = len(db.documents)
        n_shards = self.mesh.shape[self.axis]
        n_pad = pad_rows_per_shard(num_docs, n_shards) * n_shards

        ck = None if spec is None else (spec, self._built_state, n_pad)
        cached = None if ck is None else self._override_cache.get(ck)
        if cached is not None:
            rows_dev, mask_dev = cached
        else:
            host = np.zeros((n_pad, override.shape[1]), dtype=np.float32)
            host[:num_docs] = np.asarray(override, dtype=np.float32)
            valid = np.zeros(n_pad, dtype=bool)
            valid[:num_docs] = doc_mask
            rows_dev = shard_rows(self.mesh, host, self.axis)
            mask_dev = shard_rows(self.mesh, valid, self.axis)
            if ck is not None:
                if len(self._override_cache) >= 4:
                    # bound device memory: drop the oldest spec's blocks
                    self._override_cache.pop(next(iter(self._override_cache)))
                self._override_cache[ck] = (rows_dev, mask_dev)

        recency_rows = None
        if recency_bias != 0:
            dense = _engine.handle_timestamps(
                db, recency_bias, timestamp_key, np.flatnonzero(doc_mask)
            )
            recency_rows = np.zeros(n_pad, dtype=np.float32)
            recency_rows[:num_docs] = dense

        k = min(top_k, int(doc_mask.sum()))
        vals, idx = sharded_rank_top_k(
            self.mesh, q, rows_dev, mask_dev, k=min(k, n_pad), metric=metric,
            recency=recency_rows, axis=self.axis,
        )
        vals, idx = fetch(vals, idx)
        return override_rows(vals, idx, num_docs, db.documents, top_k, return_similarities)


def override_rows(vals, idx, num_docs, documents, top_k, return_similarities):
    """Result rows of an override scan (identity row -> document map)."""
    results = []
    for b in range(idx.shape[0]):
        row = []
        for doc_id, score in zip(idx[b], vals[b]):
            if doc_id >= num_docs or not np.isfinite(score):
                continue
            if len(row) >= top_k:
                break
            document = documents[int(doc_id)]
            row.append((document, float(score), int(doc_id)) if return_similarities else document)
        results.append(row)
    return results
