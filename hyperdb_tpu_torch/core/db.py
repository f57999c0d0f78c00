"""HyperDB — the public DB facade of the PyTorch/CUDA port.

Counterpart of ``hyperdb_tpu/core/db.py`` for the precomputed-vectors
surface: the constructor, ``add(documents, vectors=...)`` (one document
may bring several rows: a chunked corpus), ``remove_document``, ``query``,
``query_batch``, ``query_batch_arrays``, ``size``, ``dict`` and ``stats``.
The host keeps the documents and bookkeeping; scoring runs on ``device``
(``"cuda"`` unless the caller asks for ``"cpu"``). Text embedding (and the
text chunker with it), persistence, IVF and projscan raise
``NotImplementedError`` until their slices (ROADMAP.md queue 1).
``device_precision`` selects the device planes: ``"auto"``, ``"int8"``
(int8 scan, exact rescore against the float plane) or ``"int8-pure"``
(int8 planes only; dot and cosine).
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable

import numpy as np
import torch

from hyperdb_tpu_torch.config import CONFIG
from hyperdb_tpu_torch.core import nested as _nested
from hyperdb_tpu_torch.core.store import VectorStore
from hyperdb_tpu_torch.index.flat import FlatIndex
from hyperdb_tpu_torch.query import engine as _engine
from hyperdb_tpu_torch.query import filters as _filters
from hyperdb_tpu_torch.utils.lru import LRUCache
from hyperdb_tpu_torch.utils.sizeof import deep_sizeof
from hyperdb_tpu_torch.utils.trace import Stats

_ACCEPTED_ANN_METRICS = ("angular", "euclidean", "manhattan", "hamming", "dot", "cosine")
_FP_PRECISIONS = ("float16", "float32", "float64")

# The JAX package's IVF opt-in (HYPERDB_IVF_THRESHOLD, disabled by default).
IVF_THRESHOLD = int(os.environ.get("HYPERDB_IVF_THRESHOLD", 1 << 62))


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without CUDA that raises: the port never
    carries on quietly on the CPU unless the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hyperdb_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain (non-kernel) versions"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not available")
    return device


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md queue 1, {item}")


class HyperDB:
    """Document store and exact similarity search engine on PyTorch.

    Args mirror ``hyperdb_tpu.HyperDB``: documents, vectors, select_keys,
    embedding_function, fp_precision, add_timestamp, metadata_keys,
    ann_metric, n_trees, cache_size, device_precision (``"auto"``: bf16
    planes for float16 masters, f32 otherwise; ``"int8"``; ``"int8-pure"``;
    default from ``HYPERDB_DEVICE_PRECISION``); plus ``device``.
    """

    def __init__(
        self,
        documents=None,
        vectors=None,
        select_keys=None,
        embedding_function=None,
        fp_precision: str = "float32",
        add_timestamp: bool = False,
        metadata_keys=None,
        ann_metric: str = "cosine",
        n_trees: int = 10,
        cache_size: int = 256,
        device_precision: str | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        if device_precision is None:
            device_precision = os.environ.get("HYPERDB_DEVICE_PRECISION", "auto")
        if device_precision not in ("auto", "int8", "int8-pure"):
            raise ValueError("device_precision must be auto, int8 or int8-pure.")
        self.lru_cache = LRUCache(maxsize=cache_size)
        self.cache_hits = 0
        self.cache_misses = 0

        if fp_precision not in _FP_PRECISIONS:
            raise ValueError("Unsupported floating-point precision.")
        if ann_metric not in _ACCEPTED_ANN_METRICS:
            raise ValueError(
                "Unsupported ANN metric. Accepted values are: "
                + ", ".join(_ACCEPTED_ANN_METRICS)
            )

        self.source_indices: list[int] = []
        self.split_info: dict[int, int] = {}
        self.documents: list = []
        self.select_keys = select_keys
        self.add_timestamp = add_timestamp
        self.fp_precision = getattr(np, fp_precision)
        self._store = VectorStore(
            self.fp_precision, precision=device_precision, device=self.device
        )
        self.embedding_function = embedding_function or self.get_embedding
        self.n_trees = n_trees
        if isinstance(self.select_keys, str):
            self.select_keys = [self.select_keys]
        self.vectors_normalized = False

        self.pending_vectors: list[np.ndarray] = []
        self.pending_documents: list = []
        self.pending_source_indices: list[int] = []

        self._metadata_index: dict[int, dict] = {}
        self.metadata_keys = metadata_keys or []
        if isinstance(metadata_keys, str):
            self.metadata_keys = [metadata_keys]
        self.document_keys: list[str] = []
        if self.add_timestamp and "timestamp" not in self.metadata_keys:
            self.metadata_keys.append("timestamp")
            self.document_keys.append("timestamp")

        self.stats = Stats()
        self._metadata_codes = _filters.MetadataCodes()
        self._key_embed_cache: dict = {}
        self._sentence_mask_cache: dict = {}

        if documents:
            documents = self.validate_and_convert_documents(documents)
        if documents and isinstance(documents[0], dict):
            self.document_keys = _nested.collect_document_keys(documents)
            if self.metadata_keys:
                if self.select_keys:
                    _nested.validate_keys(
                        self.metadata_keys, self.select_keys,
                        "metadata_keys", "select_keys",
                    )
                _nested.validate_keys(
                    self.metadata_keys, self.document_keys,
                    "metadata_keys", "document_keys",
                )

        self.ann_metric = ann_metric
        self.ann_index = None
        self.ann_dim: int | None = None

        if vectors is not None:
            self.validate_vector_uniformity(vectors)
            self.ann_dim = len(vectors[0])
            self._store.set(np.asarray(vectors, dtype=self.fp_precision))
            self.documents = list(documents) if documents else []
            if self.select_keys:
                self.documents = [self.filter_document(d) for d in self.documents]
            self.source_indices = list(range(len(self.documents)))
            # the precomputed-vectors branch indexes metadata too (the JAX
            # package's fix over the reference)
            for i, doc in enumerate(self.documents):
                self._store_metadata(doc, i)
            self._build_ann_index()
        elif documents:
            _not_ported("text embedding of documents", "item 4")

    @classmethod
    def from_state(cls, state: dict, device=None) -> "HyperDB":
        """A port DB computing the same thing as a JAX ``HyperDB`` whose plain
        state is ``state``: ``vectors`` (the f16/f32 host master),
        ``documents``, ``source_indices``, ``metadata_keys``,
        ``fp_precision``, ``ann_metric`` and ``device_precision`` (the JAX
        store's ``precision``; "auto" when absent), all NumPy/Python values
        read off the JAX DB by the caller. The device planes are computed on
        the host as the JAX store computes them, so they come out bit-equal."""
        db = cls(
            documents=list(state["documents"]),
            vectors=np.asarray(state["vectors"]),
            fp_precision=np.dtype(state["fp_precision"]).name,
            metadata_keys=list(state.get("metadata_keys") or []),
            ann_metric=state.get("ann_metric", "cosine"),
            device_precision=state.get("device_precision", "auto"),
            device=device,
        )
        src = state.get("source_indices")
        if src is not None:
            db.source_indices = [int(i) for i in src]
            db._on_mutation()
        return db

    # ------------------------------------------------------------------
    # properties / small helpers
    # ------------------------------------------------------------------

    @property
    def vectors(self):
        return self._store.vectors

    @property
    def dim(self) -> int | None:
        d = self._store.dim
        if d is not None:
            return d
        return None if self.ann_dim is None else int(self.ann_dim)

    def _on_mutation(self) -> None:
        """Invalidate every derived/cached structure after a mutation."""
        self._metadata_codes.invalidate()
        self._key_embed_cache.clear()
        self._sentence_mask_cache.clear()
        self._store.invalidate()

    def get_embedding(self, documents):
        _not_ported("text embedding", "item 4")

    def save(self, *args, **kwargs):
        _not_ported("persistence", "item 9")

    def load(self, *args, **kwargs):
        _not_ported("persistence", "item 9")

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------

    def validate_vector_uniformity(self, vectors) -> None:
        """All vectors must share one dimension and form a 2-D matrix
        (reference hyperdb.py:139-164)."""
        if vectors is None or len(vectors) == 0:
            raise ValueError("Input is None or the list of vectors is empty.")
        first_len = len(vectors[0])
        if not all(len(vec) == first_len for vec in vectors):
            raise ValueError("All vectors must have the same dimension.")
        arr = np.asarray(vectors, dtype=self.fp_precision)
        if arr.ndim == 1:
            arr = arr[None, :]
        elif arr.ndim != 2:
            raise ValueError("Vectors do not have the expected structure.")
        if self.ann_dim is None:
            self.ann_dim = arr.shape[1]

    def validate_and_convert_documents(self, documents):
        """Wrap non-dict documents as {'document': doc}
        (reference hyperdb.py:166-196)."""
        if isinstance(documents, (list, tuple)):
            return [{"document": d} if not isinstance(d, dict) else d for d in documents]
        if isinstance(documents, (str, dict)):
            return [documents] if isinstance(documents, dict) else [{"document": documents}]
        if isinstance(documents, Iterable) and not isinstance(documents, (str, bytes)):
            return [{"document": d} if not isinstance(d, dict) else d for d in documents]
        raise ValueError(
            f"Unsupported document type: {type(documents)}. "
            "Expected list, tuple, or dict."
        )

    def filter_document(self, document):
        return _nested.filter_document(document, self.select_keys)

    def _store_metadata(self, document, unique_index: int) -> None:
        metadata = self._compute_metadata(document, unique_index)
        if metadata:
            self._metadata_index[unique_index] = metadata

    def _compute_metadata(self, document, unique_index: int) -> dict:
        """The metadata entry for ``document`` (reference hyperdb.py:373-392)."""
        if not isinstance(document, dict):
            return {}
        filtered = self.filter_document(document)
        metadata = {}
        for key in self.metadata_keys:
            if key == "timestamp":
                existing = self._metadata_index.get(unique_index, {}).get("timestamp")
                if existing is None and isinstance(document.get("metadata"), dict):
                    existing = document["metadata"].get("timestamp")
                if existing is None and self.add_timestamp is True:
                    metadata[key] = float(datetime.datetime.now().timestamp())
                elif existing is not None:
                    metadata[key] = existing
            else:
                if isinstance(filtered, dict) and key in filtered:
                    value = filtered[key]
                else:
                    value = _nested.get_nested_value(filtered, [key])
                if value is not None:
                    metadata[key] = value
        return metadata

    def _build_ann_index(self) -> None:
        if self.vectors is None or self.vectors.shape[0] == 0:
            self.ann_index = None
            return
        self.vectors_normalized = self.ann_metric == "cosine"
        if (
            self._store.precision == "int8-pure"
            and self.vectors.shape[0] >= CONFIG.projscan_threshold
            and self.ann_metric in ("cosine", "angular", "dot")
        ):
            _not_ported("the projscan two-stage index", "item 10")
        if self.vectors.shape[0] >= IVF_THRESHOLD:
            _not_ported("the IVF index", "item 10")
        self.ann_index = FlatIndex(self.ann_metric, int(self.vectors.shape[1]))

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------

    def add(self, documents, vectors=None, add_timestamp: bool = False) -> None:
        """Add one document or a list with their precomputed vectors
        (reference hyperdb.py:548-566)."""
        if documents is None or (
            isinstance(documents, (list, tuple, str, dict)) and not documents
        ):
            return
        if vectors is None:
            _not_ported("text embedding of documents", "item 4")
        if isinstance(documents, list):
            self.add_documents(
                [self.filter_document(d) for d in documents], vectors, add_timestamp
            )
        else:
            self.add_document(
                self.filter_document(documents), vectors, add_timestamp=add_timestamp
            )
            self.commit_pending()
            self._build_ann_index()
        self.lru_cache.clear()

    def add_document(
        self, document, vectors, count: int = 1, add_timestamp: bool = False
    ) -> None:
        """Stage a single document with its (c, d) block of rows, one row
        per chunk (reference hyperdb.py:568-626). :meth:`commit_pending`
        applies the staged state."""
        if not document:
            return
        if isinstance(document, dict) and add_timestamp:
            document.setdefault("metadata", {})["timestamp"] = float(
                datetime.datetime.now().timestamp()
            )
        rows = np.asarray(vectors, dtype=self.fp_precision)
        if rows.ndim == 1:
            rows = rows[None, :]
        self.validate_vector_uniformity(rows)
        for _ in range(count):
            doc_index = len(self.documents) + len(self.pending_documents)
            self.pending_documents.append(document)
            self.pending_vectors.append(rows)
            self.pending_source_indices.extend([doc_index] * int(rows.shape[0]))

    def add_documents(self, documents, vectors, add_timestamp: bool = False) -> None:
        """Transactional batch add (reference hyperdb.py:628-689): stage one
        row per document, consistency-check, commit or roll back."""
        if not documents:
            return
        if len(documents) != len(vectors):
            print("Error: The number of documents must match the number of vectors.")
            return
        saved = (list(self.pending_vectors), list(self.pending_documents),
                 list(self.pending_source_indices), dict(self._metadata_index))
        try:
            if add_timestamp:
                now = float(datetime.datetime.now().timestamp())
                for doc in documents:
                    if isinstance(doc, dict):
                        doc.setdefault("metadata", {})["timestamp"] = now
            rows_all = np.asarray(vectors, dtype=self.fp_precision)
            if rows_all.ndim == 1:
                rows_all = rows_all[None, :]
            self.validate_vector_uniformity(rows_all)
            for i, document in enumerate(documents):
                self.pending_source_indices.append(
                    len(self.documents) + len(self.pending_documents)
                )
                self.pending_documents.append(document)
                self.pending_vectors.append(rows_all[i : i + 1])
            self.commit_pending()
            self._build_ann_index()
        except (ValueError, TypeError) as e:
            print(f"An exception occurred: {e}")
            (self.pending_vectors, self.pending_documents,
             self.pending_source_indices, self._metadata_index) = saved

    def commit_pending(self) -> None:
        """Apply staged documents/vectors (reference hyperdb.py:496-545)."""
        if not self.pending_vectors:
            return
        rows = np.concatenate(self.pending_vectors, axis=0)
        if rows.shape[0] != len(self.pending_source_indices):
            raise ValueError("Inconsistency detected in new source indices.")
        start = len(self.documents)
        staged_metadata = [
            (start + offset, self._compute_metadata(document, start + offset))
            for offset, document in enumerate(self.pending_documents)
        ]
        self._store.append(rows)
        self.source_indices.extend(self.pending_source_indices)
        self.documents.extend(self.pending_documents)
        for unique_index, metadata in staged_metadata:
            if metadata:
                self._metadata_index[unique_index] = metadata
        self.pending_vectors.clear()
        self.pending_documents.clear()
        self.pending_source_indices.clear()
        self._on_mutation()

    # ------------------------------------------------------------------
    # delete
    # ------------------------------------------------------------------

    def remove_document(self, indices) -> None:
        """Remove documents by index (reference hyperdb.py:692-766), with
        every row of theirs (derived from ``source_indices``); the documents
        that remain are renumbered in ``source_indices``, ``split_info`` and
        the metadata index."""
        if isinstance(indices, int):
            indices = [indices]
        num_docs = len(self.documents)
        normalized = []
        for i in indices:
            i = int(i)
            if i < 0:  # python-list semantics: -1 is the last document
                i += num_docs
            if not 0 <= i < num_docs:
                raise IndexError(f"document index {i} out of range (0..{num_docs - 1})")
            normalized.append(i)
        removed = sorted(set(normalized))
        removed_set = set(removed)

        rows_to_remove = [
            r for r, src in enumerate(self.source_indices) if src in removed_set
        ]
        for idx in reversed(removed):
            self.documents.pop(idx)
        if self.vectors is not None and rows_to_remove:
            self._store.delete_rows(rows_to_remove)

        removed_arr = np.asarray(removed, dtype=np.int64)

        def shift(i: int) -> int:
            return int(np.searchsorted(removed_arr, i, side="left"))

        self.source_indices = [
            src - shift(src) for src in self.source_indices if src not in removed_set
        ]
        self.split_info = {
            idx - shift(idx): count
            for idx, count in self.split_info.items()
            if idx not in removed_set
        }
        self._metadata_index = {
            idx - shift(idx): meta
            for idx, meta in self._metadata_index.items()
            if idx not in removed_set
        }
        # removals renumber row ids: rebuild the index, do not patch it
        self._on_mutation()
        self._build_ann_index()
        self.clear_cache()

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def size(self, with_chunks: bool = False, metadata: dict | None = None) -> int:
        """Document count (reference hyperdb.py:410-442)."""
        if metadata:
            if not isinstance(metadata, dict):
                raise ValueError("metadata must be a dictionary of {key: value} pairs.")
            _nested.validate_keys(
                metadata.keys(), self.metadata_keys, "metadata", "metadata_keys"
            )
            mask = _filters.metadata_doc_mask(self, metadata)
            if with_chunks:
                return int(sum(self.split_info.get(int(i), 1) for i in np.flatnonzero(mask)))
            return int(mask.sum())
        if with_chunks:
            return len(self.source_indices)
        return len(set(self.source_indices))

    def dict(self, vectors: bool = False, metadata=None):
        """Database export (reference hyperdb.py:444-494): each document,
        optionally with its first row's vector."""
        if not self.source_indices:
            print("Debug: source_indices is empty.")
            return []
        if not self.documents:
            print("Debug: documents is empty.")
            return []
        if metadata:
            if isinstance(metadata, tuple) and len(metadata) == 2:
                metadata = {metadata[0]: metadata[1]}
            if not isinstance(metadata, dict):
                raise ValueError(
                    "metadata must be a dictionary of {key: value} pairs "
                    "or a tuple of (key, value)."
                )
            _nested.validate_keys(
                metadata.keys(), self.metadata_keys, "metadata", "metadata_keys"
            )
            doc_ids = np.flatnonzero(_filters.metadata_doc_mask(self, metadata))
        else:
            doc_ids = np.arange(len(self.documents))
        first_row = {}
        for row, src in enumerate(self.source_indices):
            first_row.setdefault(int(src), row)
        output = []
        for i in doc_ids:
            doc = self.documents[int(i)]
            if vectors and self.vectors is not None:
                entry = dict(doc) if isinstance(doc, dict) else {"document": doc}
                row = first_row.get(int(i))
                if row is not None:
                    entry["vector"] = self.vectors[row].tolist()
                output.append(entry)
            else:
                output.append(doc)
        return output

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------

    def _hashable_key(self, query_input, *rest):
        if isinstance(query_input, np.ndarray):
            query_input = ("ndarray", query_input.shape, query_input.dtype.str,
                           query_input.tobytes())
        elif isinstance(query_input, (list, tuple)):
            query_input = tuple(
                tuple(x) if isinstance(x, (list, tuple)) else x for x in query_input
            )
        top_k, return_similarities, filters, *tail = rest
        return (query_input, top_k, return_similarities,
                _filters.hashable_filters(filters), *tail)

    def query(
        self,
        query_input,
        top_k: int = 5,
        return_similarities: bool = True,
        filters=None,
        recency_bias: float = 0,
        timestamp_key=None,
        metric: str = "cosine_similarity",
        ann_percent: int = 5,
    ):
        """Top-k documents for one query (reference hyperdb.py:1584-1586),
        cached in the LRU."""
        args = (query_input, top_k, return_similarities, filters,
                recency_bias, timestamp_key, metric, ann_percent)
        key = self._hashable_key(*args)
        if key in self.lru_cache:
            self.cache_hits += 1
            return self.lru_cache[key]
        self.cache_misses += 1
        result = _engine.execute_query(self, *args)
        self.lru_cache[key] = result
        return result

    def query_batch(
        self,
        query_inputs,
        top_k: int = 5,
        return_similarities: bool = True,
        filters=None,
        recency_bias: float = 0,
        timestamp_key=None,
        metric: str = "cosine_similarity",
        ann_percent: int = 5,
        n_valid: int | None = None,
    ):
        """Batched search: one (B, d) x (d, N) scan for the whole batch.
        Returns a list of per-query result lists."""
        return _engine.execute_query_batch(
            self, query_inputs, top_k=top_k,
            return_similarities=return_similarities, filters=filters,
            recency_bias=recency_bias, timestamp_key=timestamp_key,
            metric=metric, ann_percent=ann_percent, n_valid=n_valid,
        )

    def query_batch_arrays(
        self,
        query_vectors,
        top_k: int = 5,
        filters=None,
        recency_bias: float = 0,
        timestamp_key=None,
        metric: str = "cosine_similarity",
        ann_percent: int = 5,
        n_valid: int | None = None,
    ):
        """Array-level batched search: ``(B, d) -> ((B, k) int64 doc ids,
        (B, k) float32 scores)`` with ``k = min(top_k, surviving docs)``."""
        return _engine.execute_query_batch_arrays(
            self, query_vectors, top_k=top_k, filters=filters,
            recency_bias=recency_bias, timestamp_key=timestamp_key,
            metric=metric, ann_percent=ann_percent, n_valid=n_valid,
        )

    def clear_cache(self) -> None:
        self.lru_cache.clear()
        self.cache_hits = 0
        self.cache_misses = 0

    def get_cache_size_and_info(self):
        """(reference hyperdb.py:1398-1427)"""
        cache_info = {
            "hits": self.cache_hits,
            "misses": self.cache_misses,
            "maxsize": self.lru_cache.maxsize,
            "currsize": len(self.lru_cache),
        }
        size_bytes = deep_sizeof(self.lru_cache)
        if size_bytes >= 1024 * 1024:
            cache_size_str = f"{size_bytes / (1024 * 1024):.2f} MB"
        elif size_bytes >= 1024:
            cache_size_str = f"{size_bytes / 1024:.2f} KB"
        else:
            cache_size_str = f"{int(size_bytes)} bytes"
        return {"cache_info": cache_info, "cache_memory_size": cache_size_str}
