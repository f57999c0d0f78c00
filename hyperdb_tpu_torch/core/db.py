"""HyperDB — the public DB facade of the PyTorch/CUDA port.

Counterpart of ``hyperdb_tpu/core/db.py``: the constructor over text
documents (chunked and embedded) or precomputed vectors, ``add`` /
``add_document`` / ``add_documents`` / ``add_stream`` / ``commit_pending``,
``remove_document``, ``query``, ``query_batch``, ``query_batch_arrays``,
``set_ann_metric``, ``save`` / ``load`` (pickle[.gz], json, sqlite and the
binary checkpoint, file-compatible with the JAX package), ``warmup``,
``size``, ``dict``, ``stats`` and the reference's helper methods. The host
keeps the documents and bookkeeping; the encoder and the scans run on
``device`` (``"cuda"`` unless the caller asks for ``"cpu"``). The opt-in
indexes of the JAX package build here under the same knobs: IVF from
``IVF_THRESHOLD`` rows (``HYPERDB_IVF_THRESHOLD``), projscan for int8-pure
corpora from ``CONFIG.projscan_threshold`` rows.

``device_precision`` selects the device planes: ``"auto"``, ``"int8"``
(int8 scan, exact rescore against the float plane) or ``"int8-pure"``
(int8 planes only; dot and cosine).
"""

from __future__ import annotations

import collections
import datetime
import os
import string
import zipfile
from typing import Iterable

import numpy as np
import torch

from hyperdb_tpu_torch.config import CONFIG
from hyperdb_tpu_torch.core import chunker as _chunker
from hyperdb_tpu_torch.core import nested as _nested
from hyperdb_tpu_torch.core.store import VectorStore
from hyperdb_tpu_torch.index.flat import FlatIndex
from hyperdb_tpu_torch.persist import io as _persist
from hyperdb_tpu_torch.query import engine as _engine
from hyperdb_tpu_torch.query import filters as _filters
from hyperdb_tpu_torch.utils.lru import LRUCache
from hyperdb_tpu_torch.utils.sizeof import deep_sizeof
from hyperdb_tpu_torch.utils.trace import Stats

_ACCEPTED_ANN_METRICS = ("angular", "euclidean", "manhattan", "hamming", "dot", "cosine")
_FP_PRECISIONS = ("float16", "float32", "float64")

# Corpora with at least this many rows build an IVF index (opt-in, disabled
# by default): HYPERDB_IVF_THRESHOLD, or rebind this name, as in the JAX
# package.
IVF_THRESHOLD = CONFIG.ivf_threshold


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
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but CUDA is not available")
        if device.index is None:  # "cuda" names the current card: make it explicit
            device = torch.device("cuda", torch.cuda.current_device())
    return device


class HyperDB:
    """Document store and exact similarity search engine on PyTorch.

    Args mirror ``hyperdb_tpu.HyperDB``: documents, vectors, select_keys,
    embedding_function, fp_precision, add_timestamp, metadata_keys,
    ann_metric, n_trees, cache_size, device_precision (``"auto"``: bf16
    planes for float16 masters, f32 otherwise; ``"int8"``; ``"int8-pure"``;
    default from ``HYPERDB_DEVICE_PRECISION``); plus ``device``. Documents
    without vectors are chunked and embedded by ``embedding_function``
    (default: :meth:`get_embedding`, the default encoder on ``device``).
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

        # Staged ingest: per staged document its rows, and (chunk count,
        # record in split_info?) — split_info is recorded for embedded
        # documents only, never for precomputed vectors (the reference's rule)
        self.pending_vectors: list[np.ndarray] = []
        self.pending_documents: list = []
        self.pending_source_indices: list[int] = []
        self._pending_splits: list[tuple[int, bool]] = []

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
        self._tokenizer_obj = None
        self._embedder_obj = None

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
        # rows at the last IVF/projscan build (the 1.5x rebuild rule) and at
        # the last projscan decline (no new attempt before 1.5x growth)
        self._ivf_built_rows = 0
        self._projscan_declined_rows = 0

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
            self.add(documents, vectors=None, add_timestamp=self.add_timestamp)

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
        if self.ann_dim is not None:
            return int(self.ann_dim)
        return getattr(self._embedder(), "dim", None)

    def _tokenizer(self):
        if self._tokenizer_obj is None:
            # an encoder with its own WordPiece vocab chunks with it (the
            # reference pairs its tokenizer with MiniLM the same way)
            chunk_tok = getattr(self._embedder(), "chunk_tokenizer", None)
            self._tokenizer_obj = chunk_tok or _chunker.default_tokenizer()
        return self._tokenizer_obj

    def _embedder(self):
        if self._embedder_obj is None:
            from hyperdb_tpu_torch.models.embedder import default_embedder

            # an existing corpus pins the embedder's output dim; a fresh
            # corpus gets the default encoder
            known = self._store.dim
            if known is None and self.ann_dim is not None:
                known = int(self.ann_dim)
            self._embedder_obj = default_embedder(known, device=self.device)
        return self._embedder_obj

    def _on_mutation(self) -> None:
        """Invalidate every derived/cached structure after a mutation."""
        self._metadata_codes.invalidate()
        self._key_embed_cache.clear()
        self._sentence_mask_cache.clear()
        self._store.invalidate()

    # ------------------------------------------------------------------
    # embedding / chunking
    # ------------------------------------------------------------------

    def text_to_chunks(self, text: str, max_length: int = _chunker.MAX_TOKENS):
        return _chunker.text_to_chunks(text, self._tokenizer(), max_length)

    def prepare_texts_and_indices(self, documents):
        return _chunker.prepare_texts_and_indices(documents, self._tokenizer())

    def get_embedding(self, documents):
        """Default embedding function (reference get_embedding,
        hyperdb.py:311-337): chunk then encode; returns
        (embeddings, source_indices, split_info)."""
        if documents is None:
            raise ValueError("Documents cannot be None.")
        try:
            texts, source_indices, split_info = self.prepare_texts_and_indices(documents)
            embeddings = np.asarray(
                self._embedder().encode(texts), dtype=self.fp_precision
            )
        except ValueError:
            raise
        except Exception as e:  # the reference's error contract
            raise RuntimeError(f"An error occurred while generating embeddings: {e}") from e
        return embeddings, source_indices, split_info

    def generate_query_vector(self, query_text: str):
        query_vector = self.embedding_function([query_text])
        if query_vector is None or len(query_vector) == 0:
            raise ValueError("Failed to generate an embedding for the query text.")
        return query_vector[0]

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

    def validate_keys(self, keys_to_validate, keys_validation, name_a, name_b):
        _nested.validate_keys(keys_to_validate, keys_validation, name_a, name_b)

    def collect_document_keys(self, documents):
        return _nested.collect_document_keys(documents)

    def filter_document(self, document):
        return _nested.filter_document(document, self.select_keys)

    def get_nested_value(self, dictionary, keys):
        return _nested.get_nested_value(dictionary, keys)

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
            # a stale index over deleted rows must not survive into a later add
            self.ann_index = None
            self._ivf_built_rows = 0
            return
        if self.ann_dim is None:
            self.ann_dim = int(self.vectors.shape[1])
        self.vectors_normalized = self.ann_metric == "cosine"
        n = int(self.vectors.shape[0])
        if (
            self._store.precision == "int8-pure"
            and n >= CONFIG.projscan_threshold
            and self.ann_metric in ("cosine", "angular", "dot")
        ):
            self._build_projscan(n)
            return
        if n >= IVF_THRESHOLD:
            from hyperdb_tpu_torch.index.ivf import IVFIndex

            # sample and assign on the plane queries use anyway (unit-norm
            # rows for the metrics IVF clusters normalized); int8-pure
            # stores hold no float plane and build from the host master
            device_rows = None
            if self._store.precision != "int8-pure":
                dv = self._store.device_view(self.source_indices)
                device_rows = (
                    dv["rows_norm"] if self.ann_metric in ("cosine", "angular", "dot")
                    else dv["rows"]
                )
            self.ann_index = IVFIndex.build(
                self.vectors, metric=self.ann_metric, nlist=CONFIG.ivf_nlist or None,
                n_trees=self.n_trees, device_rows=device_rows, device=self.device,
            )
            self._ivf_built_rows = n
        else:
            self.ann_index = FlatIndex(self.ann_metric, int(self.vectors.shape[1]))

    def _build_projscan(self, n: int) -> None:
        """The two-stage index over the int8 plane queries score (raw rows
        for dot, unit-norm rows otherwise). A flat-spectrum decline stands
        until the corpus outgrows the declined size by 50 %."""
        from hyperdb_tpu_torch.index.projscan import ProjScanIndex

        declined = self._projscan_declined_rows
        if declined and n <= int(declined * 1.5):
            self.ann_index = None
            self._ivf_built_rows = 0
            return
        dv = self._store.device_view(self.source_indices)
        plane = (
            (dv["rows_q"], dv["row_scales"]) if self.ann_metric == "dot"
            else (dv["rowsn_q"], dv["rown_scales"])
        )
        self.ann_index = ProjScanIndex.build_from_device_rows(
            plane,
            num_rows=int(dv["n_pad"]),
            d_prime=CONFIG.projscan_dprime,
            num_valid=self._store.num_rows,
            min_variance=CONFIG.projscan_min_variance or None,
        )
        self._projscan_declined_rows = n if self.ann_index is None else 0
        self._ivf_built_rows = 0 if self.ann_index is None else n

    def _update_ann_index(self) -> None:
        """Refresh the index after a mutation: appended rows join the
        existing IVF clusters (one assignment matmul) until the corpus
        outgrows the clustering by 50 %; everything else rebuilds (projscan
        has no incremental form)."""
        idx = self.ann_index
        n = self._store.num_rows
        if (
            hasattr(idx, "add_rows")  # IVF; projscan rebuilds
            and n > idx.num_rows
            and n <= int(self._ivf_built_rows * 1.5)
        ):
            idx.add_rows(self.vectors[idx.num_rows :], idx.num_rows)
            return
        self._build_ann_index()

    def set_ann_metric(self, new_metric: str) -> None:
        """Switch the index metric and rebuild (reference hyperdb.py:225-235)."""
        if self.ann_metric != new_metric:
            self.ann_metric = new_metric
            self.vectors_normalized = False
        self._update_ann_index()

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------

    def add(self, documents, vectors=None, add_timestamp: bool = False) -> None:
        """Add one document or a list (reference hyperdb.py:548-566); without
        ``vectors`` they are chunked and embedded."""
        if documents is None or (
            isinstance(documents, (list, tuple, str, dict)) and not documents
        ):
            return
        if isinstance(documents, list):
            self.add_documents(
                [self.filter_document(d) for d in documents], vectors, add_timestamp
            )
        else:
            self.add_document(
                self.filter_document(documents), vectors, add_timestamp=add_timestamp
            )
            self.commit_pending()
            self._update_ann_index()
        self.clear_cache()

    def _stage(self, document, rows: np.ndarray, record_split: bool) -> None:
        """Stage one document with its (c, d) block of rows."""
        chunk_count = int(rows.shape[0])
        doc_index = len(self.documents) + len(self.pending_documents)
        self.pending_documents.append(document)
        self.pending_vectors.append(rows)
        self._pending_splits.append((chunk_count, record_split))
        self.pending_source_indices.extend([doc_index] * chunk_count)

    def add_document(
        self, document, vectors=None, count: int = 1, add_timestamp: bool = False
    ) -> None:
        """Stage a single document (reference hyperdb.py:568-626), embedded
        when ``vectors`` is None (one row per chunk), else with its (c, d)
        block of rows. :meth:`commit_pending` applies the staged state."""
        if not document:
            return
        if isinstance(document, dict) and add_timestamp:
            document.setdefault("metadata", {})["timestamp"] = float(
                datetime.datetime.now().timestamp()
            )
        record_split = vectors is None
        if record_split:
            vectors, _, _ = self.embedding_function([document])
        rows = np.asarray(vectors, dtype=self.fp_precision)
        if rows.ndim == 1:
            rows = rows[None, :]
        self.validate_vector_uniformity(rows)
        for _ in range(count):
            self._stage(document, rows, record_split)

    def add_documents(self, documents, vectors=None, add_timestamp: bool = False) -> None:
        """Transactional batch add (reference hyperdb.py:628-689): embed once
        (when ``vectors`` is None), stage per document, consistency-check,
        commit or roll back. Bad input prints and rolls back; anything else
        rolls back and raises."""
        if not documents:
            return
        if vectors is not None and len(documents) != len(vectors):
            print("Error: The number of documents must match the number of vectors.")
            return
        saved = (list(self.pending_vectors), list(self.pending_documents),
                 list(self.pending_source_indices), list(self._pending_splits),
                 dict(self._metadata_index))

        def roll_back():
            (self.pending_vectors, self.pending_documents, self.pending_source_indices,
             self._pending_splits, self._metadata_index) = saved

        committed = False
        try:
            if isinstance(documents, dict):
                documents = [documents]
            if add_timestamp:
                now = float(datetime.datetime.now().timestamp())
                for doc in documents:
                    if isinstance(doc, dict):
                        doc.setdefault("metadata", {})["timestamp"] = now
            if vectors is None:
                embeddings, _, split_info = self.embedding_function(documents)
                rows_all = np.asarray(embeddings, dtype=self.fp_precision)
            else:
                rows_all = np.asarray(vectors, dtype=self.fp_precision)
                split_info = {i: 1 for i in range(len(documents))}
            if rows_all.ndim == 1:
                rows_all = rows_all[None, :]
            self.validate_vector_uniformity(rows_all)

            cursor = 0
            for i, document in enumerate(documents):
                chunk_count = int(split_info.get(i, 1))
                self._stage(document, rows_all[cursor : cursor + chunk_count], vectors is None)
                cursor += chunk_count
            total_rows = sum(v.shape[0] for v in self.pending_vectors)
            if total_rows != len(self.pending_source_indices) or cursor != rows_all.shape[0]:
                print(
                    "Inconsistency in add_documents detected between the number "
                    f"of pending vectors and documents. Total vectors calculated: "
                    f"{total_rows}, Total pending documents: "
                    f"{len(self.pending_documents)}. Transaction rolled back."
                )
                roll_back()
                return
            self.commit_pending()
            committed = True
            self._update_ann_index()
        except (ValueError, TypeError) as e:
            print(f"An exception occurred: {e}")
            if not committed:
                roll_back()
        except Exception:
            if not committed:
                roll_back()
            raise

    def add_stream(
        self,
        documents,
        batch_size: int = 1024,
        add_timestamp: bool = False,
        prefetch: int = 2,
        defer_index: bool = False,
    ) -> int:
        """Streaming ingest: a producer thread chunks and embeds batch i+1
        while the caller's thread stages, commits and indexes batch i.

        ``documents`` is any iterable; ``prefetch`` bounds the embedded
        batches held in flight. Each batch commits as its own transaction,
        so a failure mid-stream keeps the batches committed before it (the
        exception is re-raised). ``defer_index=True`` builds the index once
        at the end. Returns the number of documents added."""
        import queue as _queue
        import threading

        done = object()
        stop = threading.Event()
        q: _queue.Queue = _queue.Queue(maxsize=max(1, prefetch))

        def put(item) -> bool:
            # give up when the consumer has stopped reading
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def produce():
            try:
                batch: list = []

                def flush() -> bool:
                    if not batch:
                        return True
                    if add_timestamp:
                        now = float(datetime.datetime.now().timestamp())
                        for doc in batch:
                            if isinstance(doc, dict):
                                doc.setdefault("metadata", {})["timestamp"] = now
                    embeddings, _, split_info = self.embedding_function(batch)
                    ok = put((list(batch), np.asarray(embeddings), dict(split_info)))
                    batch.clear()
                    return ok

                for doc in documents:
                    if doc is None or (isinstance(doc, (list, tuple, str, dict)) and not doc):
                        continue
                    batch.append(self.filter_document(doc))
                    if len(batch) >= batch_size and not flush():
                        return
                if flush():
                    put(done)
            except BaseException as e:  # handed to the consumer, which raises it
                put(e)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        added = 0
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                batch_docs, rows_all, split_info = item
                rows_all = rows_all.astype(self.fp_precision, copy=False)
                if rows_all.ndim == 1:
                    rows_all = rows_all[None, :]
                self.validate_vector_uniformity(rows_all)
                cursor = 0
                for i, document in enumerate(batch_docs):
                    chunk_count = int(split_info.get(i, 1))
                    self._stage(document, rows_all[cursor : cursor + chunk_count], True)
                    cursor += chunk_count
                self.commit_pending()
                if not defer_index:
                    self._update_ann_index()
                added += len(batch_docs)
        finally:
            stop.set()
            worker.join(timeout=5.0)
            if added:
                if defer_index:
                    self._update_ann_index()
                self.clear_cache()
        return added

    def commit_pending(self) -> None:
        """Apply staged documents/vectors (reference hyperdb.py:496-545).
        Metadata is computed before any state changes, so a failure leaves
        nothing half-committed: it prints "Error occurred during commit: ...
        Rolling back transaction." and returns with the state unchanged and
        the staged buffers kept (the reference's soft failure)."""
        if not self.pending_vectors:
            return
        try:
            rows = np.concatenate(self.pending_vectors, axis=0)
            if rows.shape[0] != len(self.pending_source_indices):
                raise ValueError("Inconsistency detected in new source indices.")
            start = len(self.documents)
            staged_metadata = [
                (start + offset, self._compute_metadata(document, start + offset))
                for offset, document in enumerate(self.pending_documents)
            ]
            self._store.append(rows)  # raises, changing nothing, on a dimension mismatch
            self.source_indices.extend(self.pending_source_indices)
            for offset, (chunk_count, record_split) in enumerate(self._pending_splits):
                if record_split:
                    self.split_info[start + offset] = chunk_count
            self.documents.extend(self.pending_documents)
            for unique_index, metadata in staged_metadata:
                if metadata:
                    self._metadata_index[unique_index] = metadata
        except Exception as e:  # the reference's soft failure: print, keep the stage
            print(f"Error occurred during commit: {e}. Rolling back transaction.")
            return
        self.pending_vectors.clear()
        self.pending_documents.clear()
        self.pending_source_indices.clear()
        self._pending_splits.clear()
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

    def compute_and_save_word_frequencies(self, output_file_path) -> None:
        """Word histogram over stored documents (reference hyperdb.py:1007-1033)."""
        word_frequencies: dict[str, int] = collections.defaultdict(int)
        table = str.maketrans("", "", string.punctuation)

        def count(text: str) -> None:
            for word in text.translate(table).split():
                word_frequencies[word.lower()] += 1

        for document in self.documents:
            if isinstance(document, dict):
                for value in document.values():
                    count(str(value))
            elif isinstance(document, str):
                count(document)

        ordered = sorted(word_frequencies.items(), key=lambda x: x[1], reverse=True)
        with open(output_file_path, "w") as f:
            for word, freq in ordered:
                f.write(f"{word}: {freq}\n")

    # ------------------------------------------------------------------
    # list-based filter helpers (the reference's public surface; the
    # engine itself uses the mask pipeline of query/filters.py)
    # ------------------------------------------------------------------

    def tokenize(self, text: str):
        return _filters.tokenize(text)

    def recursive_sentence_filter(self, obj, sentence_filter_tokens) -> bool:
        return _filters._recursive_sentence_match(obj, sentence_filter_tokens)

    def apply_skip_doc(self, vectors, documents, skip_doc: int):
        """(reference hyperdb.py:1119-1134)"""
        mask = _filters.skip_doc_mask(len(documents), skip_doc)
        kept = np.flatnonzero(mask)
        vec = np.asarray(vectors)[kept] if vectors is not None else None
        return vec, [documents[i] for i in kept], kept.tolist()

    def filter_by_sentence(self, vectors, documents, sentence_filters):
        """(reference hyperdb.py:1160-1176)"""
        if not isinstance(sentence_filters, (list, tuple)):
            sentence_filters = [sentence_filters]
        tokenized = [_filters.tokenize(s) for s in sentence_filters]
        kept_vecs, kept_docs = [], []
        for vec, doc in zip(vectors, documents):
            if all(_filters._recursive_sentence_match(doc, toks) for toks in tokenized):
                kept_vecs.append(vec)
                kept_docs.append(doc)
        return kept_vecs, kept_docs

    def filter_by_key(self, vectors, documents, keys):
        """(reference hyperdb.py:1061-1110): per document, the mean of its
        keys' embeddings (a missing key counts as a zero vector)."""
        if not isinstance(keys, (list, tuple)):
            keys = [keys]
        _nested.validate_keys(keys, self.document_keys, "query_keys", "document_keys")
        if self.select_keys:
            _nested.validate_keys(keys, self.select_keys, "query_keys", "select_keys")
        dim = self.dim or (np.asarray(vectors).shape[1] if len(vectors) else 0)
        kept_vecs, kept_docs = [], []
        for doc in documents:
            if not isinstance(doc, dict):
                continue
            per_key = []
            for key in keys:
                sub = _nested.get_nested_value(doc, [key])
                if sub is not None:
                    emb = np.asarray(self.embedding_function([str(sub)])[0], dtype=np.float32)
                    vec = emb.mean(axis=0) if emb.ndim == 2 else emb.reshape(-1)
                else:
                    vec = np.zeros(dim, dtype=np.float32)
                per_key.append(vec)
            if not per_key:
                continue
            kept_vecs.append(np.mean(per_key, axis=0))
            kept_docs.append(doc)
        return kept_vecs, kept_docs

    def _filter_by_metadata(
        self, metadata_filter, filtered_vectors, filtered_documents, kept_indices=None
    ):
        """(reference hyperdb.py:1218-1256)"""
        self.validate_keys(
            metadata_filter.keys(), self.metadata_keys, "metadata_filter", "metadata_keys"
        )
        mask = _filters.metadata_doc_mask(self, metadata_filter)
        pos_by_id = {id(doc): i for i, doc in enumerate(self.documents)}
        kept_vecs, kept_docs = [], []
        for vec, doc in zip(filtered_vectors, filtered_documents):
            pos = pos_by_id.get(id(doc))
            if pos is not None and mask[pos]:
                kept_vecs.append(vec)
                kept_docs.append(doc)
        return np.array(kept_vecs, dtype=self.fp_precision), kept_docs

    def _apply_filters(self, filters, kept_indices=None, base_vectors=None, base_documents=None):
        """List-based filter combinator (reference hyperdb.py:1258-1308)."""
        vecs = self.vectors if base_vectors is None else base_vectors
        docs = self.documents if base_documents is None else base_documents
        doc_ids = set(id(d) for d in docs)
        for name, params in filters or []:
            if name not in _filters.FILTER_NAMES:
                raise ValueError(f"Invalid filter name {name}")
            if name == "skip_doc":
                continue
            if name == "key":
                vecs, sel = self.filter_by_key(vecs, docs, params)
            elif name == "metadata":
                if not self.metadata_keys:
                    raise ValueError(
                        "The 'metadata_keys' parameter has not been set in "
                        "HyperDB(). Cannot filter by metadata."
                    )
                _, sel = self._filter_by_metadata(dict(params), vecs, docs)
            elif name == "sentence":
                _, sel = self.filter_by_sentence(vecs, docs, params)
            doc_ids &= set(id(d) for d in sel)
        kept_vecs = [v for v, d in zip(vecs, docs) if id(d) in doc_ids]
        kept_docs = [d for d in docs if id(d) in doc_ids]
        return kept_vecs, kept_docs

    def _generate_and_validate_query_vector(self, query_input):
        return _engine.generate_and_validate_query_vector(self, query_input)

    def _handle_timestamps(self, recency_bias, timestamp_key, filtered_documents):
        """The recency term of ``filtered_documents`` (reference
        hyperdb.py:1310-1346), found by identity, then by equality."""
        pos_by_id = {id(doc): i for i, doc in enumerate(self.documents)}
        doc_indices = [
            pos_by_id[id(d)] if id(d) in pos_by_id else self.documents.index(d)
            for d in filtered_documents
        ]
        dense = _engine.handle_timestamps(self, recency_bias, timestamp_key, doc_indices)
        if dense is None:
            return None
        return dense[np.asarray(doc_indices, dtype=np.int64)]

    def _execute_query(
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
        return _engine.execute_query(
            self, query_input, top_k=top_k, return_similarities=return_similarities,
            filters=filters, recency_bias=recency_bias, timestamp_key=timestamp_key,
            metric=metric, ann_percent=ann_percent,
        )

    def _cached_query(self, hashable_key, args=None):
        """The LRU lookup of :meth:`query`. ``args`` carries the call's
        arguments (an array's key is an opaque bytes token); without it the
        key itself is executed, as in the reference."""
        if hashable_key in self.lru_cache:
            self.cache_hits += 1
            return self.lru_cache[hashable_key]
        self.cache_misses += 1
        result = self._execute_query(*(hashable_key if args is None else args))
        self.lru_cache[hashable_key] = result
        return result

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
        return self._cached_query(self._hashable_key(*args), args)

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

    def warmup(self, top_ks=(5, 10), batch_sizes=(1,),
               metric="cosine_similarity", max_batch=None, dtypes=None,
               text_max_batch=None, text_seq_tokens=(12, 48)):
        """Run each query shape once after load or ingest, so that the
        first user query pays no one-time cost (device planes, lazy
        uploads, kernel builds, the encoder's first forwards).

        ``max_batch`` warms every power-of-two batch up to it, in every wire
        dtype (f16 as well for low-precision corpora) unless ``dtypes`` is
        given. ``metric`` is one name or a tuple. ``text_max_batch`` also
        warms the text path (encoder forward + scan) at the power-of-two
        batches up to it, for texts of ``text_seq_tokens`` words."""
        if self.vectors is None or len(self.vectors) == 0 or not self.documents:
            return
        metrics = (metric,) if isinstance(metric, str) else tuple(metric)
        if max_batch is not None:
            batch_sizes = tuple(1 << i for i in range(int(max_batch).bit_length()))
        if dtypes is None:
            dtypes = ["float32"]
            if self._store.low_precision_device:
                dtypes.append("float16")
        rng = np.random.default_rng(0)
        for b in batch_sizes:
            base = rng.standard_normal((b, self.dim)).astype(np.float32)
            for dt in dtypes:
                queries = base.astype(dt)
                for k in top_ks:
                    for m in metrics:
                        if b == 1:
                            _engine.execute_query(
                                self, np.asarray(queries[0], dtype=np.float32),
                                top_k=k, metric=m,
                            )
                        else:
                            _engine.execute_query_batch(self, queries, top_k=k, metric=m)
        if text_max_batch:
            self._warmup_text(text_max_batch, text_seq_tokens, top_ks, metrics[0])

    def _warmup_text(self, text_max_batch, text_seq_tokens, top_ks, metric):
        """Warm the text path: encoder forwards (the device-resident block
        where the embedder has one, the host path otherwise) and the scan."""
        sizes = tuple(1 << i for i in range(int(text_max_batch).bit_length()))
        k = max(top_ks)
        probe = _engine.generate_query_vectors_batch(self, ["warmup probe"])
        if self.dim is not None and probe.shape[1] != self.dim:
            # text queries can never run against this corpus
            print(
                f"INFO: skipping text warmup — embedder dimension "
                f"{probe.shape[1]} does not match corpus dimension {self.dim}"
            )
            return
        for n_tok in text_seq_tokens:
            words = " ".join(f"w{i}" for i in range(max(1, int(n_tok))))
            for b in sizes:
                texts = [f"warm {i} {words}" for i in range(b)]
                block = _engine.generate_query_vectors_batch_device(self, texts)
                if block is None:
                    block = _engine.generate_query_vectors_batch(self, texts)
                _engine.execute_query_batch_arrays(
                    self, block, top_k=k, metric=metric, n_valid=len(texts)
                )

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def save(
        self,
        storage_file,
        format: str = "pickle",
        save_ann_index: bool = True,
        rows_per_shard: int | None = None,
    ):
        """(reference hyperdb.py:769-794) Formats: pickle[.gz] / json /
        sqlite (reference-compatible) or ``"checkpoint"``, a self-describing
        binary directory (``persist/checkpoint.py``; ``rows_per_shard``
        splits its vectors into shard files). Every file is readable by the
        JAX package, and the reverse."""
        if format == "checkpoint":
            from hyperdb_tpu_torch.persist.checkpoint import save_checkpoint

            save_checkpoint(
                self, str(storage_file), save_ann_index, rows_per_shard=rows_per_shard
            )
            return
        if self.vectors is None or len(self.vectors) == 0 or not self.documents:
            print("Nothing to save. Exit.")
            return
        data = {
            "vectors": [vector.tolist() for vector in self.vectors]
            if format != "pickle"
            else self.vectors,
            "documents": self.documents,
            "source_indices": self.source_indices,
            "split_info": self.split_info,
            "metadata_index": self._metadata_index,
            "vectors_normalized": self.vectors_normalized,
        }
        _persist.save_payload(str(storage_file), data, format=format)
        if save_ann_index and self.ann_index is not None:
            self._save_ann_index(storage_file)

    def _save_ann_index(self, storage_file) -> None:
        """The ``<file>.ann`` sidecar: the index state as an npz under the
        reference's exact sidecar name."""
        ann_index_file = str(storage_file) + ".ann"
        np.savez_compressed(ann_index_file, **_flatten_state(self.ann_index.state()))
        # np.savez appends .npz
        os.replace(ann_index_file + ".npz", ann_index_file)

    def load(
        self,
        storage_file,
        format: str = "pickle",
        load_ann_index: bool = True,
        preload_ann_into_memory: bool = False,
    ):
        """(reference hyperdb.py:901-925) A pickle, json or sqlite file is
        cast to this DB's ``fp_precision``; a checkpoint restores its own."""
        if format == "checkpoint":
            from hyperdb_tpu_torch.persist.checkpoint import load_checkpoint

            load_checkpoint(self, str(storage_file), load_ann_index)
            if preload_ann_into_memory:
                self._preload_into_memory()
            return
        data = _persist.load_payload(str(storage_file), format=format)
        self._store.set(np.array(data["vectors"], dtype=self.fp_precision))
        if self.vectors is not None and len(self.vectors) > 0:
            self.ann_dim = int(self.vectors.shape[1])
        self.documents = data["documents"]
        self.source_indices = list(data.get("source_indices", []))
        self._metadata_index = data.get("metadata_index", {})
        self.split_info = data.get("split_info", {})
        self.vectors_normalized = data.get("vectors_normalized", False)
        self._on_mutation()
        self.clear_cache()
        if load_ann_index and self.ann_dim is not None:
            self._load_ann_index(storage_file, preload_ann_into_memory)
        else:
            # a previous corpus's index must not survive into the new state
            self.ann_index = None
            self._ivf_built_rows = 0

    def _load_ann_index(self, storage_file, preload_ann_into_memory: bool = True):
        """Restore the ``.ann`` sidecar (flat, IVF or projscan, in the JAX
        package's layout), or rebuild the index when there is none. A
        sidecar that is not an npz (the reference's Annoy forest) warns and
        rebuilds."""
        ann_index_file = str(storage_file) + ".ann"
        if not os.path.exists(ann_index_file):
            self._build_ann_index()
        else:
            if preload_ann_into_memory:
                size_gb = os.path.getsize(ann_index_file) / (1024**3)
                if size_gb > 2:
                    print(
                        f"Warning: The ANN index file is {size_gb:.2f}GB "
                        "and may consume a lot of memory. Make sure your "
                        "machine has enough available memory or set "
                        "preload_ann_into_memory to False."
                    )
            try:
                with np.load(ann_index_file, allow_pickle=False) as f:
                    state = _unflatten_state(dict(f.items()))
            except (OSError, ValueError, zipfile.BadZipFile) as e:
                print(
                    "Warning: could not parse ANN index sidecar "
                    f"'{ann_index_file}' ({e}); rebuilding the index "
                    "from the loaded vectors instead."
                )
                self._build_ann_index()
            else:
                self._restore_index(state)
        if preload_ann_into_memory:
            self._preload_into_memory()

    def _restore_index(self, state: dict) -> None:
        """Install a persisted index on this DB's device; a restored IVF or
        projscan records its build size, so the next append takes the
        incremental path."""
        from hyperdb_tpu_torch.index import index_from_state

        self.ann_index = index_from_state(state, device=self.device)
        if getattr(self.ann_index, "is_ann", False):
            self._ivf_built_rows = int(self.ann_index.num_rows)

    def _preload_into_memory(self) -> None:
        """Build every device plane serving can touch now (on the card),
        instead of at the first query: the float planes (cosine and raw)
        and, for the int8 representations, the int8 planes."""
        if self._store.num_rows == 0 or not self.source_indices:
            return
        dv = self._store.device_view(self.source_indices)
        if self._store.precision != "int8-pure":
            for key in ("rows_norm", "rows"):
                dv[key]  # the lazy view uploads a plane on first access
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _flatten_state(state: dict) -> dict:
    return {
        key: value if isinstance(value, np.ndarray) else np.asarray(value)
        for key, value in state.items()
    }


def _unflatten_state(arrays: dict) -> dict:
    return {key: value.item() if value.ndim == 0 else value for key, value in arrays.items()}
