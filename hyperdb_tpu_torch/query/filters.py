"""Filter pipeline: every filter compiles to a document-level boolean mask.

The reference filters Python object lists and intersects them by ``id(doc)``
(reference hyperdb.py:1258-1308, SURVEY.md Q21 — O(N²) worst
case). Here each filter produces a ``bool (num_docs,)`` mask; the combinator
is a vectorized AND, and the surviving mask is fused into the ranking
kernels as a score mask — no document objects are touched on the hot path.

Filter parity map:
- ``skip_doc``  (hyperdb.py:1119-1134): positive k drops the first k
  documents, negative the last |k|; |k| >= N raises.
- ``metadata``  (hyperdb.py:1218-1256): exact-equality conjunction over the
  metadata index, vectorized through cached integer code columns.
- ``sentence``  (hyperdb.py:1136-1176): case-insensitive whole-word
  token-subset match, recursive over nested dicts/lists.
- ``key``       (hyperdb.py:1061-1110): re-embeds the sub-text at each
  requested key per *candidate* document at query time (zero vector for
  missing keys, averaged across keys); the per-document averaged embedding
  *replaces* the document's corpus vector for scoring. Embeddings are cached
  per (doc, key) until the next mutation.
"""

from __future__ import annotations

import json
import re
import string
from dataclasses import dataclass, field

import numpy as np

from hyperdb_tpu_torch.core.nested import get_nested_value, validate_keys
from hyperdb_tpu_torch.native.tokenizer import native_filter_tokenize

FILTER_NAMES = ("key", "metadata", "sentence", "skip_doc")

_WORD_RE = re.compile(r"\b\w+\b")
_PUNCT_TABLE = str.maketrans("", "", string.punctuation)
_MISSING = object()


def tokenize(text: str) -> set[str]:
    """Punctuation-stripped lowercase word set (reference hyperdb.py:1136-1141).

    ASCII text goes to the C++ tokenizer (the sentence filter is a host-side
    loop over every document); other text to the Unicode-aware Python one,
    which gives the same set on ASCII.
    """
    out = native_filter_tokenize(text)
    if out is not None:
        return out
    return set(_WORD_RE.findall(text.translate(_PUNCT_TABLE).lower()))


# ---------------------------------------------------------------- skip_doc


def skip_doc_mask(num_docs: int, skip_doc: int) -> np.ndarray:
    if abs(skip_doc) >= num_docs:
        print(
            f"The absolute value of skip_doc ({abs(skip_doc)}) is equal or "
            f"greater than the total number of documents ({num_docs})."
        )
        raise Exception(
            "The absolute value of skip_doc is equal or greater than the "
            "total number of documents"
        )
    mask = np.ones(num_docs, dtype=bool)
    if skip_doc > 0:
        mask[:skip_doc] = False
    elif skip_doc < 0:
        mask[skip_doc:] = False
    return mask


# ---------------------------------------------------------------- metadata


def _canon(value):
    """Canonical hashable form of a metadata value (structural equality for
    unhashables)."""
    try:
        hash(value)
        return value
    except TypeError:
        return "\x00json:" + json.dumps(value, sort_keys=True, default=str)


@dataclass
class _CodeColumn:
    codes: np.ndarray  # int32 (num_docs,)
    value_map: dict = field(default_factory=dict)


class MetadataCodes:
    """Categorical integer encoding of metadata columns.

    Built once per (key, corpus version) from the metadata index; an exact-
    equality filter is then a vectorized integer compare instead of a Python
    loop over documents.
    """

    def __init__(self):
        self._columns: dict[str, _CodeColumn] = {}

    def invalidate(self) -> None:
        self._columns.clear()

    def column(self, key: str, metadata_index: dict, num_docs: int) -> _CodeColumn:
        col = self._columns.get(key)
        if col is not None and col.codes.shape[0] == num_docs:
            return col
        value_map: dict = {}
        codes = np.empty(num_docs, dtype=np.int32)
        missing_code = -1
        for i in range(num_docs):
            value = metadata_index.get(i, {}).get(key, _MISSING)
            if value is _MISSING:
                codes[i] = missing_code
                continue
            ckey = _canon(value)
            code = value_map.get(ckey)
            if code is None:
                code = len(value_map)
                value_map[ckey] = code
            codes[i] = code
        col = _CodeColumn(codes=codes, value_map=value_map)
        self._columns[key] = col
        return col


def metadata_doc_mask(db, filter_params) -> np.ndarray:
    """Exact-equality conjunction over declared metadata keys."""
    if not db.metadata_keys:
        raise ValueError(
            "The 'metadata_keys' parameter has not been set in HyperDB(). "
            "Cannot filter by metadata."
        )
    params = dict(filter_params)
    validate_keys(params.keys(), db.metadata_keys, "metadata_filter", "metadata_keys")
    num_docs = len(db.documents)
    mask = np.ones(num_docs, dtype=bool)
    for key, value in params.items():
        col = db._metadata_codes.column(key, db._metadata_index, num_docs)
        if value is None:
            # reference parity: metadata.get(key) == None matches every
            # document MISSING the key (hyperdb.py:1246) — the index never
            # stores None values, so missing-code rows are exactly that set
            mask &= col.codes == -1
            continue
        code = col.value_map.get(_canon(value))
        if code is None:
            mask[:] = False
            break
        mask &= col.codes == code
    return mask


# ---------------------------------------------------------------- sentence


def _recursive_sentence_match(obj, filter_tokens: set[str]) -> bool:
    if isinstance(obj, dict):
        return any(_recursive_sentence_match(v, filter_tokens) for v in obj.values())
    if isinstance(obj, list):
        return any(_recursive_sentence_match(v, filter_tokens) for v in obj)
    if isinstance(obj, str):
        return filter_tokens.issubset(tokenize(obj))
    return False


def sentence_doc_mask(db, sentence_filters) -> np.ndarray:
    if not isinstance(sentence_filters, (list, tuple)):
        sentence_filters = [sentence_filters]
    # The recursive text walk over every document is the host-side hot loop;
    # masks are cached per filter spec until the next mutation (the query
    # LRU caches whole results, but different query texts with the same
    # sentence filter share this mask).
    cache_key = tuple(sentence_filters)
    cached = db._sentence_mask_cache.get(cache_key)
    if cached is not None and cached.shape[0] == len(db.documents):
        return cached.copy()
    tokenized = [tokenize(s) for s in sentence_filters]
    num_docs = len(db.documents)
    mask = np.zeros(num_docs, dtype=bool)
    for i, doc in enumerate(db.documents):
        mask[i] = all(_recursive_sentence_match(doc, toks) for toks in tokenized)
    db._sentence_mask_cache[cache_key] = mask.copy()
    return mask


# ---------------------------------------------------------------- key


def key_filter(db, keys, base_mask: np.ndarray):
    """Per-document averaged key embeddings over candidate documents.

    Returns (mask, override_vectors): mask marks dict documents in
    ``base_mask`` (non-dicts are dropped, reference hyperdb.py:1078); the
    override matrix replaces corpus vectors for scoring.
    """
    if not isinstance(keys, (list, tuple)):
        keys = [keys]
    keys = list(keys)
    validate_keys(keys, db.document_keys, "query_keys", "document_keys")
    if db.select_keys:
        validate_keys(keys, db.select_keys, "query_keys", "select_keys")

    num_docs = len(db.documents)
    dim = db.dim
    mask = np.zeros(num_docs, dtype=bool)
    vecs = np.zeros((num_docs, dim), dtype=np.float32)
    cache = db._key_embed_cache

    for i in np.flatnonzero(base_mask):
        doc = db.documents[i]
        if not isinstance(doc, dict):
            continue
        per_key = []
        for key in keys:
            sub_text = get_nested_value(doc, [key])
            if sub_text is None:
                per_key.append(np.zeros(dim, dtype=np.float32))
                continue
            cache_key = (int(i), key)
            vec = cache.get(cache_key)
            if vec is None:
                emb = db.embedding_function([str(sub_text)])[0]
                emb = np.asarray(emb, dtype=np.float32)
                if emb.size == 0:
                    # empty sub-text chunks to zero rows; mean(axis=0) over a
                    # (0, d) matrix would poison the cache with NaNs — treat
                    # it like the missing-key case (zero vector)
                    vec = np.zeros(dim, dtype=np.float32)
                elif emb.ndim == 2:
                    # Long sub-texts may chunk into several rows; average
                    # them (the reference's .flatten() on a multi-row result
                    # is a latent bug, hyperdb.py:1087).
                    vec = emb.mean(axis=0)
                else:
                    vec = emb.reshape(-1)
                if vec.shape[0] != dim:
                    raise ValueError(
                        f"Key filter embeddings have dimension {vec.shape[0]} "
                        f"but the corpus has dimension {dim}; provide an "
                        "embedding_function matching the stored vectors."
                    )
                cache[cache_key] = vec
            per_key.append(vec)
        if not per_key:
            continue
        vecs[i] = np.mean(per_key, axis=0)
        mask[i] = True
    return mask, vecs


# ---------------------------------------------------------------- combinator


def hashable_filters(filters):
    """Normalized hashable form of a query filter spec (reference
    hyperdb.py:1368-1379) — shared by the query LRU key and the sharded
    key-filter override device-block cache (the override's CONTENT depends
    on the full spec: earlier filters gate which documents get computed
    rows, so the cache must key on all of it, not just the key filter)."""
    if filters is None:
        return None
    return tuple(
        (
            name,
            tuple(sorted(params.items()))
            if isinstance(params, dict)
            else tuple(params)
            if isinstance(params, list)
            else params,
        )
        for name, params in filters
    )


def apply_filters(db, filters, base_mask: np.ndarray):
    """AND all non-skip filters over ``base_mask``
    (reference _apply_filters, hyperdb.py:1258-1308).

    Returns (mask, override_vectors_or_None).
    """
    mask = base_mask.copy()
    override = None
    for filter_name, filter_params in filters:
        if filter_name not in FILTER_NAMES:
            raise ValueError(f"Invalid filter name {filter_name}")
        if filter_name == "skip_doc":
            continue  # applied up front by the engine
        if filter_name == "key":
            key_mask, override = key_filter(db, filter_params, mask)
            mask &= key_mask
        elif filter_name == "metadata":
            mask &= metadata_doc_mask(db, filter_params)
        elif filter_name == "sentence":
            mask &= sentence_doc_mask(db, filter_params)
    return mask, override
