"""Embedding engines.

Counterpart of ``hyperdb_tpu/models/embedder.py``. The reference embeds
behind an injectable ``embedding_function`` boundary (hyperdb.py:82,
237-248,311-337); the engines here plug into it:

- :class:`HashEmbedder` — deterministic signed feature hashing (words and
  character n-grams, crc32 buckets, L2 normalised), NumPy on the host and
  bit-equal to the JAX package's;
- :class:`HybridEmbedder` — a unit dense embedding and a unit lexical hash
  embedding concatenated with mixing weight ``w``;
- :class:`hyperdb_tpu_torch.models.minilm.MiniLMEmbedder` — the encoder as
  torch modules on the card.

:func:`default_embedder` picks among them as the JAX package does;
:func:`select_embedder_for_corpus` measures them on a split-half
self-evaluation over the user's own corpus (``python -m hyperdb_tpu_torch
selectembed``); :func:`make_embedding_function` wires one to a chunker to
produce the reference-shaped triple ``(embeddings, source_indices,
split_info)``.
"""

from __future__ import annotations

import collections
import os
import re
import threading
import zlib
from typing import Any, Callable, Protocol

import numpy as np

from hyperdb_tpu_torch.core import chunker as _chunker

_TOKEN_RE = re.compile(r"\b\w+\b")


class Embedder(Protocol):
    dim: int

    def encode(self, texts: list[str]) -> np.ndarray:
        """(len(texts), dim) float32 embeddings."""
        ...


class HashEmbedder:
    """Deterministic signed feature hashing over words and char n-grams.

    Words capture topical overlap; character 3-5-grams give robustness to
    inflection ("sleep" vs "sleeps"). Buckets are crc32-based so embeddings
    are stable across processes and platforms.
    """

    def __init__(self, dim: int = 384, ngram_range: tuple[int, int] = (3, 5),
                 sublinear_tf: bool = False):
        self.dim = int(dim)
        self._ngram_range = ngram_range
        # sqrt term-frequency damping flattens the head of repeated function
        # words while keeping lexical overlap
        self.sublinear_tf = bool(sublinear_tf)
        # word -> accumulated (dim,) contribution (covers all its n-grams)
        self._word_cache: dict[str, np.ndarray] = {}

    def _word_vector(self, tok: str) -> np.ndarray:
        vec = self._word_cache.get(tok)
        if vec is not None:
            return vec
        feats = ["w:" + tok]
        padded = f"^{tok}$"
        lo, hi = self._ngram_range
        for n in range(lo, hi + 1):
            if len(padded) < n:
                continue
            for i in range(len(padded) - n + 1):
                feats.append("g:" + padded[i : i + n])
        vec = np.zeros(self.dim, dtype=np.float32)
        for feat in feats:
            h = zlib.crc32(feat.encode("utf-8"))
            sign = 1.0 if (h >> 31) & 1 else -1.0
            vec[h % self.dim] += sign
        if len(self._word_cache) < 2_000_000:  # bound memory
            self._word_cache[tok] = vec
        return vec

    def encode_one(self, text: str) -> np.ndarray:
        vec = np.zeros(self.dim, dtype=np.float32)
        toks = _TOKEN_RE.findall(text.lower())
        if self.sublinear_tf:
            for tok, count in collections.Counter(toks).items():
                vec += np.float32(np.sqrt(count)) * self._word_vector(tok)
        else:
            for tok in toks:
                vec += self._word_vector(tok)
        norm = np.linalg.norm(vec)
        if norm > 0:
            vec = vec / norm
        return vec

    def encode(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        return np.stack([self.encode_one(t) for t in texts])


class HybridEmbedder:
    """Concatenation of a unit dense embedding and a unit lexical hash
    embedding with mixing weight ``w``: cosine over the concat equals
    ``w * s_dense + (1-w) * s_lexical``. The JAX package's zero-egress
    default for new corpora (w = 0.70, ``HYPERDB_HYBRID_W``)."""

    def __init__(self, dense, w: float = 0.70, hash_dim: int = 4096):
        self.dense = dense
        self.w = float(w)
        self.lexical = HashEmbedder(dim=hash_dim, sublinear_tf=True)
        self.dim = int(getattr(dense, "dim", 384)) + hash_dim
        # the chunk tokenizer rides along from the dense encoder
        chunk_tok = getattr(dense, "chunk_tokenizer", None)
        if chunk_tok is not None:
            self.chunk_tokenizer = chunk_tok

    @staticmethod
    def _unit(x: np.ndarray) -> np.ndarray:
        n = np.linalg.norm(x, axis=1, keepdims=True)
        return x / np.maximum(n, 1e-12)

    def encode(self, texts: list[str]) -> np.ndarray:
        d = self._unit(np.asarray(self.dense.encode(texts), dtype=np.float32))
        h = self._unit(np.asarray(self.lexical.encode(texts), dtype=np.float32))
        return np.concatenate(
            [np.sqrt(self.w) * d, np.sqrt(1.0 - self.w) * h], axis=1
        )


def corpus_self_eval_set(texts, max_docs: int = 400, seed: int = 0):
    """Split-half retrieval eval set built from the user's own corpus: each
    sampled text of at least 12 words splits into two word halves; given
    the first half, retrieve the second among every other text's second
    half. Returns (docs, queries, targets) in the
    ``localdata.evaluate_retrieval`` shape; the JAX package's sample for the
    same seed."""
    rng = np.random.default_rng(seed)
    usable = [t for t in (str(t) for t in texts) if len(t.split()) >= 12]
    if len(usable) > max_docs:
        idx = rng.choice(len(usable), size=max_docs, replace=False)
        usable = [usable[i] for i in sorted(idx)]
    docs, queries = [], []
    for t in usable:
        words = t.split()
        half = len(words) // 2
        queries.append(" ".join(words[:half]))
        docs.append(" ".join(words[half:]))
    return docs, queries, list(range(len(docs)))


def select_embedder_for_corpus(texts, max_docs: int = 400, seed: int = 0, device=None):
    """Measure the candidate default encoders on
    :func:`corpus_self_eval_set` over the user's corpus and return
    ``(best_name, embedder, report)``, ranked by recall@10 then MRR.
    Candidates: ``hash_384``, ``lexical_4096`` (the 4096-d sqrt-tf hash),
    and, where the in-repo assets exist, ``trained_local`` (the local-384
    encoder on ``device``: the card unless the caller asks for the CPU) and
    ``hybrid_w70``. Where the card is asked for and there is none, this
    raises instead of dropping the dense candidates."""
    from hyperdb_tpu_torch.core.db import resolve_device
    from hyperdb_tpu_torch.models.localdata import evaluate_retrieval
    from hyperdb_tpu_torch.models.minilm import MiniLMEmbedder

    eval_set = corpus_self_eval_set(texts, max_docs=max_docs, seed=seed)
    if len(eval_set[0]) < 20:
        raise ValueError(
            f"corpus sample too small for a meaningful self-eval "
            f"({len(eval_set[0])} usable texts; need >= 20 with >= 12 words)"
        )
    candidates: dict[str, Embedder] = {
        "hash_384": HashEmbedder(dim=384),
        "lexical_4096": HashEmbedder(dim=4096, sublinear_tf=True),
    }
    dense = MiniLMEmbedder.from_local_assets(device=resolve_device(device))
    if dense is not None:
        candidates["trained_local"] = dense
        candidates["hybrid_w70"] = HybridEmbedder(dense, w=0.70)
    report = {}
    for name, emb in candidates.items():
        m = evaluate_retrieval(emb.encode, eval_set=eval_set)
        report[name] = {k: round(v, 4) for k, v in m.items()}
    best = max(report, key=lambda k: (report[k]["recall@10"], report[k]["mrr"]))
    return best, candidates[best], report


_EMBEDDER_LOCK = threading.Lock()
# one cached embedder per (requested dim, device)
_DEFAULT_EMBEDDERS: dict[tuple, Embedder] = {}


def default_embedder(dim: int | None = None, device=None) -> Embedder:
    """Best encoder available without network access, in the JAX
    package's order: the HF-pretrained MiniLM (when cached locally), the
    HYBRID of the in-repo trained encoder and the lexical hash encoder
    (w = 0.70), the in-repo encoder alone, then the hash encoder.

    ``dim`` None means a NEW corpus (the hybrid, dim 384 + 4096); a given
    ``dim`` means an EXISTING corpus of that width whose text queries must
    embed to it (a 384-d corpus gets the dense local encoder, not the
    hybrid). ``HYPERDB_DEFAULT_EMBEDDER=auto|hash|local|hf|hybrid|lexical``
    overrides the order (lexical = the 4096-d sqrt-tf hash);
    ``HYPERDB_HYBRID_W`` sets the hybrid's mix. The dense encoders run on
    ``device`` (the card unless the caller asks for the CPU). One embedder
    is cached per (dim, device)."""
    from hyperdb_tpu_torch.core.db import resolve_device
    from hyperdb_tpu_torch.models.minilm import MiniLMEmbedder

    device = resolve_device(device)
    with _EMBEDDER_LOCK:
        key = (dim, str(device))
        cached = _DEFAULT_EMBEDDERS.get(key)
        if cached is not None:
            return cached
        mode = os.environ.get("HYPERDB_DEFAULT_EMBEDDER", "auto")
        hybrid_dim = 384 + 4096
        embedder: Embedder | None = None
        if mode in ("auto", "hf"):
            embedder = MiniLMEmbedder.maybe_pretrained(dim=dim or 384, device=device)
        if embedder is None and mode in ("auto", "hybrid") and dim in (None, hybrid_dim):
            dense = MiniLMEmbedder.from_local_assets(device=device)
            if dense is not None:
                embedder = HybridEmbedder(
                    dense, w=float(os.environ.get("HYPERDB_HYBRID_W", "0.70"))
                )
        if embedder is None and mode in ("auto", "local") and dim in (None, 384):
            # auto reaches here for EXISTING 384-d corpora (the hybrid would
            # change the query dim); mode=local selects it outright
            embedder = MiniLMEmbedder.from_local_assets(device=device)
        if embedder is None and mode == "lexical":
            embedder = HashEmbedder(dim=4096, sublinear_tf=True)
        if embedder is None:
            embedder = HashEmbedder(dim=dim or 384)
        _DEFAULT_EMBEDDERS[key] = embedder
        return embedder


def make_embedding_function(
    embedder: Embedder,
    tokenizer: _chunker.Tokenizer,
    fp_dtype: np.dtype = np.float32,
) -> Callable[[Any], tuple[np.ndarray, list[int], dict[int, int]]]:
    """The reference-shaped embedding function (hyperdb.py:311-337):
    documents -> (embeddings, source_indices, split_info)."""

    def embedding_function(documents):
        if documents is None:
            raise ValueError("Documents cannot be None.")
        texts, source_indices, split_info = _chunker.prepare_texts_and_indices(
            documents, tokenizer
        )
        embeddings = np.asarray(embedder.encode(texts), dtype=fp_dtype)
        return embeddings, source_indices, split_info

    # the pipeline pieces, so the serving text path can keep the encoder
    # output on the device (query.engine.generate_query_vectors_batch_device)
    embedding_function.embedder = embedder
    embedding_function.tokenizer = tokenizer
    return embedding_function
