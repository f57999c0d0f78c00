"""Token-based document chunking (long-document support).

Counterpart of ``hyperdb_tpu/core/chunker.py``, which mirrors the
reference's chunking data model (hyperdb.py:26,251-309): texts are
tokenized without truncation, sliced into ``MAX_TOKENS``-token windows (512
minus 2 special tokens), decoded back to text, and embedded per chunk;
``source_indices`` maps each chunk row to its originating document and
``split_info`` records chunks-per-document.

Tokenization is host work, behind the small :class:`Tokenizer` protocol:

- :class:`WordTokenizer` — whitespace/word-boundary tokens, identity
  decode: one word == one token.
- :class:`WordPieceChunkTokenizer` — subword windows over the in-repo
  WordPiece vocab, chunk text sliced from the original characters.
- :class:`HFTokenizer` — adapter for a HuggingFace fast tokenizer when its
  assets are available locally.

Without the WordPiece vocab (or with ``HYPERDB_CHUNK_TOKENIZER=word``)
:func:`default_tokenizer` takes the C++ word tokenizer
(``native/tokenizer.py``), which gives :class:`WordTokenizer`'s tokens.
"""

from __future__ import annotations

import os
import re
from typing import Any, Protocol

# 512 - 2 to account for the special tokens a BERT-style encoder adds
# (reference MAX_LENGTH, hyperdb.py:26).
MAX_TOKENS = 510

_WORD_RE = re.compile(r"\S+")


class Tokenizer(Protocol):
    def encode(self, text: str) -> list:
        """Text -> token list (no truncation)."""
        ...

    def decode(self, tokens: list) -> str:
        """Token list -> text."""
        ...


class WordTokenizer:
    """Whitespace word tokenizer with identity decode."""

    def encode(self, text: str) -> list[str]:
        return _WORD_RE.findall(text)

    def decode(self, tokens: list[str]) -> str:
        return " ".join(tokens)


class HFTokenizer:
    """Adapter for a HuggingFace fast tokenizer (e.g. BertTokenizerFast)."""

    def __init__(self, hf_tokenizer):
        self._tok = hf_tokenizer

    def encode(self, text: str) -> list[int]:
        return self._tok(text, truncation=False)["input_ids"]

    def decode(self, tokens: list[int]) -> str:
        return self._tok.decode(tokens, clean_up_tokenization_spaces=True)


def text_to_chunks(
    text: str, tokenizer: Tokenizer, max_length: int = MAX_TOKENS
) -> list[str]:
    """Split text into decoded windows of at most ``max_length`` tokens
    (reference text_to_chunks, hyperdb.py:251-267).

    A tokenizer exposing ``chunk_text`` (the subword chunkers) takes the
    direct path: same window arithmetic, but chunk text recovered from
    original character spans instead of a lossy decode round-trip."""
    chunk_fn = getattr(tokenizer, "chunk_text", None)
    if chunk_fn is not None:
        return chunk_fn(text, max_length)
    tokens = tokenizer.encode(text)
    return [
        tokenizer.decode(tokens[i : i + max_length])
        for i in range(0, len(tokens), max_length)
    ]


class WordPieceChunkTokenizer:
    """Subword-accurate chunk tokenizer over the in-repo WordPiece vocab.

    Chunk boundaries count SUBWORD tokens — exactly ``ceil(total_tokens /
    max_length)`` windows, sliced at token boundaries including mid-word
    splits. Unlike a ``decode()`` (which lowercases and emits literal
    ``[UNK]`` strings), chunk text is recovered from the ORIGINAL character
    spans, so downstream embedders see faithful text.
    """

    def __init__(self, wordpiece) -> None:
        self._wp = wordpiece

    def encode(self, text: str) -> list[int]:
        return self._wp.text_ids(text)

    def decode(self, tokens: list[int]) -> str:
        return self._wp.decode(tokens)

    def chunk_text(self, text: str, max_length: int = MAX_TOKENS) -> list[str]:
        from hyperdb_tpu_torch.models.wordpiece import _WORD_RE as _WP_WORD_RE

        lowered = text.lower()
        # offsets computed on the lowered text (pretokenize parity); slice
        # the original when lowering preserved length (the common case —
        # rare Unicode expansions fall back to the lowered text)
        src = text if len(lowered) == len(text) else lowered
        spans: list[tuple[int, int]] = []
        for m in _WP_WORD_RE.finditer(lowered):
            _ids, piece_spans = self._wp.word_pieces(m.group(0))
            base = m.start()
            spans.extend((base + a, base + b) for a, b in piece_spans)
        return [
            src[spans[i][0] : spans[min(i + max_length, len(spans)) - 1][1]]
            for i in range(0, len(spans), max_length)
        ]


def document_text(doc: Any) -> str:
    """The text embedded for a dict document: values only, insertion order
    (reference hyperdb.py:297)."""
    return " ".join(str(val) for val in doc.values())


def prepare_texts_and_indices(
    documents: Any, tokenizer: Tokenizer, max_length: int = MAX_TOKENS
):
    """Chunk documents into texts + chunk->doc bookkeeping
    (reference prepare_texts_and_indices, hyperdb.py:269-309).

    Returns:
        (texts, source_indices, split_info) where ``source_indices[r]`` is
        the in-batch document index that produced chunk ``r`` and
        ``split_info[i]`` the number of chunks of document ``i``.
    """
    if documents is None or not documents:
        raise ValueError("Documents cannot be empty or None.")

    texts: list[str] = []
    source_indices: list[int] = []
    split_info: dict[int, int] = {}

    def process(text: str, index: int) -> None:
        chunks = text_to_chunks(text, tokenizer, max_length)
        texts.extend(chunks)
        source_indices.extend([index] * len(chunks))
        split_info[index] = split_info.get(index, 0) + len(chunks)

    if isinstance(documents, str):
        process(documents, 0)
        return texts, source_indices, split_info

    if isinstance(documents, list):
        for i, doc in enumerate(documents):
            if isinstance(doc, dict):
                process(document_text(doc), i)
            elif isinstance(doc, list):
                for sub in doc:
                    process(str(sub), i)
            elif isinstance(doc, str):
                process(doc, i)
            else:
                raise ValueError("Unsupported document type.")
        return texts, source_indices, split_info

    raise ValueError("Documents should either be a string or a list.")


_DEFAULT_WP_CHUNKER: list = []  # lazy singleton ([] = untried, [None] = failed)


def default_tokenizer() -> Tokenizer:
    """Best tokenizer available without network access.

    Prefers subword (WordPiece) chunk boundaries over the in-repo vocab.
    Set ``HYPERDB_CHUNK_TOKENIZER=word`` to force whitespace-word counting;
    without the vocab the whitespace-word tokenizer is used too, in C++.
    """
    if os.environ.get("HYPERDB_CHUNK_TOKENIZER", "wordpiece") == "wordpiece":
        if not _DEFAULT_WP_CHUNKER:
            from hyperdb_tpu_torch.models.minilm import ASSETS_DIR
            from hyperdb_tpu_torch.models.wordpiece import WordPieceTokenizer

            vocab = os.path.join(ASSETS_DIR, "vocab.txt")
            try:
                wp = WordPieceTokenizer.load(vocab)
            except OSError:
                _DEFAULT_WP_CHUNKER.append(None)
            else:
                _DEFAULT_WP_CHUNKER.append(WordPieceChunkTokenizer(wp))
        if _DEFAULT_WP_CHUNKER[0] is not None:
            return _DEFAULT_WP_CHUNKER[0]
    from hyperdb_tpu_torch.native.tokenizer import NativeWordTokenizer

    return NativeWordTokenizer()
