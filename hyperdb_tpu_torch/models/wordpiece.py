"""In-repo WordPiece tokenizer.

Counterpart of ``hyperdb_tpu/models/wordpiece.py``: BERT's greedy
longest-match-first encoding over a fixed vocabulary (the shipped one is
``hyperdb_tpu/models/assets/vocab.txt``). ASCII text without the
``_CTRL_WS`` control characters is encoded by the port's C++ WordPiece
(``native/tokenizer.py``), every other text in Python, under the JAX
package's rule; both give the same ids.

The tokenizer implements both interfaces the engine needs:
- model interface: ``encode(text, max_len) -> (ids, attention_mask)`` with
  [CLS]/[SEP] specials — plugs into ``MiniLMEmbedder``;
- chunker protocol (``encode(text)``/``decode(tokens)``): token-id lists for
  510-token windowing (``core/chunker.py``).

The trainer (``train_wordpiece``) belongs to training and is not ported.
"""

from __future__ import annotations

import re

PAD, UNK, CLS, SEP = "[PAD]", "[UNK]", "[CLS]", "[SEP]"
SPECIALS = (PAD, UNK, CLS, SEP)

_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


def pretokenize(text: str) -> list[str]:
    """Lowercase words + isolated punctuation (BERT basic-tokenizer style)."""
    return _WORD_RE.findall(text.lower())


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece encoding over a fixed vocab."""

    def __init__(self, vocab: list[str]):
        self.vocab = list(vocab)
        self.token_to_id = {t: i for i, t in enumerate(self.vocab)}
        for s in SPECIALS:
            if s not in self.token_to_id:
                raise ValueError(f"vocab is missing special token {s}")
        self.pad_id = self.token_to_id[PAD]
        self.unk_id = self.token_to_id[UNK]
        self.cls_id = self.token_to_id[CLS]
        self.sep_id = self.token_to_id[SEP]
        self._max_piece = max((len(t) for t in self.vocab), default=1)
        self._word_cache: dict[str, tuple[list[int], list[tuple[int, int]]]] = {}
        self._native = None  # the C++ encoder, built at the first ASCII text

    def _native_encoder(self):
        if self._native is None:
            from hyperdb_tpu_torch.native.tokenizer import NativeWordPiece

            self._native = NativeWordPiece(self.vocab, self.unk_id)
        return self._native

    # ---------------------------------------------------------------- io

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for token in self.vocab:
                f.write(token + "\n")

    @classmethod
    def load(cls, path: str) -> "WordPieceTokenizer":
        with open(path, encoding="utf-8") as f:
            return cls([line.rstrip("\n") for line in f if line.rstrip("\n")])

    # ------------------------------------------------------------ encoding

    def word_ids(self, word: str) -> list[int]:
        """Greedy longest-match-first split of one word into piece ids."""
        return self.word_pieces(word)[0]

    def word_pieces(self, word: str) -> tuple[list[int], list[tuple[int, int]]]:
        """(piece ids, per-piece char spans within ``word``).

        Spans let the subword chunker slice the original text at exact
        token boundaries (``core/chunker.WordPieceChunkTokenizer``). An
        unsplittable word is a single [UNK] spanning the whole word (BERT
        semantics)."""
        cached = self._word_cache.get(word)
        if cached is not None:
            return cached
        ids: list[int] = []
        spans: list[tuple[int, int]] = []
        start = 0
        n = len(word)
        while start < n:
            end = min(n, start + self._max_piece)
            piece_id = None
            while end > start:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                piece_id = self.token_to_id.get(piece)
                if piece_id is not None:
                    break
                end -= 1
            if piece_id is None:
                ids, spans = [self.unk_id], [(0, n)]
                break
            ids.append(piece_id)
            spans.append((start, end))
            start = end
        result = (ids, spans)
        if len(self._word_cache) < 1_000_000:
            self._word_cache[word] = result
        return result

    # ASCII control characters that Python's Unicode \s treats as
    # whitespace and the C++ tokenizer does not: text holding one takes the
    # Python path, so both paths give the same ids.
    _CTRL_WS = "\x1c\x1d\x1e\x1f"

    def text_ids(self, text: str) -> list[int]:
        if text.isascii() and not any(c in text for c in self._CTRL_WS):
            return self._native_encoder().encode_ids(text)
        return self._python_text_ids(text)

    def _python_text_ids(self, text: str) -> list[int]:
        out: list[int] = []
        for word in pretokenize(text):
            out.extend(self.word_ids(word))
        return out

    def encode(self, text: str, max_len: int | None = None):
        """Model interface: (ids, mask) with specials when ``max_len`` given;
        chunker protocol (plain token-id list, no specials) otherwise."""
        if max_len is None:
            return self.text_ids(text)
        body = self.text_ids(text)[: max(0, max_len - 2)]
        ids = [self.cls_id] + body + [self.sep_id]
        return ids, [1] * len(ids)

    def decode(self, tokens: list[int]) -> str:
        """Chunker protocol: ids -> text (## continuations joined)."""
        words: list[str] = []
        for tid in tokens:
            piece = self.vocab[tid] if 0 <= int(tid) < len(self.vocab) else UNK
            if piece in SPECIALS:
                continue
            if piece.startswith("##") and words:
                words[-1] += piece[2:]
            else:
                words.append(piece)
        return " ".join(words)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)
