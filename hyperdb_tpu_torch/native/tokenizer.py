"""Build, load and bind the port's C++ host library (``tokenizer.cc`` +
``server.cc``).

Counterpart of ``hyperdb_tpu/native/tokenizer.py``: host-side tokenization
for chunking, the sentence filter and the encoder's WordPiece, plus an
exact top-k merge of per-shard results. The library is compiled with the
host C++ compiler (``$CXX``, default ``g++``; the JAX package's Makefile
flags) into ``build/hyperdb_tpu_torch/`` at first use, never when a module
is imported. Its file name carries a hash of the sources and flags, so an
edited source rebuilds, and it is written to a temporary name and moved into
place, so concurrent processes never load a half-written file. A failed
build raises with the compiler's output.

The C++ tokenizers are ASCII-only; callers route other text to the Python
tokenizers, which give the same tokens (the JAX package's rules).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hyperdb_tpu_torch"
SOURCES = ("tokenizer.cc", "server.cc")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LINK_FLAGS = ("-lpthread",)

_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((NATIVE_DIR / name).read_bytes())
    digest.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libhyperdb_host-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path. Raises with
    the compiler's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError(
            f"no C++ compiler ({os.environ.get('CXX', 'g++')!r} not on PATH): "
            "the native host library cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp),
           *(str(NATIVE_DIR / name) for name in SOURCES), *LINK_FLAGS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the native host library failed:\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: concurrent loaders never see a partial file
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built on first use. ``CDLL`` (not ``PyDLL``):
    every call releases the GIL."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _LIB = lib
        return _LIB


def _declare(lib) -> None:
    for fn in ("hdb_tokenize_words", "hdb_tokenize_filter"):
        getattr(lib, fn).restype = ctypes.c_void_p
        getattr(lib, fn).argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
        ]
    lib.hdb_wordpiece_load.restype = ctypes.c_void_p
    lib.hdb_wordpiece_load.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int32]
    lib.hdb_wordpiece_free.restype = None
    lib.hdb_wordpiece_free.argtypes = [ctypes.c_void_p]
    lib.hdb_wordpiece_encode.restype = ctypes.c_int64
    lib.hdb_wordpiece_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    lib.hdb_merge_topk.restype = None
    lib.hdb_merge_topk.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_size_t, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.hdb_free.restype = None
    lib.hdb_free.argtypes = [ctypes.c_void_p]


def _call_tokenize(lib, fn_name: str, text: str) -> list[str]:
    raw = text.encode("utf-8")
    n = ctypes.c_size_t(0)
    ptr = getattr(lib, fn_name)(raw, len(raw), ctypes.byref(n))
    if not ptr:
        return []
    try:
        buf = ctypes.string_at(ptr, n.value)
    finally:
        lib.hdb_free(ptr)
    if not buf:
        return []
    return buf.decode("utf-8").split("\n")


class NativeWordTokenizer:
    """Whitespace word tokenizer in C++; the same tokens as
    :class:`hyperdb_tpu_torch.core.chunker.WordTokenizer` (non-ASCII text
    takes its regex: byte-level splitting cannot see Unicode whitespace)."""

    def __init__(self):
        self._lib = load()

    def encode(self, text: str) -> list[str]:
        if not text.isascii():
            from hyperdb_tpu_torch.core.chunker import _WORD_RE

            return _WORD_RE.findall(text)
        return _call_tokenize(self._lib, "hdb_tokenize_words", text)

    def decode(self, tokens: list[str]) -> str:
        return " ".join(tokens)


def native_filter_tokenize(text: str) -> set[str] | None:
    """Sentence-filter tokenization (lowercase word set, punctuation
    stripped) in C++; None for non-ASCII text, which the caller tokenizes
    in Python (byte-level lowercasing cannot reproduce ``str.lower()`` and
    Unicode ``\\w``: 'CAFÉ' must give {'café'})."""
    if not text.isascii():
        return None
    return set(_call_tokenize(load(), "hdb_tokenize_filter", text))


class NativeWordPiece:
    """Greedy longest-match-first WordPiece encoder in C++ over a fixed
    vocab. ASCII-only: ``models/wordpiece.WordPieceTokenizer`` routes other
    text to Python. One call at a time per encoder (the C++ side keeps a
    word cache), under a lock."""

    def __init__(self, vocab: list[str], unk_id: int):
        self._lib = load()
        blob = "\n".join(vocab).encode("utf-8")
        self._handle = self._lib.hdb_wordpiece_load(blob, len(blob), unk_id)
        self._buf = (ctypes.c_int32 * 4096)()
        self._mutex = threading.Lock()

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.hdb_wordpiece_free(handle)

    def encode_ids(self, text: str) -> list[int]:
        raw = text.encode("utf-8")
        with self._mutex:
            # one id per byte at most (a piece spans at least one byte)
            if len(raw) + 8 > len(self._buf):
                self._buf = (ctypes.c_int32 * (len(raw) + 8))()
            n = self._lib.hdb_wordpiece_encode(
                self._handle, raw, len(raw), self._buf, len(self._buf)
            )
            return self._buf[:n]


def native_merge_topk(scores: np.ndarray, ids: np.ndarray, k: int):
    """Exact merge of concatenated per-shard top-k lists: the ``k`` best
    ``(scores, ids)``, descending, ties to the lower id."""
    lib = load()
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    if scores.shape != ids.shape:
        raise ValueError(f"scores {scores.shape} and ids {ids.shape} differ in shape")
    out_scores = np.empty(k, dtype=np.float32)
    out_ids = np.empty(k, dtype=np.int64)
    lib.hdb_merge_topk(
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        scores.size,
        k,
        out_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out_scores, out_ids
