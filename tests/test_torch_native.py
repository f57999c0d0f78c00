"""The port's C++ host library (``hyperdb_tpu_torch/native``) against the
JAX package's native library and against the port's own Python paths.

Tokenizers are host code over the same bytes, so every comparison is exact:
tokens, token sets and WordPiece ids equal. ``native_merge_topk`` is held
to the JAX package's merge and to a NumPy stable sort on the same inputs.
The library is built from the port's sources into ``build/hyperdb_tpu_torch/``;
a source that does not compile makes ``build`` raise.
"""

import re
import string

import numpy as np
import pytest

from hyperdb_tpu.core.chunker import WordTokenizer as JaxWordTokenizer
from hyperdb_tpu.models.wordpiece import WordPieceTokenizer as JaxWordPiece
from hyperdb_tpu.models.wordpiece import train_wordpiece
from hyperdb_tpu.native import tokenizer as jax_native
from hyperdb_tpu.query.filters import tokenize as jax_filter_tokenize
from hyperdb_tpu_torch.core import chunker as TC
from hyperdb_tpu_torch.models.minilm import ASSETS_DIR
from hyperdb_tpu_torch.models.wordpiece import WordPieceTokenizer as TorchWordPiece
from hyperdb_tpu_torch.native import tokenizer as native
from hyperdb_tpu_torch.query import filters as TF

VOCAB = ASSETS_DIR + "/vocab.txt"

WORD_TEXTS = [
    "hello world",
    "  leading and   multiple   spaces\t tabs\nnewlines ",
    "",
    "single",
    "word " * 700,
    "unicode héllo wörld ünïts",
    "cafe au lait",  # NBSP and EM SPACE: Unicode whitespace
    "nul\x00inside a word",
]
FILTER_TEXTS = [
    "Sleeps 18 hours a day.",
    "don't STOP, me-now!",
    "punctuation... everywhere?!",
    "",
    "MiXeD CaSe WORDS",
    "under_score and digits 42x",
]
WORDPIECE_TEXTS = [
    "Abra sleeps 18 hours a day, but it can teleport while asleep!",
    "unaffable xyzzyqq supercalifragilisticexpialidocious",
    "MiXeD CaSe, punctuation... everywhere?! (brackets) [and] {braces}",
    "nul\x00byte and \x07bell and \x7fdel",
    "tabs\tand\nnewlines\r\nand\x0bvt\x0cff",
    "split\x1cby\x1dcontrol\x1eseparators\x1fhere",
    "Pokémon naïve café and ascii words",
    "no break space",
    "",
    "word " * 1000,
]


@pytest.fixture(scope="module")
def jax_word():
    assert jax_native.build(), "the JAX package's native library did not build"
    tok = jax_native.NativeWordTokenizer.maybe_load()
    assert tok is not None
    return tok


@pytest.fixture(scope="module")
def wordpieces():
    return JaxWordPiece.load(VOCAB), TorchWordPiece.load(VOCAB)


def test_build_lands_in_the_port_build_dir():
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "hyperdb_tpu_torch")
    assert re.fullmatch(r"libhyperdb_host-[0-9a-f]{12}\.so", path.name)
    assert path == native.library_path() and path.exists()
    lib = native.load()
    assert lib is native.load()  # loaded once per process
    assert lib._name == str(path)


def test_corrupt_source_makes_build_raise(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    for name in native.SOURCES:
        (src / name).write_bytes((native.NATIVE_DIR / name).read_bytes())
    good = native.library_path()
    with open(src / "server.cc", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(native, "NATIVE_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    # an edited source names another library: it cannot reuse the good one
    assert native.library_path() != good
    with pytest.raises(RuntimeError, match="this is not C"):
        native.build()
    assert not list((tmp_path / "build").iterdir())  # no library, no temp file


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build()


@pytest.mark.parametrize("text", WORD_TEXTS, ids=range(len(WORD_TEXTS)))
def test_native_word_tokenizer_parity(jax_word, text):
    tok = native.NativeWordTokenizer()
    want = TC.WordTokenizer().encode(text)
    assert tok.encode(text) == want
    assert jax_word.encode(text) == want == JaxWordTokenizer().encode(text)
    assert tok.decode(tok.encode(text)) == jax_word.decode(jax_word.encode(text))


@pytest.mark.parametrize("text", FILTER_TEXTS, ids=range(len(FILTER_TEXTS)))
def test_native_filter_tokenizer_parity(text):
    got = native.native_filter_tokenize(text)
    assert got is not None
    assert got == jax_native.native_filter_tokenize(text) == jax_filter_tokenize(text)
    assert TF.tokenize(text) == got


def test_native_filter_tokenizer_non_ascii_takes_python():
    """Byte-level C++ cannot lowercase 'É' or classify Unicode word chars:
    non-ASCII text takes the Unicode-aware Python tokenizer in both
    packages."""
    punct = str.maketrans("", "", string.punctuation)
    word_re = re.compile(r"\b\w+\b")
    for text in ["CAFÉ is great", "ellipsis… here", "Ünïts of WÖRK"]:
        assert native.native_filter_tokenize(text) is None
        assert jax_native.native_filter_tokenize(text) is None
        pure_python = set(word_re.findall(text.translate(punct).lower()))
        assert TF.tokenize(text) == pure_python == jax_filter_tokenize(text)
    assert TF.tokenize("CAFÉ is great") == {"café", "is", "great"}


def test_filter_tokenize_goes_native_for_ascii(monkeypatch):
    calls = []
    real = TF.native_filter_tokenize

    def spy(text):
        calls.append(text)
        return real(text)

    monkeypatch.setattr(TF, "native_filter_tokenize", spy)
    assert TF.tokenize("Sleeps a lot") == {"sleeps", "a", "lot"}
    assert TF.tokenize("CAFÉ") == {"café"}
    assert calls == ["Sleeps a lot", "CAFÉ"]


def test_native_merge_topk():
    rng = np.random.default_rng(0)
    scores = rng.standard_normal(64).astype(np.float32)
    ids = np.arange(64, dtype=np.int64)
    out_scores, out_ids = native.native_merge_topk(scores, ids, k=5)
    order = np.argsort(-scores, kind="stable")[:5]
    np.testing.assert_array_equal(out_ids, ids[order])
    np.testing.assert_array_equal(out_scores, scores[order])
    j_scores, j_ids = jax_native.native_merge_topk(scores, ids, k=5)
    np.testing.assert_array_equal(out_ids, j_ids)
    np.testing.assert_array_equal(out_scores, j_scores)


def test_native_merge_topk_shards_and_ties():
    """Per-shard top-k lists with ties across shards: ties go to the lower
    id, as in the JAX merge."""
    rng = np.random.default_rng(3)
    shards, k = 8, 10
    scores = np.round(rng.standard_normal((shards, k)), 1).astype(np.float32)
    scores = -np.sort(-scores, axis=1)
    ids = rng.permutation(shards * 1000)[: shards * k].reshape(shards, k).astype(np.int64)
    got = native.native_merge_topk(scores.ravel(), ids.ravel(), k)
    want = jax_native.native_merge_topk(scores.ravel(), ids.ravel(), k)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    key = np.lexsort((ids.ravel(), -scores.ravel()))[:k]
    np.testing.assert_array_equal(got[1], ids.ravel()[key])


def test_native_merge_topk_tie_break():
    scores = np.array([1.0, 2.0, 2.0, 0.5], dtype=np.float32)
    ids = np.array([7, 9, 3, 1], dtype=np.int64)
    _, out_ids = native.native_merge_topk(scores, ids, k=3)
    np.testing.assert_array_equal(out_ids, [3, 9, 7])  # 3 before 9 on the tie
    np.testing.assert_array_equal(out_ids, jax_native.native_merge_topk(scores, ids, 3)[1])


def test_native_merge_accepts_neg_inf_entries():
    """Masked rows arrive as (-inf, id); they fill otherwise-empty slots
    instead of leaving -1 sentinels; slots with no entry at all keep -1."""
    scores = np.array([-np.inf, -np.inf, 1.5], dtype=np.float32)
    ids = np.array([7, 3, 9], dtype=np.int64)
    _, out_ids = native.native_merge_topk(scores, ids, k=3)
    assert list(out_ids) == [9, 3, 7]
    _, wide = native.native_merge_topk(scores, ids, k=4)
    assert list(wide) == [9, 3, 7, -1]
    np.testing.assert_array_equal(wide, jax_native.native_merge_topk(scores, ids, 4)[1])


def test_native_merge_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="differ in shape"):
        native.native_merge_topk(np.zeros(4, np.float32), np.zeros(3, np.int64), 2)


def test_native_word_tokenizer_unicode_whitespace_parity():
    """NBSP and other Unicode whitespace split as the Python \\S+ does (the
    C++ path only sees ASCII bytes, so non-ASCII text takes the regex)."""
    nat = native.NativeWordTokenizer()
    py = TC.WordTokenizer()
    for text in ["cafe au lait", "plain ascii words", "tabs\tand\nnewlines",
                 "ünïcode wörds", "ideographic　space"]:
        assert nat.encode(text) == py.encode(text), text


def test_default_tokenizer_word_mode_is_native(monkeypatch):
    monkeypatch.setenv("HYPERDB_CHUNK_TOKENIZER", "word")
    tok = TC.default_tokenizer()
    assert isinstance(tok, native.NativeWordTokenizer)
    text = "some words  to\tchunk " * 400
    chunks = TC.text_to_chunks(text, tok)
    assert len(chunks) == 4  # 1600 words in 510-word windows
    assert chunks == TC.text_to_chunks(text, TC.WordTokenizer())
    assert chunks == TC.text_to_chunks(text, JaxWordTokenizer())


@pytest.mark.parametrize("text", WORDPIECE_TEXTS, ids=range(len(WORDPIECE_TEXTS)))
def test_wordpiece_native_parity(wordpieces, text):
    """The in-repo vocab: ASCII text takes the port's C++ encoder, the rest
    Python; the ids equal the port's Python path and the JAX package's
    ``text_ids`` (its own C++ encoder on the same rule), on a first and a
    second call (the Python path's word cache must not make them differ)."""
    jwp, twp = wordpieces
    py = TorchWordPiece.load(VOCAB)._python_text_ids(text)
    for _ in range(2):
        assert twp.text_ids(text) == py
        assert jwp.text_ids(text) == py
        assert twp._python_text_ids(text) == py
    assert twp.encode(text, 32) == jwp.encode(text, 32)


def test_wordpiece_routes_by_the_jax_rule(wordpieces, monkeypatch):
    _, twp = wordpieces
    calls = []
    real = twp._native_encoder().encode_ids

    def spy(text):
        calls.append(text)
        return real(text)

    monkeypatch.setattr(twp._native, "encode_ids", spy)
    twp.text_ids("plain ascii, with punctuation!")
    twp.text_ids("nul\x00byte")
    twp.text_ids("café")
    twp.text_ids("ctrl\x1dsep")
    assert calls == ["plain ascii, with punctuation!", "nul\x00byte"]


def test_wordpiece_control_char_whitespace_parity():
    """\\x1c-\\x1f are whitespace to Python's Unicode \\s but not to the C++
    is_space; such text takes the Python path, so it splits like a space."""
    vocab = train_wordpiece(["alpha beta gamma"] * 4, vocab_size=200)
    jwp, twp = JaxWordPiece(vocab), TorchWordPiece(vocab)
    with_ctrl = twp.text_ids("alpha\x1cbeta")
    plain = twp.text_ids("alpha beta")
    assert with_ctrl == plain == jwp.text_ids("alpha\x1cbeta") == jwp.text_ids("alpha beta")


def test_wordpiece_long_text_and_threads(wordpieces):
    """A text longer than the encoder's first buffer, and concurrent callers
    on one encoder, give the Python path's ids."""
    import concurrent.futures

    _, twp = wordpieces
    texts = [f"word{i} " * (300 + 97 * i) + "tail!" for i in range(12)]
    want = [twp._python_text_ids(t) for t in texts]
    with concurrent.futures.ThreadPoolExecutor(max_workers=6) as pool:
        got = list(pool.map(twp.text_ids, texts * 3))
    assert got == want * 3
