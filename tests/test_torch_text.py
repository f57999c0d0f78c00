"""The text path: tokenizers, chunker, hash embedders, the default-embedder
rule and text ``HyperDB`` flows, against the JAX package on the CPU.

All of it is host code or exact arithmetic, so the comparisons are exact:
token ids and chunks equal, hash embeddings ``np.array_equal``, and DB
state (documents, source_indices, split_info, metadata index, vectors)
equal. Query answers come from the same bit-equal vectors through two f32
scans whose sums run in different orders: ids identical, scores within
``ATOL``.
"""

import datetime

import numpy as np
import pytest
import torch

from hyperdb_tpu import HyperDB as JaxDB
from hyperdb_tpu.core import db as JDB_MODULE
from hyperdb_tpu.core import chunker as JC
from hyperdb_tpu.models import embedder as JE
from hyperdb_tpu.models import minilm as JM
from hyperdb_tpu.models.wordpiece import WordPieceTokenizer as JaxWordPiece
from hyperdb_tpu.query import engine as JENG
from hyperdb_tpu_torch import HyperDB as TorchDB
from hyperdb_tpu_torch.core import chunker as TC
from hyperdb_tpu_torch.core import db as TDB_MODULE
from hyperdb_tpu_torch.models import embedder as TE
from hyperdb_tpu_torch.models import minilm as TM
from hyperdb_tpu_torch.models.wordpiece import WordPieceTokenizer as TorchWordPiece
from hyperdb_tpu_torch.query import engine as TENG

ATOL = 1e-6  # cosines of bit-equal f32 rows, two summation orders
VOCAB = TM.ASSETS_DIR + "/vocab.txt"

TEXTS = {
    "ascii": "Abra sleeps 18 hours a day, but it can teleport while asleep!",
    "unicode": "Pokémon Flabébé — naïve café 日本語 Straße ǅ İstanbul",
    "control_ws": "split\x1cby\x1dcontrol\x1eseparators\x1fhere and\tthere\n",
    "unsplittable": "a ☃☃☃ snowman and ⌘⌘ keys",
    "empty": "",
    "long_word": "supercalifragilisticexpialidocious " * 3,
}


@pytest.fixture(scope="module")
def wordpieces():
    return JaxWordPiece.load(VOCAB), TorchWordPiece.load(VOCAB)


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_wordpiece_ids(wordpieces, name):
    jwp, twp = wordpieces
    text = TEXTS[name]
    assert twp.encode(text) == jwp.encode(text)
    assert twp.encode(text, 16) == jwp.encode(text, 16)
    assert twp.decode(twp.encode(text)) == jwp.decode(jwp.encode(text))
    for word in text.lower().split():
        assert twp.word_pieces(word) == jwp.word_pieces(word)
    if name == "unsplittable":
        assert twp.unk_id in twp.encode(text)


LONG_WORDS = " ".join(f"zyx{i}qvw" for i in range(200))  # > 510 pieces, < 510 words
DOCS = {
    "str": "A short string document.",
    "list_of_str": ["first text", "second text with more words", TEXTS["unicode"]],
    "dicts": [
        {"name": "Abra", "info": {"type": "psychic", "description": TEXTS["ascii"]}},
        {"name": "Snorlax", "info": {"type": "normal"}, "n": 7},
    ],
    "nested_list": [["part one", "part two"], "plain", {"k": "v"}],
    "long_words": ["word " * 1200, LONG_WORDS, "tail"],
}


def _tokenizers(wordpieces):
    jwp, twp = wordpieces
    return {
        "word": (JC.WordTokenizer(), TC.WordTokenizer()),
        "wordpiece_chunk": (JC.WordPieceChunkTokenizer(jwp), TC.WordPieceChunkTokenizer(twp)),
        "wordpiece": (jwp, twp),  # the local encoder's chunk tokenizer: decode path
    }


@pytest.mark.parametrize("tok", ["word", "wordpiece_chunk", "wordpiece"])
@pytest.mark.parametrize("doc", sorted(DOCS))
def test_chunking(wordpieces, tok, doc):
    jt, tt = _tokenizers(wordpieces)[tok]
    documents = DOCS[doc]
    assert TC.prepare_texts_and_indices(documents, tt) == JC.prepare_texts_and_indices(
        documents, jt
    )
    for text in [documents] if isinstance(documents, str) else documents:
        if isinstance(text, str):
            assert TC.text_to_chunks(text, tt, 100) == JC.text_to_chunks(text, jt, 100)
    if doc == "long_words" and tok != "word":
        _, _, split = TC.prepare_texts_and_indices(documents, tt)
        assert split[0] == 3 and split[1] > 1  # 200 words, but more than 510 subwords


def test_chunking_errors_and_default_tokenizer(monkeypatch):
    for bad in (None, [], [3]):
        with pytest.raises(ValueError) as terr:
            TC.prepare_texts_and_indices(bad, TC.WordTokenizer())
        with pytest.raises(ValueError) as jerr:
            JC.prepare_texts_and_indices(bad, JC.WordTokenizer())
        assert str(terr.value) == str(jerr.value)
    assert type(TC.default_tokenizer()).__name__ == type(JC.default_tokenizer()).__name__
    assert isinstance(TC.default_tokenizer(), TC.WordPieceChunkTokenizer)
    monkeypatch.setenv("HYPERDB_CHUNK_TOKENIZER", "word")
    # word mode takes the C++ word tokenizer in both packages, with
    # WordTokenizer's tokens
    word = TC.default_tokenizer()
    assert type(word).__name__ == type(JC.default_tokenizer()).__name__ == "NativeWordTokenizer"
    assert word.encode(TEXTS["ascii"]) == TC.WordTokenizer().encode(TEXTS["ascii"])
    assert word.encode(TEXTS["unicode"]) == TC.WordTokenizer().encode(TEXTS["unicode"])
    assert TC.document_text({"a": 1, "b": {"c": "d"}}) == JC.document_text({"a": 1, "b": {"c": "d"}})


EMBED_TEXTS = [TEXTS["ascii"], TEXTS["unicode"], "", "sleep sleeps sleeping " * 5, "x"]


@pytest.mark.parametrize("kw", [{}, {"dim": 64}, {"dim": 4096, "sublinear_tf": True}])
def test_hash_embedder_bit_equal(kw):
    got = TE.HashEmbedder(**kw).encode(EMBED_TEXTS)
    want = JE.HashEmbedder(**kw).encode(EMBED_TEXTS)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert TE.HashEmbedder(**kw).encode([]).shape == want[:0].shape


class _FixedDense:
    """A dense encoder giving both packages the same vectors."""

    dim = 24

    def encode(self, texts):
        rng = np.random.default_rng(len(texts))
        return rng.standard_normal((len(texts), self.dim)).astype(np.float32) * 3


def test_hybrid_embedder_bit_equal():
    got = TE.HybridEmbedder(_FixedDense(), w=0.7, hash_dim=256)
    want = JE.HybridEmbedder(_FixedDense(), w=0.7, hash_dim=256)
    assert got.dim == want.dim == 280
    np.testing.assert_array_equal(got.encode(EMBED_TEXTS), want.encode(EMBED_TEXTS))


@pytest.fixture
def cached_local(monkeypatch):
    """Build each package's local encoder once for the mode sweep (the rule
    under test is the choice, not the load)."""
    jenc, tenc = JM.MiniLMEmbedder.from_local_assets(), TM.MiniLMEmbedder.from_local_assets(device="cpu")
    monkeypatch.setattr(JM.MiniLMEmbedder, "from_local_assets", classmethod(lambda cls, a=None: jenc))
    monkeypatch.setattr(
        TM.MiniLMEmbedder, "from_local_assets", classmethod(lambda cls, a=None, device=None: tenc)
    )
    monkeypatch.setattr(JE, "_DEFAULT_EMBEDDERS", {})
    monkeypatch.setattr(TE, "_DEFAULT_EMBEDDERS", {})


def _describe(emb):
    dense = getattr(emb, "dense", None)
    return (type(emb).__name__, emb.dim, type(dense).__name__ if dense is not None else None,
            getattr(emb, "w", None), getattr(emb, "sublinear_tf", None))


@pytest.mark.parametrize("mode", ["auto", "hash", "local", "hf", "hybrid", "lexical"])
def test_default_embedder_rule(cached_local, monkeypatch, mode):
    monkeypatch.setenv("HYPERDB_DEFAULT_EMBEDDER", mode)
    for dim in (None, 384, 384 + 4096, 96):
        got = TE.default_embedder(dim, device="cpu")
        want = JE.default_embedder(dim)
        assert _describe(got) == _describe(want), (mode, dim)
        assert TE.default_embedder(dim, device="cpu") is got  # cached per (dim, device)


# ---------------------------------------------------------------- text DBs


def _docs(n, seed):
    rng = np.random.default_rng(seed)
    kinds = ("psychic", "normal", "fire", "water")
    words = ("sleeps hours day teleport asleep eats naps fire burns water swims "
             "mountain cave fast slow giant tiny ghost night light").split()
    return [
        {"name": f"mon{i}",
         "info": {"type": kinds[i % 4],
                  "description": " ".join(rng.choice(words, size=rng.integers(3, 25)))}}
        for i in range(n)
    ]


def _same_state(jdb, tdb):
    assert tdb.documents == jdb.documents
    assert tdb.source_indices == jdb.source_indices
    assert tdb.split_info == jdb.split_info
    assert tdb._metadata_index == jdb._metadata_index
    assert set(tdb.document_keys) == set(jdb.document_keys)
    assert tdb.vectors.dtype == jdb.vectors.dtype
    np.testing.assert_array_equal(tdb.vectors, np.asarray(jdb.vectors))
    assert (tdb.size(), tdb.size(with_chunks=True)) == (jdb.size(), jdb.size(with_chunks=True))


def _same_hits(jhits, thits):
    assert [h[2] for h in thits] == [h[2] for h in jhits]
    assert [h[0] for h in thits] == [h[0] for h in jhits]
    np.testing.assert_allclose([h[1] for h in thits], [h[1] for h in jhits], rtol=0, atol=ATOL)


QUERIES = ["which one sleeps all day", "fire burns in the mountain cave",
           "a tiny ghost at night", "word " * 700]


@pytest.fixture
def text_dbs():
    docs = _docs(40, 0)
    jdb = JaxDB([dict(d) for d in docs], metadata_keys=["info.type"])
    tdb = TorchDB([dict(d) for d in docs], metadata_keys=["info.type"], device="cpu")
    assert isinstance(tdb._embedder(), TE.HashEmbedder)  # HYPERDB_DEFAULT_EMBEDDER=hash
    return jdb, tdb


def test_text_db_build_add_query(text_dbs):
    jdb, tdb = text_dbs
    _same_state(jdb, tdb)
    long_doc = {"name": "long", "info": {"type": "fire", "description": "burns " * 1300}}
    for db in (jdb, tdb):
        db.add(dict(long_doc))  # one document, three chunks
        db.add([dict(d) for d in _docs(5, 1)])
        db.add("a plain string document about sleeping")
    _same_state(jdb, tdb)
    assert tdb.split_info[40] > 1
    for q in QUERIES:
        _same_hits(jdb.query(q, top_k=7), tdb.query(q, top_k=7))
    filters = [("metadata", {"info.type": "fire"})]
    _same_hits(jdb.query(QUERIES[1], top_k=5, filters=filters),
               tdb.query(QUERIES[1], top_k=5, filters=filters))
    for jrow, trow in zip(jdb.query_batch(QUERIES, top_k=6), tdb.query_batch(QUERIES, top_k=6)):
        _same_hits(jrow, trow)
    got = TENG.generate_query_vectors_batch(tdb, QUERIES)
    want = JENG.generate_query_vectors_batch(jdb, QUERIES)
    np.testing.assert_array_equal(got, want)  # the long query: mean of its chunks
    assert TENG.generate_query_vectors_batch_device(tdb, QUERIES) is None  # hash: host path
    np.testing.assert_array_equal(tdb.generate_query_vector(QUERIES[0]),
                                  jdb.generate_query_vector(QUERIES[0]))
    ji, js = jdb.query_batch_arrays(want, top_k=8)
    ti, ts = tdb.query_batch_arrays(got, top_k=8)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=ATOL)


def test_text_db_remove_stream_metric(text_dbs):
    jdb, tdb = text_dbs
    for db in (jdb, tdb):
        db.add({"name": "long", "info": {"type": "water", "description": "swims " * 1100}})
        db.remove_document([1, -3, 0])
        added = db.add_stream(iter([dict(d) for d in _docs(11, 2)] + [None, {}]), batch_size=4)
        assert added == 11
    _same_state(jdb, tdb)
    for db in (jdb, tdb):
        db.set_ann_metric("dot")
    assert tdb.ann_metric == "dot" and tdb.vectors_normalized == jdb.vectors_normalized
    for metric in ("dot_product", "cosine_similarity", "euclidean_metric"):
        _same_hits(jdb.query(QUERIES[0], top_k=6, metric=metric),
                   tdb.query(QUERIES[0], top_k=6, metric=metric))


@pytest.mark.parametrize("filters", [
    [("sentence", ["sleeps"])],
    [("key", "name")],
    [("key", ["info.description", "name"]), ("metadata", {"info.type": "psychic"})],
    [("skip_doc", 2), ("sentence", "fire")],
])
def test_text_db_filters(text_dbs, filters):
    jdb, tdb = text_dbs
    _same_hits(jdb.query(QUERIES[2], top_k=5, filters=filters),
               tdb.query(QUERIES[2], top_k=5, filters=filters))


def test_list_helpers(text_dbs, tmp_path):
    jdb, tdb = text_dbs
    vecs = np.asarray(jdb.vectors)
    docs = jdb.documents
    assert tdb.tokenize("Sleeps, all DAY!") == jdb.tokenize("Sleeps, all DAY!")
    toks = tdb.tokenize("sleeps")
    assert [tdb.recursive_sentence_filter(d, toks) for d in docs] == [
        jdb.recursive_sentence_filter(d, toks) for d in docs
    ]
    tv, td, tk = tdb.apply_skip_doc(vecs, docs, 3)
    jv, jd, jk = jdb.apply_skip_doc(vecs, docs, 3)
    assert (td, tk) == (jd, jk)
    np.testing.assert_array_equal(tv, jv)
    tv, td = tdb.filter_by_sentence(vecs, docs, ["sleeps", "day"])
    jv, jd = jdb.filter_by_sentence(vecs, docs, ["sleeps", "day"])
    assert td == jd and len(tv) == len(jv)
    tv, td = tdb.filter_by_key(vecs, docs, ["name", "info.description"])
    jv, jd = jdb.filter_by_key(vecs, docs, ["name", "info.description"])
    assert td == jd
    np.testing.assert_array_equal(np.array(tv), np.array(jv))
    tdb.compute_and_save_word_frequencies(tmp_path / "t.txt")
    jdb.compute_and_save_word_frequencies(tmp_path / "j.txt")
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert tdb.text_to_chunks("word " * 600) == jdb.text_to_chunks("word " * 600)


class _FixedClock:
    """``datetime`` with a fixed ``now()``: a stamped document's text (and
    so its embedding) holds the timestamp."""

    class datetime:
        @staticmethod
        def now():
            return datetime.datetime(2026, 1, 2, 3, 4, 5)


def test_custom_embedding_function_and_timestamps(monkeypatch):
    """``make_embedding_function`` over a hash encoder and the word chunker,
    and a per-call timestamp stamped into the document."""
    monkeypatch.setattr(JDB_MODULE, "datetime", _FixedClock)
    monkeypatch.setattr(TDB_MODULE, "datetime", _FixedClock)
    docs = _docs(12, 3)
    jef = JE.make_embedding_function(JE.HashEmbedder(dim=64), JC.WordTokenizer())
    tef = TE.make_embedding_function(TE.HashEmbedder(dim=64), TC.WordTokenizer())
    jdb = JaxDB([dict(d) for d in docs], embedding_function=jef)
    tdb = TorchDB([dict(d) for d in docs], embedding_function=tef, device="cpu")
    for db in (jdb, tdb):
        db.add(["x " * 600, "short one"])
        db.add({"name": "stamped"}, add_timestamp=True)
    _same_state(jdb, tdb)
    assert tdb.split_info == {**dict.fromkeys(range(12), 1), 12: 2, 13: 1, 14: 1}
    assert tdb.documents[-1]["metadata"]["timestamp"] == _FixedClock.datetime.now().timestamp()
    assert TENG._default_embed_path(tdb)[0] is tef.embedder
    _same_hits(jdb.query("giant ghost", top_k=4), tdb.query("giant ghost", top_k=4))


def test_device_block_rides_into_the_scan(text_dbs):
    """A 2-D tensor on the DB's device is scanned as it is, its pad rows
    sliced off by ``n_valid``; a tensor elsewhere raises."""
    _, tdb = text_dbs
    q = TENG.generate_query_vectors_batch(tdb, QUERIES[:3])
    block = torch.zeros((4, q.shape[1]))
    block[:3] = torch.from_numpy(q)
    ids, vals = tdb.query_batch_arrays(block, top_k=5, n_valid=3)
    want_ids, want_vals = tdb.query_batch_arrays(q, top_k=5)
    assert ids.shape == (3, 5)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(vals, want_vals)
    with pytest.raises(ValueError, match="query block is on meta"):
        tdb.query_batch_arrays(torch.zeros((4, q.shape[1]), device="meta"), top_k=5)


def test_warmup_runs_every_shape(text_dbs, capsys):
    """``warmup`` runs each batch bucket, wire dtype and the text path once
    and leaves the DB as it was; a text embedder of another width than the
    corpus skips the text warm-up, as in the JAX package."""
    jdb, tdb = text_dbs
    before = tdb.query(QUERIES[0], top_k=5)
    tdb.warmup(top_ks=(5,), max_batch=4, text_max_batch=2, text_seq_tokens=(3,))
    _same_state(jdb, tdb)
    _same_hits(before, tdb.query(QUERIES[0], top_k=5))
    tdb._embedder_obj = TE.HashEmbedder(dim=16)
    tdb.warmup(top_ks=(5,), text_max_batch=2)
    assert "skipping text warmup" in capsys.readouterr().out


@pytest.mark.parametrize("precision,metric", [
    ("auto", "cosine_similarity"), ("auto", "dot_product"), ("auto", "pearson_correlation"),
    ("auto", "euclidean_metric"), ("int8-pure", "cosine_similarity"), ("int8", "cosine_similarity"),
])
def test_device_block_takes_every_route(monkeypatch, precision, metric):
    """A query block on the DB's device takes each grouped route a host block
    takes, with the same answers: the int8 routes normalise it on the device
    and pearson centres it there, where the host block does both in NumPy
    (another summation order: scores within 1e-5, and an id may differ only
    where the two scores at its rank agree within that)."""
    from hyperdb_tpu_torch.config import CONFIG as TORCH_CONFIG

    monkeypatch.setattr(TORCH_CONFIG, "grouped_topk_min_rows", 1024)
    rng = np.random.default_rng(7)
    v = rng.standard_normal((4096, 64)).astype(np.float16)
    q = rng.standard_normal((512, 64)).astype(np.float32)
    db = TorchDB([{"i": i} for i in range(4096)], v, fp_precision="float16",
                 device_precision=precision, device="cpu")
    hi, hs = db.query_batch_arrays(q, top_k=10, metric=metric)
    bi, bs = db.query_batch_arrays(torch.from_numpy(q), top_k=10, metric=metric, n_valid=500)
    assert bi.shape == (500, 10)
    np.testing.assert_allclose(bs, hs[:500], rtol=0, atol=1e-5)
    differ = bi != hi[:500]
    assert differ.mean() < 0.01
    assert (np.abs(bs - hs[:500])[differ] <= 1e-5).all()
