"""The port's local training data, WordPiece trainer and encoder files
against the JAX package's, on the CPU.

``hyperdb_tpu_torch.models.localdata`` is a copy of the JAX module: every
function must return the JAX function's output on this machine, list for
list (seeded draws and sorted walks over local files). ``train_wordpiece``
must learn the same vocabulary, token for token. ``save_params`` writes the
JAX npz layout: a file written by either package loads in the other's
``load_saved_params`` to the same float16 values, and a port-written asset
directory loads through ``MiniLMEmbedder.from_local_assets``. The mirrors of
``tests/test_encoder_local.py`` run on the port with ``device="cpu"``.

The slow file walks (the stdlib's docstrings, its held-out subpackages) are
compared once; the functions built on them then read those (equal) lists
in both packages, so each walk runs once per package.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperdb_tpu.models import localdata as JL
from hyperdb_tpu.models import minilm as JM
from hyperdb_tpu.models import wordpiece as JW
from hyperdb_tpu_torch.models import localdata as L
from hyperdb_tpu_torch.models import minilm as TM
from hyperdb_tpu_torch.models.wordpiece import (
    SPECIALS,
    WordPieceTokenizer,
    train_wordpiece,
)

TINY = dict(hidden=32, layers=1, heads=2, intermediate=64, max_positions=64)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite's workers share the machine's cores: this module's torch
    ops take two threads each rather than one per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stdlib_walks():
    """(JAX, port) outputs of the two stdlib walks at their defaults."""
    return ((JL.stdlib_texts(), JL.stdlib_heldout_texts()),
            (L.stdlib_texts(), L.stdlib_heldout_texts()))


@pytest.fixture
def cached_walks(stdlib_walks, monkeypatch):
    """Each module reads its own walks' (equal) outputs at the defaults."""
    for module, (texts, heldout) in zip((JL, L), stdlib_walks):
        def stdlib_texts(max_files=400, min_len=60, _t=texts):
            assert (max_files, min_len) == (400, 60)
            return list(_t)

        def stdlib_heldout_texts(min_len=60, max_texts=4000, _h=heldout):
            assert (min_len, max_texts) == (60, 4000)
            return list(_h)

        monkeypatch.setattr(module, "stdlib_texts", stdlib_texts)
        monkeypatch.setattr(module, "stdlib_heldout_texts", stdlib_heldout_texts)


def test_stdlib_walks_equal_jax(stdlib_walks):
    (jt, jh), (tt, th) = stdlib_walks
    assert tt == jt and th == jh
    assert len(tt) > 20 and len(th) >= 300
    assert L.stdlib_texts(max_files=30) == JL.stdlib_texts(max_files=30)
    assert L.stdlib_heldout_texts(max_texts=200) == JL.stdlib_heldout_texts(max_texts=200)


GENERATED = {
    "concept_corpus": lambda m: m.concept_corpus(num_docs=300, seed=4),
    "concept_corpus_hard": lambda m: m.concept_corpus(num_docs=200, seed=5, pool=m.CONCEPTS_HARD),
    "training_pairs": lambda m: m.training_pairs(3000, seed=2),
    "training_pairs_hard": lambda m: m.training_pairs(500, seed=3, pool=m.CONCEPTS_HARD),
    "retrieval_eval_set": lambda m: m.retrieval_eval_set(),
    "retrieval_eval_set_hard": lambda m: m.retrieval_eval_set(400, 80, pool=m.CONCEPTS_HARD),
    "retrieval_eval_ceiling": lambda m: m.retrieval_eval_ceiling(),
    "paraphrase_query": lambda m: [
        m.paraphrase_query(k, 1, np.random.default_rng(i), "tide") for i, k in
        enumerate(sorted(m.CONCEPTS))],
    "paraphrase_query2": lambda m: [
        m.paraphrase_query2(c, s, np.random.default_rng(i), "stone") for i, (c, s) in
        enumerate(zip(*m.concept_corpus(num_docs=40, seed=9)[1:3]))],
    "span_pairs": lambda m: m.span_pairs(m.stdlib_texts(max_files=40), 300, seed=7,
                                         crops_per_text=3),
    "all_package_roots": lambda m: m.all_package_roots(),
    "constants": lambda m: (m.CONCEPTS, m.CONCEPTS_EXTRA, m.TYPES, m.PACKAGE_PROSE_ROOTS),
}


@pytest.mark.parametrize("name", sorted(GENERATED))
def test_generated_data_equals_jax(name):
    assert GENERATED[name](L) == GENERATED[name](JL)


WALKS = {
    "stdlib_span_pairs": lambda m: m.stdlib_span_pairs(),
    "heldout_span_eval_set": lambda m: m.heldout_span_eval_set(),
    "heldout_span_eval_set_skip": lambda m: m.heldout_span_eval_set(num_docs=50, skip_docs=800),
    "package_texts": lambda m: m.package_texts(packages=("numpy", "scipy"), max_texts=300,
                                               with_source=True),
    "image_texts": lambda m: m.image_texts(max_texts=300),
}


@pytest.mark.parametrize("name", sorted(WALKS))
def test_local_text_equals_jax(name, cached_walks):
    got, want = WALKS[name](L), WALKS[name](JL)
    assert got == want and len(got) > 0


def test_evaluate_retrieval_equals_jax():
    from hyperdb_tpu_torch.models.embedder import HashEmbedder

    eval_set = L.retrieval_eval_set(num_docs=200, num_queries=50)
    enc = HashEmbedder(dim=384).encode
    assert L.evaluate_retrieval(enc, ks=(1, 5, 10), eval_set=eval_set) == \
        JL.evaluate_retrieval(enc, ks=(1, 5, 10), eval_set=eval_set)


# ---------------------------------------------------------------- WordPiece


VOCAB_CASES = {
    "low": (["low lower lowest " * 50], 40),
    "hello": (["hello world " * 10], 64),
    "stdlib": (None, 2000),  # stdlib_texts(max_files=20)[:50]
    "pairs": (None, 512),  # the texts of training_pairs(200, seed=5)
    "min_freq": (["abcab abcab xyz " * 3, "xyx"], 200),
}


@pytest.mark.parametrize("case", sorted(VOCAB_CASES))
def test_train_wordpiece_equals_jax(case):
    texts, size = VOCAB_CASES[case]
    if case == "stdlib":
        texts = L.stdlib_texts(max_files=20)[:50]
    elif case == "pairs":
        texts = [t for p in L.training_pairs(200, seed=5) for t in p]
    got = train_wordpiece(texts, vocab_size=size)
    assert got == JW.train_wordpiece(texts, vocab_size=size)
    assert got[:4] == list(SPECIALS)
    if case == "min_freq":
        assert train_wordpiece(texts, 200, min_pair_freq=4) == \
            JW.train_wordpiece(texts, 200, min_pair_freq=4)


class TestWordPiece:
    def test_train_learns_frequent_merges(self):
        vocab = train_wordpiece(["low lower lowest " * 50], vocab_size=40)
        tok = WordPieceTokenizer(vocab)
        assert "low" in vocab
        assert tok.word_ids("low") == [tok.token_to_id["low"]]

    def test_greedy_longest_match(self):
        vocab = list(SPECIALS) + ["un", "##able", "##b", "a", "##ble", "unable"]
        tok = WordPieceTokenizer(vocab)
        assert tok.word_ids("unable") == [tok.token_to_id["unable"]]

    def test_unk_for_unsplittable(self):
        tok = WordPieceTokenizer(list(SPECIALS) + ["a", "##b"])
        assert tok.word_ids("xyz") == [tok.unk_id]

    def test_encode_decode_roundtrip(self):
        vocab = train_wordpiece(L.stdlib_texts(max_files=20)[:50], vocab_size=2000)
        tok = WordPieceTokenizer(vocab)
        sample = "the quick brown fox jumps over the lazy dog"
        ids = tok.encode(sample)
        assert tok.decode(ids) == sample
        assert ids == JW.WordPieceTokenizer(vocab).encode(sample)

    def test_model_interface_specials(self):
        tok = WordPieceTokenizer(train_wordpiece(["hello world " * 10], vocab_size=64))
        ids, mask = tok.encode("hello world", 16)
        assert ids[0] == tok.cls_id and ids[-1] == tok.sep_id
        assert len(ids) == len(mask) and all(m == 1 for m in mask)
        assert tok.pad_id == 0

    def test_max_len_truncation(self):
        tok = WordPieceTokenizer(train_wordpiece(["word " * 30], vocab_size=64))
        ids, _ = tok.encode("word " * 30, 8)
        assert len(ids) == 8 and ids[-1] == tok.sep_id

    def test_save_load(self, tmp_path):
        tok = WordPieceTokenizer(train_wordpiece(["alpha beta gamma " * 20], vocab_size=128))
        p = str(tmp_path / "vocab.txt")
        tok.save(p)
        assert WordPieceTokenizer.load(p).vocab == tok.vocab == JW.WordPieceTokenizer.load(p).vocab
        assert WordPieceTokenizer.load(p).encode("alpha beta", 16) == tok.encode("alpha beta", 16)

    def test_chunker_integration(self):
        from hyperdb_tpu_torch.core.chunker import text_to_chunks

        tok = WordPieceTokenizer(train_wordpiece(["word " * 50], vocab_size=64))
        chunks = text_to_chunks("word " * 700, tok, max_length=510)
        assert len(chunks) == 2
        assert chunks[0].split()[0] == "word"


class TestLocalData:
    def test_eval_set_deterministic(self):
        a = L.retrieval_eval_set(num_docs=50, num_queries=10)
        assert a == L.retrieval_eval_set(num_docs=50, num_queries=10)

    def test_query_surface_differs_from_doc(self):
        docs, queries, targets = L.retrieval_eval_set(num_docs=100, num_queries=40)
        assert sum(1 for q, t in zip(queries, targets) if q[12:] in docs[t]) == 0

    def test_training_pairs_shapes(self):
        pairs = L.training_pairs(100)
        assert len(pairs) == 100
        assert all(isinstance(q, str) and isinstance(d, str) for q, d in pairs)

    def test_span_pairs_random_crops(self):
        texts = [
            "First sentence with enough words to pass the length cut here. "
            "Second sentence also has plenty of words in it for the test. "
            "Third sentence rounds out the paragraph with more material.",
        ] * 5
        pairs = L.span_pairs(texts, 20, seed=3, crops_per_text=3)
        assert 0 < len(pairs) <= 20
        for a, b in pairs:
            assert len(a) >= 40 and len(b) >= 40 and a != b
        assert pairs == L.span_pairs(texts, 20, seed=3, crops_per_text=3)
        assert pairs == JL.span_pairs(texts, 20, seed=3, crops_per_text=3)

    def test_heldout_eval_skip_docs_disjoint(self, cached_walks):
        first = L.heldout_span_eval_set(num_docs=20)
        later = L.heldout_span_eval_set(num_docs=20, skip_docs=20)
        assert first[0] and later[0]
        assert not set(first[0]) & set(later[0])

    def test_package_texts_hygiene(self, cached_walks):
        texts = L.package_texts(packages=("numpy",), max_texts=50)
        assert len(texts) == 50 and all(len(t) >= 60 for t in texts)
        assert not set(L.stdlib_heldout_texts()) & set(texts)
        tagged = L.package_texts(packages=("numpy",), max_texts=50, with_source=True)
        assert [t for _, t in tagged] == texts and {p for p, _ in tagged} == {"numpy"}

    def test_image_texts_are_prose(self, cached_walks):
        texts = L.image_texts(max_texts=100)
        assert len(texts) == 100
        for t in texts[:50]:
            assert len(t) >= 80 and L._SENTENCE_RE.search(t)
            assert sum(c.isalpha() or c == " " for c in t) / len(t) >= 0.8
        assert not set(L.stdlib_heldout_texts()) & set(texts)

    def test_evaluate_retrieval_perfect_encoder(self):
        docs, queries, targets = L.retrieval_eval_set(num_docs=30, num_queries=10)

        def oracle_encode(texts):
            out = np.zeros((len(texts), 30), dtype=np.float32)
            for i, t in enumerate(texts):
                out[i, docs.index(t) if t in docs else targets[queries.index(t)]] = 1.0
            return out

        metrics = L.evaluate_retrieval(oracle_encode, eval_set=(docs, queries, targets))
        assert metrics["recall@1"] == 1.0 and metrics["mrr"] == 1.0

    def test_hash_encoder_ood_floor(self, cached_walks):
        from hyperdb_tpu_torch.models.embedder import HashEmbedder

        m = L.evaluate_retrieval(HashEmbedder(dim=384).encode,
                                 eval_set=L.heldout_span_eval_set(num_docs=120))
        assert m["recall@10"] >= 0.4, m


# ---------------------------------------------------------------- encoder files


def _tiny_assets(tmp_path, vocab_size: int = 256):
    """A tiny encoder directory written by the port: vocab, weights (the
    port's seeded init), manifest. Returns the weights."""
    vocab = train_wordpiece([t for p in L.training_pairs(50) for t in p], vocab_size=vocab_size)
    WordPieceTokenizer(vocab).save(str(tmp_path / "vocab.txt"))
    config = dict(TINY, vocab_size=max(vocab_size, len(vocab)))
    params = TM.init_params(TM.EncoderConfig(**config), seed=0)
    TM.save_params(params, str(tmp_path / "encoder_local.npz"))
    with open(tmp_path / "manifest.json", "w") as f:
        json.dump({"config": config}, f)
    return params


def test_save_params_loads_in_jax(tmp_path):
    """Port -> JAX: the JAX loader reads every leaf of a port-written file
    at the float16 value the port wrote; the port's own loader agrees."""
    params = _tiny_assets(tmp_path)
    path = str(tmp_path / "encoder_local.npz")
    tree = JM.load_saved_params(path, dtype=jnp.float32)
    want = TM.params_to_flax({k: v.half() for k, v in params.items()})
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves(tree)
    assert len(flat_w) == len(flat_g)
    for (path_, w), g in zip(flat_w, flat_g):
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=jax.tree_util.keystr(path_))
    back = TM.load_saved_params(path)
    assert set(back) == set(params)
    for k in params:
        torch.testing.assert_close(back[k].float(), params[k].half().float(), rtol=0, atol=0)


def test_jax_saved_params_load_in_the_port(tmp_path):
    """JAX -> port: ``hyperdb_tpu``'s ``save_params`` of a Flax init loads
    in the port to the same float16 values, and the port writes the same
    keys and values back."""
    config = JM.EncoderConfig(vocab_size=256, **TINY)
    params = JM.MiniLM(config=config).init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
                                           jnp.ones((1, 4), jnp.int32))
    path = str(tmp_path / "jax.npz")
    JM.save_params(params, path)
    got = TM.load_saved_params(path, dtype=torch.float32)
    want = TM.params_from_flax(jax.tree_util.tree_map(
        lambda x: np.asarray(x).astype(np.float16).astype(np.float32), params), torch.float32)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    again = str(tmp_path / "port.npz")
    TM.save_params(got, again)
    with np.load(path) as a, np.load(again) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype == np.float16
            np.testing.assert_array_equal(a[key], b[key])


def test_from_local_assets_end_to_end(tmp_path):
    _tiny_assets(tmp_path)
    emb = TM.MiniLMEmbedder.from_local_assets(str(tmp_path), device="cpu")
    assert emb is not None and emb.dim == 32
    out = emb.encode(["a creature that naps", "lives near water"])
    assert out.shape == (2, 32)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, rtol=1e-3)
    np.testing.assert_allclose(out, emb.encode(["a creature that naps", "lives near water"]),
                               atol=1e-6)
    assert emb.chunk_tokenizer is not None
    # the JAX package reads the same directory to the same encoder
    jemb = JM.MiniLMEmbedder.from_local_assets(str(tmp_path))
    want = jemb.encode(["a creature that naps", "lives near water"])
    assert np.abs(out - want).max() <= 5e-3


def test_from_local_assets_missing_dir(tmp_path):
    assert TM.MiniLMEmbedder.from_local_assets(str(tmp_path / "nope"), device="cpu") is None


class TestShippedAssets:
    @pytest.fixture(scope="class")
    def shipped(self):
        emb = TM.MiniLMEmbedder.from_local_assets(device="cpu")
        if emb is None:
            pytest.skip(f"no trained assets in {TM.ASSETS_DIR}")
        return emb

    def test_loads_and_encodes(self, shipped):
        out = shipped.encode(["a creature that naps in the sun"])
        assert out.shape == (1, 384)
        np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, rtol=1e-3)

    def test_beats_hash_on_heldout(self, shipped):
        from hyperdb_tpu_torch.models.embedder import HashEmbedder

        eval_set = L.retrieval_eval_set(num_docs=150, num_queries=30)
        local = L.evaluate_retrieval(shipped.encode, eval_set=eval_set)
        hash_m = L.evaluate_retrieval(HashEmbedder(dim=384).encode, eval_set=eval_set)
        assert local["recall@10"] > hash_m["recall@10"] and local["mrr"] > hash_m["mrr"]

    def test_shipped_encoder_sits_at_the_eval_ceiling(self):
        path = os.path.join(TM.ASSETS_DIR, "manifest.json")
        with open(path) as f:
            ev = json.load(f)["eval"]
        ceiling = L.retrieval_eval_ceiling()["recall@10"]
        assert 0.80 <= ceiling <= 0.92
        assert ev["local"]["recall@10"] >= ceiling - 0.05
        if "hard" in ev:  # the 56-concept benchmark: ceiling ~1.0
            hard = L.retrieval_eval_ceiling(pool=L.CONCEPTS_HARD)["recall@10"]
            assert hard >= 0.98 and ev["hard"]["recall@10"] >= hard - 0.05


def test_corpus_self_eval_set_equals_jax():
    from hyperdb_tpu.models.embedder import corpus_self_eval_set as jax_set
    from hyperdb_tpu_torch.models.embedder import corpus_self_eval_set

    rng = np.random.default_rng(11)
    texts = [" ".join(f"w{j}" for j in rng.integers(0, 300, rng.integers(5, 40)))
             for _ in range(120)]
    for max_docs, seed in ((400, 0), (50, 3)):
        assert corpus_self_eval_set(texts, max_docs, seed) == jax_set(texts, max_docs, seed)


def test_select_embedder_for_corpus_measures():
    """Mirror of the JAX test: on a word-overlap corpus the lexical family
    wins; the four candidates are measured on the CPU."""
    from hyperdb_tpu_torch.models.embedder import select_embedder_for_corpus

    rng = np.random.default_rng(9)
    vocab = [f"tok{j}" for j in range(600)]
    texts = [" ".join(rng.choice(vocab, size=24).tolist()) for _ in range(60)]
    best, emb, report = select_embedder_for_corpus(texts, max_docs=60, device="cpu")
    assert set(report) == {"hash_384", "lexical_4096", "trained_local", "hybrid_w70"}
    assert best in ("lexical_4096", "hash_384", "hybrid_w70") and hasattr(emb, "encode")
    assert report[best]["recall@10"] >= max(r["recall@10"] for r in report.values())
    with pytest.raises(ValueError, match="too small"):
        select_embedder_for_corpus(texts[:10], device="cpu")


def test_select_embedder_asks_for_the_card(monkeypatch):
    from hyperdb_tpu_torch.models.embedder import select_embedder_for_corpus

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    texts = [" ".join(f"w{i + j}" for j in range(14)) for i in range(30)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        select_embedder_for_corpus(texts)


def test_db_retrieval_with_tiny_trained_encoder():
    """Mirror of the JAX end-to-end test: a tiny encoder over a port-trained
    vocabulary plugs into ``HyperDB`` through ``make_embedding_function``."""
    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.models.embedder import make_embedding_function

    pairs = L.training_pairs(200, seed=5)
    tok = WordPieceTokenizer(train_wordpiece([t for p in pairs for t in p], vocab_size=512))
    config = TM.EncoderConfig(vocab_size=max(512, tok.vocab_size), **TINY)
    emb = TM.MiniLMEmbedder(params=None, tokenizer=tok, config=config, device="cpu")
    docs, queries, _ = L.retrieval_eval_set(num_docs=30, num_queries=5)
    db = HyperDB(documents=[{"text": d} for d in docs],
                 embedding_function=make_embedding_function(emb, tok), device="cpu")
    assert len(db.query(queries[0], top_k=3)) == 3
