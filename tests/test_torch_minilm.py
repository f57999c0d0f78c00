"""The encoder: ``hyperdb_tpu_torch.models.minilm`` against the Flax
``hyperdb_tpu.models.minilm``, on the CPU.

Parameters cross by ``params_from_flax`` (the same function the port's
``from_local_assets`` loads the in-repo npz through), so both packages run
bit-equal weights. The forwards then differ only by the order of f32 sums
and where a bf16 rounding lands, so embeddings (unit rows, f32) are held to
``MAX_ABS`` element-wise and ``MIN_COS`` per row. Top-10 ids over a text
corpus must be the JAX package's except where the JAX scores of the two ids
at a rank lie within ``MAX_ABS`` of each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperdb_tpu.models import minilm as JM
from hyperdb_tpu_torch.models import minilm as TM

MAX_ABS = 5e-3  # measured on this suite's inputs: 1.8e-3 (small), 1.0e-3 (local-384)
MIN_COS = 0.9999  # measured: 0.99999 (small), 0.99998 (local-384)
SMALL = dict(hidden=64, layers=2, heads=4, intermediate=128, vocab_size=512, max_positions=64)


def _flax_tree(cfg, seed):
    """Seeded numpy parameters in the Flax module's tree layout."""
    rng = np.random.default_rng(seed)
    h = cfg.hidden

    def lin(i, o):
        return {"kernel": (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32),
                "bias": (0.02 * rng.standard_normal(o)).astype(np.float32)}

    def ln(n):
        return {"scale": (1 + 0.1 * rng.standard_normal(n)).astype(np.float32),
                "bias": (0.02 * rng.standard_normal(n)).astype(np.float32)}

    def emb(n):
        return {"embedding": (0.5 * rng.standard_normal((n, h))).astype(np.float32)}

    tree = {"tok_emb": emb(cfg.vocab_size), "pos_emb": emb(cfg.max_positions),
            "type_emb": emb(2), "emb_ln": ln(h)}
    for i in range(cfg.layers):
        tree[f"layer_{i}"] = {
            "query": lin(h, h), "key": lin(h, h), "value": lin(h, h),
            "attn_output": lin(h, h), "attn_ln": ln(h),
            "intermediate": lin(h, cfg.intermediate), "output": lin(cfg.intermediate, h),
            "ffn_ln": ln(h),
        }
    return tree


def _jax_params(tree, path=()):
    """The JAX package's cast (``load_saved_params``): layer norms f32, the
    rest bf16."""
    if isinstance(tree, dict):
        return {k: _jax_params(v, path + (k,)) for k, v in tree.items()}
    f32 = path[-1] == "scale" or path[-2].endswith("_ln")
    return jnp.asarray(tree, dtype=jnp.float32 if f32 else jnp.bfloat16)


def _close(jax_emb, port_emb):
    assert port_emb.shape == jax_emb.shape and port_emb.dtype == np.float32
    assert np.isfinite(port_emb).all()
    max_abs = float(np.abs(port_emb - jax_emb).max())
    min_cos = float((port_emb * jax_emb).sum(axis=1).min())
    assert max_abs <= MAX_ABS, max_abs
    assert min_cos >= MIN_COS, min_cos


def _ids(rng, b, s, vocab):
    ids = rng.integers(4, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), dtype=np.int32)
    for i, n in enumerate(rng.integers(1, s + 1, b)):
        mask[i, n:] = 0
        ids[i, n:] = 0
    return ids, mask


@pytest.mark.parametrize("seed,s", [(0, 32), (1, 64), (2, 8)])
def test_small_config_matches_flax(seed, s):
    jcfg, tcfg = JM.EncoderConfig(**SMALL), TM.EncoderConfig(**SMALL)
    tree = _flax_tree(jcfg, seed)
    ids, mask = _ids(np.random.default_rng(seed + 10), 16, s, jcfg.vocab_size)
    want = np.asarray(JM.MiniLM(config=jcfg).apply(
        {"params": _jax_params(tree)}, jnp.asarray(ids), jnp.asarray(mask)
    ))
    model = TM.MiniLM(tcfg, device="cpu")
    model.load_state_dict(TM.params_from_flax({"params": tree}))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    _close(want, got)


def test_params_from_flax_layout_and_dtypes():
    cfg = TM.EncoderConfig(**SMALL)
    tree = _flax_tree(JM.EncoderConfig(**SMALL), 3)
    sd = TM.params_from_flax(tree)
    assert set(sd) == set(TM.MiniLM(cfg, device="meta").state_dict())
    w = sd["layers.1.intermediate.weight"]
    assert w.shape == (128, 64) and w.dtype == torch.bfloat16  # (out, in)
    np.testing.assert_array_equal(
        w.float().numpy(), np.asarray(_jax_params(tree)["layer_1"]["intermediate"]["kernel"],
                                      dtype=np.float32).T,
    )
    assert sd["layers.0.attn_ln.bias"].dtype == torch.float32
    assert sd["emb_ln.weight"].dtype == torch.float32
    assert sd["tok_emb.weight"].dtype == torch.bfloat16


@pytest.fixture(scope="module")
def encoders():
    return JM.MiniLMEmbedder.from_local_assets(), TM.MiniLMEmbedder.from_local_assets(device="cpu")


def test_local_assets_params_bit_equal(encoders):
    """The in-repo npz gives the port the JAX package's parameters bit for
    bit: the port's loader and ``params_from_flax`` of the JAX tree agree."""
    jenc, tenc = encoders
    assert tenc.config.__dict__ == jenc.config.__dict__
    assert tenc.max_seq == jenc.max_seq and tenc.dim == jenc.dim == 384
    carried = TM.params_from_flax(jax.tree_util.tree_map(np.asarray, jenc.params))
    loaded = tenc.model.state_dict()
    assert set(carried) == set(loaded)
    for name, value in carried.items():
        assert torch.equal(value, loaded[name]), name


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    words = ("pokemon sleeps hours fire water grass electric psychic ghost rock "
             "dragon flies swims attacks quickly slowly large small red blue "
             "ancient forest cave mountain sea river city night day").split()
    return [" ".join(rng.choice(words, size=rng.integers(1, 40))) for _ in range(n)]


def test_prep_batch_matches(encoders):
    jenc, tenc = encoders
    texts = _texts(37, 4) + ["", "Ünïcödé wörds and 日本語", "x" * 600]
    for got, want in zip(tenc._prep_batch(texts), jenc._prep_batch(texts)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_local_384_matches_flax(encoders):
    jenc, tenc = encoders
    texts = _texts(32, 5)
    _close(jenc.encode(texts), tenc.encode(texts))


def test_local_384_top10_ids(encoders):
    """Top-10 over a 120-text corpus for 32 queries: the ids are the JAX
    package's except where the two ids' JAX scores lie within MAX_ABS."""
    jenc, tenc = encoders
    docs, queries = _texts(120, 6), _texts(32, 7)
    js = jenc.encode(queries) @ jenc.encode(docs).T
    ts = tenc.encode(queries) @ tenc.encode(docs).T
    ji = np.argsort(-js, axis=1, kind="stable")[:, :10]
    ti = np.argsort(-ts, axis=1, kind="stable")[:, :10]
    rows = np.arange(32)[:, None]
    differ = ti != ji
    assert differ.mean() < 0.1
    gap = np.abs(js[rows, ti] - js[rows, ji])
    assert (gap[differ] <= MAX_ABS).all()


def test_encode_device_contract(encoders):
    """The block stays on the encoder's device, padded to a power of two;
    its rows are encode()'s, and blocks past _MAX_BATCH are concatenated."""
    _, tenc = encoders
    texts = _texts(5, 8)
    block = tenc.encode_device(texts)
    assert isinstance(block, torch.Tensor) and block.device.type == "cpu"
    assert block.shape == (8, 384) and block.dtype == torch.float32
    assert torch.isfinite(block).all()
    np.testing.assert_array_equal(block[:5].numpy(), tenc.encode(texts))
    tenc._MAX_BATCH = 2  # an instance attribute shadows the class's
    try:
        multi = tenc.encode_device(texts)
    finally:
        del tenc._MAX_BATCH
    assert multi.shape == (8, 384)
    # other slice shapes take other CPU GEMM blockings: bf16-level differences
    np.testing.assert_allclose(multi[:5].numpy(), tenc.encode(texts), rtol=0, atol=MAX_ABS)
    assert tenc.encode_device([]) is None
    assert tenc.encode([]).shape == (0, 384)


def test_seeded_init_is_deterministic():
    # the hashing tokenizer's ids span the BERT vocab: keep its size
    cfg = TM.EncoderConfig(hidden=64, layers=1, heads=2, intermediate=128)
    a = TM.MiniLMEmbedder(config=cfg, device="cpu", seed=3)
    b = TM.MiniLMEmbedder(config=cfg, device="cpu", seed=3)
    c = TM.MiniLMEmbedder(config=cfg, device="cpu", seed=4)
    texts = ["alpha beta", "gamma delta epsilon"]
    np.testing.assert_array_equal(a.encode(texts), b.encode(texts))
    assert not np.array_equal(a.encode(texts), c.encode(texts))
    np.testing.assert_allclose(np.linalg.norm(a.encode(texts), axis=1), 1.0, rtol=1e-5)


def test_maybe_pretrained_is_none_in_both():
    assert JM.MiniLMEmbedder.maybe_pretrained() is None
    assert TM.MiniLMEmbedder.maybe_pretrained(device="cpu") is None
    assert TM.MiniLMEmbedder.maybe_pretrained(dim=768, device="cpu") is None


def test_missing_assets_give_none(tmp_path):
    assert TM.MiniLMEmbedder.from_local_assets(str(tmp_path), device="cpu") is None
    assert JM.MiniLMEmbedder.from_local_assets(str(tmp_path)) is None


def test_text_db_with_local_encoder(encoders):
    """A text DB embedded by the local-384 encoder through
    ``make_embedding_function`` in both packages: equal bookkeeping, rows
    within the encoder tolerance, and the same top-10 up to near-ties; the
    device-block query path gives the host path's answers."""
    from hyperdb_tpu import HyperDB as JaxDB
    from hyperdb_tpu.models.embedder import make_embedding_function as jmake
    from hyperdb_tpu.query import engine as JENG
    from hyperdb_tpu_torch import HyperDB as TorchDB
    from hyperdb_tpu_torch.models.embedder import make_embedding_function as tmake
    from hyperdb_tpu_torch.query import engine as TENG

    jenc, tenc = encoders
    docs = [{"name": f"mon{i}", "info": {"type": "fire" if i % 2 else "water", "text": t}}
            for i, t in enumerate(_texts(40, 9))]
    jdb = JaxDB([dict(d) for d in docs], embedding_function=jmake(jenc, jenc.chunk_tokenizer))
    tdb = TorchDB([dict(d) for d in docs], embedding_function=tmake(tenc, tenc.chunk_tokenizer),
                  device="cpu")
    assert (tdb.documents, tdb.source_indices, tdb.split_info) == (
        jdb.documents, jdb.source_indices, jdb.split_info)
    _close(np.asarray(jdb.vectors), tdb.vectors)

    queries = _texts(8, 10)
    jq = JENG.generate_query_vectors_batch(jdb, queries)
    tq = TENG.generate_query_vectors_batch(tdb, queries)
    _close(jq, tq)
    ji, _ = jdb.query_batch_arrays(jq, top_k=10)
    ti, ts = tdb.query_batch_arrays(tq, top_k=10)
    js = jq @ np.asarray(jdb.vectors).T  # unit rows: the JAX cosines
    rows = np.arange(8)[:, None]
    differ = ti != ji
    assert (np.abs(js[rows, ti] - js[rows, ji])[differ] <= MAX_ABS).all()

    block = TENG.generate_query_vectors_batch_device(tdb, queries)
    assert isinstance(block, torch.Tensor) and block.shape == (8, 384)
    bi, bs = tdb.query_batch_arrays(block, top_k=10, n_valid=8)
    np.testing.assert_array_equal(bi, ti)
    np.testing.assert_array_equal(bs, ts)
    jblock = JENG.generate_query_vectors_batch_device(jdb, queries)
    _close(np.asarray(jblock), block.numpy())
