"""``hyperdb_tpu_torch.models.finetune`` on the CPU: the four tests of
``tests/test_finetune.py`` on the port, and the port's ``finetune`` beside
the JAX package's from the same carried weights.

Parity: MiniLM-L6 from the JAX package's seeded Flax init (f32 weights,
bf16 compute in both packages), the same pairs and seed. The batches reach
the tokenizer in the same order, text for text; each step's loss is within
5e-3 relative (bf16 compute: the first loss of a batch, before any update,
differs by bf16 rounding alone, and Adam turns the bf16 gradients' sign
noise into updates of up to lr on a small share of the weights); the
trained embedders' rows have cosine at least 0.999. Both packages refuse
the same inputs with the same ``ValueError``.
"""

import jax
import numpy as np
import pytest
import torch

from hyperdb_tpu.models import finetune as JF
from hyperdb_tpu.models import minilm as JM
from hyperdb_tpu.parallel import make_mesh as jax_make_mesh
from hyperdb_tpu_torch.models import finetune as TF
from hyperdb_tpu_torch.models import minilm as TM
from hyperdb_tpu_torch.models.finetune import finetune
from hyperdb_tpu_torch.parallel import make_mesh

PAIRS = [
    ("sleepy creature", "a creature that sleeps all day in warm caves"),
    ("river hunter", "hunts fish along the river shallows at dawn"),
    ("storm flier", "rides mountain storms on wide wings"),
    ("rock burrower", "digs deep tunnels beneath the cold rocks"),
    ("night singer", "sings at dusk to mark its territory"),
    ("tide dweller", "hides in tide pools until the sea returns"),
    ("sun sleeper", "dozes in the sun and wakes only to feed"),
    ("plain racer", "races thunderstorms across the open plains"),
]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite's workers share the machine's cores: this module's torch
    ops take two threads each rather than one per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_finetune_reduces_loss():
    emb = finetune(PAIRS * 4, epochs=3, batch_size=8, seq_len=16, learning_rate=1e-4,
                   device="cpu")
    first, last = emb.losses[0], np.mean(emb.losses[-3:])
    assert last < first, f"loss did not decrease: {first} -> {last}"


def test_finetuned_embedder_encodes():
    emb = finetune(PAIRS, epochs=1, batch_size=4, seq_len=16, device="cpu")
    out = emb.encode(["sleepy creature", "storm flier"])
    assert out.shape == (2, 384)
    assert np.isfinite(out).all()
    assert emb.device == torch.device("cpu") and len(emb.losses) == 2


def test_finetune_requires_pairs():
    with pytest.raises(ValueError):
        finetune([("a", "b")], device="cpu")


def test_finetune_on_mesh():
    mesh = make_mesh(8, device="cpu")
    emb = finetune(PAIRS, mesh=mesh, epochs=1, batch_size=8, seq_len=16)
    assert emb.encode(["x"]).shape == (1, 384)
    assert emb.device == torch.device("cpu")


def _record_batches(monkeypatch, module) -> list:
    seen = []
    real = module._tokenize_batch

    def recording(texts, tokenizer, seq_len):
        seen.append(list(texts))
        return real(texts, tokenizer, seq_len)

    monkeypatch.setattr(module, "_tokenize_batch", recording)
    return seen


def test_finetune_matches_jax(monkeypatch):
    tree = JM.init_params(seed=0)[1]  # f32 weights, as the JAX trainer starts
    pairs = PAIRS
    kw = dict(epochs=2, batch_size=4, seq_len=16, learning_rate=1e-4, seed=3)
    jax_seen, port_seen = _record_batches(monkeypatch, JF), _record_batches(monkeypatch, TF)
    jemb = JF.finetune(pairs, params=tree, **kw)
    params = TM.params_from_flax(jax.tree_util.tree_map(np.asarray, tree), dtype=torch.float32)
    temb = TF.finetune(pairs, params=params, device="cpu", **kw)
    assert port_seen == jax_seen and len(port_seen) == 2 * 4  # q and d texts, 4 steps
    assert len(temb.losses) == len(jemb.losses) == 4
    np.testing.assert_allclose(temb.losses, jemb.losses, rtol=5e-3)
    texts = ["sleepy creature", "a creature that rides storms", "tide pools"]
    want, got = jemb.encode(texts), temb.encode(texts)
    assert np.min(np.sum(want * got, axis=1)) >= 0.999
    # the carried weights were copied, not trained in place
    assert torch.equal(params["tok_emb.weight"],
                       TM.params_from_flax(jax.tree_util.tree_map(np.asarray, tree),
                                           dtype=torch.float32)["tok_emb.weight"])


@pytest.mark.parametrize("case", ["one_pair", "mesh_too_wide"])
def test_finetune_refuses_as_jax(case):
    if case == "one_pair":
        pairs, jkw, tkw = [("a", "b")], {}, {"device": "cpu"}
    else:  # 5 pairs cannot fill one batch divisible by an 8-way 'data' axis
        pairs = PAIRS[:5]
        jkw, tkw = {"mesh": jax_make_mesh(8)}, {"mesh": make_mesh(8, device="cpu")}
    with pytest.raises(ValueError) as want:
        JF.finetune(pairs, **jkw)
    with pytest.raises(ValueError) as got:
        finetune(pairs, **tkw)
    assert str(got.value) == str(want.value)


def test_finetune_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        finetune(PAIRS)
