"""The port's training step (``hyperdb_tpu_torch.models.train``) against the
JAX package's, on the CPU.

A small encoder (hidden 32, 2 layers, 2 heads, intermediate 64, vocab 256)
takes seeded numpy batches (8 pairs of 16 tokens, ragged masks); the JAX
weights cross with ``params_from_flax`` and the gradients come back with
``params_to_flax``. Tolerances:

- f32 weights and compute: loss within 1e-6 relative; every gradient
  element within 2e-6 absolute plus 1e-5 relative (the largest gradient is
  about 1); AdamW steps (lr 1e-3) within 2e-6 of optax's parameters. These
  are f32 sums in different orders. After a step the exception is a weight
  whose gradient is below 1e-6 (the key projections' biases, whose
  gradient is zero in exact arithmetic, and rows that barely take part):
  Adam divides each gradient by its own magnitude plus eps = 1e-8, so
  rounding noise of 1e-10 there moves the update by up to lr a step, of
  either sign. Such weights are held within 2 lr per step, and the losses
  after the first step within 1e-5 relative.
- bf16 weights and compute: both packages round every product and sum to
  bf16 in their own order, so about 60 % of the gradient elements differ by
  more than one bf16 ulp. The test holds each package to exact arithmetic
  instead: the port's gradients lie no farther (largest and RMS error, 1.5x
  margin) from the f32 gradient at the same bf16 weights than JAX's do, and
  the loss is within 5e-3 relative of JAX's and of the f32 loss (JAX's
  compiled and op-by-op bf16 losses alone differ by 2.5e-3 at seed 1). After an AdamW step the share of
  weights more than one ulp apart and the largest difference are bounded
  as stated at the test.
- The mesh steps (in one process, and over two gloo ranks) against the
  single-device step of the port: f32, 2e-6. An SGD step at lr 1 makes the
  update the gradient itself, which pins the factor of the reduction
  (AdamW would hide a constant factor).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hyperdb_tpu.models import minilm as JM
from hyperdb_tpu.models import train as JT
from hyperdb_tpu_torch.models import minilm as TM
from hyperdb_tpu_torch.models import train as TT
from hyperdb_tpu_torch.parallel.launch import free_port
from hyperdb_tpu_torch.parallel.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(hidden=32, layers=2, heads=2, intermediate=64, vocab_size=256, max_positions=64)
JCFG, TCFG = JM.EncoderConfig(**CFG), TM.EncoderConfig(**CFG)
F32_ATOL, F32_RTOL = 2e-6, 1e-5
LR = 1e-3

# (weights, compute) of each package; "mixed" is the JAX trainer's own
# setting from its Flax init: f32 weights, bf16 compute
DTYPES = {
    "f32": ((jnp.float32, jnp.float32), (torch.float32, torch.float32)),
    "bf16": ((jnp.bfloat16, jnp.bfloat16), (torch.bfloat16, torch.bfloat16)),
    "mixed": ((jnp.float32, jnp.bfloat16), (torch.float32, torch.bfloat16)),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite's workers share the machine's cores: this module's torch
    ops take two threads each rather than one per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed: int, b: int = 8, s: int = 16, lex: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    mask = np.ones((b, s), np.int32)
    mask[:, 10:] = rng.integers(0, 2, (b, s - 10))
    out = {
        "q_ids": rng.integers(5, CFG["vocab_size"], (b, s)).astype(np.int32),
        "q_mask": mask,
        "d_ids": rng.integers(5, CFG["vocab_size"], (b, s)).astype(np.int32),
        "d_mask": mask[::-1].copy(),
    }
    if lex:
        out["lex_sims"] = rng.uniform(-0.2, 0.6, (b, b)).astype(np.float32)
    return out


def _to_numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(jnp.asarray(x, jnp.float32)), tree)


def _jax_params(seed: int, dtype):
    """The JAX init at ``dtype``, layer norms f32 (``load_saved_params``'s
    casts)."""
    model = JM.MiniLM(dtype=jnp.float32, config=JCFG)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32),
                        jnp.ones((1, 8), jnp.int32))
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x if any(getattr(k, "key", "").endswith("_ln") for k in path)
        else x.astype(dtype), params)


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(tree)])


def _port(tree, tdtype, compute=None):
    """The JAX weights as a port state dict in ``tdtype``, and the port's
    model computing in ``compute`` (default: ``tdtype``)."""
    return (TM.params_from_flax(_to_numpy(tree), dtype=tdtype),
            TM.MiniLM(TCFG, dtype=compute or tdtype, device="cpu"))


def _port_value_and_grad(loss_fn, params, model, batch):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves, model, batch)
    loss.backward()
    return float(loss.detach()), TM.params_to_flax({k: v.grad for k, v in leaves.items()})


def _assert_params_close(got: dict, want: dict, grads: dict, n_steps: int):
    """Port state dicts after ``n_steps`` optimiser steps: within 2e-6,
    but weights whose first gradient (``grads``) is below 1e-6 within 2 lr
    a step (see the module note)."""
    for k in want:
        g, w = np.asarray(got[k], np.float32), np.asarray(want[k], np.float32)
        tol = np.where(np.abs(np.asarray(grads[k], np.float32)) < 1e-6, 2 * LR * n_steps, 2e-6)
        bad = np.abs(g - w) > tol
        assert not bad.any(), (k, int(bad.sum()), float(np.abs(g - w).max()))

def _jit_value_and_grad(fn):
    # one compiled program: far quicker on the CPU than op-by-op dispatch
    return jax.jit(jax.value_and_grad(fn), static_argnums=1)


LOSSES = {
    "info_nce": (_jit_value_and_grad(JT.info_nce_loss), TT.info_nce_loss),
    "distill": (_jit_value_and_grad(JT.info_nce_distill_loss), TT.info_nce_distill_loss),
}
JAX_STEP_GRAD = LOSSES["info_nce"][0]


@pytest.mark.parametrize("loss", sorted(LOSSES))
def test_loss_and_grads_f32_match_jax(loss):
    jloss_fn, tloss_fn = LOSSES[loss]
    batch = _batch(0, lex=loss == "distill")
    jp = _jax_params(0, jnp.float32)
    jl, jg = jloss_fn(jp, JM.MiniLM(dtype=jnp.float32, config=JCFG), batch)
    tp, tmodel = _port(jp, torch.float32)
    tl, tg = _port_value_and_grad(tloss_fn, tp, tmodel, batch)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-6)
    jg, tg = _to_numpy(jg), tg
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jg),
                                 jax.tree_util.tree_leaves(tg)):
        np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("loss", sorted(LOSSES))
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_grads_bf16_against_jax(loss, seed):
    jloss_fn, tloss_fn = LOSSES[loss]
    batch = _batch(seed, lex=loss == "distill")
    jp = _jax_params(seed, jnp.bfloat16)
    # exact arithmetic's answer at the same bf16 weights: f32 compute
    exact_loss, exact = jloss_fn(jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jp),
                                 JM.MiniLM(dtype=jnp.float32, config=JCFG), batch)
    exact = _flat(_to_numpy(exact))
    jl, jg = jloss_fn(jp, JM.MiniLM(dtype=jnp.bfloat16, config=JCFG), batch)
    tp, tmodel = _port(jp, torch.bfloat16)
    tl, tg = _port_value_and_grad(tloss_fn, tp, tmodel, batch)
    np.testing.assert_allclose(tl, float(jl), rtol=5e-3)
    np.testing.assert_allclose(tl, float(exact_loss), rtol=5e-3)
    want, got = _flat(_to_numpy(jg)), _flat(tg)
    share = float(np.mean(np.abs(got - want) > np.abs(want) * 2.0 ** -8))
    scale = np.abs(exact).max()
    jax_err = (np.abs(want - exact).max(), np.sqrt(np.mean((want - exact) ** 2)))
    port_err = (np.abs(got - exact).max(), np.sqrt(np.mean((got - exact) ** 2)))
    msg = (f"bf16 gradients: {share:.3f} of elements more than 1 ulp apart; largest difference "
           f"{np.abs(got - want).max() / scale:.4f} of the largest gradient; error to f32: "
           f"JAX {jax_err}, port {port_err}")
    assert port_err[0] <= 1.5 * jax_err[0] and port_err[1] <= 1.5 * jax_err[1], msg
    assert np.abs(got - want).max() <= 0.1 * scale, msg


def _optax_steps(jp, jmodel, batch, n: int):
    opt = optax.adamw(LR)
    state = opt.init(jp)
    losses = []
    for _ in range(n):
        loss, grads = JAX_STEP_GRAD(jp, jmodel, batch)
        updates, state = opt.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        losses.append(float(loss))
    return jp, losses


def _port_steps(params, model, batch, n: int, mesh=None, opt=None, opt_state=None):
    opt = opt or TT.make_adamw(params, LR)
    opt_state = opt_state if opt_state is not None else TT.init_opt_state(params)
    step = TT.make_train_step(mesh, model, opt, params, donate=False)
    losses = []
    for _ in range(n):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    return params, losses


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_adamw_steps_match_optax(n_steps, dtype):
    """One and three AdamW steps from the same weights on the same batch.
    f32: parameters within 2e-6 (lr 1e-3) and losses within 1e-6 relative.
    bf16: most updates of lr 1e-3 are under a weight's half ulp and round
    away in both packages; optax's ``p - lr * (adam + wd * p)`` and torch's
    ``p * (1 - lr * wd) - lr * adam`` round differently when they do not.
    Where the two bf16 gradients differ in sign (noise-sized gradients),
    Adam's normalised updates differ by up to 2 lr a step (bf16 moments
    round the normalised update to at most 1 % past 1). Bound: at most
    5 % of the weights more than one ulp apart, none more than 4 ulps (of
    the larger magnitude) plus 2.1 lr per step apart (measured: 0.6 % and
    2.6 % of the weights more than one ulp apart after 1 and 3 steps).
    mixed (f32 weights, bf16 compute, the JAX trainer's own setting): no
    rounding of the update, so only the sign noise: at most 5 % of the
    weights more than 0.1 lr apart (measured 0.6 % and 2.4 %), none more
    than 2 lr per step."""
    (jdtype, jcompute), (tdtype, tcompute) = DTYPES[dtype]
    batch = _batch(2)
    jp = _jax_params(2, jdtype)
    tp, tmodel = _port(jp, tdtype, tcompute)
    jmodel = JM.MiniLM(dtype=jcompute, config=JCFG)
    jg = JAX_STEP_GRAD(jp, jmodel, batch)[1]
    jp, jlosses = _optax_steps(jp, jmodel, batch, n_steps)
    tp, tlosses = _port_steps(tp, tmodel, batch, n_steps)
    if dtype == "f32":
        np.testing.assert_allclose(tlosses[0], jlosses[0], rtol=1e-6)
        np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)  # after the noisy updates
        _assert_params_close(tp, TM.params_from_flax(_to_numpy(jp), torch.float32),
                             TM.params_from_flax(_to_numpy(jg), torch.float32), n_steps)
        return
    want, got = _flat(_to_numpy(jp)), _flat(TM.params_to_flax(tp))
    np.testing.assert_allclose(tlosses, jlosses, rtol=5e-3)
    diff = np.abs(got - want)
    if dtype == "mixed":  # f32 weights: the bf16 gradients' sign noise alone
        share = float(np.mean(diff > 0.1 * LR))
        assert share <= 0.05, f"{share:.4f} of weights more than 0.1 lr apart"
        assert diff.max() <= 2 * LR * n_steps + 2e-6, f"largest difference {diff.max():.3g}"
        return
    ulp = np.maximum(np.abs(want), np.abs(got)) * 2.0 ** -7
    share = float(np.mean(diff > ulp))
    assert share <= 0.05, f"{share:.4f} of bf16 weights more than one ulp apart"
    assert np.all(diff <= 4 * ulp + 2.1 * LR * n_steps), f"largest difference {diff.max():.3g}"


def _sgd_and_adamw(params, model, batch, mesh):
    """One SGD step at lr 1 (the update is minus the gradient), then two
    AdamW steps."""
    sgd = torch.optim.SGD(list(params.values()), lr=1.0)
    after_sgd, _ = _port_steps(params, model, batch, 1, mesh=mesh, opt=sgd,
                               opt_state={k: {} for k in params})
    grads = {k: (params[k] - after_sgd[k]).float() for k in params}
    after, losses = _port_steps(params, model, batch, 2, mesh=mesh)
    return grads, after, losses


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (1, 1)], ids=["data8", "data4-model2",
                                                                  "data1"])
def test_mesh_step_matches_single_device(shape):
    """The step over eight (or one) ``cpu`` shards equals the single-device
    step: gradients and two AdamW steps, f32, 2e-6."""
    n_data, n_model = shape
    mesh = make_mesh(n_data * n_model, model_parallel=n_model, device="cpu")
    assert mesh.shape == {"data": n_data, "model": n_model}
    batch = _batch(3)
    tp, tmodel = _port(_jax_params(3, jnp.float32), torch.float32)
    want_g, want_p, want_l = _sgd_and_adamw(tp, tmodel, batch, None)
    got_g, got_p, got_l = _sgd_and_adamw(tp, tmodel, batch, mesh)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-6)
    for k in tp:
        np.testing.assert_allclose(got_g[k].numpy(), want_g[k].numpy(), rtol=F32_RTOL,
                                   atol=F32_ATOL, err_msg=k)
    _assert_params_close(got_p, want_p, want_g, 2)


@pytest.mark.parametrize("dtype", ["bf16", "mixed"])
def test_mesh_step_low_precision_on_repeated_shards(dtype):
    """bf16 compute over (data 4, model 2) on ``cpu`` shards against the
    single-device step, two AdamW steps; loss within 1e-3 relative. bf16
    weights: the shards' gradients are summed by autograd in bf16, so at
    most 2 % of the weights end more than one ulp apart. mixed (f32
    weights): only the bf16 gradients' sign noise, so at most 2 % more than
    0.1 lr apart, none more than 2 lr a step."""
    (jdtype, _), (tdtype, tcompute) = DTYPES[dtype]
    mesh = make_mesh(8, model_parallel=2, device="cpu")
    batch = _batch(4)
    tp, tmodel = _port(_jax_params(4, jdtype), tdtype, tcompute)
    want_p, want_l = _port_steps(tp, tmodel, batch, 2)
    got_p, got_l = _port_steps(tp, tmodel, batch, 2, mesh=mesh)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-3)
    want, got = _flat(TM.params_to_flax(want_p)), _flat(TM.params_to_flax(got_p))
    diff = np.abs(got - want)
    if dtype == "mixed":
        assert float(np.mean(diff > 0.1 * LR)) <= 0.02 and diff.max() <= 4 * LR + 2e-6
        return
    ulp = np.maximum(np.abs(want), np.abs(got)) * 2.0 ** -7
    assert float(np.mean(diff > ulp)) <= 0.02


_RANK_SCRIPT = r"""
import json, sys
import numpy as np, torch
import torch.distributed as dist
from hyperdb_tpu_torch.models import minilm as TM, train as TT
from hyperdb_tpu_torch.parallel.launch import init_group
from hyperdb_tpu_torch.parallel.mesh import make_mesh

rank, port, inp, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
cfg = json.loads(sys.argv[5])
dev, group = init_group(rank, 2, port, "gloo", "cpu", timeout_s=120)
data = np.load(inp)
params = {k[2:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("p/")}
batch = {k[2:]: data[k] for k in data.files if k.startswith("b/")}
model = TM.MiniLM(TM.EncoderConfig(**cfg), dtype=torch.float32, device="cpu")
mesh = make_mesh(2, device="cpu", group=group)  # 2 shards here, 4 on the 'data' axis
assert mesh.shape["data"] == 4
sgd = torch.optim.SGD(list(params.values()), lr=1.0)
step = TT.make_train_step(mesh, model, sgd, params, donate=False)
after, _, loss0 = step(params, {k: {} for k in params}, batch)
res = {"g/" + k: (params[k] - after[k]).numpy() for k in params}
opt = TT.make_adamw(params, float(sys.argv[6]))
state = TT.init_opt_state(params)
step = TT.make_train_step(mesh, model, opt, params, donate=False)
losses = []
for _ in range(2):
    params, state, loss = step(params, state, batch)
    losses.append(float(loss))
res.update({"p/" + k: v.numpy() for k, v in params.items()})
np.savez(out, losses=np.array(losses), loss0=float(loss0), **res)
dist.destroy_process_group()
"""


def test_two_gloo_ranks_match_single_process(tmp_path):
    """Two processes over gloo on a free port, each with 2 ``cpu`` shards
    (a 'data' axis of 4), each given the same global batch: the gradient
    (an SGD step at lr 1) and two AdamW steps equal the single-process step
    within 2e-6, on both ranks; a sum without the gather's rule would give
    twice the gradient, a mean half of it."""
    batch = _batch(5)
    tp, tmodel = _port(_jax_params(5, jnp.float32), torch.float32)
    want_g, want_p, want_l = _sgd_and_adamw(tp, tmodel, batch, None)
    inp = tmp_path / "in.npz"
    np.savez(inp, **{"p/" + k: v.numpy() for k, v in tp.items()},
             **{"b/" + k: v for k, v in batch.items()})
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=ROOT)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(port), str(inp), str(tmp_path / f"out{r}.npz"),
         json.dumps(CFG), str(LR)], env=env, cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out
    for r in range(2):
        got = np.load(tmp_path / f"out{r}.npz")
        np.testing.assert_allclose(got["losses"], want_l, rtol=1e-6)
        for k in tp:
            g = got["g/" + k]
            np.testing.assert_allclose(g, want_g[k].numpy(), rtol=F32_RTOL, atol=F32_ATOL,
                                       err_msg=k)
        _assert_params_close({k: got["p/" + k] for k in tp}, want_p, want_g, 2)
        norm = np.sqrt(sum(float(np.sum(got["g/" + k] ** 2)) for k in tp))
        want_norm = np.sqrt(sum(float(torch.sum(want_g[k] ** 2)) for k in tp))
        assert abs(norm / want_norm - 1.0) < 1e-4


def test_train_step_compiles_and_runs():
    """Mirror of ``tests/test_parallel.py::test_train_step_compiles_and_runs``:
    MiniLM-L6 over an 8-shard ``cpu`` mesh, a synthetic batch of 8 x 16, two
    steps threading the state; both losses finite."""
    mesh = make_mesh(8, device="cpu")
    model, params, opt, opt_state = TT.make_train_state(mesh)
    # the JAX state's dtypes: f32 weights from the init, bf16 compute
    assert model.config == TM.EncoderConfig() and model.dtype == torch.bfloat16
    assert {p.dtype for p in params.values()} == {torch.float32}
    step = TT.make_train_step(mesh, model, opt, params, donate=False)
    batch = TT.synthetic_batch(batch_size=8, seq_len=16)
    params2, opt_state2, loss = step(params, opt_state, batch)
    assert np.isfinite(float(loss))
    # donate=False left the inputs as they were
    assert all(float(s["step"]) == 0.0 for s in opt_state.values())
    assert all(float(s["step"]) == 1.0 for s in opt_state2.values())
    assert not torch.equal(params["layers.0.query.weight"], params2["layers.0.query.weight"])
    _, _, loss2 = step(params2, opt_state2, batch)
    assert np.isfinite(float(loss2))


def test_donated_step_updates_in_place():
    tp, tmodel = _port(_jax_params(6, jnp.float32), torch.float32)
    params = {k: v.clone() for k, v in tp.items()}
    opt = TT.make_adamw(params, LR)
    state = TT.init_opt_state(params)
    step = TT.make_train_step(None, tmodel, opt, params)
    params2, state2, _ = step(params, state, _batch(6))
    assert all(params2[k] is params[k] for k in params)
    assert not torch.equal(params["layers.0.query.weight"], tp["layers.0.query.weight"])
    assert float(state2["tok_emb.weight"]["step"]) == 1.0
    # the optimiser keeps no reference to this step's tensors
    assert not opt.state


def test_synthetic_batch_is_the_jax_draw():
    want, got = JT.synthetic_batch(8, 16, seed=3), TT.synthetic_batch(8, 16, seed=3)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _port_name(path) -> str:
    keys = [getattr(k, "key", str(k)) for k in path][1:]  # drop "params"
    module, leaf = keys[:-1], keys[-1]
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(leaf, leaf)
    if module[0].startswith("layer_"):
        module = ["layers", module[0][len("layer_"):], *module[1:]]
    return ".".join([*module, leaf])


def test_param_spec_every_name():
    """The port's rule on every ``state_dict`` name of MiniLM-L6 equals the
    JAX rule on the matching Flax path, transposed to (out, in)."""
    from jax.sharding import PartitionSpec as P

    shapes = jax.eval_shape(lambda: JM.init_params()[1])
    port = TM.MiniLM(TM.EncoderConfig(), device="meta").state_dict()
    transposed = {P(None, "model"): ("model", None), P("model", None): (None, "model"),
                  P("model"): ("model",), P(): ()}
    seen = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        name = _port_name(path)
        assert name in port, name
        assert TT.param_spec(name, port[name]) == transposed[JT.param_spec(path, leaf)], name
        seen.add(name)
    assert seen == set(port)
    assert TT.make_param_shardings(make_mesh(4, model_parallel=2, device="cpu"), port)


def test_model_axis_must_divide_the_projections():
    params = TM.init_params(TCFG, 0)  # hidden 32, intermediate 64
    with pytest.raises(ValueError, match="does not split 3 ways"):
        TT.make_param_shardings(make_mesh(3, model_parallel=3, device="cpu"), params)


def test_batch_must_split_over_the_data_axis():
    tp, tmodel = _port(_jax_params(7, jnp.float32), torch.float32)
    mesh = make_mesh(3, device="cpu")
    step = TT.make_train_step(mesh, tmodel, TT.make_adamw(tp, LR), tp, donate=False)
    with pytest.raises(ValueError, match="3-way 'data' axis"):
        step(tp, TT.init_opt_state(tp), _batch(7))


def test_distill_loss_pulls_dense_sims_toward_lexical():
    """Mirror of ``test_encoder_local.py``'s distill test on the port: with
    the model's own cosines as the target the loss is InfoNCE; an
    off-diagonal change adds ``w * delta^2 / (B^2 - B)``; a diagonal change
    adds nothing; the distill term has gradients."""
    batch = _batch(8)
    tp, tmodel = _port(_jax_params(8, jnp.float32), torch.float32)
    base = float(TT.info_nce_loss(tp, tmodel, batch))
    q = TT._embed(tp, tmodel, batch["q_ids"], batch["q_mask"])
    d = TT._embed(tp, tmodel, batch["d_ids"], batch["d_mask"])
    own = (q @ d.t()).detach().numpy()
    same = float(TT.info_nce_distill_loss(tp, tmodel, dict(batch, lex_sims=own), distill_weight=7.0))
    assert abs(same - base) < 1e-5
    target = own.copy()
    target[0, 1] += 0.5
    off = float(TT.info_nce_distill_loss(tp, tmodel, dict(batch, lex_sims=target),
                                         distill_weight=7.0))
    assert abs(off - base - 7.0 * 0.5 ** 2 / (8 * 8 - 8)) < 1e-4
    target2 = own.copy()
    target2[2, 2] += 5.0
    diag = float(TT.info_nce_distill_loss(tp, tmodel, dict(batch, lex_sims=target2),
                                          distill_weight=7.0))
    assert abs(diag - base) < 1e-5
    _, g = _port_value_and_grad(
        lambda p, m, b: TT.info_nce_distill_loss(p, m, b, distill_weight=7.0)
        - TT.info_nce_loss(p, m, b), tp, tmodel, dict(batch, lex_sims=target))
    assert sum(float(np.abs(x).sum()) for x in jax.tree_util.tree_leaves(g)) > 0.0


def test_training_asks_for_the_card(monkeypatch):
    """Without a device the training state goes to the card, and raises
    where there is none: nothing trains on the CPU unless asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.make_train_state(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(2)
