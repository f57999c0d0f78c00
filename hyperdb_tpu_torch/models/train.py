"""Contrastive training of the sentence encoder over a ('data', 'model') mesh.

Counterpart of ``hyperdb_tpu/models/train.py``: an in-batch-negative
InfoNCE step (and the lexical-distillation loss beside it) with
``torch.optim.AdamW`` at optax's ``adamw`` defaults: betas (0.9, 0.999),
eps 1e-8, weight decay 1e-4 on every parameter, moments in the parameter
dtype. The step is functional, as the JAX one is:
``step(params, opt_state, batch) -> (params, opt_state, loss)`` with
``params`` a ``state_dict``-shaped dict of tensors on the mesh's first
device and ``opt_state`` AdamW's per-parameter state under the same names.

The mesh (``parallel/mesh.Mesh``, or None for one device):

- 'data': the batch splits into contiguous slices, one per data shard, as
  ``P("data", None)`` does; each slice is encoded on its shard's device and
  the embeddings are gathered for the loss, so the in-batch negatives come
  from the whole batch, exactly as in the JAX step. Across processes (a
  mesh with a ``group``) the axis spans the ranks: every rank gathers the
  embeddings of all of them and computes the same loss, the backward keeps
  this rank's slice of the embeddings' gradient (which is then whole), and
  the parameter gradients are summed over the group, so a step equals the
  single-process step: neither ``world`` times it nor ``1/world`` of it.
- 'model': the six projections split by :func:`param_spec`: ``query``,
  ``key``, ``value`` and ``intermediate`` by output features (the slices'
  outputs are concatenated), ``attn_output`` and ``output`` by input
  features (the slices' f32 partial products are summed and rounded once,
  as the whole product is).

A mesh may name one device several times (several shards on one card);
its shards then share one set of parameters and autograd sums their
gradients. The parameters and the optimiser state live whole on the first
device; a shard on another device gets copies that autograd reduces back.
Nothing here is a TPU kernel: the JAX package trains plain Flax, the port
plain torch.
"""

from __future__ import annotations

import copy
from collections import defaultdict
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from hyperdb_tpu_torch.models.minilm import MiniLM, EncoderConfig, init_params

# Column-parallel projections (output features split) and their
# row-parallel counterparts (input features split).
_COL_PARALLEL = ("query", "key", "value", "intermediate")
_ROW_PARALLEL = ("attn_output", "output")

# optax.adamw's defaults (torch's own weight decay default is 0.01)
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


def param_spec(name: str, param) -> tuple:
    """The mesh axis each dimension of a parameter splits over, in the
    port's (out, in) weight layout: ``("model", None)`` for a column-parallel
    weight, ``(None, "model")`` for a row-parallel one, ``("model",)`` for a
    column-parallel bias, ``()`` for everything replicated (embeddings,
    layer norms, row-parallel biases). The JAX package's rule on its (in,
    out) kernels, transposed."""
    parts = name.split(".")
    if param.ndim == 2:
        for part in parts:
            if part in _COL_PARALLEL:
                return ("model", None)
            if part in _ROW_PARALLEL:
                return (None, "model")
    if param.ndim == 1:
        for part in parts:
            if part in _COL_PARALLEL:
                return ("model",)
    return ()


def make_param_shardings(mesh, params) -> dict[str, tuple]:
    """name -> :func:`param_spec`, the split each step applies. Raises
    where the mesh's 'model' axis does not divide a split dimension."""
    m = int(mesh.shape.get("model", 1)) if mesh is not None else 1
    specs = {}
    for name, p in params.items():
        spec = param_spec(name, p)
        for dim, axis in enumerate(spec):
            if axis == "model" and p.shape[dim] % m:
                raise ValueError(f"{name}: dimension {p.shape[dim]} does not split {m} ways")
        specs[name] = spec
    return specs


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def _as_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x, device=device)


def _embed(params, model, ids, mask) -> torch.Tensor:
    """A forward WITH gradients (``MiniLMEmbedder._forward`` runs under
    ``no_grad``): unit f32 rows of ``model`` at ``params``, on their device."""
    dev = next(iter(params.values())).device
    return functional_call(model, params, (_as_tensor(ids, dev), _as_tensor(mask, dev)))


def _info_nce(q_emb, d_emb, temperature: float):
    sims = q_emb @ d_emb.t()  # (B, B) cross-view cosines
    # a tensor divisor: on the card torch divides by a Python scalar as a
    # product with its reciprocal, not as an IEEE division
    logits = sims / torch.tensor(temperature, dtype=sims.dtype, device=sims.device)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return F.cross_entropy(logits, labels), sims


def _distill(sims, lex_sims):
    off = 1.0 - torch.eye(sims.shape[0], dtype=sims.dtype, device=sims.device)
    return torch.sum(off * (sims - lex_sims) ** 2) / torch.sum(off)


def info_nce_loss(params, model, batch, temperature: float = 0.05):
    """In-batch-negative InfoNCE: cross entropy of the (B, B) logits
    ``q . d / temperature`` against ``arange(B)``, mean over the batch."""
    q_emb = _embed(params, model, batch["q_ids"], batch["q_mask"])
    d_emb = _embed(params, model, batch["d_ids"], batch["d_mask"])
    return _info_nce(q_emb, d_emb, temperature)[0]


def info_nce_distill_loss(params, model, batch, temperature: float = 0.05,
                          distill_weight: float = 10.0):
    """InfoNCE plus lexical distillation: the off-diagonal dense cross-view
    cosines are pulled toward ``batch["lex_sims"]`` (a host-computed (B, B)
    block of lexical hash cosines) by a mean squared term; the diagonal is
    InfoNCE's alone."""
    q_emb = _embed(params, model, batch["q_ids"], batch["q_mask"])
    d_emb = _embed(params, model, batch["d_ids"], batch["d_mask"])
    loss, sims = _info_nce(q_emb, d_emb, temperature)
    lex = _as_tensor(batch["lex_sims"], sims.device).to(sims.dtype)
    return loss + distill_weight * _distill(sims, lex)


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------


class _SplitDense(nn.Module):
    """A ``minilm.Dense`` whose product is split over one data shard's
    'model' devices. It keeps the Dense's parameter names, so
    ``functional_call`` hands it the whole weight and it slices by
    :func:`param_spec`; it computes in the Dense's dtype, as the Dense does."""

    def __init__(self, dense, kind: str, devices):
        super().__init__()
        self.weight, self.bias, self.dtype = dense.weight, dense.bias, dense.dtype
        self.kind, self.devices = kind, list(devices)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        home, w, b, m, dt = x.device, self.weight, self.bias, len(self.devices), self.dtype
        if self.kind == "col":  # output features: each slice is a whole Dense
            size = w.shape[0] // m
            outs = []
            for j, dev in enumerate(self.devices):
                cut = slice(j * size, (j + 1) * size)
                y = torch.matmul(x.to(dev, dt), w[cut].to(dev, dt).t()) + b[cut].to(dev, dt)
                outs.append(y.to(home))
            return torch.cat(outs, dim=-1)
        size = w.shape[1] // m  # input features: f32 partial products, summed
        total = None
        for j, dev in enumerate(self.devices):
            cut = slice(j * size, (j + 1) * size)
            # the operands at the compute dtype's values, their products exact in f32
            part = torch.matmul(x[..., cut].to(dev, dt).float(),
                                w[:, cut].to(dev, dt).float().t()).to(home)
            total = part if total is None else total + part
        return total.to(dt) + b.to(dt)


def _shard_module(model: MiniLM, devices) -> MiniLM:
    """A copy of ``model`` on ``devices[0]`` whose six projections split
    over ``devices`` when there are several. Its own parameter values are
    never read (``functional_call`` substitutes the step's); it carries the
    compute dtype and the buffers."""
    shard = copy.deepcopy(model).to(devices[0])
    if len(devices) > 1:
        for layer in shard.layers:
            for name in _COL_PARALLEL + _ROW_PARALLEL:
                kind = "col" if name in _COL_PARALLEL else "row"
                setattr(layer, name, _SplitDense(getattr(layer, name), kind, devices))
    return shard


class _GatherRows(torch.autograd.Function):
    """All-gather of every rank's embedding rows along the batch. Each rank
    computes the same loss from the gathered block, so the gradient of this
    rank's rows is already whole: the backward keeps that slice and
    communicates nothing (the parameter gradients are summed afterwards)."""

    @staticmethod
    def forward(ctx, x, group, rank, world):
        import torch.distributed as dist

        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.rank, ctx.rows = rank, x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.rows
        return grad[lo:lo + ctx.rows], None, None, None


def _mesh_embed(mesh, model: MiniLM):
    """(params, ids, mask) -> the batch's unit rows on the first device,
    the batch split over the mesh's 'data' axis (see the module note)."""
    if mesh is None:
        return lambda params, ids, mask: _embed(params, model, ids, mask)
    grid = mesh.devices
    rows = [list(grid[i]) for i in range(grid.shape[0])]
    home = rows[0][0]
    shards = {}
    for row in rows:
        key = tuple(str(d) for d in row)
        if key not in shards:
            shards[key] = _shard_module(model, row)
    modules = [shards[tuple(str(d) for d in row)] for row in rows]
    n_data = int(mesh.shape["data"])

    def embed(params, ids, mask):
        ids, mask = _as_tensor(ids, home), _as_tensor(mask, home)
        if ids.shape[0] % n_data:
            raise ValueError(f"a batch of {ids.shape[0]} does not split over the mesh's "
                             f"{n_data}-way 'data' axis")
        per = ids.shape[0] // mesh.world
        lo = mesh.rank * per
        ids, mask = ids[lo:lo + per], mask[lo:lo + per]
        size = per // len(rows)
        on_device = {}  # this step's parameters on each shard device
        outs = []
        for i, (row, module) in enumerate(zip(rows, modules)):
            dev = row[0]
            if dev not in on_device:
                on_device[dev] = {k: v.to(dev) for k, v in params.items()}
            cut = slice(i * size, (i + 1) * size)
            out = functional_call(module, on_device[dev], (ids[cut].to(dev), mask[cut].to(dev)))
            outs.append(out.to(home))
        local = torch.cat(outs)
        if mesh.group is None:
            return local
        return _GatherRows.apply(local, mesh.group, mesh.rank, mesh.world)

    return embed


# --------------------------------------------------------------------------
# optimiser, state, step
# --------------------------------------------------------------------------


def make_adamw(params, learning_rate: float) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` at optax ``adamw``'s defaults."""
    return torch.optim.AdamW(
        list(params.values()), lr=learning_rate, betas=ADAMW_BETAS, eps=ADAMW_EPS,
        weight_decay=ADAMW_WEIGHT_DECAY,
    )


def init_opt_state(params) -> dict[str, dict[str, torch.Tensor]]:
    """AdamW's state for a fresh run, per parameter name: the step count
    (f32 on the host, as torch keeps it) and both moments in the
    parameter's dtype and device (optax's ``mu_dtype=None``)."""
    return {
        name: {"step": torch.tensor(0.0, dtype=torch.float32),
               "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
        for name, p in params.items()
    }


def make_train_state(mesh, seed: int = 0, learning_rate: float = 2e-5, device=None):
    """``(model, params, opt, opt_state)`` for a fresh run of ``MiniLM()``
    (MiniLM-L6) computing in bf16. The weights are ``init_params``'s seeded
    draw kept in f32, as Flax's init keeps them (``minilm.Dense`` casts them
    to bf16 at use), on the mesh's first device (without a mesh: ``device``,
    the card unless the caller asks for the CPU)."""
    from hyperdb_tpu_torch.core.db import resolve_device

    dev = mesh.devices.flat[0] if mesh is not None else resolve_device(device)
    config = EncoderConfig()
    params = {k: v.to(dev) for k, v in init_params(config, seed, torch.float32).items()}
    make_param_shardings(mesh, params)
    model = MiniLM(config, device=dev)
    opt = make_adamw(params, learning_rate)
    return model, params, opt, init_opt_state(params)


def make_train_step(mesh, model: MiniLM, opt: torch.optim.Optimizer, params_example,
                    donate: bool = True):
    """The InfoNCE step ``(params, opt_state, batch) -> (params, opt_state,
    loss)`` over ``mesh`` (None: one device, the parameters' own).

    ``batch`` holds ``q_ids``, ``q_mask``, ``d_ids``, ``d_mask``: (B, S)
    integer arrays or tensors, the global batch (every rank of a
    multi-process mesh passes the same one). ``opt`` steps with its own
    hyperparameters over the parameters it is handed each step.
    ``donate=True`` updates ``params`` and ``opt_state`` in place and returns
    them; ``donate=False`` leaves them as they were and returns new ones, as
    the JAX step without donated buffers does. ``loss`` is a 0-d f32 tensor
    on the first device."""
    make_param_shardings(mesh, params_example)
    names = list(params_example)
    embed = _mesh_embed(mesh, model)
    group = mesh.group if mesh is not None else None

    def step(params, opt_state, batch):
        if not donate:
            params = {k: params[k].detach().clone() for k in names}
            opt_state = {k: {s: t.clone() for s, t in opt_state[k].items()} for k in names}
        # leaves sharing the parameters' storage: the update lands in params
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        loss, _ = _info_nce(embed(leaves, batch["q_ids"], batch["q_mask"]),
                            embed(leaves, batch["d_ids"], batch["d_mask"]), 0.05)
        loss.backward()
        if group is not None:
            import torch.distributed as dist

            for leaf in leaves.values():
                dist.all_reduce(leaf.grad, group=group)
        opt.param_groups[0]["params"] = list(leaves.values())
        opt.state = defaultdict(dict, {leaves[k]: opt_state[k] for k in names})
        opt.step()
        new_state = {k: opt.state[leaves[k]] for k in names}
        for leaf in leaves.values():
            leaf.grad = None
        opt.state = defaultdict(dict)
        return params, new_state, loss.detach()

    return step


def synthetic_batch(batch_size: int, seq_len: int, seed: int = 0) -> dict[str, Any]:
    """Deterministic token batch for compile checks and benchmarks (the JAX
    package's draws)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1000, 30000, size=(batch_size, seq_len), dtype=np.int32)
    mask = np.ones((batch_size, seq_len), dtype=np.int32)
    return {
        "q_ids": ids,
        "q_mask": mask,
        "d_ids": rng.integers(1000, 30000, size=(batch_size, seq_len), dtype=np.int32),
        "d_mask": mask.copy(),
    }
