"""MiniLM-style sentence encoder as torch modules.

Counterpart of ``hyperdb_tpu/models/minilm.py`` (Flax): a post-LN BERT
encoder (hidden 384, 12 heads, intermediate 1536, GELU) with attention-
masked mean pooling and L2 normalisation. :class:`EncoderConfig` sizes it;
``PRESETS`` has MiniLM-L6/L12, bert-base and ``local-384``, the in-repo
trained encoder (4 layers) whose weights, WordPiece vocab and manifest ship
as ``hyperdb_tpu/models/assets/``. Those files are read by path from the
repository, read-only.

The forward mirrors the Flax module's dtype at every step:
- the embedding sum ``tok + pos + typ`` is bf16, in that order; ``emb_ln``
  runs in f32 and its output is cast back to bf16;
- a ``Dense`` casts its input to bf16, rounds the product to bf16, then
  adds its bf16 bias;
- attention scores are f32 products of the bf16 operands, divided by
  sqrt(head_dim), plus a -1e9 f32 mask bias; softmax in f32; the
  probabilities are cast to bf16 for the second product;
- a LayerNorm returns f32, so after the first ``attn_ln`` the residual
  stream is f32 (bf16 + f32 promotes) and the next ``Dense`` casts back;
- GELU is exact (erf); pooling and the normalisation are f32 with the
  1e-9 / 1e-12 clamps.
Nothing here is a TPU kernel: the JAX package runs it as plain XLA, and the
port as plain torch ops on the encoder's ``device``.

Weights cross from the JAX package through :func:`params_from_flax` (a Flax
parameter tree as NumPy arrays -> this module's ``state_dict``); the
in-repo assets load through the same function. Without parameters the
encoder is initialised from its own seeded ``torch.Generator``: it cannot
reproduce the JAX package's ``jax.random`` seed-0 init, and random weights
carry no meaning, so parity is always checked on carried-across weights.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hyperdb_tpu_torch.core.db import resolve_device

VOCAB_SIZE = 30522
HIDDEN = 384
LAYERS = 6
HEADS = 12
INTERMEDIATE = 1536
MAX_POSITIONS = 512
TYPE_VOCAB = 2
LAYER_NORM_EPS = 1e-12

SEQ_BUCKETS = (32, 64, 128, 256, 512)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    hidden: int = HIDDEN
    layers: int = LAYERS
    heads: int = HEADS
    intermediate: int = INTERMEDIATE
    vocab_size: int = VOCAB_SIZE
    max_positions: int = MAX_POSITIONS


PRESETS = {
    "minilm-l6": EncoderConfig(),
    "minilm-l12": EncoderConfig(layers=12),
    "bert-base": EncoderConfig(hidden=768, layers=12, heads=12, intermediate=3072),
    # the in-repo trained encoder: 384-d like MiniLM-L6, 4 layers, its own
    # WordPiece vocab (the manifest beside the weights gives its exact config)
    "local-384": EncoderConfig(layers=4, vocab_size=8192),
}

# The trained encoder's files live in the JAX package's tree; the port reads
# them by path (repository root / hyperdb_tpu / models / assets).
ASSETS_DIR = str(Path(__file__).resolve().parents[2] / "hyperdb_tpu" / "models" / "assets")

_DENSE = ("query", "key", "value", "attn_output", "intermediate", "output")


class Dense(nn.Module):
    """Flax ``nn.Dense`` at the weight dtype: input cast to it, product
    rounded to it, bias added in it. ``weight`` is (out, in) as in torch;
    a Flax kernel is (in, out)."""

    def __init__(self, d_in: int, d_out: int, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x.to(self.weight.dtype), self.weight.t()) + self.bias


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(dtype=float32)``: f32 statistics with the
    variance as E[x^2] - E[x]^2 clipped at 0, f32 scale and bias, f32
    output whatever the input dtype."""

    def __init__(self, hidden: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(hidden, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        mean2 = (x32 * x32).mean(-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + LAYER_NORM_EPS) * self.weight
        return (x32 - mean) * mul + self.bias


class MiniLMLayer(nn.Module):
    """One post-LN BERT encoder block."""

    def __init__(self, config: EncoderConfig, dtype, device):
        super().__init__()
        h, i = config.hidden, config.intermediate
        self.heads = config.heads
        self.query = Dense(h, h, dtype, device)
        self.key = Dense(h, h, dtype, device)
        self.value = Dense(h, h, dtype, device)
        self.attn_output = Dense(h, h, dtype, device)
        self.attn_ln = LayerNorm(h, device)
        self.intermediate = Dense(h, i, dtype, device)
        self.output = Dense(i, h, dtype, device)
        self.ffn_ln = LayerNorm(h, device)
        # a tensor divisor on purpose: on the card torch divides by a Python
        # scalar as a product with its reciprocal, not as an IEEE division
        self.register_buffer(
            "scale", torch.tensor(math.sqrt(h // config.heads), device=device), persistent=False
        )

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        b, s, h = hidden.shape

        def split(x):
            return x.view(b, s, self.heads, h // self.heads).transpose(1, 2)

        q, k, v = split(self.query(hidden)), split(self.key(hidden)), split(self.value(hidden))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / self.scale
        probs = torch.softmax(scores + attn_bias, dim=-1).to(v.dtype)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, h)
        hidden = self.attn_ln(self.attn_output(ctx) + hidden)
        ff = F.gelu(self.intermediate(hidden), approximate="none")
        return self.ffn_ln(self.output(ff) + hidden)


class MiniLM(nn.Module):
    """BERT-style encoder with masked mean pooling -> unit-norm f32 rows."""

    def __init__(self, config: EncoderConfig = EncoderConfig(), dtype=torch.bfloat16, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        h = config.hidden
        self.tok_emb = nn.Embedding(config.vocab_size, h, dtype=dtype, device=device)
        self.pos_emb = nn.Embedding(config.max_positions, h, dtype=dtype, device=device)
        self.type_emb = nn.Embedding(TYPE_VOCAB, h, dtype=dtype, device=device)
        self.emb_ln = LayerNorm(h, device)
        self.layers = nn.ModuleList(
            MiniLMLayer(config, dtype, device) for _ in range(config.layers)
        )

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        seq = input_ids.shape[1]
        tok = self.tok_emb(input_ids)
        pos = self.pos_emb.weight[:seq][None]
        typ = self.type_emb.weight[0]  # token type 0 everywhere
        hidden = self.emb_ln(tok + pos + typ).to(self.dtype)
        live = attention_mask[:, None, None, :].bool()
        attn_bias = torch.where(live, 0.0, -1e9).float()
        for layer in self.layers:
            hidden = layer(hidden, attn_bias)
        mask = attention_mask[:, :, None].float()
        summed = torch.sum(hidden.float() * mask, dim=1)
        emb = summed / torch.clamp(torch.sum(mask, dim=1), min=1e-9)
        norm = torch.sqrt(torch.sum(emb * emb, dim=-1, keepdim=True))
        return emb / torch.clamp(norm, min=1e-12)


# --------------------------------------------------------------------------
# parameters: the Flax tree, the in-repo npz, seeded init
# --------------------------------------------------------------------------


def _tensor(arr: np.ndarray, dtype) -> torch.Tensor:
    arr = np.array(arr)  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":  # a JAX bf16 leaf read with np.asarray
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(dtype)
    return torch.from_numpy(arr).to(dtype)


def params_from_flax(tree: dict, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """A Flax ``MiniLM`` parameter tree (``{"params": {...}}`` or its
    inside) with NumPy leaves -> this module's ``state_dict`` on the CPU.
    A Dense kernel (in, out) becomes a weight (out, in); layer norms are
    f32 and everything else ``dtype``, the JAX package's cast."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}
    for name in ("tok_emb", "pos_emb", "type_emb"):
        out[f"{name}.weight"] = _tensor(tree[name]["embedding"], dtype)

    def ln(dst: str, node: dict) -> None:
        out[f"{dst}.weight"] = _tensor(node["scale"], torch.float32)
        out[f"{dst}.bias"] = _tensor(node["bias"], torch.float32)

    ln("emb_ln", tree["emb_ln"])
    i = 0
    while f"layer_{i}" in tree:
        layer = tree[f"layer_{i}"]
        for name in _DENSE:
            out[f"layers.{i}.{name}.weight"] = _tensor(np.asarray(layer[name]["kernel"]).T, dtype)
            out[f"layers.{i}.{name}.bias"] = _tensor(layer[name]["bias"], dtype)
        for name in ("attn_ln", "ffn_ln"):
            ln(f"layers.{i}.{name}", layer[name])
        i += 1
    return out


def load_saved_params(path: str, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """The npz of trained parameters (the JAX package's ``save_params``:
    the Flax tree flattened to keys ``a/b/c``, float16 leaves) -> this
    module's ``state_dict``, through :func:`params_from_flax`."""
    tree: dict = {}
    with np.load(path, allow_pickle=False) as f:
        for key, arr in f.items():
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = arr
    return params_from_flax(tree, dtype=dtype)


def init_params(config: EncoderConfig, seed: int = 0, dtype=torch.bfloat16) -> dict:
    """Seeded random parameters from a ``torch.Generator``: normal weights
    with std 1/sqrt(fan-in) (embeddings: 1/sqrt(hidden)), zero biases,
    unit LayerNorm scales."""
    gen = torch.Generator().manual_seed(seed)
    model = MiniLM(config, dtype=torch.float32, device="meta")
    out = {}
    for name, p in model.state_dict().items():
        if name.endswith("bias"):
            t = torch.zeros(p.shape)
        elif "_ln" in name:
            t = torch.ones(p.shape)
        else:
            t = torch.randn(p.shape, generator=gen) / math.sqrt(p.shape[-1])
        out[name] = t.to(torch.float32 if "_ln" in name else dtype)
    return out


# --------------------------------------------------------------------------
# HF weight conversion (local cache only; no network)
# --------------------------------------------------------------------------

_HF_MODEL = "sentence-transformers/all-MiniLM-L6-v2"


def load_hf_params():
    """The locally cached HF checkpoint as a Flax-shaped NumPy tree (for
    :func:`params_from_flax`), or None when it is not cached here."""
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    try:
        from transformers import AutoModel

        hf = AutoModel.from_pretrained(_HF_MODEL, local_files_only=True)
    except Exception:  # no transformers, or no cached checkpoint
        return None
    sd = {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}

    def lin(prefix):
        return {"kernel": sd[prefix + ".weight"].T, "bias": sd[prefix + ".bias"]}

    def ln(prefix):
        return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}

    params = {
        "tok_emb": {"embedding": sd["embeddings.word_embeddings.weight"]},
        "pos_emb": {"embedding": sd["embeddings.position_embeddings.weight"]},
        "type_emb": {"embedding": sd["embeddings.token_type_embeddings.weight"]},
        "emb_ln": ln("embeddings.LayerNorm"),
    }
    for i in range(LAYERS):
        p = f"encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "query": lin(f"{p}.attention.self.query"),
            "key": lin(f"{p}.attention.self.key"),
            "value": lin(f"{p}.attention.self.value"),
            "attn_output": lin(f"{p}.attention.output.dense"),
            "attn_ln": ln(f"{p}.attention.output.LayerNorm"),
            "intermediate": lin(f"{p}.intermediate.dense"),
            "output": lin(f"{p}.output.dense"),
            "ffn_ln": ln(f"{p}.output.LayerNorm"),
        }
    return {"params": params}


# --------------------------------------------------------------------------
# Hermetic tokenizer: words -> stable ids in the BERT id space
# --------------------------------------------------------------------------

_CLS, _SEP, _PAD = 101, 102, 0
_WORD_RE = re.compile(r"\b\w+\b")


class HashingTokenizer:
    """Deterministic word -> id hashing into the BERT vocab range, used
    when no WordPiece vocab is given: the same word always gets the same
    id."""

    def encode(self, text: str, max_len: int) -> tuple[list[int], list[int]]:
        words = _WORD_RE.findall(text.lower())[: max_len - 2]
        ids = [_CLS] + [
            1000 + (zlib.crc32(w.encode()) % (VOCAB_SIZE - 2000)) for w in words
        ] + [_SEP]
        return ids, [1] * len(ids)


class MiniLMEmbedder:
    """Batched sentence encoder on ``device`` with bucketed shapes: texts
    are tokenized on the host into (power-of-two batch, sequence bucket)
    int32 blocks and encoded in slices of at most ``_MAX_BATCH``."""

    # Largest slice per forward; bigger inputs loop over slices.
    _MAX_BATCH = 512

    def __init__(
        self,
        params=None,
        dtype=torch.bfloat16,
        tokenizer=None,
        dim=HIDDEN,
        config: EncoderConfig | None = None,
        max_seq: int | None = None,
        device=None,
        seed: int = 0,
    ):
        if config is None:
            # pick the preset matching the requested embedding dimension
            config = next((c for c in PRESETS.values() if c.hidden == dim), EncoderConfig())
        self.config = config
        self.dim = config.hidden
        self.max_seq = min(max_seq or config.max_positions, config.max_positions)
        self.device = resolve_device(device)
        self.model = MiniLM(config, dtype=dtype, device=self.device)
        self.model.load_state_dict(init_params(config, seed, dtype) if params is None else params)
        self.model.eval().requires_grad_(False)
        self._tokenizer = tokenizer or HashingTokenizer()

    @classmethod
    def from_local_assets(cls, assets_dir: str | None = None, device=None):
        """The in-repo trained encoder: WordPiece vocab, weights and
        manifest from ``assets_dir`` (default: the repository's
        ``hyperdb_tpu/models/assets``). None when the files are absent."""
        from hyperdb_tpu_torch.models.wordpiece import WordPieceTokenizer

        assets = assets_dir or ASSETS_DIR
        vocab_path = os.path.join(assets, "vocab.txt")
        params_path = os.path.join(assets, "encoder_local.npz")
        manifest_path = os.path.join(assets, "manifest.json")
        if not (os.path.exists(vocab_path) and os.path.exists(params_path)):
            return None
        config = PRESETS["local-384"]
        trained_seq = None
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                manifest = json.load(f)
            config = EncoderConfig(**manifest.get("config", {}))
            trained_seq = manifest.get("inference_seq")
        tokenizer = WordPieceTokenizer.load(vocab_path)
        emb = cls(
            params=load_saved_params(params_path), tokenizer=tokenizer, config=config,
            max_seq=trained_seq, device=device,
        )
        emb.chunk_tokenizer = tokenizer  # chunks count the encoder's own WordPiece
        return emb

    @classmethod
    def maybe_pretrained(cls, dim: int = HIDDEN, device=None):
        """An embedder only when the pretrained HF weights AND tokenizer are
        cached locally; None otherwise."""
        if dim != HIDDEN:
            return None
        params = load_hf_params()
        if params is None:
            return None
        try:
            from transformers import AutoTokenizer

            hf_tok = AutoTokenizer.from_pretrained(_HF_MODEL, local_files_only=True)
        except Exception:  # weights without tokenizer files: refuse the pair
            return None

        class _HFTok:
            def encode(self, text, max_len):
                out = hf_tok(text, truncation=True, max_length=max_len)
                return out["input_ids"], out["attention_mask"]

        return cls(params=params_from_flax(params), tokenizer=_HFTok(), device=device)

    @staticmethod
    def _bucket(n: int, buckets) -> int:
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]

    def _prep_batch(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """Tokenize one <= ``_MAX_BATCH`` slice into bucketed host
        ``(ids, mask)`` int32 arrays; the batch dim is padded to the next
        power of two."""
        encoded = [self._tokenizer.encode(t, self.max_seq) for t in texts]
        max_len = max(len(ids) for ids, _ in encoded)
        seq = self._bucket(max_len, SEQ_BUCKETS)
        batch = 1 << (len(encoded) - 1).bit_length()

        pad_id = getattr(self._tokenizer, "pad_id", _PAD)
        cls_id = getattr(self._tokenizer, "cls_id", _CLS)
        ids = np.full((batch, seq), pad_id, dtype=np.int32)
        mask = np.zeros((batch, seq), dtype=np.int32)
        for i, (tok_ids, tok_mask) in enumerate(encoded):
            tok_ids = tok_ids[:seq]
            tok_mask = tok_mask[:seq]
            ids[i, : len(tok_ids)] = tok_ids
            mask[i, : len(tok_mask)] = tok_mask
        # fully padded rows would mean-pool over nothing; give them one live
        # CLS token so they stay NaN-free
        empty = mask.sum(axis=1) == 0
        ids[empty, 0] = cls_id
        mask[empty, 0] = 1
        return ids, mask

    def _forward(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """One forward of a host ``(ids, mask)`` block -> (batch, dim) f32
        on ``device``."""
        with torch.no_grad():
            return self.model(
                torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device)
            )

    def encode(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        if len(texts) > self._MAX_BATCH:
            parts = [
                self.encode(texts[i : i + self._MAX_BATCH])
                for i in range(0, len(texts), self._MAX_BATCH)
            ]
            return np.concatenate(parts, axis=0)
        emb = self._forward(*self._prep_batch(texts))
        return emb[: len(texts)].cpu().numpy()

    def encode_device(self, texts: list[str]):
        """Twin of :meth:`encode` whose embeddings stay on ``device``: a
        ``(b_pad, dim)`` float32 tensor with ``b_pad`` the next power of two
        >= ``len(texts)``. Rows past ``len(texts)`` are finite padding
        (bare-CLS embeddings) that callers slice off the RESULTS (the batch
        query's ``n_valid``). Blocks past ``_MAX_BATCH`` run as full slices
        ("" rows fill the last) and are concatenated. None for no texts."""
        if not texts:
            return None
        n = len(texts)
        if n <= self._MAX_BATCH:
            return self._forward(*self._prep_batch(list(texts)))
        b_out = 1 << (n - 1).bit_length()
        parts = []
        for i in range(0, b_out, self._MAX_BATCH):
            chunk = list(texts[i : i + self._MAX_BATCH])
            chunk += [""] * (self._MAX_BATCH - len(chunk))
            parts.append(self._forward(*self._prep_batch(chunk)))
        return torch.cat(parts, dim=0)
