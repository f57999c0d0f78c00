"""Contrastive fine-tuning of the sentence encoder on (query, document) pairs.

Counterpart of ``hyperdb_tpu/models/finetune.py``: ``models/train.py``'s
InfoNCE step wrapped into a data-in, embedder-out call:

    pairs = [("likes to sleep", doc_text), ...]
    embedder = finetune(pairs, epochs=2)          # on the card
    db = HyperDB(docs, embedding_function=make_embedding_function(embedder, tok))

The model is ``MiniLM()`` at its default config (MiniLM-L6, 384 wide), as in
the JAX package. With a mesh the step runs data-parallel over 'data' and
splits the projections over 'model' (``models/train.py``); without one it
runs on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from hyperdb_tpu_torch.models.minilm import (
    MAX_POSITIONS,
    EncoderConfig,
    HashingTokenizer,
    MiniLM,
    MiniLMEmbedder,
    init_params,
    load_hf_params,
    params_from_flax,
)
from hyperdb_tpu_torch.models.train import init_opt_state, make_adamw, make_train_step


def _tokenize_batch(texts, tokenizer, seq_len: int):
    ids = np.zeros((len(texts), seq_len), dtype=np.int32)
    mask = np.zeros((len(texts), seq_len), dtype=np.int32)
    for i, text in enumerate(texts):
        tok_ids, tok_mask = tokenizer.encode(text, seq_len)
        tok_ids = tok_ids[:seq_len]
        ids[i, : len(tok_ids)] = tok_ids
        mask[i, : len(tok_ids)] = tok_mask[: len(tok_ids)]
    # an empty row would mean-pool over nothing: one live CLS token
    empty = mask.sum(axis=1) == 0
    ids[empty, 0] = getattr(tokenizer, "cls_id", 101)
    mask[empty, 0] = 1
    return ids, mask


def finetune(
    pairs,
    *,
    mesh=None,
    epochs: int = 1,
    batch_size: int = 32,
    seq_len: int = 64,
    learning_rate: float = 2e-5,
    seed: int = 0,
    params=None,
    tokenizer=None,
    verbose: bool = False,
    device=None,
):
    """Fine-tune MiniLM with in-batch-negative InfoNCE; returns an embedder
    on the training device holding the trained weights, with the loss of
    every step in ``embedder.losses``.

    Args:
        pairs: iterable of (query_text, positive_document_text).
        mesh: optional ('data', 'model') ``Mesh``; the batch is rounded down
            to a multiple of its 'data' size, and the run takes place on its
            devices.
        params: starting weights, a ``MiniLM`` state dict, bf16 or f32
            (default: the pretrained weights if cached locally, else the
            seeded init in f32). They are copied, never changed; the model
            computes in bf16 and the embedder holds the weights rounded to
            bf16, as its Flax counterpart computes with them.
        device: without a mesh, where to train: the card unless the caller
            asks for the CPU.
    """
    from hyperdb_tpu_torch.core.db import resolve_device

    pairs = list(pairs)
    if len(pairs) < 2:
        raise ValueError("Need at least 2 pairs for in-batch negatives.")
    seq_len = min(seq_len, MAX_POSITIONS)
    batch_size = min(batch_size, len(pairs))
    if mesh is not None:
        # the step splits the batch over 'data': round down to a multiple
        data_size = int(mesh.shape.get("data", 1))
        batch_size = max(data_size, (batch_size // data_size) * data_size)
        if batch_size > len(pairs):
            raise ValueError(
                f"Need at least {batch_size} pairs (one batch divisible by "
                f"the mesh's {data_size}-way 'data' axis); got {len(pairs)}."
            )
        dev = mesh.devices.flat[0]
    else:
        dev = resolve_device(device)
    tokenizer = tokenizer or HashingTokenizer()

    config = EncoderConfig()
    if params is None:
        # the pretrained weights are bf16; a seeded init keeps f32 weights,
        # as Flax's does (the model computes in bf16 either way)
        tree = load_hf_params()
        params = (params_from_flax(tree) if tree is not None
                  else init_params(config, seed, torch.float32))
    # our own copy: the donated step updates it in place
    params = {k: v.detach().to(dev, copy=True) for k, v in params.items()}
    model = MiniLM(config, dtype=torch.bfloat16, device=dev)
    opt = make_adamw(params, learning_rate)
    opt_state = init_opt_state(params)
    step = make_train_step(mesh, model, opt, params, donate=True)

    rng = np.random.default_rng(seed)
    losses = []
    for epoch in range(epochs):
        order = rng.permutation(len(pairs))
        for start in range(0, len(pairs) - batch_size + 1, batch_size):
            idx = order[start : start + batch_size]
            q_ids, q_mask = _tokenize_batch([pairs[i][0] for i in idx], tokenizer, seq_len)
            d_ids, d_mask = _tokenize_batch([pairs[i][1] for i in idx], tokenizer, seq_len)
            batch = {"q_ids": q_ids, "q_mask": q_mask, "d_ids": d_ids, "d_mask": d_mask}
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(float(loss))
            if verbose:
                print(f"epoch {epoch} step {start // batch_size}: loss {losses[-1]:.4f}")

    embedder = MiniLMEmbedder(params=params, tokenizer=tokenizer, config=config, device=dev)
    embedder.losses = losses
    return embedder
