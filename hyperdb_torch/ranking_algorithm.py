"""Reference-shaped ranking API over the PyTorch/CUDA port.

Counterpart of the JAX package's ``hyperdb/ranking_algorithm.py``: the
reference's names and numpy-in, numpy-out single-query contracts, scored by
:mod:`hyperdb_tpu_torch.ops.metrics` on float32 tensors. Each scoring
function and the sort take ``device``: the card unless the caller asks for
the CPU. Nothing here mutates its inputs (the reference's binarizer does).

One difference from the JAX layer: ``euclidean_scores`` expands the squared
distance in float64 before rounding the score to float32 (the JAX layer
expands in float32), so euclidean scores and distances agree with the
reference's difference form to the last float32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from hyperdb_tpu_torch.core.db import resolve_device
from hyperdb_tpu_torch.ops import metrics as _m
from hyperdb_tpu_torch.ops.ranking import ranking_algorithm_sort


def get_norm_vector(vector):
    """L2-normalize rows; zero norms are treated as 1, and NaN entries print
    the reference's warning."""
    vector = np.asarray(vector, dtype=np.float64)
    norms = np.linalg.norm(vector, axis=-1, keepdims=True)
    norms[norms == 0] = 1
    nan_indices = np.where(np.isnan(vector))
    if nan_indices[0].size > 0:
        print(f"Warning: Vectors at indices {nan_indices} contain NaN values.")
    return vector / norms


def _single(fn, vectors, query_vector, device):
    dev = resolve_device(device)
    v = torch.from_numpy(np.asarray(vectors, dtype=np.float32)).to(dev)
    q = torch.from_numpy(np.asarray(query_vector, dtype=np.float32).reshape(1, -1)).to(dev)
    return fn(q, v)[0].cpu().numpy()


def dot_product(vectors, query_vector, device=None):
    return _single(_m.dot_scores, vectors, query_vector, device)


def cosine_similarity(vectors, query_vector, device=None):
    return _single(_m.cosine_scores, vectors, query_vector, device).flatten()


def euclidean_metric(vectors, query_vector, get_similarity_score=True, device=None):
    v = np.asarray(vectors, dtype=np.float32)
    if v.ndim != 2:
        raise ValueError("vectors must be 2D")
    sims = _single(_m.euclidean_scores, v, query_vector, device)
    if get_similarity_score:
        return sims
    return 1.0 / sims - 1.0  # invert the 1/(1+d) transform back to distance


def manhattan_distance(vectors, query_vector, device=None):
    return _single(_m.manhattan_scores, vectors, query_vector, device)


def jaccard_similarity(vectors, query_vector, device=None):
    return _single(_m.jaccard_scores, vectors, query_vector, device)


def pearson_correlation(vectors, query_vector, device=None):
    return _single(_m.pearson_scores, vectors, query_vector, device)


def hamming_distance(vectors, query_vector, device=None):
    return _single(_m.hamming_scores, vectors, query_vector, device)


def check_and_binarize_vectors(vectors):
    """Pure binarization: 1 where an entry is positive, else 0, in the
    input's dtype; the input is left as it was."""
    vectors = np.asarray(vectors)
    out = np.zeros_like(vectors)
    out[vectors > 0] = 1
    return out


def hyperDB_ranking_algorithm_sort(
    vectors, query_vector, top_k=5, metric="cosine_similarity",
    timestamps=None, recency_bias=0, device=None,
):
    return ranking_algorithm_sort(
        vectors, query_vector, top_k=top_k, metric=metric,
        timestamps=timestamps, recency_bias=recency_bias, device=device,
    )
