"""Scoring, ranking and the CUDA stage-1 kernels.

Exports the names of the JAX package's ``hyperdb_tpu.ops`` in its order.
Importing this package builds no kernel.
"""

from hyperdb_tpu_torch.ops.metrics import (
    METRICS,
    cosine_scores,
    dot_scores,
    euclidean_scores,
    hamming_scores,
    jaccard_scores,
    manhattan_scores,
    normalize,
    pearson_scores,
    scores,
)
from hyperdb_tpu_torch.ops.ranking import (
    GROUPED_METRICS,
    exact_top_k,
    exact_top_k_grouped,
    rank_docs_top_k,
    rank_gathered,
    rank_top_k,
    rank_top_k_grouped,
    rank_top_k_grouped_metric,
    rank_top_k_planar,
    ranking_algorithm_sort,
    recency_scores,
)

__all__ = [
    "METRICS",
    "cosine_scores",
    "dot_scores",
    "euclidean_scores",
    "hamming_scores",
    "jaccard_scores",
    "manhattan_scores",
    "normalize",
    "pearson_scores",
    "scores",
    "GROUPED_METRICS",
    "exact_top_k",
    "exact_top_k_grouped",
    "rank_top_k_grouped_metric",
    "rank_docs_top_k",
    "rank_gathered",
    "rank_top_k",
    "rank_top_k_grouped",
    "rank_top_k_planar",
    "ranking_algorithm_sort",
    "recency_scores",
]
