"""hyperdb_tpu_torch — the PyTorch/CUDA port of hyperdb_tpu.

Runs on an NVIDIA Hopper card (``device="cuda"``, the default) with
hand-written CUDA kernels for the scans the JAX package ran as Pallas
kernels; ``device="cpu"`` runs their plain PyTorch versions.
"""

import torch

__version__ = "0.1.0"

# f32 corpora must score in true f32, as the JAX package's dot-precision
# rule (Precision.HIGHEST for any f32 operand) does: TF32 keeps ~3 decimal
# digits and would reorder near-tied results against the reference.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from hyperdb_tpu_torch.ops.metrics import METRICS, scores  # noqa: E402
from hyperdb_tpu_torch.ops.ranking import (  # noqa: E402
    rank_top_k,
    ranking_algorithm_sort,
    recency_scores,
)
from hyperdb_tpu_torch.core.db import HyperDB  # noqa: E402

__all__ = ["HyperDB", "METRICS", "rank_top_k", "ranking_algorithm_sort", "scores"]
