"""Drop-in compatibility package over the PyTorch/CUDA port.

Users of the reference (AdamCodd/local-hyperDB) import
``from hyperdb import HyperDB``; this package gives the same names over
``hyperdb_tpu_torch`` under ``hyperdb_torch`` — including the
``hyperdb_torch.hyperdb`` submodule path, its module-level constants and
``hyperdb_torch.ranking_algorithm`` — so switching engines changes only the
package name. It is the counterpart of the JAX package's ``hyperdb``. The
compat ``HyperDB`` keeps the reference's constructor metadata quirk (see
``hyperdb_torch/hyperdb.py``) and runs on the card unless the caller passes
``device="cpu"``; use ``hyperdb_tpu_torch.HyperDB`` for the fixed engine.
"""

from hyperdb_torch.hyperdb import *  # noqa: F401,F403 — mirrors the reference's __init__.py
from hyperdb_torch.ranking_algorithm import (  # noqa: F401
    cosine_similarity,
    dot_product,
    euclidean_metric,
    get_norm_vector,
    hamming_distance,
    hyperDB_ranking_algorithm_sort,
    jaccard_similarity,
    manhattan_distance,
    pearson_correlation,
)
