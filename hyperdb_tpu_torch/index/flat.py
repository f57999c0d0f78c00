"""Exact flat "index".

Brute-force scoring of small/medium corpora is one matmul and is faster
than any pre-filter, so below the IVF threshold the "ANN index" is simply
the exact scan: every document is a candidate. This
preserves the reference's ANN-path semantics (the candidate set is the whole
corpus) while the scoring itself is always exact (SURVEY.md Q3, consciously
fixed).
"""

from __future__ import annotations

import numpy as np


class FlatIndex:
    """Candidate generator that nominates every live document."""

    is_ann = False  # engine skips candidate masking entirely

    def __init__(self, metric: str, dim: int):
        self.metric = metric
        self.dim = dim

    def candidate_doc_mask(self, db, query_vector, budget: int) -> np.ndarray:
        return np.ones(len(db.documents), dtype=bool)

    # --- persistence hooks (sidecar round-trip parity with reference .ann) ---

    def state(self) -> dict:
        return {"kind": "flat", "metric": self.metric, "dim": self.dim}

    @classmethod
    def from_state(cls, state: dict) -> "FlatIndex":
        return cls(metric=str(state["metric"]), dim=int(state["dim"]))
