"""IVF (inverted-file) index: a k-means coarse quantizer over the corpus.

Counterpart of ``hyperdb_tpu/index/ivf.py``, with the same state, the same
random draws and the same candidate contract:

- build: Lloyd k-means on a row sample (assignment is ``argmax(x . c -
  |c|^2 / 2)``, one matmul; the centroid update a sum over assigned rows),
  then one full assignment pass. Rows are kept bucketed by cluster (CSR
  layout: ``row_order`` + ``offsets``).
- determinism: the build gives the same clusters on the card as on the CPU,
  run after run. The centroid sums are exact integer sums of the rows in
  fixed point (:func:`_segment_mean`), which no summation order can change,
  where float atomics (``index_add_`` on the card) sum in another order on
  every run; the assignment logits are f64 (:func:`_assign`), where the
  products of f32 operands are exact and only the sums round, about 1e-16
  relative, so the card and the CPU part only on a near-tie that close. The
  JAX package sums in f32 (``segment_sum``): centroids agree with it within
  1e-5.
- query: rank the centroids against the query and walk clusters in that
  order until the candidate budget is covered (the reference's Q12 budget
  ``max(top_k * 20, ceil(N * ann_percent / 100))``); the engine rescores the
  candidates exactly.

cosine / angular / dot cluster on unit-norm rows, the other metrics on raw
rows; the index only generates candidates, so an L2 quantizer serves all.
k-means and assignment run on the index's device (torch); the probe walk and
the CSR bookkeeping are NumPy on the host, as in the JAX package. There is
no kernel here: the work is matmuls, argmax and gathers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_TRAIN_SAMPLE = 131072
_KMEANS_ITERS = 12
# f64 logits per assignment chunk: bounds the (rows, nlist) temporary
_ASSIGN_CELLS = 1 << 27
# Fixed-point bits below the largest training magnitude: a value becomes an
# integer of at most 2^40, so a sum of _TRAIN_SAMPLE (2^17) of them stays
# under 2^57 and fits int64 exactly.
_FIX_BITS = 40


def default_nlist(n: int) -> int:
    """sqrt-scaled cluster count, capped at 4096."""
    return int(min(4096, max(16, 2 * round(np.sqrt(n)))))


def _assign(rows: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row in L2: ``argmax(x . c - |c|^2 / 2)``,
    ties to the lower cluster (as ``jnp.argmax``). The logits are f64: the
    products of f32 operands are exact there, so the device's and the CPU's
    matmuls differ only in how they round their sums (about 1e-16 relative)
    and pick the same cluster short of a tie that close. Chunked over rows,
    which changes no result."""
    c = centroids.double()
    half_sq = 0.5 * torch.sum(c * c, dim=1)
    step = max(1, _ASSIGN_CELLS // max(1, c.shape[0]))
    parts = [
        torch.argmax(rows[a : a + step].double() @ c.T - half_sq, dim=1)
        for a in range(0, rows.shape[0], step)
    ]
    return torch.cat(parts)


def _segment_mean(train: torch.Tensor, assign: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Mean of the rows assigned to each cluster; an empty cluster keeps its
    ``prev`` centroid. The sums are exact: every value is scaled by a power
    of two to an integer of at most 2^_FIX_BITS (values below 2^-_FIX_BITS
    of the largest magnitude round to the nearest such step) and summed in
    int64, which no order of addition changes, so ``index_add_``'s atomics
    on the card give the CPU's sums bit for bit. The rest is elementwise
    and correctly rounded on both."""
    amax = float(train.abs().max()) if train.numel() else 0.0
    if not math.isfinite(amax):
        raise ValueError("IVF k-means needs finite rows")
    scale = 2.0 ** (_FIX_BITS - math.frexp(amax)[1])  # amax < 2^frexp exponent
    fixed = torch.round(train.double() * scale).long()
    nlist = prev.shape[0]
    sums = torch.zeros((nlist, train.shape[1]), dtype=torch.int64, device=train.device)
    sums.index_add_(0, assign, fixed)
    counts = torch.bincount(assign, minlength=nlist)
    mean = (sums.double() / scale) / torch.clamp(counts, min=1).double()[:, None]
    return torch.where((counts > 0)[:, None], mean.float(), prev)


def _kmeans(train: torch.Tensor, init: torch.Tensor, iters: int) -> torch.Tensor:
    """Lloyd iterations on the device; an empty cluster keeps its centroid."""
    centroids = init
    for _ in range(iters):
        centroids = _segment_mean(train, _assign(train, centroids), centroids)
    return centroids


def _unit_rows(data: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(data, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    return data / norms


class IVFIndex:
    is_ann = True
    kind = "ivf"

    def __init__(self, centroids, row_order, offsets, metric: str, normalized: bool,
                 device=None):
        from hyperdb_tpu_torch.core.db import resolve_device

        self.centroids = np.array(centroids, dtype=np.float32)  # owned: shared with torch
        self.row_order = np.asarray(row_order, dtype=np.int32)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.metric = metric
        self.normalized = bool(normalized)
        self.device = resolve_device(device)  # the card unless the caller asks for the CPU
        self.nlist = self.centroids.shape[0]
        self.dim = self.centroids.shape[1]
        self._sizes = np.diff(self.offsets)

    # ------------------------------------------------------------- build

    @classmethod
    def build(
        cls,
        vectors: np.ndarray,
        metric: str = "cosine",
        nlist: int | None = None,
        n_trees: int = 10,
        seed: int = 0,
        device_rows: torch.Tensor | None = None,
        device=None,
    ) -> "IVFIndex":
        """k-means over ``vectors`` (the (N, d) host master).

        ``device_rows`` is the store's padded (N_pad >= N, d) device plane,
        unit-norm for cosine/angular/dot: the sample is gathered and the
        assignment scanned there, so the build uploads nothing. Without it
        the rows are normalized on the host and the sample uploaded to
        ``device`` (the card unless the caller asks for the CPU). Both
        branches draw the sample and the initial centroids from
        ``np.random.default_rng(seed)`` in the JAX package's order, so the
        two packages start from the same rows."""
        from hyperdb_tpu_torch.core.db import resolve_device

        n, d = vectors.shape
        nlist = nlist or default_nlist(n)
        nlist = min(nlist, n)
        normalized = metric in ("cosine", "angular", "dot")
        rng = np.random.default_rng(seed)

        if device_rows is not None:
            dev = device_rows.device
            if n > _TRAIN_SAMPLE:
                train_idx = np.sort(rng.choice(n, size=_TRAIN_SAMPLE, replace=False))
            else:
                train_idx = np.arange(n)
            train = device_rows[torch.from_numpy(train_idx).to(dev)].float()
            init_idx = rng.choice(train_idx.size, size=nlist, replace=False)
            init = train[torch.from_numpy(init_idx).to(dev)]
            centroids = _kmeans(train, init, _KMEANS_ITERS)
            assign = _assign(device_rows[:n], centroids).cpu().numpy()
        else:
            dev = resolve_device(device)
            data = np.asarray(vectors, dtype=np.float32)
            if normalized:
                data = _unit_rows(data)
            if n > _TRAIN_SAMPLE:
                train = data[rng.choice(n, size=_TRAIN_SAMPLE, replace=False)]
            else:
                train = data
            init = train[rng.choice(train.shape[0], size=nlist, replace=False)]
            train_t = torch.from_numpy(np.ascontiguousarray(train)).to(dev)
            centroids = _kmeans(
                train_t, torch.from_numpy(np.ascontiguousarray(init)).to(dev), _KMEANS_ITERS,
            )
            assign = np.concatenate([
                _assign(torch.from_numpy(data[a : a + (1 << 20)]).to(dev), centroids)
                .cpu().numpy()
                for a in range(0, n, 1 << 20)
            ])

        assign = assign.astype(np.int64)
        row_order = np.argsort(assign, kind="stable").astype(np.int32)
        offsets = np.zeros(nlist + 1, dtype=np.int64)
        np.cumsum(np.bincount(assign, minlength=nlist), out=offsets[1:])
        return cls(centroids.cpu().numpy(), row_order, offsets, metric, normalized, device=dev)

    # ------------------------------------------------------------- update

    def add_rows(self, vectors: np.ndarray, first_row_id: int) -> None:
        """Assign appended rows to the existing clusters (one assignment
        matmul, no re-clustering) and splice their ids into the CSR. The DB
        rebuilds instead once the corpus outgrows the clustering by 50 %."""
        data = np.asarray(vectors, dtype=np.float32)
        if self.normalized:
            data = _unit_rows(data)
        assign = _assign(
            torch.from_numpy(np.ascontiguousarray(data)).to(self.device),
            torch.from_numpy(self.centroids).to(self.device),
        ).cpu().numpy()
        new_ids = np.arange(first_row_id, first_row_id + data.shape[0], dtype=np.int32)
        order = []
        for cluster in range(self.nlist):
            lo, hi = self.offsets[cluster], self.offsets[cluster + 1]
            order.append(self.row_order[lo:hi])
            added = new_ids[assign == cluster]
            if added.size:
                order.append(added)
        self.row_order = np.concatenate(order).astype(np.int32)
        counts = np.diff(self.offsets) + np.bincount(assign, minlength=self.nlist)
        self.offsets = np.zeros(self.nlist + 1, dtype=np.int64)
        np.cumsum(counts, out=self.offsets[1:])
        self._sizes = np.diff(self.offsets)

    @property
    def num_rows(self) -> int:
        return int(self.offsets[-1])

    # ------------------------------------------------------------- query

    def probe(self, query_vector: np.ndarray, budget: int) -> np.ndarray:
        """Candidate row ids: walk clusters by centroid score until the
        budget is covered. The centroid order is ``np.argsort`` as in the JAX
        package (not stable there either), so on the same state both
        packages walk the same clusters."""
        q = np.asarray(query_vector, dtype=np.float32).reshape(-1)
        if self.normalized:
            norm = np.linalg.norm(q)
            if norm > 0:
                q = q / norm
            order = np.argsort(-(self.centroids @ q))
        else:
            d2 = np.sum(self.centroids * self.centroids, axis=1) - 2 * (self.centroids @ q)
            order = np.argsort(d2)

        picked = []
        total = 0
        for cluster in order:
            lo, hi = self.offsets[cluster], self.offsets[cluster + 1]
            if hi <= lo:
                continue
            picked.append(self.row_order[lo:hi])
            total += hi - lo
            if total >= budget:
                break
        if not picked:
            return np.zeros(0, dtype=np.int32)
        return np.concatenate(picked)

    def probe_batch(self, q_block: np.ndarray, budget: int) -> tuple[np.ndarray, np.ndarray]:
        """Shared probe frontier for a (B, d) query block: each query walks
        its own centroid ranking as :meth:`probe` does, and the candidates
        are the UNION of the probed clusters. Returns ``(cand_ids, valid)``:
        (U,) int32 global row ids and a (B, U) bool matrix of the union rows
        each query probed."""
        q = np.asarray(q_block, dtype=np.float32)
        if self.normalized:
            q = _unit_rows(q)
            order = np.argsort(-(q @ self.centroids.T), axis=1)
        else:
            d2 = np.sum(self.centroids * self.centroids, axis=1)[None, :] - 2 * (
                q @ self.centroids.T
            )
            order = np.argsort(d2, axis=1)

        nq = q.shape[0]
        sizes = self._sizes
        covered = np.cumsum(sizes[order], axis=1)
        # probe cluster j iff the clusters ranked before it leave the budget uncovered
        probe_col = np.concatenate(
            [np.ones((nq, 1), dtype=bool), covered[:, :-1] < budget], axis=1
        )
        probed = np.zeros((nq, self.nlist), dtype=bool)
        np.put_along_axis(probed, order, probe_col, axis=1)
        probed &= sizes[None, :] > 0

        union_clusters = np.flatnonzero(probed.any(axis=0))
        if union_clusters.size == 0:
            return np.zeros(0, dtype=np.int32), np.zeros((nq, 0), dtype=bool)
        cand_ids = np.concatenate(
            [self.row_order[self.offsets[c] : self.offsets[c + 1]] for c in union_clusters]
        ).astype(np.int32)
        # probed[:, cluster_of_row], built row-major: the fancy column gather
        # returns a column-major (B, U) matrix, whose row slices the engine
        # then reads with a stride of B bytes
        return cand_ids, np.repeat(probed[:, union_clusters], sizes[union_clusters], axis=1)

    def candidate_doc_mask(self, db, query_vector, budget: int) -> np.ndarray:
        rows = self.probe(query_vector, budget)
        mask = np.zeros(len(db.documents), dtype=bool)
        if rows.size:
            mask[np.asarray(db.source_indices, dtype=np.int64)[rows]] = True
        return mask

    # ------------------------------------------------------------- persist

    def state(self) -> dict:
        return {
            "kind": "ivf",
            "metric": self.metric,
            "normalized": self.normalized,
            "centroids": self.centroids,
            "row_order": self.row_order,
            "offsets": self.offsets,
        }

    @classmethod
    def from_state(cls, state: dict, device=None) -> "IVFIndex":
        return cls(
            centroids=state["centroids"],
            row_order=state["row_order"],
            offsets=state["offsets"],
            metric=str(state["metric"]),
            normalized=bool(state["normalized"]),
            device=device,
        )
