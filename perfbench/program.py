"""The system under test, as a user reaches it: ``hyperdb_tpu_torch``.

Only the drivers call this module; the reference and the judge never do.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch


def build_db(master: np.ndarray, probe_query: np.ndarray, config: dict, device):
    """``HyperDB(documents=[{}] * n, vectors=master, fp_precision=...,
    device_precision=...)`` as the configuration states them, and its device
    planes, which the engine builds at the first query: one query
    ``probe_query`` at the configuration's k, ending in the read-back of its
    answer. Returns (db, seconds on the host clock)."""
    from hyperdb_tpu_torch import HyperDB

    t0 = time.perf_counter()
    db = HyperDB(
        documents=[{}] * int(master.shape[0]),
        vectors=master,
        fp_precision=config["fp_precision"],
        device_precision=config["device_precision"],
        device=device,
    )
    db.query_batch_arrays(probe_query[None, :], top_k=int(config["top_k"]), metric=config["metric"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return db, time.perf_counter() - t0


def free(device) -> None:
    """Let go of the program's device memory once its objects are dropped
    (a store and its device view refer to each other: collect the cycle)."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
