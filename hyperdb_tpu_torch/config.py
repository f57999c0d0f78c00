"""Engine configuration for the PyTorch/CUDA port.

Only the knobs this package reads, under the SAME environment-variable
names as ``hyperdb_tpu/config.py``, so one deployment's settings mean the
same thing in both packages. The values are read when the module is
imported; tests change them by monkeypatching ``CONFIG`` attributes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env_int(name: str, default: int):
    def read() -> int:
        try:
            return int(os.environ.get(name, default))
        except ValueError:
            return default

    return field(default_factory=read)


def _env_float(name: str, default: float):
    def read() -> float:
        try:
            return float(os.environ.get(name, default))
        except ValueError:
            return default

    return field(default_factory=read)


@dataclass
class EngineConfig:
    # Minimum padded row count before dot/cosine scans take the grouped
    # (group-max + rescore) exact top-k instead of one wide top-k. 0 disables.
    grouped_topk_min_rows: int = _env_int("HYPERDB_GROUPED_TOPK_MIN_ROWS", 262144)
    # Master switch of the hand-written stage-1 scan kernels (ops/gmax.py).
    # 0 disables them: every scan then takes the plain grouped route.
    pallas_gmax: int = _env_int("HYPERDB_PALLAS_GMAX", 1)
    # Minimum query-batch height before bf16 dot-form grouped scans route
    # stage 1 through the gmax kernels. 0 disables the float route.
    pallas_gmax_f_min_batch: int = _env_int(
        "HYPERDB_PALLAS_GMAX_F_MIN_BATCH", 512
    )
    # Minimum query-batch height before large-corpus manhattan scans route
    # stage 1 through the L1 kernels (ops/l1.py) instead of the streamed
    # scan. 0 disables the kernel route.
    pallas_l1_min_batch: int = _env_int("HYPERDB_PALLAS_L1_MIN_BATCH", 64)
    # 1: stage 1 of the manhattan kernel route scans a transposed (d, N)
    # copy of the corpus (gmax_l1t), made once per call, while the corpus
    # stays under ops/l1._L1T_MAX_BYTES; 0: the in-place kernel (gmax_l1)
    # everywhere.
    pallas_l1t: int = _env_int("HYPERDB_PALLAS_L1T", 1)
    # Subgroup width of the two-level selection (gmax_f_sub): stage 1 emits
    # per-SUB-row maxes, selection narrows top-k groups to top-k subgroups,
    # and stage 3 rescores only (B, k, SUB, d) rows. Must divide 128 and be
    # at least 8; anything else (0 included) selects single-level gmax_f.
    pallas_subgroup: int = _env_int("HYPERDB_PALLAS_SUBGROUP", 32)
    # 1: the kernel writes group AND subgroup maxes; 0: subgroup maxes only,
    # with the group maxes taken as a max over each run outside the kernel
    # (bitwise identical — max is exact).
    pallas_sub_dual: int = _env_int("HYPERDB_PALLAS_SUB_DUAL", 0)
    # Row count from which a corpus builds an IVF index (index/ivf.py) and
    # routes eligible single queries through its candidate pre-filter.
    # Opt-in (1<<62 disables), as in the JAX package.
    ivf_threshold: int = _env_int("HYPERDB_IVF_THRESHOLD", 1 << 62)
    # IVF cluster count of the DB's index builds; 0 = the sqrt-scaled
    # default (ivf.default_nlist). The JAX package declares this name but
    # never reads it, so a nonzero value makes the two packages cluster
    # differently.
    ivf_nlist: int = _env_int("HYPERDB_IVF_NLIST", 0)
    # Row count from which query_batch routes an IVF-indexed corpus through
    # the shared probe frontier (query/engine._rank_block_ivf). Opt-in.
    batch_ivf_min_rows: int = _env_int("HYPERDB_BATCH_IVF_MIN_ROWS", 1 << 62)
    # Row count from which an int8-pure corpus builds the two-stage
    # reduced-rank index (index/projscan.py) and serves dot/cosine through
    # its stage-A scan plus an exact int8 rescore. Opt-in.
    projscan_threshold: int = _env_int("HYPERDB_PROJSCAN_THRESHOLD", 1 << 62)
    # Stage-A rank (projected dimension) and candidate overfetch per query.
    projscan_dprime: int = _env_int("HYPERDB_PROJSCAN_DPRIME", 96)
    projscan_overfetch: int = _env_int("HYPERDB_PROJSCAN_OVERFETCH", 256)
    # Decline the projscan build (exact scan instead) when the top-d' PCA
    # directions keep less than this fraction of the sample variance.
    # 0 disables the gate.
    projscan_min_variance: float = _env_float("HYPERDB_PROJSCAN_MIN_VARIANCE", 0.5)
    # Rank on the host (NumPy) when corpus_rows * batch is at most this many
    # score cells: below it a device launch costs more than the scan.
    # 0 disables.
    host_path_max_cells: int = _env_int("HYPERDB_HOST_PATH_MAX_CELLS", 65536)
    # Pad query_batch's batch dimension up to the next power of two (pad
    # rows repeat row 0 and are sliced off the results), so both packages
    # scan the same batch shapes. 0 disables.
    batch_bucket: int = _env_int("HYPERDB_BATCH_BUCKET", 1)


CONFIG = EngineConfig()
