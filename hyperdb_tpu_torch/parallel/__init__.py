"""Multi-device scale-out: meshes, the sharded exact top-k, sharded serving."""

from hyperdb_tpu_torch.parallel.distributed import (
    DistributedCorpus,
    ShardedRows,
    sharded_rank_top_k,
)
from hyperdb_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["DistributedCorpus", "Mesh", "ShardedRows", "make_mesh", "sharded_rank_top_k"]
