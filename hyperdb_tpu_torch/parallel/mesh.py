"""Device meshes: a ('data', 'model') grid of torch devices.

Counterpart of ``hyperdb_tpu/parallel/mesh.py``. A corpus scales out by
row-sharding its (N, d) matrix over the 'data' axis; encoder training
(``models/train.py``) splits its batch over 'data' and its projections over
the 'model' axis.

In one process a mesh is a list of devices, as JAX's single-controller mesh
is, and one device may hold several shards: the CPU tests shard over eight
``cpu`` entries, and one H100 holds 1 or 4 shards on ``cuda:0``. A mesh that
spans processes also carries the ``torch.distributed`` process group its
candidates are gathered over; its grid is this process's devices, and the
'data' axis counts the shards of every process (each holds the same number).
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """A grid of this process's devices with named axes.

    Args:
        devices: a (data, model) grid of devices, or a 1-D list (one axis),
            of ``torch.device`` or device strings.
        axis_names: one name per grid axis, ``("data", "model")`` by default.
        group: the ``torch.distributed`` process group of a mesh that spans
            processes (None: this process holds every shard).
    """

    def __init__(self, devices, axis_names=("data", "model"), group=None):
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for pos in np.ndindex(given.shape):
            grid[pos] = torch.device(given[pos])
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-D device grid needs {grid.ndim} axis names")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.group = group
        if group is None:
            self.rank, self.world = 0, 1
        else:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        # the 'data' axis (the first) counts the shards of every process
        sizes = list(grid.shape)
        sizes[0] *= self.world
        self.shape = dict(zip(self.axis_names, sizes))

    def local_devices(self, axis: str = "data") -> list[torch.device]:
        """This process's devices along ``axis`` (the first entry of every
        other axis), in shard order."""
        dim = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[dim]):
            index[dim] = i
            out.append(self.devices[tuple(index)])
        return out

    def first_shard(self, axis: str = "data") -> int:
        """Global index of this process's first shard along ``axis``."""
        return self.rank * len(self.local_devices(axis))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})}, "
                f"rank={self.rank}/{self.world})")


def make_mesh(n_devices: int | None = None, model_parallel: int = 1, device=None,
              group=None) -> Mesh:
    """Build a ('data', 'model') mesh of ``n_devices`` shards.

    ``device`` is the card unless the caller asks for the CPU (``"cpu"``);
    with CUDA the shards go round-robin over the visible cards (an indexed
    device such as ``"cuda:1"`` pins them to that one), so a mesh larger
    than the card count holds several shards per card. ``n_devices``
    defaults to the card count (1 on the CPU). A mesh asked for on the card
    where there is none raises: it never holds CPU shards in its place.
    ``group`` makes it a multi-process mesh: this process's ``n_devices``
    shards join every other rank's on the 'data' axis."""
    from hyperdb_tpu_torch.core.db import resolve_device

    pinned = device is not None and torch.device(device).index is not None
    dev = resolve_device(device)
    if dev.type == "cuda" and not pinned:
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        cards = [dev]
    if n_devices is None:
        n_devices = len(cards)
    if n_devices < 1:
        raise ValueError("A mesh needs at least one device.")
    if n_devices % model_parallel != 0:
        raise ValueError("n_devices must be divisible by model_parallel.")
    flat = [cards[i % len(cards)] for i in range(n_devices)]
    grid = [flat[r * model_parallel:(r + 1) * model_parallel]
            for r in range(n_devices // model_parallel)]
    return Mesh(grid, axis_names=("data", "model"), group=group)
