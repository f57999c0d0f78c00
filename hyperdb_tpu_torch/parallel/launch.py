"""Start the ranks of a multi-process mesh on one host.

The launchers in ``hyperdb_tpu_torch/tools/multihost_*dryrun.py`` spawn
their ranks as processes of their own (``spawn``), each of which joins the
process group through :func:`init_group` at ``tcp://127.0.0.1:<port>`` on a
port the launcher bound itself (:func:`free_port`). Nothing tells a program
of a cluster: the address, world size and rank are passed explicitly.
"""

from __future__ import annotations

import datetime
import socket
import subprocess
import sys

import torch


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launcher_device(device: str | None) -> str:
    """The ranks' device: the card unless the caller names another (``cpu``).
    Raises where the card is asked for and there is none."""
    from hyperdb_tpu_torch.core.db import resolve_device

    device = device or "cuda"
    resolve_device(device)
    return device


def default_backend(device: str) -> str:
    """``nccl`` on the card, ``gloo`` on the CPU: a default, never a silent
    switch (a caller that names a backend gets that backend or an error)."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_group(rank: int, world: int, port: int, backend: str, device: str,
               timeout_s: float = 300.0):
    """Join the process group as ``rank`` of ``world``; returns this rank's
    device (the card is made current) and the group. ``cuda`` without an
    index puts rank r on card ``r % device_count``: one rank per card where
    there are enough, every rank on the one card where there is one."""
    import torch.distributed as dist

    from hyperdb_tpu_torch.core.db import resolve_device

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return dev, dist.group.WORLD


def spawn(script: str, procs: int, argv: list[str], cwd: str, env=None) -> list:
    """Start ``procs`` ranks of ``script`` (``--worker <rank>`` appended to
    ``argv``), stdout and stderr merged into one pipe each."""
    return [
        subprocess.Popen(
            [sys.executable, script, *argv, "--worker", str(rank)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=cwd, env=env,
        )
        for rank in range(procs)
    ]


def finish(procs: list, timeout_s: float) -> list[tuple[int, str]]:
    """Wait for every rank; a rank still running at the deadline is killed
    (its own handle, never a pattern kill). Returns (rc, output) per rank."""
    out = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
            text += "\n(killed at the launcher's deadline)"
        out.append((p.returncode, text))
    return out
