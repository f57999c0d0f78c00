"""The host's CPUs as a served run sees them: SMT siblings and the card's
NUMA node.

Everything here reads ``/proc`` and ``/sys`` and writes nothing. Which CPUs
the server and the load processes take is a pure function of the affinity
set and the sibling map, :func:`place`, so that it is tested on made-up
maps; the card's NUMA node is read only for the run's lines.
"""

from __future__ import annotations

from pathlib import Path

SYS_CPU = Path("/sys/devices/system/cpu")
SYS_PCI = Path("/sys/bus/pci/devices")


def parse_cpulist(text: str) -> list[int]:
    """CPUs of a kernel CPU list such as ``"0-3,8,10-11"``."""
    out: list[int] = []
    for part in text.strip().split(","):
        if not part:
            continue
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def smt_siblings(cpus, root: Path = SYS_CPU) -> dict[int, frozenset[int]]:
    """Each CPU's SMT siblings, itself included, from
    ``cpuN/topology/thread_siblings_list`` (a CPU whose list cannot be read
    is its own core)."""
    out = {}
    for c in cpus:
        try:
            out[c] = frozenset(parse_cpulist((root / f"cpu{c}" / "topology" / "thread_siblings_list").read_text()))
        except (OSError, ValueError):
            out[c] = frozenset([c])
    return out


def card_bus_id(index: int = 0) -> str | None:
    """The card's PCI address as sysfs names it (``0000:1b:00.0``), from
    CUDA's device properties; None where there is no card to ask."""
    try:
        import torch

        p = torch.cuda.get_device_properties(index)
        return f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:{p.pci_device_id:02x}.0"
    except (AssertionError, AttributeError, RuntimeError):
        return None


def card_numa(bus_id: str | None, root: Path = SYS_PCI) -> tuple[int | None, list[int]]:
    """(NUMA node, local CPUs) of the PCI device ``bus_id``: (None, []) where
    sysfs does not say (a node of -1 is none)."""
    if not bus_id:
        return None, []
    dev = root / bus_id
    try:
        node = int((dev / "numa_node").read_text())
    except (OSError, ValueError):
        node = -1
    try:
        cpus = parse_cpulist((dev / "local_cpulist").read_text())
    except (OSError, ValueError):
        cpus = []
    return (node if node >= 0 else None), cpus


def cores(cpus, siblings: dict[int, frozenset[int]]) -> list[list[int]]:
    """``cpus`` grouped into physical cores (each core's CPUs among ``cpus``,
    by :func:`smt_siblings`), in the order of their lowest CPU."""
    cpus = set(cpus)
    groups = {frozenset(siblings.get(c, frozenset([c])) & cpus) | {c} for c in cpus}
    return sorted((sorted(g) for g in groups), key=lambda g: g[0])


def place(affinity, siblings: dict[int, frozenset[int]], processes: int) -> tuple[list[int], list[list[int]]]:
    """(server CPUs, each load process's CPUs), as clients on another host
    would be placed: each of the ``processes`` load processes takes one
    whole physical core of ``affinity``, the last ones, and every SMT
    sibling of those cores leaves the server's set. Where that would leave
    the server no core, both sides run on every CPU of ``affinity``."""
    groups = cores(affinity, siblings)
    allc = sorted(set(affinity))
    if processes >= len(groups):
        return allc, [allc for _ in range(processes)]
    load = groups[-processes:]
    taken = {c for g in load for c in g}
    return [c for c in allc if c not in taken], load
