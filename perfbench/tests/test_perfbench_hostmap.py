"""Where a served run puts the server and its load processes: whole physical
cores for the load, their SMT siblings out of the server's set, decided from
made-up sibling and NUMA maps; and the sysfs readers those maps come from."""

from __future__ import annotations

import pytest

from perfbench.hostmap import card_bus_id, card_numa, cores, parse_cpulist, place, smt_siblings


def smt(n: int) -> dict[int, frozenset[int]]:
    """``n`` CPUs as ``n // 2`` cores, CPU ``c`` beside ``c + n // 2``."""
    h = n // 2
    return {c: frozenset({c % h, c % h + h}) for c in range(n)}


def flat(n: int) -> dict[int, frozenset[int]]:
    return {c: frozenset([c]) for c in range(n)}


def test_parse_cpulist():
    assert parse_cpulist("0-3,8,10-11\n") == [0, 1, 2, 3, 8, 10, 11]
    assert parse_cpulist("5") == [5] and parse_cpulist("") == []


def test_cores_group_siblings_within_the_set():
    assert cores(range(8), smt(8)) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert cores([0, 1, 4], smt(8)) == [[0, 4], [1]]  # 5 is not ours


@pytest.mark.parametrize("processes", [1, 2, 3])
def test_each_load_process_takes_a_whole_core_and_its_siblings_leave_the_server(processes):
    server, load = place(range(8), smt(8), processes)
    assert load == [[0, 4], [1, 5], [2, 6], [3, 7]][4 - processes:]
    assert server == sorted(c for g in [[0, 4], [1, 5], [2, 6], [3, 7]][: 4 - processes] for c in g)


def test_no_smt():
    server, load = place(range(8), flat(8), 1)
    assert server == [0, 1, 2, 3, 4, 5, 6] and load == [[7]]
    server, load = place(range(8), flat(8), 3)
    assert server == [0, 1, 2, 3, 4] and load == [[5], [6], [7]]


@pytest.mark.parametrize("siblings", [flat(1), smt(2)], ids=["one-cpu", "one-smt-core"])
def test_one_core_is_shared(siblings):
    every = sorted(siblings)
    server, load = place(every, siblings, 1)
    assert server == every and load == [every]


def test_as_many_processes_as_cores_share_every_cpu():
    server, load = place(range(4), flat(4), 4)
    assert server == [0, 1, 2, 3] and load == [[0, 1, 2, 3]] * 4
    server, load = place(range(8), smt(8), 3)
    assert len(server) == 2 and all(len(cpus) == 2 for cpus in load)  # three of four cores still leave one


def test_only_the_affinity_set_counts():
    server, load = place([2, 3, 6, 7], smt(8), 1)
    assert server == [2, 6] and load == [[3, 7]]
    server, load = place([1, 2, 3, 6], smt(8), 2)  # 7, 3's sibling, is not ours
    assert server == [1] and load == [[2, 6], [3]]


def test_sysfs_readers(tmp_path):
    for c, text in enumerate(["0,2", "1,3", "0,2", "1,3"]):
        d = tmp_path / "cpu" / f"cpu{c}" / "topology"
        d.mkdir(parents=True)
        (d / "thread_siblings_list").write_text(text + "\n")
    sib = smt_siblings([0, 1, 2, 3, 4], root=tmp_path / "cpu")
    assert sib[0] == {0, 2} and sib[3] == {1, 3} and sib[4] == {4}
    dev = tmp_path / "pci" / "0000:1b:00.0"
    dev.mkdir(parents=True)
    (dev / "numa_node").write_text("1\n")
    (dev / "local_cpulist").write_text("4-7\n")
    assert card_numa("0000:1b:00.0", root=tmp_path / "pci") == (1, [4, 5, 6, 7])
    (dev / "numa_node").write_text("-1\n")
    assert card_numa("0000:1b:00.0", root=tmp_path / "pci") == (None, [4, 5, 6, 7])
    assert card_numa(None) == (None, []) and card_numa("0000:99:00.0", root=tmp_path / "pci") == (None, [])


def test_no_card_no_bus_id():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is there to ask")
    assert card_bus_id() is None
