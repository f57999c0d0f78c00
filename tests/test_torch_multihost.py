"""The multi-process mesh and serving on ``torch.distributed`` (gloo, CPU).

Each test runs one of the port's launchers
(``hyperdb_tpu_torch/tools/multihost_*dryrun.py``): two ranks, spawned as
processes of their own, each with 4 ``cpu`` shards of one 8-shard mesh,
the layout of the JAX package's tests/test_multihost.py (2 processes x 4
devices). The launchers bind their own free ports (the group's rendezvous
and the serving control channel), so parallel test workers never collide,
and every rank is waited for or killed through its own process handle
before the test returns.
"""

import importlib.util
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "hyperdb_tpu_torch", "tools")


def _launch(script: str, timeout: float, *argv: str) -> str:
    out = subprocess.run(
        [sys.executable, os.path.join(TOOLS, script), "--device", "cpu", *argv],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT,
    )
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    return out.stdout


def test_two_process_mesh_matches_oracle():
    """The f32 and int8 sharded top-k, gathered across two processes, match
    a NumPy oracle of the whole corpus in every rank."""
    out = _launch("multihost_dryrun.py", 120, "--timeout", "100")
    assert out.count("f32 sharded top-k matches the oracle") == 2
    assert out.count("int8 sharded top-k matches the oracle") == 2
    assert "MULTIHOST DRYRUN: OK" in out


def test_two_process_serving_control_flow():
    """The leader relays query blocks, the follower runs the same
    collectives; the array surface matches the oracle three times, the
    native front end serves the whole mesh, and the document-level surface
    holds across the process boundary: 11 checks against the single-process
    engine (a chunked corpus with a relayed refill, metadata, sentence and
    skip_doc filters, recency, key-filter overrides, plane reuse), then
    int8-pure serving."""
    out = _launch("multihost_serve_dryrun.py", 150, "--timeout", "120")
    assert "MULTIHOST SERVE DRYRUN: OK (launcher)" in out
    assert "DOCUMENT SURFACE: 11 checks + refill + plane reuse OK" in out, out[-3000:]
    assert "refill relayed a deeper fetch: OK" in out
    assert "INT8 SERVING: OK" in out


def test_hung_follower_raises_within_deadline():
    """A follower that stops reading its control socket surfaces as a
    leader-side RuntimeError within the ack deadline, before the leader
    enters the collective, instead of deadlocking the group."""
    out = _launch("multihost_fault_dryrun.py", 120, "--timeout", "100",
                  "--ack-timeout", "3", "--raise-deadline", "20")
    assert "hung follower raised in" in out
    assert "MULTIHOST FAULT DRYRUN: OK (launcher)" in out


@pytest.mark.parametrize(
    "script", ["multihost_dryrun.py", "multihost_serve_dryrun.py", "multihost_fault_dryrun.py"]
)
def test_launcher_takes_the_card_unless_told(script, monkeypatch):
    """Without ``--device`` a launcher puts its ranks on the card: where
    there is none it raises before it spawns a rank. ``--device cpu`` is
    the caller's own choice."""
    from hyperdb_tpu_torch.parallel import launch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(launch, "spawn", lambda *a, **k: pytest.fail("a rank was spawned"))
    spec = importlib.util.spec_from_file_location(f"_launcher_{script[:-3]}",
                                                  os.path.join(TOOLS, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [script])
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main()
    assert launch.launcher_device("cpu") == "cpu"
    assert launch.default_backend("cpu") == "gloo"
