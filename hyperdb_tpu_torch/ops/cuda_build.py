"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``build/hyperdb_tpu_torch/`` beside
the package and loaded with ``ctypes``, at its first use — never when a
module is imported, so hosts without ``nvcc`` or a card import the package
and use the kernels' plain versions on CPU tensors. The library's file name
carries a hash of its source and flags, so an edited source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hyperdb_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels "
            "cannot be built"
        )
    return nvcc


def build(names=None) -> dict[str, Path]:
    """Compile every missing library among ``names`` (default: all sources),
    one ``nvcc`` process per source, all started together. Returns the
    library paths; raises with the compiler's output if any build fails.
    ``nvcc``'s ``-Xptxas=-v`` report lands in a ``.log`` beside each library."""
    names = sources() if names is None else list(names)
    paths = {name: library_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out = todo[name]
        out.with_suffix(".log").write_text(log)
        if proc.returncode:
            failed.append(f"nvcc failed on csrc/{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: concurrent loaders never see a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LIBS[name] = lib
        return lib
