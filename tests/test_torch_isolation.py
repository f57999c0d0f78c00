"""The port stands alone and runs on the card unless asked otherwise.

- No file of ``hyperdb_tpu_torch/`` and not ``chip_smoke.py`` imports
  ``jax``, ``flax``, ``hyperdb_tpu`` or ``hyperdb`` (AST scan).
- ``HyperDB(...)`` without ``device=`` raises where CUDA is missing.
- The kernel wrappers take their plain versions for CPU tensors only: any
  other tensor goes to the kernel, and a kernel library that cannot be
  built or loaded raises, with no fallback.
- The in-repo encoder's assets are found by path, from any working
  directory, with no module of the JAX package loaded.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import hyperdb_tpu_torch
from hyperdb_tpu_torch.core.db import resolve_device
from hyperdb_tpu_torch.ops import cuda_build
from hyperdb_tpu_torch.ops import gmax as G
from hyperdb_tpu_torch.ops import l1 as L

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hyperdb_tpu", "hyperdb")


def _port_files():
    files = sorted((ROOT / "hyperdb_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert path.exists(), path
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_local_assets_found_without_the_jax_package(tmp_path):
    script = (
        "import sys\n"
        "from hyperdb_tpu_torch.models.minilm import MiniLMEmbedder\n"
        "emb = MiniLMEmbedder.from_local_assets(device='cpu')\n"
        "assert emb is not None and emb.dim == 384 and emb.config.layers == 4\n"
        "assert emb.encode(['a short text']).shape == (1, 384)\n"
        "loaded = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "assert not loaded, loaded\n" % (FORBIDDEN,)
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env, check=True, timeout=120)


def test_package_import_disables_tf32():
    assert hyperdb_tpu_torch.HyperDB is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hyperdb_tpu_torch.HyperDB(["a"], np.ones((1, 4), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.fixture
def no_kernel_library(monkeypatch, tmp_path):
    """Point the loader at a build directory with no library and a toolkit
    with no ``nvcc``: every kernel load must fail."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))


def test_wrappers_raise_without_kernel(no_kernel_library):
    q = torch.empty((128, 128), dtype=torch.bfloat16, device="meta")
    v = torch.empty((1024, 128), dtype=torch.bfloat16, device="meta")
    extra = torch.empty((1024,), dtype=torch.float32, device="meta")
    before = dict(G.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        G.gmax_f(q, v, extra)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        G.gmax_f_sub(q, v, extra)
    q_sum = torch.empty((128, 1), dtype=torch.float32, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        G.gmax_jaccard(q, v, q_sum, extra, extra)
    q8 = torch.empty((128, 128), dtype=torch.int8, device="meta")
    v8 = torch.empty((1024, 128), dtype=torch.int8, device="meta")
    q_scale = torch.empty((128,), dtype=torch.float32, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        G.gmax_int8(q8, q_scale, v8, extra, extra)
    assert G.LAUNCHES == before
    assert set(G.LAUNCHES) == {"gmax_f_sub", "gmax_f", "gmax_int8", "gmax_jaccard"}
    # the same shapes on CPU tensors take the plain versions
    cpu = [torch.zeros(t.shape, dtype=t.dtype) for t in (q, v, extra)]
    assert G.gmax_f(*cpu).shape == (128, 8)
    assert G.gmax_jaccard(cpu[0], cpu[1], torch.zeros(128, 1), cpu[2], cpu[2]).shape == (128, 8)
    cpu8 = [torch.zeros(t.shape, dtype=t.dtype) for t in (q8, q_scale, v8)]
    assert G.gmax_int8(*cpu8, cpu[2], cpu[2]).shape == (128, 8)
    assert G.LAUNCHES == before


def test_l1_wrappers_raise_without_kernel(no_kernel_library, monkeypatch):
    """``gmax_l1`` / ``gmax_l1t`` and the manhattan route above them: a
    tensor off the CPU reaches the kernel and the failed build raises; no
    streamed scan or plain version steps in."""
    from hyperdb_tpu_torch.ops import ranking as R

    q = torch.empty((64, 128), dtype=torch.float32, device="meta")
    v = torch.empty((1024, 128), dtype=torch.bfloat16, device="meta")
    extra = torch.empty((1024,), dtype=torch.float32, device="meta")
    before = dict(L.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        L.gmax_l1(q, v, extra)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        L.gmax_l1t(q, v.t().contiguous(), extra)
    monkeypatch.setattr(L, "rank_top_k_manhattan_stream", lambda *a, **kw: pytest.fail("stream"))
    monkeypatch.setattr(L, "gmax_l1_plain", lambda *a, **kw: pytest.fail("plain version"))
    monkeypatch.setattr(L, "gmax_l1t_plain", lambda *a, **kw: pytest.fail("plain version"))
    for l1t in (1, 0):
        monkeypatch.setattr(L.CONFIG, "pallas_l1t", l1t)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            L.rank_top_k_manhattan_l1(q, v, 4)
    monkeypatch.setattr(R.CONFIG, "grouped_topk_min_rows", 512)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        R.rank_top_k(q, v, 4, metric="manhattan_distance")
    assert L.LAUNCHES == before and set(L.LAUNCHES) == {"gmax_l1", "gmax_l1t"}
    # the same shapes on CPU tensors take the plain versions
    cpu = [torch.zeros(t.shape, dtype=t.dtype) for t in (q, v, extra)]
    monkeypatch.undo()
    assert L.gmax_l1(*cpu).shape == (64, 8)
    assert L.gmax_l1t(cpu[0], cpu[1].t().contiguous(), cpu[2]).shape == (64, 8)
    assert L.LAUNCHES == before


def test_l1_wrappers_check_their_operands(monkeypatch):
    """With a library in place the wrappers refuse what the kernel does not
    take, before any launch."""
    monkeypatch.setattr(L, "_scan_fn", lambda: pytest.fail)
    q = torch.empty((64, 128), dtype=torch.float32, device="meta")
    v = torch.empty((1024, 128), dtype=torch.bfloat16, device="meta")
    extra = torch.empty((1024,), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        L._launch(L._KIND_L1, q, v, extra, 1024)


def test_routes_raise_without_kernel(no_kernel_library, monkeypatch):
    """The routes above the wrappers give way to nothing either: a tensor
    that is not on the CPU reaches the kernel, and the failed build raises
    through ``rank_top_k_int8`` and ``rank_top_k_grouped_metric``."""
    from hyperdb_tpu_torch.ops import quantized as Q
    from hyperdb_tpu_torch.ops import ranking as R

    monkeypatch.setattr(Q, "_EPILOGUE_BUDGET_BYTES", 1 << 10)
    # meta tensors cannot be quantized or top-k'd: stand in for those steps
    monkeypatch.setattr(
        Q, "_quantize_device",
        lambda x: (x.to(torch.int8), torch.empty((x.shape[0],), device=x.device)),
    )
    q = torch.empty((512, 128), dtype=torch.float32, device="meta")
    v8 = torch.empty((8192, 128), dtype=torch.int8, device="meta")
    scales = torch.empty((8192,), dtype=torch.float32, device="meta")
    before = dict(G.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        Q.rank_top_k_int8(q, v8, scales, 10)
    rows = torch.empty((8192, 128), dtype=torch.bfloat16, device="meta")
    for metric in R.GROUPED_METRICS:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            R.rank_top_k_grouped_metric(q, rows, scales, 10, metric)
    assert G.LAUNCHES == before


def test_missing_library_file_raises(no_kernel_library, monkeypatch, tmp_path):
    missing = tmp_path / "libgmax-missing.so"
    monkeypatch.setattr(cuda_build, "build", lambda names=None: {"gmax": missing})
    with pytest.raises(OSError):
        cuda_build.load("gmax")
    assert "gmax" not in cuda_build._LIBS


def test_build_flags_and_sources():
    # the four stage-1 scans (gmax_f_sub, gmax_f, gmax_int8, gmax_jaccard) are
    # instantiations of one template in each of two variants: gmax_wgmma.cu
    # (wgmma fed by TMA) and gmax.cu (mma.sync fed by cp.async); l1.cu holds
    # the two manhattan kernels
    assert cuda_build.sources() == ["gmax", "gmax_wgmma", "l1"]
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    # no fast-math: the jaccard division and the NaN scrub must be IEEE
    assert not any("fast" in flag for flag in cuda_build.NVCC_FLAGS)
    src = (cuda_build.CSRC / "gmax.cu").read_text()
    for needle in ("m16n8k32.row.col.s32.s8.s8.s32", "__fmul_rn", "__fdiv_rn", "KIND_JACCARD"):
        assert needle in src
    new = (cuda_build.CSRC / "gmax_wgmma.cu").read_text()
    for needle in (
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8",
        "cp.async.bulk.tensor", "mbarrier", "setmaxnreg", "const __grid_constant__ CUtensorMap",
        "cuTensorMapEncodeTiled", "__fmul_rn", "KIND_JACCARD",
        "hyperdb_tpu/ops/pallas_gmax.py", "Bound on the H100: operations",
    ):
        assert needle in new, needle
    for text in (src, new):
        for banned in ("#include <torch", "ATen", "cublas", "cutlass/gemm/device", "later work"):
            assert banned not in text, banned
    p = cuda_build.library_path("gmax")
    assert p.parent == cuda_build.BUILD_DIR and p.name.startswith("libgmax-")
    assert cuda_build.library_path("gmax_wgmma").name.startswith("libgmax_wgmma-")


@pytest.mark.parametrize("variant", ["wgmma", "mma"])
def test_either_variant_raises_without_kernel(no_kernel_library, monkeypatch, variant):
    """Both variants reach the loader and raise when their library cannot be
    built, by the shape rule and when forced; neither gives way to the other
    or to a plain version."""
    for name in ("gmax_f_plain", "gmax_f_sub_plain", "gmax_int8_plain", "gmax_jaccard_plain"):
        monkeypatch.setattr(G, name, lambda *a, **kw: pytest.fail("plain version"))
    d = 128 if variant == "wgmma" else 1024  # 256- and 2048-byte rows
    assert G.kernel_variant(1024, d, 2) == variant
    loaded = []
    real_load = cuda_build.load
    monkeypatch.setattr(cuda_build, "load", lambda name: loaded.append(name) or real_load(name))
    q = torch.empty((128, d), dtype=torch.bfloat16, device="meta")
    v = torch.empty((1024, d), dtype=torch.bfloat16, device="meta")
    extra = torch.empty((1024,), dtype=torch.float32, device="meta")
    before = dict(G.LAUNCHES), dict(G.LAUNCHES_BY_VARIANT)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        G.gmax_f_sub(q, v, extra)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        G.gmax_f(q, v, extra)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        G.gmax_jaccard(q, v, torch.empty((128, 1), device="meta"), extra, extra)
    q8 = torch.empty((128, 2 * d), dtype=torch.int8, device="meta")
    v8 = torch.empty((1024, 2 * d), dtype=torch.int8, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        G.gmax_int8(q8, torch.empty((128,), device="meta"), v8, extra, extra)
    source = G._VARIANTS[variant][0]
    assert loaded == [source] * 4
    # forced: the other variant's loader is reached whatever the rule says
    other = "mma" if variant == "wgmma" else "wgmma"
    sm = torch.empty((128, 32), dtype=torch.float32, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        G._launch(G._KIND_F, q, v, extra, sm, None, 32, _variant=other)
    assert loaded[-1] == G._VARIANTS[other][0]
    assert (dict(G.LAUNCHES), dict(G.LAUNCHES_BY_VARIANT)) == before


def test_l1_source_carries_its_note():
    """``csrc/l1.cu``: hand-written CUDA with a plain C entry point, the note
    on which TPU kernels it replaces and what bounds it, and nothing of
    PyTorch's headers (they would turn a build of seconds into minutes)."""
    src = (cuda_build.CSRC / "l1.cu").read_text()
    for needle in (
        "hyperdb_tpu/ops/pallas_l1.py", "gmax_l1 (_l1_kernel)", "gmax_l1t (_l1t_kernel)",
        "Bound on the H100: operations", 'extern "C" int l1_scan', "__global__",
        "KIND_L1T", "__shfl_xor_sync", "fabsf",
    ):
        assert needle in src, needle
    for banned in ("torch/", "ATen", "atomicMax", "atomicMin", "atomicCAS", "cublas", "mma."):
        assert banned not in src, banned
    doc = L.__doc__
    assert "hyperdb_tpu/ops/pallas_l1.py" in doc and "Bound on the H100: operations" in doc
    assert cuda_build.library_path("l1").name.startswith("libl1-")


def test_index_thresholds_keep_the_card_default(monkeypatch):
    """With an index asked for, ``HyperDB`` without ``device=`` still
    raises where CUDA is missing: no index builds on the CPU by default."""
    from hyperdb_tpu_torch.config import CONFIG
    from hyperdb_tpu_torch.core import db as DB

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(DB, "IVF_THRESHOLD", 1)
    monkeypatch.setattr(CONFIG, "projscan_threshold", 1)
    v = np.ones((4, 8), np.float32)
    for precision in ("auto", "int8-pure"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            hyperdb_tpu_torch.HyperDB([{"i": i} for i in range(4)], v, device_precision=precision)


@pytest.mark.parametrize("kind", ["ivf", "projscan"])
def test_index_restore_keeps_the_card_default(monkeypatch, kind):
    """``index_from_state`` without ``device=`` restores onto the card, as
    ``HyperDB`` and the index builds do: where CUDA is missing it raises
    instead of keeping the state on the CPU."""
    from hyperdb_tpu_torch.index import index_from_state
    from hyperdb_tpu_torch.index.ivf import IVFIndex
    from hyperdb_tpu_torch.index.projscan import ProjScanIndex

    rows = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    if kind == "ivf":
        state = IVFIndex.build(rows, nlist=4, device="cpu").state()
    else:
        state = ProjScanIndex.build(rows, d_prime=4, device="cpu").state()
    assert index_from_state(state, device="cpu").kind == kind
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        index_from_state(state)


def test_projscan_stage_a_raises_without_kernel(no_kernel_library, monkeypatch):
    """A projscan stage A off the CPU reaches ``gmax_int8``; a kernel
    library that cannot be built raises, and the group-16 scan never steps
    in."""
    from hyperdb_tpu_torch.index import projscan as P

    monkeypatch.setattr(
        P, "_quantize_device",
        lambda x: (x.to(torch.int8), torch.empty((x.shape[0],), device=x.device)),
    )
    monkeypatch.setattr(P, "_gmax_int8_groups16", lambda *a, **kw: pytest.fail("group-16 scan"))
    monkeypatch.setattr(G, "gmax_int8_plain", lambda *a, **kw: pytest.fail("plain version"))
    n, d, dp = 1 << 14, 384, 128
    index = P.ProjScanIndex(
        np.eye(d, dp, dtype=np.float32),
        torch.empty((n, dp), dtype=torch.int8, device="meta"),
        torch.empty((n,), dtype=torch.float32, device="meta"),
        n,
    )
    q = torch.empty((1024, d), dtype=torch.float32, device="meta")
    v8 = torch.empty((n, d), dtype=torch.int8, device="meta")
    scales = torch.empty((n,), dtype=torch.float32, device="meta")
    before = dict(G.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        index.search(q, v8, scales, k=16, overfetch=256)
    assert G.LAUNCHES == before


def test_native_host_library_is_the_ports_own(tmp_path):
    """The port builds its C++ host library from its own sources into
    ``build/hyperdb_tpu_torch/`` and never maps the JAX package's
    ``hyperdb_tpu/native/libhyperdb_host.so``: a process that runs every
    native path of the port (both servers, the client, the three tokenizer
    call sites, the merge) holds only the port's library, and no module of
    the JAX package."""
    script = (
        "import sys, numpy as np\n"
        "from hyperdb_tpu_torch import HyperDB\n"
        "from hyperdb_tpu_torch.client import HyperDBClient\n"
        "from hyperdb_tpu_torch.core.chunker import default_tokenizer\n"
        "from hyperdb_tpu_torch.models.minilm import ASSETS_DIR\n"
        "from hyperdb_tpu_torch.models.wordpiece import WordPieceTokenizer\n"
        "from hyperdb_tpu_torch.native import tokenizer as T\n"
        "from hyperdb_tpu_torch.native.server import NativeQueryServer\n"
        "from hyperdb_tpu_torch.query.filters import tokenize\n"
        "import hyperdb_tpu_torch.__main__, hyperdb_tpu_torch.server\n"
        "assert WordPieceTokenizer.load(ASSETS_DIR + '/vocab.txt').text_ids('a b') \n"
        "assert tokenize('Some Words') == {'some', 'words'}\n"
        "assert default_tokenizer().encode('x y') == ['x', 'y']\n"
        "T.native_merge_topk(np.ones(4, np.float32), np.arange(4), 2)\n"
        "v = np.eye(8, dtype=np.float32)\n"
        "db = HyperDB(documents=[{'i': i} for i in range(8)], vectors=v, device='cpu')\n"
        "with NativeQueryServer(db, port=0) as srv, HyperDBClient('127.0.0.1', srv.port) as c:\n"
        "    assert c.query(v[3], top_k=1)[0][0] == 3\n"
        "maps = open('/proc/self/maps').read()\n"
        "libs = {l.split()[-1] for l in maps.splitlines() if 'libhyperdb_host' in l}\n"
        "assert libs == {str(T.library_path())}, libs\n"
        "assert '/build/hyperdb_tpu_torch/' in T.library_path().as_posix()\n"
        "assert not any('hyperdb_tpu/native' in p for p in libs)\n"
        "loaded = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "assert not loaded, loaded\n" % (FORBIDDEN,)
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), HYPERDB_CHUNK_TOKENIZER="word")
    subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env, check=True, timeout=300)
