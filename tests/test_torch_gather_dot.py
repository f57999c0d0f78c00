"""Stage 3's product, ``ranking.gather_dot``, on CPU tensors.

CPU tensors take the plain form (gather, upcast, batched product); bf16
operands on the card take ``csrc/gather_dot.cu``, which
``tests/test_torch_cuda.py`` holds to the plain form there. Here the plain
form is held to a float64 sum of the same bf16 values: every bf16 x bf16
product is exact in f32, so an f32 sum of d of them in any order lies within
gamma_d = d u / (1 - d u), u = 2^-24, of the exact sum, relative to the sum of
the products' magnitudes. Int8 rows must give exact integer sums, chunking
must change no bit, and no CPU tensor may reach the kernel's library.
"""

import numpy as np
import pytest
import torch

from hyperdb_tpu_torch.config import CONFIG
from hyperdb_tpu_torch.ops import cuda_build
from hyperdb_tpu_torch.ops import gmax as G
from hyperdb_tpu_torch.ops import quantized as Q
from hyperdb_tpu_torch.ops import ranking as R

RUNS = 17  # runs in each test plane; the last one, 16, is always a candidate


def _operands(b, k, width, d, seed, dtype=torch.bfloat16):
    """Seeded (b, d) queries, a (RUNS * width, d) plane and (b, k) run ids
    that hold the plane's last run and, where k > 1, one run twice."""
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        q = torch.from_numpy(rng.integers(-128, 128, (b, d), dtype=np.int8))
        rows = torch.from_numpy(rng.integers(-128, 128, (RUNS * width, d), dtype=np.int8))
    else:
        q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dtype)
        rows = torch.from_numpy(
            rng.standard_normal((RUNS * width, d)).astype(np.float32)
        ).to(dtype)
    cidx = rng.integers(0, RUNS, (b, k))
    cidx[:, -1] = RUNS - 1
    if k > 1:
        cidx[:, 0] = cidx[:, 1]
    return q, rows, torch.from_numpy(cidx)


def _exact(q, rows, cidx, width):
    """float64 products and the sums of their magnitudes, (b, k, width) each."""
    q64 = q.double()
    r64 = rows.double()
    full = r64 @ q64.T  # (n, b)
    mag = r64.abs() @ q64.abs().T
    b, k = cidx.shape
    pos = (cidx[..., None] * width + torch.arange(width)).reshape(b, -1)  # (b, k * width)
    cols = torch.arange(b)[:, None]
    return full[pos, cols].view(b, k, width), mag[pos, cols].view(b, k, width)


@pytest.mark.parametrize("b,k", [(1, 1), (3, 16), (64, 1)])
@pytest.mark.parametrize("d", [8, 768, 1536])
@pytest.mark.parametrize("width", [32, 128, 256])
def test_plain_form_within_f32_rounding_of_exact(b, k, width, d):
    q, rows, cidx = _operands(b, k, width, d, seed=width + d + b + k)
    got = R.gather_dot(q, rows, cidx, width)
    assert got.shape == (b, k, width) and got.dtype == torch.float32
    want, mag = _exact(q, rows, cidx, width)
    u = 2.0**-24
    gamma = d * u / (1 - d * u)
    assert ((got.double() - want).abs() <= gamma * mag).all()
    if k > 1:  # the same run twice gives the same bits
        assert torch.equal(got[:, 0], got[:, 1])


@pytest.mark.parametrize("cells", [1, 5 * 32 * 64, 64 * 32 * 64 - 1])
def test_chunking_changes_no_bit(monkeypatch, cells):
    """One query a chunk, a few, and all but the last: each the same bits as
    one chunk over all 64 queries."""
    q, rows, cidx = _operands(64, 16, 32, 64, seed=5)
    whole = R.gather_dot(q, rows, cidx, 32)
    monkeypatch.setattr(R, "_CHUNK_CELLS", cells)
    assert torch.equal(R.gather_dot(q, rows, cidx, 32), whole)


@pytest.mark.parametrize("width,d", [(32, 64), (128, 384), (128, 1040)])
def test_int8_rows_give_exact_integer_sums(width, d):
    """Int8 rows (``quantized._rescore_groups``) stay on the plain form on
    every device: their sums are integers, exact in f32 up to 127 * 127 *
    1040 < 2^24."""
    q, rows, cidx = _operands(5, 16, width, d, seed=d, dtype=torch.int8)
    got = R.gather_dot(q, rows, cidx, width)
    exact = rows.long() @ q.long().T  # (n, b) integers
    b, k = cidx.shape
    pos = (cidx[..., None] * width + torch.arange(width)).reshape(b, -1)
    want = exact[pos, torch.arange(b)[:, None]].view(b, k, width)
    assert torch.equal(got.long(), want)
    assert torch.equal(got, want.float())


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_other_float_rows_keep_the_plain_form(dtype):
    q, rows, cidx = _operands(3, 4, 32, 48, seed=2, dtype=dtype)
    got = R.gather_dot(q, rows, cidx, 32)
    want, mag = _exact(q, rows, cidx, 32)
    assert ((got.double() - want).abs() <= 48 * 2.0**-24 / (1 - 48 * 2.0**-24) * mag).all()


@pytest.fixture
def no_library(monkeypatch):
    """Every way to the kernel's library raises."""

    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor reached the gather_dot library")

    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(cuda_build, "build", refuse)
    monkeypatch.setattr(R, "_gather_dot_fn", refuse)
    monkeypatch.setattr(R, "gather_dot_kernel", refuse)


def test_cpu_tensors_never_reach_the_library(no_library, monkeypatch):
    """Direct calls in every dtype, and the three grouped routes whose stage
    3 it is (dot, the metric kernel route, the plain grouped metric route)
    plus the int8 one, on CPU tensors: each takes the plain form, with no
    load and no launch."""
    plain = []
    real_plain = R.gather_dot_plain
    monkeypatch.setattr(
        R, "gather_dot_plain", lambda *a: plain.append(a[1].dtype) or real_plain(*a)
    )
    before = dict(R.LAUNCHES)
    dtypes = (torch.bfloat16, torch.float16, torch.float32, torch.int8)
    for dtype in dtypes:
        q, rows, cidx = _operands(3, 4, 32, 64, seed=1, dtype=dtype)
        assert R.gather_dot(q, rows, cidx, 32).shape == (3, 4, 32)
    monkeypatch.setattr(CONFIG, "pallas_gmax_f_min_batch", 1)
    rng = np.random.default_rng(0)
    n, d, k = 4096, 64, 8
    v = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    v /= v.norm(dim=1, keepdim=True)
    vb = v.bfloat16()
    q = torch.from_numpy(rng.standard_normal((128, d)).astype(np.float32))
    qb = (q / q.norm(dim=1, keepdim=True)).bfloat16()
    assert G.rank_top_k_grouped_gmax(qb, vb, k)[1].shape == (128, k)
    sq = (vb.float() ** 2).sum(-1)
    assert G.rank_top_k_grouped_metric_gmax(q, vb, sq, k, "euclidean_metric")[1].shape == (128, k)
    # recency keeps the grouped metric route on its plain form
    ids = R.rank_top_k_grouped_metric(q, vb, sq, k, "euclidean_metric", recency=torch.zeros(n))[1]
    assert ids.shape == (128, k)
    v8 = (v * 127).round().to(torch.int8)
    ids = Q._rescore_groups(
        (q * 20).round().to(torch.int8), torch.ones(128), v8, torch.ones(n),
        torch.arange(128 * k).view(128, k) % (n // 128), 128, None, None,
    )[1]
    assert ids.shape == (128, k)
    assert plain == [*dtypes, torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.int8]
    assert R.LAUNCHES == before and set(R.LAUNCHES) == {"gather_dot"}


def test_kernel_wrapper_checks_its_operands(monkeypatch):
    """The kernel's wrapper refuses what the kernel does not take, before
    the library is loaded."""
    monkeypatch.setattr(R, "_gather_dot_fn", lambda: pytest.fail("loaded"))
    q = torch.empty((4, 64), dtype=torch.bfloat16, device="meta")
    rows = torch.empty((1024, 64), dtype=torch.bfloat16, device="meta")
    cidx = torch.empty((4, 8), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        R.gather_dot_kernel(q, rows, cidx, 32)
    before = dict(R.LAUNCHES)
    # meta tensors are not on the card: the dispatch keeps the plain form
    assert R.gather_dot(q, rows, cidx, 32).shape == (4, 8, 32)
    assert R.LAUNCHES == before


def test_source_carries_its_note():
    """``csrc/gather_dot.cu``: a plain C entry point, the note on what it
    replaces and what bounds it, a fixed summation order, and nothing of
    PyTorch's headers, the library's products, atomics or stage 1's kernel
    names (the benchmark's stage-1 readers match kernel names by substring)."""
    src = (cuda_build.CSRC / "gather_dot.cu").read_text()
    for needle in (
        'extern "C" int gather_dot(', "__global__", "gather_dot_kernel",
        "hyperdb_tpu/ops/pallas_gmax.py:668-673", "It replaces no Pallas kernel",
        "Bound on the H100: bytes", "12.9 GB a batch", "__shfl_xor_sync",
        "ld.global.nc.L1::no_allocate", "__bfloat1622float2",
    ):
        assert needle in src, needle
    for banned in (
        "torch/", "ATen", "cublas", "atomicAdd", "atomicMax", "gmax_wgmma_kernel", "gmax_stream_kernel",
    ):
        assert banned not in src, banned
    assert cuda_build.library_path("gather_dot").name.startswith("libgather_dot-")
