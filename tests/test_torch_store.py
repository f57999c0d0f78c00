"""Vector-store parity: bucket sizes and device planes against the JAX package.

Planes must be bit-equal: the port normalizes on the host exactly as the
JAX package does (f32, zero norm -> 1) and casts f32 -> bf16 with
round-to-nearest-even, as ml_dtypes does; bf16 planes are compared through
a uint16 view. The int8, binary and pearson views are built on the host
with the same NumPy expressions in both packages and must be bit-equal too
(NaN rows of the pearson plane compared as NaN, payloads aside).
"""

import numpy as np
import pytest
import torch

from hyperdb_tpu.core import store as JS
from hyperdb_tpu_torch.core import store as TS


def test_bucket_size_matches_jax():
    for n in list(range(0, 5000)) + [2**20 - 1, 2**20, 10**6, 2**20 + 1, 3 * 10**6, 2**24 + 7]:
        assert TS.bucket_size(n) == JS.bucket_size(n), n
    assert TS.bucket_size(1_000_000) == 1 << 20


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
def test_device_view_planes_bit_equal(dtype):
    rng = np.random.default_rng(0)
    v = (rng.standard_normal((1000, 48)) * 3).astype(dtype)
    v[7] = 0  # zero norm -> divided by 1
    v[8] = 1e-3
    js = JS.VectorStore(dtype)
    ts = TS.VectorStore(dtype, device="cpu")
    js.set(v)
    ts.set(v)
    src = list(range(1000))
    jdv, tdv = js.device_view(src), ts.device_view(src)
    assert tdv["n"] == jdv["n"] == 1000
    assert tdv["n_pad"] == jdv["n_pad"] == 1024
    for key in ("rows", "rows_norm"):
        j = np.asarray(jdv[key])
        t = tdv[key]
        want = torch.bfloat16 if dtype == np.float16 else torch.float32
        assert t.dtype == want and t.device.type == "cpu"
        t = t.view(torch.int16 if want == torch.bfloat16 else torch.int32).numpy()
        np.testing.assert_array_equal(t.view(_bits(j).dtype), _bits(j))
    for key in ("row_valid", "row_docs", "row_sq"):
        np.testing.assert_array_equal(tdv[key].numpy(), np.asarray(jdv[key]))


def test_append_and_invalidate():
    ts = TS.VectorStore(np.float16, device="cpu")
    ts.set(np.ones((3, 8)))
    dv = ts.device_view([0, 1, 2])
    assert ts.device_view([0, 1, 2]) is dv
    ts.append(np.zeros(8))
    assert ts.num_rows == 4 and ts.vectors.dtype == np.float16
    dv2 = ts.device_view([0, 1, 2, 3])
    assert dv2 is not dv and dv2["n"] == 4
    assert set(dv2) >= {"n", "n_pad", "row_valid"} and "rows" not in dv2  # lazy
    ts.invalidate()
    with pytest.raises(ValueError):
        ts.device_view([0, 1])


def test_host_view_matches_jax():
    rng = np.random.default_rng(1)
    v = rng.standard_normal((50, 16)).astype(np.float16)
    js, ts = JS.VectorStore(np.float16), TS.VectorStore(np.float16, device="cpu")
    js.set(v)
    ts.set(v)
    for key in ("rows", "rows_norm"):
        np.testing.assert_array_equal(ts.host_view()[key], js.host_view()[key])


def _stores(dtype, precision, n=1000, d=48, seed=2):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((n, d)) * 3).astype(dtype)
    v[7] = 0  # zero row: scale 0, popcount 0
    v[8] = 2.5  # constant row: a NaN row of the pearson plane
    js = JS.VectorStore(dtype, precision=precision)
    ts = TS.VectorStore(dtype, precision=precision, device="cpu")
    js.set(v)
    ts.set(v)
    return js, ts, list(range(n))


@pytest.mark.parametrize("precision", ["int8", "int8-pure"])
@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_int8_views_bit_equal(dtype, precision):
    js, ts, src = _stores(dtype, precision)
    jdv, tdv = js.device_view(src), ts.device_view(src)
    for key, want in (("rows_q", torch.int8), ("rowsn_q", torch.int8),
                      ("row_scales", torch.float32), ("rown_scales", torch.float32)):
        assert tdv[key].dtype == want and tdv[key].shape[0] == 1024
        np.testing.assert_array_equal(tdv[key].numpy(), np.asarray(jdv[key]))
    assert tdv["row_scales"][7] == 0 and not tdv["rows_q"][7].any()
    assert not tdv["rows_q"][1000:].any()  # padding rows quantize to zero
    assert ts.low_precision_device and js.low_precision_device
    if precision == "int8-pure":  # never holds float planes
        for key in ("rows", "rows_norm"):
            with pytest.raises(KeyError):
                tdv[key]
    else:
        assert tdv["rows_norm"].shape == (1024, 48)


@pytest.mark.parametrize("precision", ["int8", "int8-pure"])
def test_int8_views_bit_equal_over_chunks(monkeypatch, precision):
    """The int8 planes are quantized a chunk of rows at a time on several
    threads: at 7 rows a chunk (143 chunks and a ragged last one) they are
    the JAX package's whole-plane quantization bit for bit."""
    monkeypatch.setattr(TS, "_BUILD_CHUNK_ELEMS", 48 * 7)
    js, ts, src = _stores(np.float16, precision)
    jdv, tdv = js.device_view(src), ts.device_view(src)
    for key in ("rows_q", "rowsn_q", "row_scales", "rown_scales"):
        np.testing.assert_array_equal(tdv[key].numpy(), np.asarray(jdv[key]))


def test_binary_view_bit_equal_over_chunks(monkeypatch):
    """The same for the 0/1 plane and its popcounts."""
    monkeypatch.setattr(TS, "_BUILD_CHUNK_ELEMS", 48 * 7)
    js, ts, src = _stores(np.float16, "auto")
    jbv, tbv = js.binary_view(src), ts.binary_view(src)
    np.testing.assert_array_equal(
        tbv["rows_bin"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(jbv["rows_bin"]).view(np.uint16),
    )
    np.testing.assert_array_equal(tbv["row_bin_sum"].numpy(), np.asarray(jbv["row_bin_sum"]))
    assert not tbv["rows_bin"][1000:].any() and not tbv["row_bin_sum"][1000:].any()


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_binary_and_pearson_views_bit_equal(dtype):
    js, ts, src = _stores(dtype, "auto")
    jbv, tbv = js.binary_view(src), ts.binary_view(src)
    assert tbv["rows_bin"].dtype == torch.bfloat16  # whatever the master dtype
    np.testing.assert_array_equal(
        tbv["rows_bin"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(jbv["rows_bin"]).view(np.uint16),
    )
    np.testing.assert_array_equal(tbv["row_bin_sum"].numpy(), np.asarray(jbv["row_bin_sum"]))
    assert ts.binary_view(src) is tbv and "rows_bin" in ts.device_view(src)

    jpv, tpv = js.pearson_view(src), ts.pearson_view(src)
    want = torch.bfloat16 if dtype == np.float16 else torch.float32
    t = tpv["rows_pearson"]
    assert t.dtype == want
    j = np.asarray(jpv["rows_pearson"])
    nan = np.isnan(j.astype(np.float32))
    assert nan[[7, 8]].all() and nan.sum() == 96  # the constant rows, on purpose
    np.testing.assert_array_equal(torch.isnan(t.float()).numpy(), nan)
    t = t.view(torch.int16 if want == torch.bfloat16 else torch.int32).numpy()
    np.testing.assert_array_equal(t.view(_bits(j).dtype)[~nan], _bits(j)[~nan])
    assert ts.low_precision_device == (dtype == np.float16)
    ts.append(np.ones(48))
    assert "rows_pearson" not in ts.device_view(src + [1000])  # rebuilt after a mutation
