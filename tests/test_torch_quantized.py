"""Int8 path parity: ``hyperdb_tpu_torch.ops.quantized`` and the int8 stage-1
scan against the JAX package.

The same seeded numpy inputs go through ``hyperdb_tpu.ops.quantized`` /
``pallas_gmax.gmax_int8`` (Pallas in interpret mode) and through the port on
CPU tensors (the kernel wrapper's plain version).

Tolerances. Quantized rows, scales and query quantization are bit-equal
(both sides run the same f32 expressions, rounding half to even). The
integer dot is exact on both sides and the epilogue is the same sequence of
f32 operations, but XLA may contract ``dot * scale + extra`` into one fused
multiply-add where torch rounds twice: scores agree to 1e-6 relative plus
1e-6 absolute. The f32 rescore sums 64..128 products in different orders:
1e-5 relative plus 1e-5 absolute. -inf positions must agree exactly and ids
must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperdb_tpu.ops import pallas_gmax as PG
from hyperdb_tpu.ops import quantized as JQ
from hyperdb_tpu_torch.ops import gmax as G
from hyperdb_tpu_torch.ops import quantized as TQ

RTOL = ATOL = 1e-6


@pytest.fixture(autouse=True)
def fresh_jax_programs():
    """The JAX package's own tests count calls made while its jitted routes
    are traced; leave them no compiled program of this file's shapes."""
    yield
    PG.rank_top_k_int8_pallas.clear_cache()
    JQ.rank_top_k_int8.clear_cache()


def _data(n, d, b, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[7] = 0.0  # zero row: scale 0, scores 0 + extra
    q = rng.standard_normal((b, d)).astype(np.float32)
    mask = rng.random(n) < 0.9
    mask[7] = True
    rec = (rng.random(n) * 0.01).astype(np.float32)
    return v, q, mask, rec


def _same_scores(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = ~np.isneginf(want)
    assert np.isfinite(got[fin]).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


def test_quantize_rows_bit_equal():
    v, _, _, _ = _data(3000, 48, 1, 0)
    v[11] = 1e-30
    v[12, 3] = 5.0
    jq, js = JQ.quantize_rows(v)
    tq, ts = TQ.quantize_rows(v)
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts, js)
    assert ts[7] == 0 and not tq[7].any()
    assert tq.dtype == np.int8 and ts.dtype == np.float32


def test_quantize_rows_blocks_change_nothing(monkeypatch):
    v, _, _, _ = _data(1000, 32, 1, 1)
    want = TQ.quantize_rows(v)
    monkeypatch.setattr(TQ, "_QUANTIZE_BLOCK_CELLS", 32 * 7)
    got = TQ.quantize_rows(v)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_quantize_device_bit_equal():
    _, q, _, _ = _data(8, 64, 33, 2)
    q[3] = 0.0
    q[4] = np.round(q[4] * 4) / 8 * np.abs(q[4]).max()  # halves: round half to even
    jq, js = JQ._quantize_device(jnp.asarray(q))
    tq, ts = TQ._quantize_device(torch.from_numpy(q))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_int8_scores_match_jax():
    v, q, _, _ = _data(512, 64, 8, 3)
    v_i8, sc = TQ.quantize_rows(v)
    jq, js = JQ._quantize_device(jnp.asarray(q))
    tq, ts = TQ._quantize_device(torch.from_numpy(q))
    want = JQ.int8_scores(jq, js, jnp.asarray(v_i8), jnp.asarray(sc))
    got = TQ.int8_scores(tq, ts, torch.from_numpy(v_i8), torch.from_numpy(sc))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # no add to contract


@pytest.mark.parametrize("masked, recency", [(True, True), (True, False), (False, False)])
def test_gmax_int8_plain_matches_pallas(masked, recency):
    n, d, b = 8192, 128, 16
    v, q, mask, rec = _data(n, d, b, 4)
    mask[256:384] = False  # one whole group masked
    v[1024:1152] = 0.0  # a whole group of zero-scale rows
    v_i8, sc = TQ.quantize_rows(v)
    jq, js = JQ._quantize_device(jnp.asarray(q))
    tq, ts = TQ._quantize_device(torch.from_numpy(q))
    jextra = PG.make_extra(
        n, jnp.asarray(mask) if masked else None, jnp.asarray(rec) if recency else None
    )
    textra = G.make_extra(
        n, torch.from_numpy(mask) if masked else None,
        torch.from_numpy(rec) if recency else None,
    )
    want = PG.gmax_int8(jq, js, jnp.asarray(v_i8), jnp.asarray(sc), jextra, interpret=True)
    before = dict(G.LAUNCHES)
    got = G.gmax_int8(tq, ts, torch.from_numpy(v_i8), torch.from_numpy(sc), textra)
    assert G.LAUNCHES == before  # CPU tensors never launch a kernel
    _same_scores(got, want)
    if masked:
        assert torch.isneginf(got[:, 2]).all()
    want_zero = textra[1024:1152].max()
    assert (got[:, 8] == want_zero).all()  # zero rows score 0 + extra, not NaN


def test_gmax_int8_plain_scrubs_nan():
    """An infinite scale against a zero dot is NaN: scrubbed to -inf."""
    q = torch.zeros(2, 16, dtype=torch.int8)
    v = torch.ones(128, 16, dtype=torch.int8)
    qs = torch.tensor([float("inf"), 1.0])
    vs = torch.ones(128)
    got = G.gmax_int8_plain(q, qs, v, vs, torch.zeros(128))
    assert torch.isneginf(got[0]).all() and (got[1] == 0).all()


def _rank_both(v, q, mask, rec, k, rescore, **kw):
    v_i8, sc = TQ.quantize_rows(v)
    jm = None if mask is None else jnp.asarray(mask)
    jr = None if rec is None else jnp.asarray(rec)
    tm = None if mask is None else torch.from_numpy(mask)
    tr = None if rec is None else torch.from_numpy(rec)
    jv, ji = JQ.rank_top_k_int8(
        jnp.asarray(q), jnp.asarray(v_i8), jnp.asarray(sc), k=k, row_mask=jm, recency=jr,
        rescore_rows=jnp.asarray(v) if rescore else None,
    )
    tv, ti = TQ.rank_top_k_int8(
        torch.from_numpy(q), torch.from_numpy(v_i8), torch.from_numpy(sc), k, row_mask=tm,
        recency=tr, rescore_rows=torch.from_numpy(v) if rescore else None,
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    tol = 1e-5 if rescore else RTOL
    _same_scores(tv, jv, rtol=tol, atol=tol)
    return ti


@pytest.mark.parametrize("rescore", [False, True])
@pytest.mark.parametrize(
    "mask_on, rec_on", [(False, False), (True, False), (True, True)]
)
@pytest.mark.parametrize(
    "n, b, k",
    [
        (4096, 8, 10),  # grouped form, group 256
        (8192, 128, 5),  # grouped form, group 128
        (600, 4, 10),  # n % group != 0: flat form
    ],
)
def test_rank_top_k_int8_matches_jax(n, b, k, mask_on, rec_on, rescore):
    v, q, mask, rec = _data(n, 64, b, n + b)
    _rank_both(v, q, mask if mask_on else None, rec if rec_on else None, k, rescore)


@pytest.mark.parametrize("rescore", [False, True])
def test_rank_top_k_int8_kernel_route_matches_jax(monkeypatch, rescore):
    """With the epilogue budget lowered the port sends stage 1 to gmax_int8
    (its plain version here), where the JAX package on the CPU runs its
    row-chunked scan: both are exact over the same quantized scores."""
    monkeypatch.setattr(JQ, "_EPILOGUE_BUDGET_BYTES", 1 << 18)
    monkeypatch.setattr(TQ, "_EPILOGUE_BUDGET_BYTES", 1 << 18)
    JQ.rank_top_k_int8.clear_cache()  # the budget is read when the scan is traced
    n, b, k = 8192, 32, 6
    assert TQ._pick_chunks(b, n, 256) > 1
    calls = []
    real = G.gmax_int8
    monkeypatch.setattr(G, "gmax_int8", lambda *a: calls.append(a[0].shape) or real(*a))
    v, q, mask, rec = _data(n, 128, b, 21)
    _rank_both(v, q, mask, rec, k, rescore)
    assert calls == [(b, 128)]


def test_kernel_route_needs_supported_shapes(monkeypatch):
    """d % 16 != 0 is outside the kernel's contract: such scans keep the
    plain grouped form even past the budget, and the route itself raises."""
    monkeypatch.setattr(TQ, "_EPILOGUE_BUDGET_BYTES", 1 << 16)
    v, q, _, _ = _data(4096, 24, 32, 5)
    v_i8, sc = TQ.quantize_rows(v)
    monkeypatch.setattr(G, "gmax_int8", lambda *a: pytest.fail("kernel route taken"))
    TQ.rank_top_k_int8(torch.from_numpy(q), torch.from_numpy(v_i8), torch.from_numpy(sc), 5)
    with pytest.raises(ValueError, match="d % 16"):
        G.rank_top_k_int8_gmax(
            torch.from_numpy(q), torch.from_numpy(v_i8), torch.from_numpy(sc), 5
        )


def test_pick_chunks_matches_jax():
    for b, n, group in [(256, 10_485_760, 128), (8, 65536, 128), (512, 1 << 20, 128),
                        (1024, 1 << 20, 128), (4096, 1 << 20, 128), (64, 3 * (1 << 18), 256)]:
        assert TQ._pick_chunks(b, n, group) == JQ._pick_chunks(b, n, group)
    assert TQ._pick_chunks(512, 1 << 20, 128) == 1  # exactly the budget: one chunk
    assert TQ._pick_chunks(1024, 1 << 20, 128) == 2
    assert TQ._EPILOGUE_BUDGET_BYTES == JQ._EPILOGUE_BUDGET_BYTES


@pytest.mark.parametrize("mask_on, rec_on", [(False, False), (True, True)])
def test_rank_top_k_int8_gmax_matches_pallas(mask_on, rec_on):
    n, d, b, k = 8192, 128, 16, 10
    v, q, mask, rec = _data(n, d, b, 6)
    v[40] = v[300] = v[9]  # equal rows in three groups: the lower id first
    q[0] = v[9]
    mask[[9, 40, 300]] = True
    rec[[9, 40, 300]] = 0.0
    v_i8, sc = TQ.quantize_rows(v)
    jv, ji = PG.rank_top_k_int8_pallas(
        jnp.asarray(q), jnp.asarray(v_i8), jnp.asarray(sc), k=k,
        row_mask=jnp.asarray(mask) if mask_on else None,
        recency=jnp.asarray(rec) if rec_on else None, interpret=True,
    )
    tv, ti = G.rank_top_k_int8_gmax(
        torch.from_numpy(q), torch.from_numpy(v_i8), torch.from_numpy(sc), k,
        row_mask=torch.from_numpy(mask) if mask_on else None,
        recency=torch.from_numpy(rec) if rec_on else None,
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _same_scores(tv, jv)
    assert ti[0, :3].tolist() == [9, 40, 300]


def test_rescore_groups_chunking_changes_nothing(monkeypatch):
    from hyperdb_tpu_torch.ops import ranking as TR

    v, q, mask, rec = _data(4096, 64, 12, 8)
    v_i8, sc = TQ.quantize_rows(v)
    tq, ts = TQ._quantize_device(torch.from_numpy(q))
    gidx = torch.from_numpy(np.random.default_rng(1).integers(0, 32, (12, 5)))
    args = (tq, ts, torch.from_numpy(v_i8), torch.from_numpy(sc), gidx, 128,
            torch.from_numpy(mask), torch.from_numpy(rec))
    want = TQ._rescore_groups(*args)
    monkeypatch.setattr(TR, "_CHUNK_CELLS", 5 * 128 * 64)  # a few queries per chunk
    got = TQ._rescore_groups(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
