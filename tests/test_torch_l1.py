"""Manhattan (L1) parity: the port's plain stage-1 versions, its kernel
route and its streamed scan against the JAX package.

The same seeded numpy inputs go through ``hyperdb_tpu.ops.pallas_l1``
(``gmax_l1`` / ``gmax_l1t`` / ``rank_top_k_manhattan_pallas``, Pallas in
interpret mode) and ``hyperdb_tpu.ops.ranking.rank_top_k_manhattan_stream``,
and through the port on CPU tensors, where the kernel wrappers take their
plain versions.

Tolerances. Group maxes are f32 sums of d terms taken in different orders:
``rtol 1e-5, atol 1e-4`` on ``-L1`` (the JAX package's own tolerance between
its kernel and its reference). The route and the stream rescore with the
true ``1/(1 + L1)``: ids must be identical, scores within ``rtol 1e-6``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperdb_tpu.config import CONFIG as JAX_CONFIG
from hyperdb_tpu.ops import pallas_l1 as PL
from hyperdb_tpu.ops import ranking as JR
from hyperdb_tpu.ops.pallas_gmax import make_extra
from hyperdb_tpu_torch.config import CONFIG as TORCH_CONFIG
from hyperdb_tpu_torch.ops import l1 as L
from hyperdb_tpu_torch.ops import ranking as TR

RTOL, ATOL = 1e-5, 1e-4
B, N, D = 8, 8192, 128


@pytest.fixture(autouse=True, scope="module")
def fresh_jax_programs():
    """Leave the JAX package's own tests no compiled program of this file's
    shapes (some read the config while they are traced)."""
    yield
    for fn in (
        PL.gmax_l1, PL.gmax_l1t, PL.rank_top_k_manhattan_pallas,
        JR.rank_top_k_manhattan_stream, JR.rank_top_k,
    ):
        fn.clear_cache()


def _inputs(seed, b=B, n=N, d=D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    v = rng.standard_normal((n, d)).astype(np.float32)
    mask = rng.random(n) < 0.9
    rec = (rng.random(n) * 0.05).astype(np.float32)
    return q, v, mask, rec


def _case(name):
    """(q, v, mask) of one stage-1 case; ``v`` may be bf16-rounded."""
    q, v, mask, _ = _inputs(sum(map(ord, name)))
    if name == "no_mask":
        mask = None
    elif name == "masked_group":
        mask[256:384] = False
    elif name == "nan_row":
        v[100, 5] = np.nan  # sinks its row only, not its group
    elif name == "nan_query":
        q[3, 7] = np.nan
    elif name == "nan_row_and_query":
        v[100, 5] = np.nan
        q[3, 5] = np.nan
    return q, v, mask


CASES = ("mask", "no_mask", "masked_group", "nan_row", "nan_query", "nan_row_and_query")


def _jax_extra(n, mask):
    return make_extra(n, None if mask is None else jnp.asarray(mask))


def _torch_extra(n, mask):
    return L.make_extra(n, None if mask is None else torch.from_numpy(mask))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_gmax_l1_plain_matches_pallas(case, bf16):
    q, v, mask = _case(case)
    jv, tv = jnp.asarray(v), torch.from_numpy(v)
    if bf16:
        jv, tv = jv.astype(jnp.bfloat16), tv.bfloat16()
    want = np.asarray(PL.gmax_l1(jnp.asarray(q), jv, _jax_extra(N, mask), interpret=True))
    before = dict(L.LAUNCHES)
    got = L.gmax_l1(torch.from_numpy(q), tv, _torch_extra(N, mask)).numpy()
    assert L.LAUNCHES == before  # CPU tensors never launch a kernel
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if case == "masked_group":
        assert np.isneginf(got[:, 2]).all()
    if case in ("nan_query", "nan_row_and_query"):
        assert np.isneginf(got[3]).all() and np.isfinite(np.delete(got, 3, 0)).all()
    if case == "nan_row":
        assert np.isfinite(got).all()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_gmax_l1t_plain_matches_pallas(case, bf16):
    """The first oracle of ``gmax_l1t``: group MINS of the distance, +inf on
    a dead group, and a NaN query bottoming out at the finite ~1e30."""
    q, v, mask = _case(case)
    jv, tv = jnp.asarray(v), torch.from_numpy(v)
    if bf16:
        jv, tv = jv.astype(jnp.bfloat16), tv.bfloat16()
    want = np.asarray(PL.gmax_l1t(jnp.asarray(q), jv.T, _jax_extra(N, mask), interpret=True))
    before = dict(L.LAUNCHES)
    got = L.gmax_l1t(torch.from_numpy(q), tv.t().contiguous(), _torch_extra(N, mask)).numpy()
    assert L.LAUNCHES == before
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if case == "masked_group":
        assert np.isposinf(got[:, 2]).all()
    if case in ("nan_query", "nan_row_and_query"):
        assert (got[3] >= 1e29).all()


@pytest.mark.parametrize("case", ["mask", "masked_group", "nan_row"])
def test_two_contracts_agree_after_negation(case):
    """``-gmax_l1t`` is ``gmax_l1`` wherever no query is NaN (there the one
    bottoms out at -inf and the other at about -1e30). The transposed plain
    version sums over a strided block, so the two agree within summation
    noise, not bit for bit."""
    q, v, mask = _case(case)
    extra = _torch_extra(N, mask)
    tq, tv = torch.from_numpy(q), torch.from_numpy(v).bfloat16()
    a = L.gmax_l1_plain(tq, tv, extra).numpy()
    t = -L.gmax_l1t_plain(tq, tv.t().contiguous(), extra).numpy()
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(t))
    np.testing.assert_allclose(t, a, rtol=RTOL, atol=ATOL)


def _route_case(name):
    """(q, v, mask, recency, k) of one route case."""
    b, n, d, k = 16, N, D, 10
    if name == "margin_clamp":
        b, n, k = 8, 2048, 2048 // 128  # k == g: the overfetch clamps
    elif name == "d96":
        b, d, k = 8, 96, 5
    elif name == "d100":
        b, n, d, k = 8, 2 * N, 100, 5  # d % 8 != 0: off the kernel route in both
    elif name == "few_groups":
        b, n, k = 8, 2 * N, 200  # n // 128 < k: the stream
    elif name == "recency":
        n = 2 * N  # two stream tiles (one tile alone would materialise)
    q, v, mask, rec = _inputs(sum(map(ord, name)), b, n, d)
    if name == "duplicates":
        v[1000] = v[0]  # exact duplicates in different groups
        v[2000] = v[0]
        q[0] = v[0] + 0.01
    elif name == "nan_row":
        v[100, 5] = np.nan
    elif name == "nan_query":
        q[3, 7] = np.nan
    if name in ("no_mask", "duplicates", "margin_clamp"):
        mask = None
    return q, v, mask, (rec if name == "recency" else None), k


ROUTE_CASES = (
    "mask", "no_mask", "duplicates", "nan_row", "nan_query", "margin_clamp",
    "d96", "d100", "few_groups", "recency",
)


def _both_routes(q, v, mask, rec, k, bf16=False):
    jv, tv = jnp.asarray(v), torch.from_numpy(v)
    if bf16:
        jv, tv = jv.astype(jnp.bfloat16), tv.bfloat16()
    jres = PL.rank_top_k_manhattan_pallas(
        jnp.asarray(q), jv, k=k,
        row_mask=None if mask is None else jnp.asarray(mask),
        recency=None if rec is None else jnp.asarray(rec), interpret=True,
    )
    tres = L.rank_top_k_manhattan_l1(
        torch.from_numpy(q), tv, k,
        row_mask=None if mask is None else torch.from_numpy(mask),
        recency=None if rec is None else torch.from_numpy(rec),
    )
    return jres, tres


def _same(tres, jres):
    (tv, ti), (jv, ji) = tres, jres
    assert ti.dtype == torch.int64 and tv.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


@pytest.mark.parametrize("l1t", [1, 0], ids=["l1t", "l1"])
@pytest.mark.parametrize("case", ROUTE_CASES)
def test_route_matches_pallas_route(monkeypatch, case, l1t):
    """Index-identical to the Pallas route with either stage 1, and the
    port takes the stage the JAX route takes (or the stream where the JAX
    route takes it; d = 96 passes the CUDA kernel's shape rule, so there the
    port scores through its kernel route and still returns the same ids)."""
    monkeypatch.setattr(JAX_CONFIG, "pallas_l1t", l1t)
    monkeypatch.setattr(TORCH_CONFIG, "pallas_l1t", l1t)
    PL.rank_top_k_manhattan_pallas.clear_cache()  # the knob is read when traced
    calls = []
    for name in ("gmax_l1", "gmax_l1t", "rank_top_k_manhattan_stream"):
        real = getattr(L, name)
        monkeypatch.setattr(
            L, name, lambda *a, _n=name, _r=real, **kw: calls.append(_n) or _r(*a, **kw)
        )
    q, v, mask, rec, k = _route_case(case)
    jres, tres = _both_routes(q, v, mask, rec, k)
    PL.rank_top_k_manhattan_pallas.clear_cache()
    _same(tres, jres)
    if case in ("d100", "few_groups", "recency"):
        assert calls == ["rank_top_k_manhattan_stream"]
    else:
        assert calls == ["gmax_l1t" if l1t else "gmax_l1"]
    if case == "duplicates":
        assert tres[1][0, :3].tolist() == [0, 1000, 2000]
    if case == "nan_query":
        assert torch.isneginf(tres[0][3]).all()


@pytest.mark.parametrize("case", ["mask", "duplicates", "nan_row"])
def test_route_matches_pallas_route_bf16_plane(case):
    q, v, mask, rec, k = _route_case(case)
    jres, tres = _both_routes(q, v, mask, rec, k, bf16=True)
    _same(tres, jres)


def test_route_without_a_tile_materialises():
    """An odd row count has no stream tile: both packages score the whole
    (B, N) matrix."""
    q, v, mask, rec = _inputs(31, 4, 1000, 24)
    jres, tres = _both_routes(q, v, mask, rec, 7)
    _same(tres, jres)


def test_transpose_cap_keeps_the_in_place_kernel(monkeypatch):
    calls = []
    real = L.gmax_l1
    monkeypatch.setattr(L, "gmax_l1", lambda *a: calls.append("gmax_l1") or real(*a))
    monkeypatch.setattr(L, "gmax_l1t", lambda *a: pytest.fail("transposed past the cap"))
    monkeypatch.setattr(L, "_L1T_MAX_BYTES", N * D * 4 - 1)
    q, v, mask, _, k = _route_case("mask")
    got = L.rank_top_k_manhattan_l1(
        torch.from_numpy(q), torch.from_numpy(v), k, row_mask=torch.from_numpy(mask)
    )
    assert calls == ["gmax_l1"]
    monkeypatch.undo()
    want = L.rank_top_k_manhattan_l1(
        torch.from_numpy(q), torch.from_numpy(v), k, row_mask=torch.from_numpy(mask)
    )
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("tile", [512, 2048])
@pytest.mark.parametrize("how", ["plain", "mask", "recency", "mask+recency"])
def test_stream_matches_jax_stream(tile, how):
    q, v, mask, rec = _inputs(tile, 16)
    v[3000] = v[10]  # an exact tie across tiles: the lower row id wins
    q[0] = v[10]
    v[50, 3] = np.nan
    q[5, 1] = np.nan
    mask = mask if "mask" in how else None
    rec = rec if "recency" in how else None
    jres = JR.rank_top_k_manhattan_stream(
        jnp.asarray(q), jnp.asarray(v), k=10,
        row_mask=None if mask is None else jnp.asarray(mask),
        recency=None if rec is None else jnp.asarray(rec), tile=tile,
    )
    tres = TR.rank_top_k_manhattan_stream(
        torch.from_numpy(q), torch.from_numpy(v), 10,
        row_mask=None if mask is None else torch.from_numpy(mask),
        recency=None if rec is None else torch.from_numpy(rec), tile=tile,
    )
    _same(tres, jres)
    if how == "plain":
        assert tres[1][0, :2].tolist() == [10, 3000]
        assert torch.isneginf(tres[0][5]).all() and tres[1][5].tolist() == list(range(10))


def test_stream_chunks_over_queries(monkeypatch):
    """Scoring a tile a few queries at a time changes no result."""
    q, v, mask, rec = _inputs(77, 16)
    args = (torch.from_numpy(q), torch.from_numpy(v), 10)
    kw = {"row_mask": torch.from_numpy(mask), "recency": torch.from_numpy(rec), "tile": 1024}
    want = TR.rank_top_k_manhattan_stream(*args, **kw)
    monkeypatch.setattr(TR, "_CHUNK_CELLS", 1024 * D * 3)  # 3 queries per chunk
    got = TR.rank_top_k_manhattan_stream(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_stream_rejects_bad_tiles():
    q, v = torch.zeros(2, 8), torch.zeros(1024, 8)
    with pytest.raises(ValueError, match="must divide"):
        TR.rank_top_k_manhattan_stream(q, v, 4, tile=768)
    with pytest.raises(ValueError, match="<= tile"):
        TR.rank_top_k_manhattan_stream(q, v, 600, tile=512)


@pytest.mark.parametrize("batch", [1, 8, 64, 256, 512, 2048, 16384])
def test_manhattan_tile_is_the_jax_arithmetic(batch):
    for n in (1000, 1024, 4096, 8192, 10240, 1 << 20, 1_000_000, 3 * (1 << 18)):
        for k in (1, 10, 16, 600, 5000):
            assert TR._manhattan_tile(batch, n, k) == JR._manhattan_tile(batch, n, k)


def test_knobs_carry_the_jax_names_and_defaults(monkeypatch):
    from hyperdb_tpu_torch import config as TC

    assert TORCH_CONFIG.pallas_l1_min_batch == JAX_CONFIG.pallas_l1_min_batch == 64
    assert TORCH_CONFIG.pallas_l1t == JAX_CONFIG.pallas_l1t == 1
    assert L.L1_GROUP_MARGIN == PL.L1_GROUP_MARGIN == 12
    assert L._L1T_MAX_BYTES == PL._L1T_MAX_BYTES
    monkeypatch.setenv("HYPERDB_PALLAS_L1_MIN_BATCH", "256")
    monkeypatch.setenv("HYPERDB_PALLAS_L1T", "0")
    fresh = TC.EngineConfig()
    assert (fresh.pallas_l1_min_batch, fresh.pallas_l1t) == (256, 0)


def test_supported():
    q = torch.zeros(3, 384)
    assert L.supported(q, torch.zeros(1 << 10, 384, dtype=torch.bfloat16))
    assert L.supported(q.half(), torch.zeros(256, 384))  # any batch, any float wire
    assert L.supported_t(q, torch.zeros(256, 96))
    assert not L.supported(q, torch.zeros(256, 100))  # d % 8
    assert not L.supported(q, torch.zeros(1000, 384))  # N % 128
    assert not L.supported(q, torch.zeros(128, 384))  # one group
    assert not L.supported(q, torch.zeros(256, 384, dtype=torch.float16))
    assert not L.supported_t(q, torch.zeros(256, 384, dtype=torch.int8))


@pytest.fixture
def lowered(monkeypatch):
    monkeypatch.setattr(JAX_CONFIG, "grouped_topk_min_rows", 4096)
    monkeypatch.setattr(TORCH_CONFIG, "grouped_topk_min_rows", 4096)
    JR.rank_top_k.clear_cache()  # the threshold is read when the router is traced
    yield
    JR.rank_top_k.clear_cache()


@pytest.mark.parametrize(
    "b, how, want",
    [
        (64, "mask", "l1"),  # the smallest batch on the kernel route
        (63, "mask", "stream"),
        (64, "recency", "stream"),  # the -L1 surrogate cannot carry recency
        (64, "off", "stream"),  # pallas_l1_min_batch = 0
        (64, "f16", "l1"),  # an f16 query wire is upcast and takes the kernel
    ],
)
def test_router_gate(monkeypatch, lowered, b, how, want):
    """``rank_top_k`` sends manhattan over a large corpus where the JAX
    router would on a TPU, and returns the JAX router's ids (on the CPU the
    JAX router streams everything)."""
    if how == "off":
        monkeypatch.setattr(TORCH_CONFIG, "pallas_l1_min_batch", 0)
    calls = []
    real_l1, real_stream = L.rank_top_k_manhattan_l1, TR.rank_top_k_manhattan_stream
    monkeypatch.setattr(
        L, "rank_top_k_manhattan_l1", lambda *a, **kw: calls.append("l1") or real_l1(*a, **kw)
    )
    monkeypatch.setattr(
        TR, "rank_top_k_manhattan_stream",
        lambda *a, **kw: calls.append("stream") or real_stream(*a, **kw),
    )
    q, v, mask, rec = _inputs(b, b, n=2 * N)  # two stream tiles
    rec = rec if how == "recency" else None
    if how == "f16":
        q = q.astype(np.float16)
    jres = JR.rank_top_k(
        jnp.asarray(q), jnp.asarray(v), k=10, metric="manhattan_distance",
        row_mask=jnp.asarray(mask), recency=None if rec is None else jnp.asarray(rec),
    )
    tres = TR.rank_top_k(
        torch.from_numpy(q), torch.from_numpy(v), 10, metric="manhattan_distance",
        row_mask=torch.from_numpy(mask), recency=None if rec is None else torch.from_numpy(rec),
    )
    assert calls == [want]
    _same(tres, jres)
    if how == "f16":
        # the f16 wire returns what the f32 wire returns for the same values
        t32 = TR.rank_top_k(
            torch.from_numpy(q.astype(np.float32)), torch.from_numpy(v), 10,
            metric="manhattan_distance", row_mask=torch.from_numpy(mask),
        )
        assert torch.equal(t32[1], tres[1]) and torch.equal(t32[0], tres[0])


def test_small_corpus_still_materialises(monkeypatch):
    """Below ``grouped_topk_min_rows`` manhattan keeps the materialising
    form, whatever the batch."""
    monkeypatch.setattr(L, "rank_top_k_manhattan_l1", lambda *a, **kw: pytest.fail("l1"))
    monkeypatch.setattr(TR, "rank_top_k_manhattan_stream", lambda *a, **kw: pytest.fail("stream"))
    q, v, mask, rec = _inputs(5, 64)
    jres = JR.rank_top_k(
        jnp.asarray(q), jnp.asarray(v), k=10, metric="manhattan_distance",
        row_mask=jnp.asarray(mask), recency=jnp.asarray(rec),
    )
    tres = TR.rank_top_k(
        torch.from_numpy(q), torch.from_numpy(v), 10, metric="manhattan_distance",
        row_mask=torch.from_numpy(mask), recency=torch.from_numpy(rec),
    )
    _same(tres, jres)
