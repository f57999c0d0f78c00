"""Stage-1 scan parity: the port's gmax functions against the Pallas kernels.

The same seeded numpy inputs go through ``hyperdb_tpu.ops.pallas_gmax`` (in
interpret mode, as its own tests run it) and through
``hyperdb_tpu_torch.ops.gmax`` on CPU tensors (the wrappers' plain
versions). Both sides see bit-identical bf16 operands.

Tolerance: 1e-5 absolute on unit-norm queries and rows. Both sides add the
same exact bf16 x bf16 products in f32, in different orders; at d = 128 that
moves a score of magnitude <= 1 by a few f32 ulps (~1e-7 each). -inf
positions (masked, padding and NaN rows) must agree exactly, and ids must be
identical, ties going to the lower index.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperdb_tpu.config import CONFIG as JAX_CONFIG
from hyperdb_tpu.ops import pallas_gmax as PG
from hyperdb_tpu_torch.config import CONFIG as TORCH_CONFIG
from hyperdb_tpu_torch.ops import gmax as G

ATOL = 1e-5
B, N, D, K = 128, 16384, 128, 10
DUPS = (1000, 1200, 2000, 2100, 4096, 5000, 7000, 9000, 12000, 13000, 15000, 16000)


def _inputs(seed=0, b=B, n=N, d=D):
    """Unit-norm queries and rows with a NaN row, a NaN group, a masked group, recency,
    and exact duplicates: rows 3/5 (one subgroup), 40/300 (two groups), and
    twelve copies of one row spread over the corpus, so that the 10th
    result of query 2 is a tie that only the lower index can settle."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    v = rng.standard_normal((n, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[5] = v[3]
    v[300] = v[40]
    v[list(DUPS)] = v[DUPS[0]]
    q[0], q[1], q[2] = v[3], v[40], v[DUPS[0]]
    v[777] = np.nan
    v[512:640] = np.nan  # a whole NaN group: only the scrub makes its maxes -inf
    mask = rng.random(n) < 0.9
    mask[128:256] = False
    mask[list(DUPS) + [3, 5, 40, 300]] = True
    rec = (rng.random(n) * 0.05).astype(np.float32)
    rec[list(DUPS) + [3, 5, 40, 300]] = 0.0  # keep the duplicates tied
    return q, v, mask, rec


def _both(q, v, mask, rec):
    jq = jnp.asarray(q, dtype=jnp.bfloat16)
    jv = jnp.asarray(v, dtype=jnp.bfloat16)
    tq = torch.from_numpy(q).bfloat16()
    tv = torch.from_numpy(v).bfloat16()
    # the same bf16 bits on both sides (NaN payloads aside)
    jbits = np.asarray(jv).view(np.uint16)
    tbits = tv.view(torch.int16).numpy().view(np.uint16)
    nan = np.isnan(v)
    np.testing.assert_array_equal(np.isnan(np.asarray(jv, dtype=np.float32)), nan)
    np.testing.assert_array_equal(jbits[~nan], tbits[~nan])
    jm = None if mask is None else jnp.asarray(mask)
    jr = None if rec is None else jnp.asarray(rec)
    tm = None if mask is None else torch.from_numpy(mask)
    tr = None if rec is None else torch.from_numpy(rec)
    return (jq, jv, jm, jr), (tq, tv, tm, tr)


def _same(got: torch.Tensor, want) -> None:
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = ~np.isneginf(want)
    assert np.isfinite(got[fin]).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=ATOL)


def test_gmax_f_matches_pallas():
    (jq, jv, jm, jr), (tq, tv, tm, tr) = _both(*_inputs(0))
    jextra = PG.make_extra(N, jm, jr)
    textra = G.make_extra(N, tm, tr)
    np.testing.assert_array_equal(textra.numpy(), np.asarray(jextra))
    want = PG.gmax_f(jq, jv, jextra, interpret=True)
    _same(G.gmax_f(tq, tv, textra), want)


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("sub", [32, 16])
def test_gmax_f_sub_matches_pallas(sub, dual):
    (jq, jv, jm, jr), (tq, tv, tm, tr) = _both(*_inputs(1))
    jextra = PG.make_extra(N, jm, jr)
    textra = G.make_extra(N, tm, tr)
    want_gm, want_sm = PG.gmax_f_sub(jq, jv, jextra, sub=sub, interpret=True, dual=dual)
    gm, sm = G.gmax_f_sub(tq, tv, textra, sub=sub, dual=dual)
    _same(sm, want_sm)
    _same(gm, want_gm)


@pytest.mark.parametrize("subgroup", [32, 0])
@pytest.mark.parametrize("masked", [True, False])
def test_grouped_route_matches_pallas(monkeypatch, subgroup, masked):
    """The three-stage route, index-identical with ties to the lower index.
    ``subgroup=0`` takes single-level ``gmax_f`` in both packages."""
    monkeypatch.setattr(JAX_CONFIG, "pallas_subgroup", subgroup)
    monkeypatch.setattr(TORCH_CONFIG, "pallas_subgroup", subgroup)
    q, v, mask, rec = _inputs(2)
    if not masked:
        mask = rec = None
    (jq, jv, jm, jr), (tq, tv, tm, tr) = _both(q, v, mask, rec)
    jv_, ji = PG.rank_top_k_grouped_pallas(
        jq, jv, K, row_mask=jm, recency=jr, interpret=True
    )
    before = dict(G.LAUNCHES)
    tv_, ti = G.rank_top_k_grouped_gmax(tq, tv, K, row_mask=tm, recency=tr)
    assert G.LAUNCHES == before  # CPU tensors never launch a kernel
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv_.numpy(), np.asarray(jv_), rtol=0, atol=ATOL)
    # duplicated rows: the lower index first, and the tie at the 10th value
    # goes to the ten lowest of the twelve copies
    assert list(ti[0, :2]) == [3, 5]
    assert list(ti[1, :2]) == [40, 300]
    assert sorted(ti[2].tolist()) == list(DUPS[:K])


def test_make_extra_order():
    """Masked rows are -inf whatever their recency; NaN scores scrub to -inf
    after ``+ extra`` (the kernels' order)."""
    mask = torch.tensor([True, False, True, True])
    rec = torch.tensor([0.5, 0.25, 0.0, 1.0])
    extra = G.make_extra(4, mask, rec)
    assert extra.tolist() == [0.5, float("-inf"), 0.0, 1.0]
    q = torch.ones(1, 8, dtype=torch.bfloat16)
    v = torch.zeros(128, 8, dtype=torch.bfloat16)
    v[0] = float("nan")
    v[1] = 1
    extra = torch.zeros(128)
    extra[1] = float("-inf")
    s = next(G._plain_scores(q, v, extra))[1]
    assert torch.isneginf(s[0, :2]).all() and s[0, 2] == 0


@pytest.mark.parametrize("k", [2, 3])
def test_subgroup_order_settles_ties(k):
    """Two copies of one row, the lower in a subgroup whose max it is, the
    higher beside a better row: after the subgroup selection, candidates
    must be taken in row order, so the lower copy wins the tie."""
    rng = np.random.default_rng(4)
    v = rng.standard_normal((N, D)).astype(np.float32)
    v[:, 0] = -np.abs(v[:, 0]) - 4.0  # every other row scores below the pair
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    u = np.zeros(D, np.float32)
    u[0], u[1] = 0.6, 0.8
    w = np.zeros(D, np.float32)
    w[0], w[2] = 0.9, np.sqrt(1 - 0.81)
    v[10] = v[40] = v[9000] = u  # subgroups 0 and 1 of group 0, and group 70
    v[41] = w
    q = np.zeros((B, D), np.float32)
    q[:, 0] = 1.0
    (jq, jv, _, _), (tq, tv, _, _) = _both(q, v, None, None)
    _, ji = PG.rank_top_k_grouped_pallas(jq, jv, k, interpret=True)
    _, ti = G.rank_top_k_grouped_gmax(tq, tv, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0].tolist() == [41, 10, 40][:k]


@pytest.mark.parametrize(
    "qdt, vdt, n, k",
    [
        (torch.float32, torch.float32, 1024, 4),  # f32 scores on the plain route
        (torch.bfloat16, torch.bfloat16, 1000, 4),  # N % 128 != 0
        (torch.bfloat16, torch.bfloat16, 256, 3),  # fewer groups than k
    ],
)
def test_grouped_gmax_refuses_out_of_contract(qdt, vdt, n, k):
    """The router routes only supported shapes here; others raise."""
    q = torch.ones(4, 16, dtype=qdt)
    v = torch.ones(n, 16, dtype=vdt)
    assert not G.supported(q, v, k)
    with pytest.raises(ValueError, match="bf16"):
        G.rank_top_k_grouped_gmax(q, v, k)


@pytest.mark.parametrize(
    "n, d, itemsize, want",
    [
        (1 << 20, 384, 2, "wgmma"),  # the main path's bf16 plane: 6 boxes of 128 bytes
        (1 << 20, 384, 1, "wgmma"),  # its int8 plane: 3 boxes
        (256, 8, 2, "wgmma"),  # one ragged box
        (1024, 40, 2, "wgmma"),  # 80 bytes: less than one box
        (4096, 392, 2, "wgmma"),  # 784 bytes: a ragged seventh box
        (4096, 768, 2, "wgmma"),  # 1536 bytes: the deepest resident query tile
        (4096, 1536, 1, "wgmma"),  # the same depth in int8
        (4096, 776, 2, "wgmma_stream"),  # one 16-byte step past it
        (4096, 1024, 2, "wgmma_stream"),
        (4096, 1552, 1, "wgmma_stream"),
        (4096, 4096, 1, "wgmma_stream"),
        (1 << 20, 4480, 2, "wgmma_stream"),  # the default hybrid embedder's bf16 plane: 70 boxes
        (1 << 20, 4480, 1, "wgmma_stream"),  # its int8 plane: 35 boxes
    ],
)
def test_kernel_variant_rule(n, d, itemsize, want):
    """The one rule on shapes: a row of at most 12 boxes of 128 bytes goes to
    the resident-query wgmma variant, a deeper one to the streaming variant;
    the batch does not matter."""
    assert G.kernel_variant(n, d, itemsize) == want
    assert (d * itemsize <= G.WGMMA_MAX_ROW_BYTES) == (want == "wgmma")


@pytest.mark.parametrize(
    "n, d, itemsize",
    [
        (1000, 384, 2),  # N % 128 != 0
        (0, 384, 2),
        (1024, 12, 2),  # 24-byte rows: not a multiple of 16
        (1024, 40, 1),  # int8 rows need d % 16 == 0
        (1024, 0, 2),
    ],
)
def test_kernel_variant_refuses_what_neither_kernel_takes(n, d, itemsize):
    with pytest.raises(ValueError, match="unsupported shapes"):
        G.kernel_variant(n, d, itemsize)


def test_variant_counter_and_entry_points():
    """``LAUNCHES`` keeps its four keys; the second counter has one key per
    variant, each with a source under csrc/ and a C entry point; CPU tensors
    move neither counter."""
    from hyperdb_tpu_torch.ops import cuda_build

    assert set(G.LAUNCHES) == {"gmax_f_sub", "gmax_f", "gmax_int8", "gmax_jaccard"}
    assert set(G.LAUNCHES_BY_VARIANT) == set(G._VARIANTS) == {"wgmma", "wgmma_stream"}
    for source, entry in G._VARIANTS.values():
        assert source in cuda_build.sources()
        assert f'extern "C" int {entry}(' in (cuda_build.CSRC / f"{source}.cu").read_text()
    before = dict(G.LAUNCHES), dict(G.LAUNCHES_BY_VARIANT)
    G.gmax_f_sub(torch.ones(8, 16).bfloat16(), torch.ones(256, 16).bfloat16(), torch.zeros(256))
    assert (G.LAUNCHES, G.LAUNCHES_BY_VARIANT) == before


def test_unknown_variant_raises_before_any_load(monkeypatch):
    """A forced variant outside the two raises before any library is built
    or loaded and before either counter moves: the retired ``mma.sync``
    kernel's name reaches nothing."""
    from hyperdb_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "load", lambda name: pytest.fail(f"loaded {name}"))
    q = torch.empty((128, 384), dtype=torch.bfloat16, device="meta")
    v = torch.empty((1024, 384), dtype=torch.bfloat16, device="meta")
    extra = torch.empty((1024,), dtype=torch.float32, device="meta")
    gm = torch.empty((128, 8), dtype=torch.float32, device="meta")
    before = dict(G.LAUNCHES), dict(G.LAUNCHES_BY_VARIANT)
    with pytest.raises(KeyError):
        G._launch(G._KIND_F, q, v, extra, None, gm, 0, _variant="mma")
    assert (dict(G.LAUNCHES), dict(G.LAUNCHES_BY_VARIANT)) == before


# Deep rows (the streaming variant's shapes): the JAX kernels in interpret
# mode against the port's plain versions, which the streaming kernel is held
# to on the card.


def test_gmax_f_sub_deep_rows_match_pallas():
    """d = 4480, the default hybrid embedder's width. Tolerance 1e-5 absolute
    on unit-norm rows: both sides sum the same exact bf16 products in f32 in
    different orders; at d = 4480 each order moves a score of magnitude <= 1
    by some 1e-7."""
    b, n, d = 8, 256, 4480
    rng = np.random.default_rng(6)
    q = rng.standard_normal((b, d)).astype(np.float32)
    v = rng.standard_normal((n, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[5] = v[3]
    v[77] = np.nan
    q[0] = v[3]
    mask = rng.random(n) < 0.9
    mask[128:] = False  # the second group masked
    rec = (rng.random(n) * 0.05).astype(np.float32)
    (jq, jv, jm, jr), (tq, tv, tm, tr) = _both(q, v, mask, rec)
    jextra = PG.make_extra(n, jm, jr)
    textra = G.make_extra(n, tm, tr)
    want_gm, want_sm = PG.gmax_f_sub(jq, jv, jextra, sub=32, interpret=True, dual=True)
    gm, sm = G.gmax_f_sub(tq, tv, textra, sub=32, dual=True)
    _same(sm, want_sm)
    _same(gm, want_gm)
    assert np.isneginf(gm[:, 1].numpy()).all()
    assert G.kernel_variant(n, d, 2) == "wgmma_stream"


def test_gmax_int8_deep_rows_equal_pallas():
    """d = 1664 (13 boxes of 128 bytes, one past the resident tile). The
    products are exact integers on both sides; XLA on the CPU may contract
    the rescale's multiply and add into one fused multiply-add, which rounds
    once where the port rounds twice: within 2.5e-7 relative (two f32 ulps).
    The port's plain version, which the kernel must equal on the card, is
    held EQUAL to the same IEEE operations in numpy."""
    from hyperdb_tpu.ops.quantized import _quantize_device as jax_quantize
    from hyperdb_tpu.ops.quantized import quantize_rows as jax_quantize_rows
    from hyperdb_tpu_torch.ops.quantized import _quantize_device, quantize_rows

    b, n, d = 8, 256, 1664
    rng = np.random.default_rng(7)
    v = rng.standard_normal((n, d)).astype(np.float32)
    v[5] = 0.0  # a zero-scale row: 0 + extra
    q = rng.standard_normal((b, d)).astype(np.float32)
    mask = rng.random(n) < 0.9
    mask[:128] = False  # the first group masked
    rec = (rng.random(n) * 0.05).astype(np.float32)
    v_i8, v_sc = quantize_rows(v)
    jv_i8, jv_sc = jax_quantize_rows(v)
    np.testing.assert_array_equal(v_i8, jv_i8)
    np.testing.assert_array_equal(v_sc, jv_sc)
    q_i8, q_sc = _quantize_device(torch.from_numpy(q))
    jq_i8, jq_sc = jax_quantize(jnp.asarray(q))
    np.testing.assert_array_equal(q_i8.numpy(), np.asarray(jq_i8))
    np.testing.assert_array_equal(q_sc.numpy(), np.asarray(jq_sc))
    jextra = PG.make_extra(n, jnp.asarray(mask), jnp.asarray(rec))
    textra = G.make_extra(n, torch.from_numpy(mask), torch.from_numpy(rec))
    want = PG.gmax_int8(
        jq_i8, jq_sc, jnp.asarray(jv_i8), jnp.asarray(jv_sc), jextra, interpret=True
    )
    got = G.gmax_int8(q_i8, q_sc, torch.from_numpy(v_i8), torch.from_numpy(v_sc), textra)
    np.testing.assert_array_equal(np.isneginf(got.numpy()), np.isneginf(np.asarray(want)))
    live = ~np.isneginf(np.asarray(want))
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], rtol=2.5e-7, atol=0)
    dot = (q_i8.numpy().astype(np.int64) @ v_i8.T.astype(np.int64)).astype(np.float32)
    s = dot * (q_sc.numpy()[:, None] * v_sc[None, :]) + textra.numpy()[None, :]
    np.testing.assert_array_equal(got.numpy(), s.reshape(b, n // 128, 128).max(-1))
    assert np.isneginf(got[:, 0].numpy()).all()
    assert G.kernel_variant(n, d, 1) == "wgmma_stream"


def test_gmax_jaccard_deep_rows_equal_pallas():
    """0/1 rows of d = 2560 whose unions pass 2048 (dense rows and queries),
    with an empty row and an empty query (0/0 -> -inf): exact integer counts
    and one IEEE division on both sides, so equal."""
    b, n, d = 8, 256, 2560
    rng = np.random.default_rng(8)
    vb = (rng.random((n, d)) < 0.85).astype(np.float32)
    qb = (rng.random((b, d)) < 0.85).astype(np.float32)
    vb[5] = 0.0
    qb[0] = 0.0
    mask = rng.random(n) < 0.9
    union = qb.sum(1)[:, None] + vb.sum(1)[None, :] - qb @ vb.T
    assert union[1:].max() > 2048  # past the range the wgmma variant's division covers
    jq, jv = jnp.asarray(qb, dtype=jnp.bfloat16), jnp.asarray(vb, dtype=jnp.bfloat16)
    jextra = PG.make_extra(n, jnp.asarray(mask))
    want = PG.gmax_jaccard(
        jq, jv, jnp.asarray(qb.sum(1, keepdims=True)), jnp.asarray(vb.sum(1)), jextra,
        interpret=True,
    )
    textra = G.make_extra(n, torch.from_numpy(mask))
    got = G.gmax_jaccard(
        torch.from_numpy(qb).bfloat16(), torch.from_numpy(vb).bfloat16(),
        torch.from_numpy(qb.sum(1, keepdims=True)), torch.from_numpy(vb.sum(1)), textra,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert G.kernel_variant(n, d, 2) == "wgmma_stream"
