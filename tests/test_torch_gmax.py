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
