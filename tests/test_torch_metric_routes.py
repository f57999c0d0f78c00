"""Grouped euclidean/hamming/jaccard parity: the port's plain form and its
stage-1 kernel route against the JAX package.

The same seeded numpy inputs (bf16 device planes, as the engine lays them
out) go through ``hyperdb_tpu.ops.ranking.rank_top_k_grouped_metric`` (the
XLA form), ``pallas_gmax.rank_top_k_grouped_metric_pallas`` and
``pallas_gmax.gmax_jaccard`` (Pallas in interpret mode), and through the
port on CPU tensors (the kernel wrappers' plain versions).

Tolerances. Hamming and jaccard are exact integer counts and one IEEE
division on both sides: values must be EQUAL. Euclidean sums bf16 products
in f32 in different orders and then cancels ``|v|^2 - 2 q.v + |q|^2``:
1e-5 relative plus 1e-6 absolute on scores of magnitude ~0.05 (the JAX
package's own tolerance between its two forms). Ids must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperdb_tpu.config import CONFIG as JAX_CONFIG
from hyperdb_tpu.ops import pallas_gmax as PG
from hyperdb_tpu.ops import ranking as JR
from hyperdb_tpu_torch.config import CONFIG as TORCH_CONFIG
from hyperdb_tpu_torch.ops import gmax as G
from hyperdb_tpu_torch.ops import ranking as TR

METRICS = ("euclidean_metric", "hamming_distance", "jaccard_similarity")


@pytest.fixture(autouse=True)
def fresh_jax_programs():
    """The JAX package's own tests count calls made while its jitted routes
    are traced; leave them no compiled program of this file's shapes."""
    yield
    PG._grouped_metric_pallas_impl.clear_cache()
    JR.rank_top_k_grouped_metric.clear_cache()


def _inputs(seed, b, n=8192, d=128):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    mask = rng.random(n) < 0.9
    rec = (rng.random(n) * 0.01).astype(np.float32)
    return q, v, mask, rec


def _planes(v, metric):
    """(jax rows, torch rows, aux) as the engine builds them: the raw bf16
    plane with |v|^2 from the f32 master, or the 0/1 bf16 plane with its
    popcounts."""
    if metric == "euclidean_metric":
        rows = v
        aux = np.sum(v.astype(np.float32) ** 2, axis=1)
    else:
        rows = (v > 0).astype(np.float32)
        aux = rows.sum(axis=1)
    return jnp.asarray(rows, dtype=jnp.bfloat16), torch.from_numpy(rows).bfloat16(), aux


def _same(tres, jres, metric):
    (tv, ti), (jv, ji) = tres, jres
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if metric == "euclidean_metric":
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("empty", [False, True])
def test_gmax_jaccard_plain_matches_pallas(empty):
    """Masked group, empty rows, and an empty query against them (0/0)."""
    q, v, mask, _ = _inputs(0, 16)
    mask[256:384] = False
    vb = (v > 0).astype(np.float32)
    vb[512:640] = 0.0  # a whole group of empty rows
    vb[5] = 0.0
    qb = (q > 0).astype(np.float32)
    if empty:
        qb[3] = 0.0
    aux = vb.sum(axis=1)
    qsum = qb.sum(axis=1, keepdims=True)
    want = PG.gmax_jaccard(
        jnp.asarray(qb, dtype=jnp.bfloat16), jnp.asarray(vb, dtype=jnp.bfloat16),
        jnp.asarray(qsum), jnp.asarray(aux), PG.make_extra(8192, jnp.asarray(mask)),
        interpret=True,
    )
    before = dict(G.LAUNCHES)
    got = G.gmax_jaccard(
        torch.from_numpy(qb).bfloat16(), torch.from_numpy(vb).bfloat16(),
        torch.from_numpy(qsum), torch.from_numpy(aux),
        G.make_extra(8192, torch.from_numpy(mask)),
    )
    assert G.LAUNCHES == before  # CPU tensors never launch a kernel
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.isneginf(got[:, 2]).all()  # the masked group
    live = [i for i in range(16) if not (empty and i == 3)]
    assert (got[live, 4] == 0).all()  # live query x empty rows: 0 / |q| = 0
    if empty:
        assert torch.isneginf(got[3, 4])  # empty query x empty group: 0/0 -> -inf
        assert (got[3, [0, 1, 3]] == 0).all()  # empty query x live rows: 0/|v| = 0


def test_jaccard_scrub_comes_before_extra():
    """0/0 -> -inf first, then + extra: a NaN score never meets the mask
    term, and a masked live row is -inf through the addition alone."""
    q = torch.zeros(1, 8, dtype=torch.bfloat16)
    v = torch.zeros(128, 8, dtype=torch.bfloat16)
    v[1] = 1
    extra = torch.zeros(128)
    extra[1] = float("-inf")
    got = G.gmax_jaccard_plain(q, v, torch.zeros(1, 1), v.float().sum(1), extra)
    assert torch.isneginf(got).all()
    q[0, 0] = 1
    got = G.gmax_jaccard_plain(q, v, torch.ones(1, 1), v.float().sum(1), torch.zeros(128))
    assert got.item() == 0.125  # 1 / (1 + 8 - 1) on row 1; empty rows score 0


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("b, group", [(32, 128), (8, 256)])
def test_plain_form_matches_xla_form(metric, masked, b, group):
    q, v, mask, rec = _inputs(9, b)
    jrows, trows, aux = _planes(v, metric)
    k = 7
    jres = JR.rank_top_k_grouped_metric(
        jnp.asarray(q), jrows, jnp.asarray(aux), k, metric,
        row_mask=jnp.asarray(mask) if masked else None, group=group,
    )
    tres = TR.rank_top_k_grouped_metric(
        torch.from_numpy(q), trows, torch.from_numpy(aux), k, metric,
        row_mask=torch.from_numpy(mask) if masked else None, group=group,
    )
    _same(tres, jres, metric)


@pytest.mark.parametrize("metric", METRICS)
def test_recency_takes_plain_form_in_both(metric, monkeypatch):
    """Recency breaks the surrogate's monotonicity: at a kernel-sized batch
    a recency query still takes the plain form, as in the JAX package."""
    monkeypatch.setattr(
        G, "rank_top_k_grouped_metric_gmax", lambda *a, **kw: pytest.fail("kernel route")
    )
    q, v, mask, rec = _inputs(10, 512, n=4096)
    jrows, trows, aux = _planes(v, metric)
    jres = JR.rank_top_k_grouped_metric(
        jnp.asarray(q), jrows, jnp.asarray(aux), 8, metric,
        row_mask=jnp.asarray(mask), recency=jnp.asarray(rec), group=128,
    )
    tres = TR.rank_top_k_grouped_metric(
        torch.from_numpy(q), trows, torch.from_numpy(aux), 8, metric,
        row_mask=torch.from_numpy(mask), recency=torch.from_numpy(rec), group=128,
    )
    _same(tres, jres, metric)


@pytest.mark.parametrize("metric", METRICS)
def test_small_corpus_takes_flat_form(metric):
    q, v, mask, rec = _inputs(11, 4, n=1000)  # n % group != 0
    jrows, trows, aux = _planes(v, metric)
    jres = JR.rank_top_k_grouped_metric(
        jnp.asarray(q), jrows, jnp.asarray(aux), 5, metric,
        row_mask=jnp.asarray(mask), recency=jnp.asarray(rec), group=128,
    )
    tres = TR.rank_top_k_grouped_metric(
        torch.from_numpy(q), trows, torch.from_numpy(aux), 5, metric,
        row_mask=torch.from_numpy(mask), recency=torch.from_numpy(rec), group=128,
    )
    _same(tres, jres, metric)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize(
    "b, subgroup",
    [
        (128, 32),  # two-level: gmax_f_sub for euclidean/hamming
        (128, 0),  # pallas_subgroup = 0: single-level gmax_f
        (32, 32),  # query tile not a multiple of 128: single-level
    ],
)
def test_gmax_route_matches_pallas_and_xla(monkeypatch, metric, masked, b, subgroup):
    """The inputs of the JAX package's surrogate-pipeline tests (at k = 9):
    the port's kernel route is index-identical to the Pallas route AND to
    the XLA form, and takes the same kernel the Pallas route takes."""
    monkeypatch.setattr(JAX_CONFIG, "pallas_subgroup", subgroup)
    monkeypatch.setattr(TORCH_CONFIG, "pallas_subgroup", subgroup)
    q, v, mask, _ = _inputs(17, b)
    jrows, trows, aux = _planes(v, metric)
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    k = 9
    calls = []
    for name in ("gmax_f", "gmax_f_sub", "gmax_jaccard"):
        real = getattr(G, name)
        monkeypatch.setattr(
            G, name, lambda *a, _n=name, _r=real, **kw: calls.append(_n) or _r(*a, **kw)
        )
    xla = JR.rank_top_k_grouped_metric(
        jnp.asarray(q), jrows, jnp.asarray(aux), k, metric, row_mask=jm, group=128
    )
    pallas = PG.rank_top_k_grouped_metric_pallas(
        jnp.asarray(q), jrows, jnp.asarray(aux), k, metric, row_mask=jm, interpret=True
    )
    before = dict(G.LAUNCHES)
    got = G.rank_top_k_grouped_metric_gmax(
        torch.from_numpy(q), trows, torch.from_numpy(aux), k, metric, row_mask=tm
    )
    assert G.LAUNCHES == before
    _same(got, pallas, metric)
    _same(got, xla, metric)
    if metric == "jaccard_similarity":
        assert calls == ["gmax_jaccard"]
    else:
        assert calls == ["gmax_f_sub" if (b, subgroup) == (128, 32) else "gmax_f"]


def test_router_gate(monkeypatch):
    """b >= pallas_gmax_f_min_batch over a bf16 plane without recency goes to
    the kernel route; smaller batches, recency, f32 planes and a switched-off
    kernel keep the plain form."""
    calls = []
    real = G.rank_top_k_grouped_metric_gmax
    monkeypatch.setattr(
        G, "rank_top_k_grouped_metric_gmax",
        lambda *a, **kw: calls.append(a[4]) or real(*a, **kw),
    )
    q, v, mask, rec = _inputs(3, 512, n=2048)
    _, trows, aux = _planes(v, "hamming_distance")
    args = (trows, torch.from_numpy(aux), 4, "hamming_distance")
    tq = torch.from_numpy(q)
    want = TR.rank_top_k_grouped_metric(tq, *args)
    assert calls == ["hamming_distance"]
    TR.rank_top_k_grouped_metric(tq[:256], *args)
    got = TR.rank_top_k_grouped_metric(tq, *args, recency=torch.zeros(2048))
    TR.rank_top_k_grouped_metric(tq, trows.float(), *args[1:])
    monkeypatch.setattr(TORCH_CONFIG, "pallas_gmax", 0)
    TR.rank_top_k_grouped_metric(tq, *args)
    assert calls == ["hamming_distance"]
    # and the two forms agree (hamming scores are exact integers)
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize(
    "rows_dtype, n, metric",
    [
        (torch.float32, 1024, "euclidean_metric"),  # f32 planes score on the plain form
        (torch.bfloat16, 1000, "hamming_distance"),  # N % 128 != 0
        (torch.bfloat16, 1024, "pearson_correlation"),  # no grouped epilogue form
    ],
)
def test_gmax_route_refuses_out_of_contract(rows_dtype, n, metric):
    q = torch.ones(4, 16)
    rows = torch.ones(n, 16, dtype=rows_dtype)
    with pytest.raises(ValueError, match="bf16"):
        G.rank_top_k_grouped_metric_gmax(q, rows, torch.ones(n), 4, metric)
    if metric == "pearson_correlation":
        with pytest.raises(ValueError, match="no grouped epilogue"):
            TR.rank_top_k_grouped_metric(q, rows, torch.ones(n), 4, metric)


# ---------------------------------------------------------------- manhattan

MANHATTAN_KWARGS = {
    "plain": {},
    "filter": {"filters": [("metadata", {"kind": "b"})]},
    "recency": {"recency_bias": 0.05, "timestamp_key": "ts"},
}


@pytest.fixture(scope="module")
def manhattan_dbs():
    from hyperdb_tpu import HyperDB as JaxDB
    from hyperdb_tpu_torch import HyperDB as TorchDB

    rng = np.random.default_rng(21)
    v = (rng.standard_normal((16384, 128)) / np.sqrt(128)).astype(np.float16)
    v[17] = v[4]  # exact duplicates: the lower id first
    docs = [{"ts": float(i % 97) / 97.0, "kind": ("a", "b", "c")[i % 3]} for i in range(16384)]
    kw = {"fp_precision": "float16", "metadata_keys": ["kind", "ts"]}
    return JaxDB(docs, v, **kw), TorchDB(docs, v, device="cpu", **kw), v


@pytest.mark.parametrize("how", list(MANHATTAN_KWARGS))
@pytest.mark.parametrize("wire", [np.float32, np.float16], ids=["f32", "f16"])
@pytest.mark.parametrize("b", [64, 16])
def test_manhattan_db_matches_jax(monkeypatch, manhattan_dbs, b, wire, how):
    """Manhattan over a large corpus through ``HyperDB`` of both packages,
    over bf16 planes. b = 64 is the smallest batch on the port's kernel route
    (an f16 wire is upcast and takes it too); recency and b = 16 take the
    streamed scan. Ids identical; scores ``rtol 1e-6`` (f32 sums of |v - q|
    in different orders; 1e-6 absolute once recency adds its term)."""
    from hyperdb_tpu_torch.ops import l1 as L

    monkeypatch.setattr(JAX_CONFIG, "grouped_topk_min_rows", 4096)
    monkeypatch.setattr(TORCH_CONFIG, "grouped_topk_min_rows", 4096)
    JR.rank_top_k.clear_cache()  # the threshold is read when the router is traced
    jdb, tdb, v = manhattan_dbs
    q = np.random.default_rng(b).standard_normal((b, 128)).astype(np.float32) / np.sqrt(128)
    q[0] = v[4].astype(np.float32)
    q = q.astype(wire)
    calls = []
    for name in ("gmax_l1", "gmax_l1t", "rank_top_k_manhattan_stream"):
        real = getattr(L, name)
        monkeypatch.setattr(
            L, name, lambda *a, _n=name, _r=real, **kw: calls.append(_n) or _r(*a, **kw)
        )
    stream = TR.rank_top_k_manhattan_stream
    monkeypatch.setattr(
        TR, "rank_top_k_manhattan_stream",
        lambda *a, **kw: calls.append("router stream") or stream(*a, **kw),
    )
    kw = MANHATTAN_KWARGS[how]
    ti, ts = tdb.query_batch_arrays(q, top_k=10, metric="manhattan_distance", **kw)
    ji, js = jdb.query_batch_arrays(q, top_k=10, metric="manhattan_distance", **kw)
    JR.rank_top_k.clear_cache()
    JR.rank_top_k_manhattan_stream.clear_cache()
    assert calls == (["gmax_l1t"] if b == 64 and how != "recency" else ["router stream"])
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-6 if how == "recency" else 0)
    if how == "plain":
        assert ti[0, :2].tolist() == [4, 17]
    if how == "filter":
        assert (ti % 3 == 1).all()
