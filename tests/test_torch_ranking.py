"""Ranking parity: the port's router and metrics against the JAX package.

Seeded numpy inputs go through ``hyperdb_tpu.ops.ranking`` (XLA on the
CPU) and ``hyperdb_tpu_torch.ops.ranking`` (CPU tensors, so the stage-1
wrappers run their plain versions). ``grouped_topk_min_rows`` is lowered on
both configs so the 16384-row corpus takes the grouped routes; at b = 512
the port's router sends bf16 scans to its gmax route while the JAX router,
on the CPU, keeps the XLA grouped form. Both are exact, so ids agree.

Tolerances: 1e-5 absolute on unit-norm operands (f32 sums of the same exact
products in different orders); 1e-5 relative plus 1e-5 absolute for the
raw-valued metrics. Ids must be identical, ties going to the lower index.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperdb_tpu import ops as JOPS
from hyperdb_tpu.config import CONFIG as JAX_CONFIG
from hyperdb_tpu.ops import ranking as JR
from hyperdb_tpu_torch.config import CONFIG as TORCH_CONFIG
from hyperdb_tpu_torch.ops import gmax as G
from hyperdb_tpu_torch.ops import metrics as TM
from hyperdb_tpu_torch.ops import ranking as TR

N, D, K = 16384, 128, 16


@pytest.fixture
def grouped(monkeypatch):
    monkeypatch.setattr(JAX_CONFIG, "grouped_topk_min_rows", 4096)
    monkeypatch.setattr(TORCH_CONFIG, "grouped_topk_min_rows", 4096)


def _corpus(seed, low_precision):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((N, D)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[9] = v[2]
    mask = rng.random(N) < 0.95
    rec = (rng.random(N) * 0.01).astype(np.float32)
    rec[[2, 9]] = 0.0
    mask[[2, 9]] = True
    if low_precision:
        jv = jnp.asarray(v, dtype=jnp.bfloat16)
        tv = torch.from_numpy(v).bfloat16()
    else:
        jv, tv = jnp.asarray(v), torch.from_numpy(v)
    return v, jv, tv, mask, rec


@pytest.mark.parametrize("b", [1, 64, 512])
@pytest.mark.parametrize("metric", ["cosine_similarity", "dot_product"])
@pytest.mark.parametrize("low_precision", [True, False])
def test_router_grouped_matches_jax(grouped, b, metric, low_precision):
    v, jv, tv, mask, rec = _corpus(b, low_precision)
    rng = np.random.default_rng(100 + b)
    q = rng.standard_normal((b, D)).astype(np.float32)
    q[0] = v[2] * 3.0  # rows 2 and 9 tie at the top for query 0
    if metric == "dot_product":
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        if low_precision:  # the dot route takes the wire dtype as it is
            q = q.astype(np.float16)
    prenorm = metric == "cosine_similarity"
    jvals, jidx = JR.rank_top_k(
        jnp.asarray(q), jv, K, metric=metric, row_mask=jnp.asarray(mask),
        recency=jnp.asarray(rec), prenormalized=prenorm,
    )
    before = dict(G.LAUNCHES)
    tvals, tidx = TR.rank_top_k(
        torch.from_numpy(q), tv, K, metric=metric, row_mask=torch.from_numpy(mask),
        recency=torch.from_numpy(rec), prenormalized=prenorm,
    )
    assert G.LAUNCHES == before
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tvals.numpy(), np.asarray(jvals), rtol=0, atol=1e-5)
    assert list(tidx[0, :2]) == [2, 9]


def test_router_takes_gmax_route_at_min_batch(grouped, monkeypatch):
    """At b >= pallas_gmax_f_min_batch a bf16 scan goes to the gmax route;
    with the kernels switched off it takes the plain grouped form."""
    calls = []
    real = G.rank_top_k_grouped_gmax
    monkeypatch.setattr(
        G, "rank_top_k_grouped_gmax", lambda *a, **kw: calls.append(1) or real(*a, **kw)
    )
    _, _, tv, _, _ = _corpus(0, True)
    q = torch.randn(512, D, generator=torch.Generator().manual_seed(0))
    TR.rank_top_k(q, tv, K, prenormalized=True)
    assert calls == [1]
    TR.rank_top_k(q[:256], tv, K, prenormalized=True)
    monkeypatch.setattr(TORCH_CONFIG, "pallas_gmax", 0)
    TR.rank_top_k(q, tv, K, prenormalized=True)
    assert calls == [1]


def _stand_ins(device, b, n, d, dtype=torch.bfloat16):
    """A (b, d) query block and an (n, d) plane as the router sees them:
    their device, shapes and dtypes alone (no card needed for a CUDA one)."""
    dev = torch.device(device)
    return (
        types.SimpleNamespace(shape=torch.Size((b, d)), dtype=dtype, device=dev),
        types.SimpleNamespace(shape=torch.Size((n, d)), dtype=dtype, device=dev),
    )


@pytest.mark.parametrize(
    "device,b,n,want",
    [("cuda", 1, 1 << 20, True), ("cuda", 127, 1 << 20, True), ("cuda", 128, 1 << 20, True),
     ("cuda", 511, 1 << 20, True), ("cuda", 256, 8_388_608, True),
     ("cuda", 256, 1 << 18, True), ("cuda", 512, 1 << 18, True),
     ("cpu", 511, 1 << 20, False), ("cpu", 512, 1 << 20, True), ("cpu", 1, 8_388_608, False)],
)
def test_gmax_rule_by_device_and_batch(device, b, n, want, monkeypatch):
    """On the card a bf16 dot-form batch of any height takes the stage-1
    kernels; on the CPU the JAX package's floor (512 by default) holds."""
    monkeypatch.setattr(TORCH_CONFIG, "pallas_gmax_f_min_batch", 512)
    assert TR._use_gmax(*_stand_ins(device, b, n, 768), 128) is want


@pytest.mark.parametrize(
    "device,b,want",
    [("cuda", 1, False), ("cuda", 256, False), ("cuda", 511, False), ("cuda", 512, True),
     ("cpu", 511, False), ("cpu", 512, True)],
)
def test_gmax_rule_keeps_the_floor_for_the_metric_routes(device, b, want, monkeypatch):
    """The euclidean, hamming and jaccard routes keep the JAX package's
    floor on the card too, as ``rank_top_k_grouped_metric`` asks."""
    monkeypatch.setattr(TORCH_CONFIG, "pallas_gmax_f_min_batch", 512)
    qq, rows = _stand_ins(device, b, 1 << 20, 768)
    assert TR._use_gmax(qq, rows, 128, small_on_card=False) is want


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("knob", ["pallas_gmax_f_min_batch", "pallas_gmax"])
def test_gmax_rule_switched_off(device, knob, monkeypatch):
    monkeypatch.setattr(TORCH_CONFIG, knob, 0)
    for b in (1, 128, 512, 4096):
        assert not TR._use_gmax(*_stand_ins(device, b, 1 << 20, 768), 128)


@pytest.mark.parametrize(
    "n,d,dtype,k",
    [(1 << 20, 768, torch.float32, 128), ((1 << 20) + 64, 768, torch.bfloat16, 128),
     (1 << 20, 768, torch.bfloat16, 8193), (1 << 20, 772, torch.bfloat16, 128)],
)
def test_gmax_rule_keeps_shapes_the_kernel_refuses(n, d, dtype, k):
    """On the card too: an f32 plane, N not a multiple of 128, fewer than k
    groups, d not a multiple of 8 stay on the plain route."""
    assert TR._use_gmax(*_stand_ins("cuda", 1, 1 << 20, 768), 128)
    assert not TR._use_gmax(*_stand_ins("cuda", 1, n, d, dtype), k)


@pytest.mark.parametrize(
    "device,b,sub,want",
    [("cuda", 1, 32, 32), ("cuda", 3, 32, 32), ("cuda", 64, 32, 32), ("cuda", 600, 32, 32),
     ("cuda", 64, 0, 0), ("cuda", 64, 128, 0), ("cpu", 64, 32, 0), ("cpu", 128, 32, 32),
     ("cpu", 600, 32, 0), ("cpu", 2048, 32, 32)],
)
def test_subgroup_form_by_device_and_batch(device, b, sub, want, monkeypatch):
    """The two-level form on the card at every b; on the CPU where the JAX
    route's query tile, min(b, 1024), is a multiple of 128."""
    monkeypatch.setattr(TORCH_CONFIG, "pallas_subgroup", sub)
    assert G._subgroup(_stand_ins(device, b, 1 << 20, 768)[0]) == want


def _metric_inputs():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((8, 32)).astype(np.float32)
    v = rng.standard_normal((512, 32)).astype(np.float32)
    v[3] = 1.0  # constant row: pearson NaN -> -inf
    v[4] = 0.0  # zero row: jaccard 0/0 and cosine's zero norm
    v[11] = v[10]
    q[1] = 0.0
    return q, v


@pytest.mark.parametrize("metric", TM.METRICS)
def test_materialising_metrics_match_jax(metric):
    q, v = _metric_inputs()
    mask = np.ones(512, dtype=bool)
    mask[100:140] = False
    rec = np.linspace(0, 0.05, 512, dtype=np.float32)
    jvals, jidx = JR.rank_top_k(
        jnp.asarray(q), jnp.asarray(v), 32, metric=metric,
        row_mask=jnp.asarray(mask), recency=jnp.asarray(rec),
    )
    tvals, tidx = TR.rank_top_k(
        torch.from_numpy(q), torch.from_numpy(v), 32, metric=metric,
        row_mask=torch.from_numpy(mask), recency=torch.from_numpy(rec),
    )
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tvals.numpy(), np.asarray(jvals), rtol=1e-5, atol=1e-5)
    # the scores themselves, NaN policy included
    from hyperdb_tpu.ops import metrics as JM

    js = np.asarray(JM.scores(jnp.asarray(q), jnp.asarray(v), metric))
    ts = TM.scores(torch.from_numpy(q), torch.from_numpy(v), metric).numpy()
    np.testing.assert_array_equal(np.isnan(ts), np.isnan(js))
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)


def test_exact_top_k_prefers_lower_index():
    s = torch.tensor([[1.0, 3.0, 3.0, float("-inf"), 3.0, -2.0, -0.5, -2.0]])
    vals, idx = TR.exact_top_k(s, 7)
    assert idx.tolist() == [[1, 2, 4, 0, 6, 5, 7]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 1.0, -0.5, -2.0, -2.0]]
    jv, ji = JR.exact_top_k(jnp.asarray(s.numpy()), 7)
    assert np.asarray(ji).tolist() == idx.tolist()


def test_large_manhattan_not_ported(grouped):
    """Manhattan over a large corpus used to raise; it now takes the
    streamed scan at this batch and returns the JAX router's answer
    (``tests/test_torch_l1.py`` holds the routes in full)."""
    v, jv, tv, mask, rec = _corpus(23, low_precision=True)
    q = np.random.default_rng(24).standard_normal((4, D)).astype(np.float32)
    q[0] = v[2]  # rows 2 and 9 tie at the top for query 0
    jvals, jidx = JR.rank_top_k(
        jnp.asarray(q), jv, K, metric="manhattan_distance",
        row_mask=jnp.asarray(mask), recency=jnp.asarray(rec),
    )
    tvals, tidx = TR.rank_top_k(
        torch.from_numpy(q), tv, K, metric="manhattan_distance",
        row_mask=torch.from_numpy(mask), recency=torch.from_numpy(rec),
    )
    assert tidx[0, :2].tolist() == [2, 9]
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tvals.numpy(), np.asarray(jvals), rtol=1e-6)


# --------------------------------------------------------------------------
# the ops package's exports: JAX's ``hyperdb_tpu.ops.__all__``, each name
# held to its JAX counterpart on one small input
# --------------------------------------------------------------------------


def _export_cases():
    """name -> (JAX call, port call), both on the same seeded numpy input."""
    from hyperdb_tpu_torch import ops as tops

    rng = np.random.default_rng(31)
    n, d, b, k = 300, 24, 4, 5
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    s = rng.standard_normal((b, 4096)).astype(np.float32)
    mask = rng.random(n) < 0.9
    rec = (rng.random(n) * 0.01).astype(np.float32)
    docs = np.repeat(np.arange(n // 3), 3).astype(np.int32)
    cand = rng.permutation(n)[:40].astype(np.int32)  # one candidate union per block
    cand_ok = rng.random((b, 40)) < 0.8
    vb = (v > 0).astype(np.float32)
    ts = rng.random(n) * 100.0
    J, T = jnp.asarray, torch.from_numpy
    cases = {name: (lambda f=getattr(JOPS, name), g=getattr(tops, name): (f(J(q), J(v)), g(T(q), T(v))))
             for name in ("cosine_scores", "dot_scores", "euclidean_scores", "hamming_scores",
                          "jaccard_scores", "manhattan_scores", "pearson_scores")}
    cases.update({
        "METRICS": lambda: (tuple(JOPS.METRICS), tuple(tops.METRICS)),
        "GROUPED_METRICS": lambda: (tuple(JOPS.GROUPED_METRICS), tuple(tops.GROUPED_METRICS)),
        "normalize": lambda: (JOPS.normalize(J(v)), tops.normalize(T(v))),
        "scores": lambda: (JOPS.scores(J(q), J(v), "dot_product"),
                           tops.scores(T(q), T(v), "dot_product")),
        "exact_top_k": lambda: (JOPS.exact_top_k(J(s), k), tops.exact_top_k(T(s), k)),
        "exact_top_k_grouped": lambda: (JOPS.exact_top_k_grouped(J(s), k, group=128),
                                        tops.exact_top_k_grouped(T(s), k, group=128)),
        "rank_top_k": lambda: (
            JOPS.rank_top_k(J(q), J(v), k, row_mask=J(mask), recency=J(rec)),
            tops.rank_top_k(T(q), T(v), k, row_mask=T(mask), recency=T(rec))),
        "rank_top_k_grouped": lambda: (
            JOPS.rank_top_k_grouped(J(q), J(v), k, row_mask=J(mask), recency=J(rec), group=32),
            tops.rank_top_k_grouped(T(q), T(v), k, row_mask=T(mask), recency=T(rec), group=32)),
        "rank_top_k_grouped_metric": lambda: (
            JOPS.rank_top_k_grouped_metric(J(q), J(vb), J(vb.sum(1)), k, "jaccard_similarity",
                                           row_mask=J(mask), group=32),
            tops.rank_top_k_grouped_metric(T(q), T(vb), T(vb.sum(1)), k, "jaccard_similarity",
                                           row_mask=T(mask), group=32)),
        "rank_docs_top_k": lambda: (
            JOPS.rank_docs_top_k(J(q), J(v), J(docs), J(mask), k, n // 3),
            tops.rank_docs_top_k(T(q), T(v), T(docs), T(mask), k, n // 3)),
        "rank_gathered": lambda: (
            JOPS.rank_gathered(J(q), J(v), J(cand), J(cand_ok), k),
            tops.rank_gathered(T(q), T(v), T(cand), T(cand_ok), k)),
        "ranking_algorithm_sort": lambda: (
            JOPS.ranking_algorithm_sort(v, q[0], k, timestamps=ts, recency_bias=0.5),
            tops.ranking_algorithm_sort(v, q[0], k, timestamps=ts, recency_bias=0.5,
                                        device="cpu")),
        "recency_scores": lambda: (JOPS.recency_scores(ts, 0.5), tops.recency_scores(ts, 0.5)),
        "rank_top_k_planar": lambda: (
            JOPS.rank_top_k_planar(J(q), [J(v[:100]), J(v[100:])], k, metric="euclidean_metric",
                                   row_masks=[J(mask[:100]), J(mask[100:])]),
            tops.rank_top_k_planar(T(q), [T(v[:100]), T(v[100:])], k, metric="euclidean_metric",
                                   row_masks=[T(mask[:100]), T(mask[100:])])),
    })
    return cases


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def test_ops_exports_jax_names_but_the_planar_route():
    """The port's ``ops`` exports every name of JAX's ``ops.__all__``, the
    planar route included, in JAX's order."""
    from hyperdb_tpu_torch import ops as tops

    assert tops.__all__ == JOPS.__all__
    assert set(_export_cases()) == set(tops.__all__)
    assert "rank_top_k_planar" in tops.__all__


@pytest.mark.parametrize("name", JOPS.__all__)
def test_ops_export_matches_jax(name):
    """``from hyperdb_tpu_torch.ops import <name>`` gives the JAX function's
    answer: ids equal, floats within 1e-5 relative plus 1e-5 absolute (f32
    sums in different orders)."""
    exec(f"from hyperdb_tpu_torch.ops import {name}", {})
    want, got = _export_cases()[name]()
    if isinstance(want, tuple) and isinstance(want[0], str):
        assert got == want
        return
    want = want if isinstance(want, (tuple, list)) else (want,)
    got = got if isinstance(got, (tuple, list)) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _as_numpy(g), _as_numpy(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       rtol=1e-5, atol=1e-5)
