"""The distributed exact top-k: ``hyperdb_tpu_torch.parallel`` against
``hyperdb_tpu.parallel`` on the CPU.

The JAX package runs on its 8-device CPU mesh (``tests/conftest.py``), the
port on an 8-shard ``cpu`` mesh (``make_mesh(8, device="cpu")``); the same
seeded numpy inputs go through both. Ids must be identical (ties go to the
lower global row id in both); scores agree within ``rtol 1e-5, atol 1e-6``
(f32 products summed in other orders; the port's plain euclidean expands in
f64). Where a shard's route reaches a kernel, the port's CPU wrappers take
their plain versions, and the sharded answer is held to the port's own
single-device router over the whole corpus.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperdb_tpu.config import CONFIG as JAX_CONFIG
from hyperdb_tpu.ops.ranking import rank_top_k as jax_rank_top_k
from hyperdb_tpu.parallel import DistributedCorpus as JaxCorpus
from hyperdb_tpu.parallel import distributed as JD
from hyperdb_tpu.parallel import make_mesh as jax_make_mesh
from hyperdb_tpu_torch.config import CONFIG as TORCH_CONFIG
from hyperdb_tpu_torch.ops import gmax as G
from hyperdb_tpu_torch.ops import l1 as L
from hyperdb_tpu_torch.ops.ranking import rank_top_k
from hyperdb_tpu_torch.parallel import DistributedCorpus, make_mesh, sharded_rank_top_k
from hyperdb_tpu_torch.parallel import distributed as TD

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= 8, "conftest must provide 8 simulated devices"
    return jax_make_mesh(8), make_mesh(8, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def fresh_jax_programs():
    """The JAX sharded programs are cached per shape class and read the
    config when traced: leave none traced under this file's settings."""
    yield
    JD._sharded_topk_program.cache_clear()
    JD._sharded_topk_int8_program.cache_clear()


def _same(t_vals, t_idx, j_vals, j_idx, rtol=RTOL, atol=ATOL):
    np.testing.assert_array_equal(np.asarray(t_idx), np.asarray(j_idx))
    np.testing.assert_allclose(np.asarray(t_vals), np.asarray(j_vals), rtol=rtol, atol=atol)


@pytest.mark.parametrize("metric", ["cosine_similarity", "dot_product", "euclidean_metric"])
def test_sharded_matches_single_device(meshes, metric):
    jmesh, tmesh = meshes
    rng = np.random.default_rng(0)
    n, d, b, k = 512, 32, 4, 10
    v = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    vals, idx = DistributedCorpus(tmesh, v, metric=metric).query(q, k=k)
    _same(vals, idx, *JaxCorpus(jmesh, v, metric=metric).query(q, k=k))
    ov, oi = rank_top_k(torch.from_numpy(q), torch.from_numpy(v), k=k, metric=metric)
    _same(vals, idx, ov, oi)


def test_sharded_with_uneven_rows_and_mask(meshes):
    jmesh, tmesh = meshes
    rng = np.random.default_rng(1)
    n, d, b, k = 333, 16, 2, 7  # not divisible by 8: padding rows
    v = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    corpus = DistributedCorpus(tmesh, v, metric="dot_product")
    assert corpus.n_pad == 8 * 128 and corpus.rows.shards[0].shape == (128, d)
    vals, idx = corpus.query(q, k=k)
    assert (idx < n).all(), "padding rows must never be returned"
    _same(vals, idx, *JaxCorpus(jmesh, v, metric="dot_product").query(q, k=k))
    ov, oi = jax_rank_top_k(jnp.asarray(q), jnp.asarray(v), k=k, metric="dot_product")
    np.testing.assert_array_equal(idx, np.asarray(oi))


def test_sharded_recency(meshes):
    jmesh, tmesh = meshes
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(2)
    n, d = 64, 8
    v = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(1, d)).astype(np.float32)
    corpus = DistributedCorpus(tmesh, v, metric="cosine_similarity")
    rec_pad = np.zeros(corpus.n_pad, dtype=np.float32)
    rec_pad[5] = 100.0  # forces row 5 to the top
    vals, idx = sharded_rank_top_k(
        tmesh, q, corpus.rows, corpus.row_valid, k=3, metric="cosine_similarity",
        recency=rec_pad,
    )
    assert int(idx[0, 0]) == 5
    jc = JaxCorpus(jmesh, v, metric="cosine_similarity")
    jv, ji = JD.sharded_rank_top_k(
        jmesh, jnp.asarray(q), jc.rows, jc.row_valid, k=3, metric="cosine_similarity",
        recency=jax.device_put(rec_pad, NamedSharding(jmesh, P("data"))),
    )
    _same(vals, idx, jv, ji, rtol=1e-6)


def test_sharded_grouped_topk_matches_oracle(meshes, monkeypatch):
    """The per-shard grouped route (``grouped_topk_min_rows`` lowered on
    both packages) equals the per-shard plain route and the JAX package's
    grouped program."""
    jmesh, tmesh = meshes
    rng = np.random.default_rng(17)
    n, d, b, k = 8 * 512, 16, 130, 7  # b >= 128: group 128 divides 512
    rows = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    valid[::5] = False
    rec = rng.standard_normal(n).astype(np.float32) * 0.05

    monkeypatch.setattr(TORCH_CONFIG, "grouped_topk_min_rows", 10**9)
    ov, oi = sharded_rank_top_k(tmesh, q, rows, valid, k=k, metric="dot_product", recency=rec)
    routes = []
    real = TD.rank_top_k_grouped
    monkeypatch.setattr(TD, "rank_top_k_grouped",
                        lambda *a, **kw: routes.append(1) or real(*a, **kw))
    monkeypatch.setattr(TORCH_CONFIG, "grouped_topk_min_rows", 256)
    gv, gi = sharded_rank_top_k(tmesh, q, rows, valid, k=k, metric="dot_product", recency=rec)
    assert len(routes) == 8, "every shard must take the grouped route"
    np.testing.assert_array_equal(gi.numpy(), oi.numpy())
    np.testing.assert_allclose(gv.numpy(), ov.numpy(), rtol=1e-5)

    monkeypatch.setattr(JAX_CONFIG, "grouped_topk_min_rows", 256)
    JD._sharded_topk_program.cache_clear()
    jv, ji = JD.sharded_rank_top_k(
        jmesh, jnp.asarray(q), jnp.asarray(rows), jnp.asarray(valid), k=k,
        metric="dot_product", recency=jnp.asarray(rec),
    )
    JD._sharded_topk_program.cache_clear()
    _same(gv, gi, jv, ji, rtol=1e-5)


def test_sharded_int8_matches_unsharded_int8(meshes):
    """Merged per-shard int8 top-k == the unsharded int8 scan, in both
    packages, on the same quantized rows."""
    from hyperdb_tpu.ops.quantized import rank_top_k_int8 as jax_int8
    from hyperdb_tpu_torch.ops.quantized import quantize_rows, rank_top_k_int8

    jmesh, tmesh = meshes
    rng = np.random.default_rng(21)
    n, d, b, k = 8 * 256, 32, 4, 9
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    v_i8, scales = quantize_rows(v)
    valid = np.ones(n, dtype=bool)
    valid[::7] = False
    rec = (rng.standard_normal(n) * 0.02).astype(np.float32)

    sv, si = TD.sharded_rank_top_k_int8(tmesh, q, v_i8, scales, valid, k=k, recency=rec)
    ov, oi = rank_top_k_int8(torch.from_numpy(q), torch.from_numpy(v_i8),
                             torch.from_numpy(scales), k=k,
                             row_mask=torch.from_numpy(valid), recency=torch.from_numpy(rec))
    np.testing.assert_array_equal(si.numpy(), oi.numpy())
    np.testing.assert_allclose(sv.numpy(), ov.numpy(), rtol=1e-5)
    jv, ji = JD.sharded_rank_top_k_int8(
        jmesh, jnp.asarray(q), jnp.asarray(v_i8), jnp.asarray(scales),
        jnp.asarray(valid), k=k, recency=jnp.asarray(rec),
    )
    _same(sv, si, jv, ji, rtol=1e-5)
    _, jo = jax_int8(jnp.asarray(q), jnp.asarray(v_i8), jnp.asarray(scales), k=k,
                     row_mask=jnp.asarray(valid), recency=jnp.asarray(rec))
    np.testing.assert_array_equal(si.numpy(), np.asarray(jo))


def test_distributed_corpus_int8_recall(meshes):
    jmesh, tmesh = meshes
    rng = np.random.default_rng(22)
    n, d, b, k = 4096, 48, 6, 10
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    corpus = DistributedCorpus(tmesh, v, metric="cosine_similarity", precision="int8")
    vals, idx = corpus.query(q, k=k)
    _, oi = rank_top_k(torch.from_numpy(q), torch.from_numpy(v), k=k)
    oi = oi.numpy()
    recall = np.mean([len(set(idx[i].tolist()) & set(oi[i].tolist())) / k for i in range(b)])
    assert recall >= 0.9, recall
    assert corpus.rows_q.dtype == torch.int8  # the corpus is held as int8
    # the same quantized scan as the JAX package's
    _same(vals, idx, *JaxCorpus(jmesh, v, metric="cosine_similarity", precision="int8")
          .query(q, k=k), rtol=1e-5)


def test_distributed_corpus_int8_rejects_other_metrics(meshes):
    jmesh, tmesh = meshes
    v = np.random.default_rng(23).standard_normal((256, 16)).astype(np.float32)
    for corpus_cls, mesh in ((DistributedCorpus, tmesh), (JaxCorpus, jmesh)):
        with pytest.raises(ValueError):
            corpus_cls(mesh, v, metric="euclidean_metric", precision="int8")
    with pytest.raises(ValueError):
        DistributedCorpus(tmesh, v, precision="bf16")


def test_rows_must_divide_over_the_mesh(meshes):
    _, tmesh = meshes
    rng = np.random.default_rng(24)
    v = rng.standard_normal((100, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="divide evenly"):
        sharded_rank_top_k(tmesh, v[:2], v, np.ones(100, bool), k=3)
    with pytest.raises(ValueError, match="total rows"):
        sharded_rank_top_k(tmesh, v[:2], v[:96], np.ones(96, bool), k=97)


def test_top_k_beyond_one_shard(meshes):
    """k larger than a shard's rows: every shard gives all its rows and the
    merge is still the exact top-k (``k_local = min(k, n_local)``)."""
    jmesh, tmesh = meshes
    rng = np.random.default_rng(25)
    v = rng.standard_normal((256, 16)).astype(np.float32)  # 32 rows per shard
    q = rng.standard_normal((3, 16)).astype(np.float32)
    valid = np.ones(256, dtype=bool)
    tv, ti = sharded_rank_top_k(tmesh, q, v, valid, k=100, metric="dot_product")
    jv, ji = JD.sharded_rank_top_k(jmesh, jnp.asarray(q), jnp.asarray(v),
                                   jnp.asarray(valid), k=100, metric="dot_product")
    _same(tv, ti, jv, ji)


def test_ties_go_to_the_lower_global_row(meshes):
    """Duplicated rows on different shards tie exactly: the lower global id
    comes first, as with ``lax.top_k`` over the JAX package's merge."""
    jmesh, tmesh = meshes
    rng = np.random.default_rng(26)
    v = rng.standard_normal((1024, 16)).astype(np.float32)
    v[900] = v[5]
    v[300] = v[5]
    q = v[5:6] * 2.0
    valid = np.ones(1024, dtype=bool)
    tv, ti = sharded_rank_top_k(tmesh, q, v, valid, k=3, metric="cosine_similarity")
    assert ti[0].tolist() == [5, 300, 900]
    jv, ji = JD.sharded_rank_top_k(jmesh, jnp.asarray(q), jnp.asarray(v),
                                   jnp.asarray(valid), k=3, metric="cosine_similarity")
    _same(tv, ti, jv, ji)


def test_f16_wire_is_cast_to_the_shard_dtype(meshes):
    """An f16 query block against bf16 shards is cast per shard (JAX's
    ``_match_wire_dtype``); answers equal the bf16 block's."""
    _, tmesh = meshes
    q16 = torch.randn(4, 16, dtype=torch.float16)
    assert TD._match_wire_dtype(q16, torch.zeros(2, 16, dtype=torch.bfloat16)).dtype == torch.bfloat16
    assert TD._match_wire_dtype(q16, torch.zeros(2, 16)).dtype == torch.float16
    rng = np.random.default_rng(27)
    v = torch.from_numpy(rng.standard_normal((1024, 16)).astype(np.float32)).bfloat16()
    valid = np.ones(1024, dtype=bool)
    a = sharded_rank_top_k(tmesh, q16, v, valid, k=5, metric="dot_product")
    b = sharded_rank_top_k(tmesh, q16.bfloat16(), v, valid, k=5, metric="dot_product")
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])


@pytest.mark.parametrize("route", ["gmax_f_sub", "gmax_f", "gmax_int8", "gmax_l1t", "gmax_l1"])
def test_every_shard_takes_the_kernel_route(meshes, monkeypatch, route):
    """With the thresholds lowered, each shard of a bf16 (or int8) corpus
    takes the same stage-1 kernel route as the single-device router (the
    CPU wrappers run their plain versions and are counted here); the merge
    equals the single-device router over the whole corpus."""
    from hyperdb_tpu_torch.ops import quantized as Q

    _, tmesh = meshes
    rng = np.random.default_rng(28)
    n, d, k = 8 * 1024, 32, 6
    b = 128 if route.startswith("gmax_f") or route == "gmax_int8" else 64
    monkeypatch.setattr(TORCH_CONFIG, "grouped_topk_min_rows", 1024)
    monkeypatch.setattr(TORCH_CONFIG, "pallas_gmax_f_min_batch", 128)
    monkeypatch.setattr(TORCH_CONFIG, "pallas_l1t", int(route == "gmax_l1t"))
    monkeypatch.setattr(TORCH_CONFIG, "pallas_subgroup", 0 if route == "gmax_f" else 32)
    monkeypatch.setattr(Q, "_EPILOGUE_BUDGET_BYTES", 1 << 16)
    calls = {"n": 0}
    mod = L if route.startswith("gmax_l1") else G
    real = getattr(mod, route)
    monkeypatch.setattr(mod, route, lambda *a, **kw: calls.update(n=calls["n"] + 1) or real(*a, **kw))

    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    valid = rng.random(n) < 0.9
    if route == "gmax_int8":
        v_i8, scales = Q.quantize_rows(v)
        tv, ti = TD.sharded_rank_top_k_int8(tmesh, q, v_i8, scales, valid, k=k)
        calls_sharded = calls["n"]
        ov, oi = Q.rank_top_k_int8(torch.from_numpy(q), torch.from_numpy(v_i8),
                                   torch.from_numpy(scales), k=k, row_mask=torch.from_numpy(valid))
    else:
        metric = "manhattan_distance" if route.startswith("gmax_l1") else "dot_product"
        rows = torch.from_numpy(v).bfloat16()
        qq = torch.from_numpy(q)
        if metric == "dot_product":
            qq = qq.bfloat16()
        tv, ti = sharded_rank_top_k(tmesh, qq, rows, valid, k=k, metric=metric)
        calls_sharded = calls["n"]
        ov, oi = rank_top_k(qq, rows, k=k, metric=metric, row_mask=torch.from_numpy(valid))
    assert calls_sharded == 8, f"{route} ran on {calls_sharded} of 8 shards"
    np.testing.assert_array_equal(ti.numpy(), oi.numpy())
    np.testing.assert_allclose(tv.numpy(), ov.numpy(), rtol=1e-6, atol=0)


def test_mesh_shape_and_placement():
    mesh = make_mesh(8, device="cpu")
    assert mesh.shape == {"data": 8, "model": 1} and mesh.world == 1
    assert mesh.local_devices() == [torch.device("cpu")] * 8
    assert make_mesh(4, model_parallel=2, device="cpu").shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError):
        make_mesh(3, model_parallel=2, device="cpu")
    assert make_mesh(device="cpu").shape["data"] == 1


def test_cuda_mesh_never_holds_cpu_shards(monkeypatch):
    """A mesh asked for on the card where there is none raises, by default
    and by name: it never falls back to CPU shards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(4, device=device)
