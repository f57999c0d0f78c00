"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: skipped where no CUDA device is present. On a machine with
a Hopper card run ``python -m pytest tests/test_torch_cuda.py -m cuda -q``.
Tolerance: 1e-5 absolute on unit-norm rows and queries — the kernel and
cuBLAS sum the same exact bf16 products in f32 in different orders, which
moves scores of magnitude <= 1 by a few f32 ulps (~1e-7 each); -inf positions must match exactly.
``gmax_int8`` and ``gmax_jaccard`` must EQUAL their plain versions: their
products are exact integers and their epilogues are the same sequence of
IEEE f32 operations, with no multiply-add contracted.
The stage-1 scans exist in two variants (``wgmma`` fed by TMA, ``mma.sync``
fed by ``cp.async``), chosen by ``gmax.kernel_variant``: the shapes below
stress the first (ragged query tiles, depths that end inside a 128-byte
box, the deepest resident query tile and one past it) and hold each variant
to the plain versions and to the other.
``gmax_l1`` and ``gmax_l1t`` sum d terms |v - q| in f32 in another order
than torch's ``sum(-1)``: rtol 1e-5 plus atol 1e-4 on distances of
magnitude ~d; -inf / +inf positions must match exactly.
"""

import numpy as np
import pytest
import torch

from hyperdb_tpu_torch.ops import gmax as G
from hyperdb_tpu_torch.ops import l1 as L
from hyperdb_tpu_torch.ops import quantized as Q
from hyperdb_tpu_torch.ops import ranking as R

pytestmark = pytest.mark.cuda

ATOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, b, n, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    v = rng.standard_normal((n, d)).astype(np.float32)
    # unit-norm rows and queries, as the cosine main path scans
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[5] = v[3]  # exact tie inside one subgroup
    v[300] = v[40]  # exact tie across groups
    v[777] = np.nan  # NaN row -> -inf scores
    v[512:640] = np.nan  # a whole NaN group: only the scrub makes its maxes -inf
    mask = rng.random(n) < 0.9
    mask[128:256] = False  # one whole group masked
    rec = (rng.random(n) * 0.05).astype(np.float32)
    qt = torch.from_numpy(q).to(dev).bfloat16()
    vt = torch.from_numpy(v).to(dev).bfloat16()
    extra = G.make_extra(
        n, torch.from_numpy(mask).to(dev), torch.from_numpy(rec).to(dev), device=dev
    )
    return qt, vt, extra


def _same(got, want):
    assert got.shape == want.shape
    ninf_g, ninf_w = torch.isneginf(got), torch.isneginf(want)
    assert torch.equal(ninf_g, ninf_w)
    fin = ~ninf_w
    assert torch.isfinite(got[fin]).all()
    assert (got[fin] - want[fin]).abs().max().item() <= ATOL


@pytest.mark.parametrize("b,n,d", [(128, 4096, 384), (77, 2048, 128), (300, 1024, 40)])
def test_gmax_f_kernel_matches_plain(dev, b, n, d):
    q, v, extra = _inputs(dev, b, n, d)
    got = G.gmax_f(q, v, extra)
    torch.cuda.synchronize()
    _same(got, G.gmax_f_plain(q, v, extra))


@pytest.mark.parametrize("sub", [8, 16, 32, 64])
@pytest.mark.parametrize("dual", [True, False])
def test_gmax_f_sub_kernel_matches_plain(dev, sub, dual):
    q, v, extra = _inputs(dev, 200, 4096, 384, seed=sub)
    gm, sm = G.gmax_f_sub(q, v, extra, sub=sub, dual=dual)
    torch.cuda.synchronize()
    want_gm, want_sm = G.gmax_f_sub_plain(q, v, extra, sub=sub)
    _same(sm, want_sm)
    _same(gm, want_gm)
    # the group maxes are exactly the maxes of their subgroups
    assert torch.equal(gm, sm.view(200, -1, 128 // sub).amax(-1))


def test_launch_counters(dev):
    q, v, extra = _inputs(dev, 128, 1024, 128)
    before = dict(G.LAUNCHES)
    G.gmax_f(q, v, extra)
    G.gmax_f_sub(q, v, extra)
    G.gmax_f_plain(q, v, extra)
    assert G.LAUNCHES["gmax_f"] == before["gmax_f"] + 1
    assert G.LAUNCHES["gmax_f_sub"] == before["gmax_f_sub"] + 1


@pytest.mark.parametrize("sub", [32, 0])
def test_route_matches_plain_grouped(dev, monkeypatch, sub):
    from hyperdb_tpu_torch.config import CONFIG

    monkeypatch.setattr(CONFIG, "pallas_subgroup", sub)
    q, v, _ = _inputs(dev, 512, 8192, 384, seed=3)
    rng = np.random.default_rng(4)
    mask = torch.from_numpy(rng.random(8192) < 0.9).to(dev)
    rec = torch.from_numpy((rng.random(8192) * 0.05).astype(np.float32)).to(dev)
    gv, gi = G.rank_top_k_grouped_gmax(q, v, 16, row_mask=mask, recency=rec)
    pv, pi = R.rank_top_k_grouped(q, v, 16, row_mask=mask, recency=rec)
    torch.cuda.synchronize()
    assert (gv - pv).abs().max().item() <= ATOL
    # ids may swap only between rows whose scores tie within the tolerance
    diff = gi != pi
    assert ((gv - pv).abs()[diff] <= ATOL).all()


@pytest.mark.parametrize("sub", [32, 0])
def test_db_on_card_matches_cpu(dev, monkeypatch, sub):
    """The slice end to end: the same DB on the card (kernels) and on the
    CPU (plain versions) returns the same ids, through the kernel route."""
    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.config import CONFIG

    monkeypatch.setattr(CONFIG, "grouped_topk_min_rows", 4096)
    monkeypatch.setattr(CONFIG, "pallas_subgroup", sub)
    rng = np.random.default_rng(9)
    v = (rng.standard_normal((16384, 384)) / np.sqrt(384)).astype(np.float16)
    docs = list(range(16384))
    q = rng.standard_normal((600, 384)).astype(np.float32)
    card = HyperDB(docs, v, fp_precision="float16", device=dev)
    cpu = HyperDB(docs, v, fp_precision="float16", device="cpu")
    before = dict(G.LAUNCHES)
    gi, gv = card.query_batch_arrays(q, top_k=10)
    name = "gmax_f_sub" if sub else "gmax_f"
    assert G.LAUNCHES[name] == before[name] + 1
    pi, pv = cpu.query_batch_arrays(q, top_k=10)
    assert np.abs(gv - pv).max() <= ATOL
    diff = gi != pi
    assert (np.abs(gv - pv)[diff] <= ATOL).all()


@pytest.mark.parametrize("b,n,d", [(128, 4096, 384), (77, 2048, 128), (300, 1024, 48), (8, 256, 1024)])
def test_gmax_int8_kernel_equals_plain(dev, b, n, d):
    rng = np.random.default_rng(b)
    v = rng.standard_normal((n, d)).astype(np.float32)
    v[5] = 0.0  # zero-scale row: 0 + extra, not NaN
    v[128:256] = 0.0  # a whole zero-scale group
    v_i8, sc = Q.quantize_rows(v)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
    q[1] = 0.0
    q_i8, q_scale = Q._quantize_device(q)
    mask = rng.random(n) < 0.9
    mask[384:512] = False
    rec = (rng.random(n) * 0.05).astype(np.float32)
    extra = G.make_extra(
        n, torch.from_numpy(mask).to(dev), torch.from_numpy(rec).to(dev), device=dev
    )
    args = (q_i8, q_scale, torch.from_numpy(v_i8).to(dev), torch.from_numpy(sc).to(dev), extra)
    before = G.LAUNCHES["gmax_int8"]
    got = G.gmax_int8(*args)
    torch.cuda.synchronize()
    assert G.LAUNCHES["gmax_int8"] == before + 1
    assert torch.equal(got, G.gmax_int8_plain(*args))
    if n >= 512:
        assert torch.isneginf(got[:, 3]).all()  # the masked group


@pytest.mark.parametrize("b,n,d", [(128, 4096, 384), (77, 2048, 128), (300, 1024, 40)])
def test_gmax_jaccard_kernel_equals_plain(dev, b, n, d):
    rng = np.random.default_rng(n)
    vb = (rng.standard_normal((n, d)) > 0).astype(np.float32)
    vb[5] = 0.0
    vb[128:256] = 0.0  # a whole group of empty rows
    qb = (rng.standard_normal((b, d)) > 0).astype(np.float32)
    qb[1] = 0.0  # an empty query: 0/0 against the empty rows
    mask = rng.random(n) < 0.9
    mask[384:512] = False
    extra = G.make_extra(n, torch.from_numpy(mask).to(dev), device=dev)
    args = (
        torch.from_numpy(qb).to(dev).bfloat16(), torch.from_numpy(vb).to(dev).bfloat16(),
        torch.from_numpy(qb.sum(1, keepdims=True)).to(dev), torch.from_numpy(vb.sum(1)).to(dev),
        extra,
    )
    before = G.LAUNCHES["gmax_jaccard"]
    got = G.gmax_jaccard(*args)
    torch.cuda.synchronize()
    assert G.LAUNCHES["gmax_jaccard"] == before + 1
    assert torch.equal(got, G.gmax_jaccard_plain(*args))
    assert torch.isneginf(got[1, 1]) and torch.isneginf(got[:, 3]).all()


def test_quantize_device_card_equals_cpu(dev):
    """Query quantization divides in IEEE on the card as on the CPU: torch
    turns a division by a Python scalar into a multiplication by its
    reciprocal there, which moved scales by an ulp and a few quantized
    elements by one."""
    x = torch.from_numpy(
        np.random.default_rng(5).standard_normal((4096, 384)).astype(np.float32)
    )
    x /= x.norm(dim=1, keepdim=True)
    cq, cs = Q._quantize_device(x)
    gq, gs = Q._quantize_device(x.to(dev))
    assert torch.equal(gs.cpu(), cs) and torch.equal(gq.cpu(), cq)


@pytest.mark.parametrize("precision", ["int8", "int8-pure"])
def test_int8_db_on_card_matches_cpu(dev, monkeypatch, precision):
    """The int8 slice end to end: the same DB on the card (gmax_int8) and
    on the CPU (its plain version) returns the same ids. The quantized
    scores are equal; the f32 rescore of the int8 mode sums in another
    order on the card (1e-5)."""
    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.config import CONFIG

    monkeypatch.setattr(CONFIG, "grouped_topk_min_rows", 4096)
    monkeypatch.setattr(Q, "_EPILOGUE_BUDGET_BYTES", 1 << 22)
    rng = np.random.default_rng(9)
    v = (rng.standard_normal((16384, 384)) / np.sqrt(384)).astype(np.float16)
    docs = list(range(16384))
    q = rng.standard_normal((600, 384)).astype(np.float32)
    card = HyperDB(docs, v, fp_precision="float16", device=dev, device_precision=precision)
    cpu = HyperDB(docs, v, fp_precision="float16", device="cpu", device_precision=precision)
    before = G.LAUNCHES["gmax_int8"]
    gi, gv = card.query_batch_arrays(q, top_k=10)
    assert G.LAUNCHES["gmax_int8"] == before + 1
    pi, pv = cpu.query_batch_arrays(q, top_k=10)
    tol = 0.0 if precision == "int8-pure" else ATOL
    assert np.abs(gv - pv).max() <= tol
    diff = gi != pi
    assert (np.abs(gv - pv)[diff] <= tol).all() and diff.mean() < 0.01
    # below the budget: the plain grouped int8 form, on the card too
    gi, gv = card.query_batch_arrays(q[:64], top_k=10)
    assert G.LAUNCHES["gmax_int8"] == before + 1
    pi, pv = cpu.query_batch_arrays(q[:64], top_k=10)
    assert np.abs(gv - pv).max() <= tol and (gi == pi).mean() > 0.99


@pytest.mark.parametrize(
    "metric, kernel",
    [
        ("euclidean_metric", "gmax_f_sub"),
        ("hamming_distance", "gmax_f_sub"),
        ("jaccard_similarity", "gmax_jaccard"),
        ("pearson_correlation", "gmax_f_sub"),
    ],
)
def test_metric_db_on_card_matches_cpu(dev, monkeypatch, metric, kernel):
    """The grouped metrics end to end, card against CPU. Hamming and
    jaccard scores are exact; euclidean and pearson sum in another order."""
    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.config import CONFIG

    monkeypatch.setattr(CONFIG, "grouped_topk_min_rows", 4096)
    rng = np.random.default_rng(10)
    v = (rng.standard_normal((16384, 384)) / np.sqrt(384)).astype(np.float16)
    docs = [{"ts": float(i % 89) / 89.0} for i in range(16384)]
    q = rng.standard_normal((512, 384)).astype(np.float32)
    card = HyperDB(docs, v, fp_precision="float16", device=dev, metadata_keys=["ts"])
    cpu = HyperDB(docs, v, fp_precision="float16", device="cpu", metadata_keys=["ts"])
    exact = metric in ("hamming_distance", "jaccard_similarity")
    before = dict(G.LAUNCHES)
    gi, gv = card.query_batch_arrays(q, top_k=10, metric=metric)
    assert G.LAUNCHES[kernel] == before[kernel] + 1
    pi, pv = cpu.query_batch_arrays(q, top_k=10, metric=metric)
    assert np.abs(gv - pv).max() <= (0.0 if exact else ATOL)
    assert (gi == pi).all() if exact else (gi == pi).mean() > 0.99
    # recency: the plain form on the card (pearson is dot: its kernel takes recency)
    before = dict(G.LAUNCHES)
    kw = {"recency_bias": 0.05, "timestamp_key": "ts"}
    gi, gv = card.query_batch_arrays(q, top_k=10, metric=metric, **kw)
    if metric != "pearson_correlation":
        assert G.LAUNCHES == before
    pi, pv = cpu.query_batch_arrays(q, top_k=10, metric=metric, **kw)
    assert np.abs(gv - pv).max() <= ATOL and (gi == pi).mean() > 0.99


STRESS_B = [1, 63, 64, 77, 128, 129, 640]
STRESS_D = [40, 64, 128, 384, 392, 768, 1024]  # 392: a ragged box; 1024: past the resident tile
STRESS_N = [256, 1024, 4096]
STRESS = [
    (b, STRESS_N[(i + j) % 3], d) for i, b in enumerate(STRESS_B) for j, d in enumerate(STRESS_D)
]


def _stress_inputs(dev, b, n, d, seed=0):
    """Unit-norm rows and queries with ties, a NaN row, a NaN group, a masked
    group and recency, placed so that a 256-row corpus holds them all (its
    two groups are then the masked one and a live one)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    v = rng.standard_normal((n, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[5] = v[3]  # exact tie inside one subgroup
    v[77] = np.nan  # a NaN row
    mask = rng.random(n) < 0.9
    mask[128:256] = False  # one whole group masked
    if n > 256:
        v[300] = v[40]  # exact tie across groups
        v[n - 128 :] = np.nan  # a whole NaN group, the last one
    rec = (rng.random(n) * 0.05).astype(np.float32)
    extra = G.make_extra(
        n, torch.from_numpy(mask).to(dev), torch.from_numpy(rec).to(dev), device=dev
    )
    return torch.from_numpy(q).to(dev).bfloat16(), torch.from_numpy(v).to(dev).bfloat16(), extra


def _launch_variant(variant, kind, q, v, extra, sub=0, group=True, qaux=None, vaux=None):
    """One scan through ``variant`` whatever the shape rule says."""
    b, n = q.shape[0], v.shape[0]
    sm = torch.empty((b, n // sub), dtype=torch.float32, device=q.device) if sub else None
    gm = torch.empty((b, n // 128), dtype=torch.float32, device=q.device) if group else None
    G._launch(kind, q, v, extra, sm, gm, sub, qaux=qaux, vaux=vaux, _variant=variant)
    torch.cuda.synchronize()
    return gm, sm


@pytest.mark.parametrize("b,n,d", STRESS)
def test_float_scans_over_stress_shapes(dev, b, n, d):
    """``gmax_f_sub`` (single and dual) and ``gmax_f`` through the variant the
    rule picks, against the plain versions and against the other variant."""
    q, v, extra = _stress_inputs(dev, b, n, d, seed=b + d)
    variant = G.kernel_variant(n, d, 2)
    assert variant == ("wgmma" if d <= 768 else "mma")
    before = dict(G.LAUNCHES_BY_VARIANT)
    gm, sm = G.gmax_f_sub(q, v, extra, sub=32, dual=False)
    gm_d, sm_d = G.gmax_f_sub(q, v, extra, sub=32, dual=True)
    gm_f = G.gmax_f(q, v, extra)
    torch.cuda.synchronize()
    assert G.LAUNCHES_BY_VARIANT[variant] == before[variant] + 3
    assert sum(G.LAUNCHES_BY_VARIANT.values()) == sum(before.values()) + 3
    want_gm, want_sm = G.gmax_f_sub_plain(q, v, extra, sub=32)
    _same(sm, want_sm)
    _same(gm, want_gm)
    _same(gm_f, want_gm)
    assert torch.equal(sm_d, sm) and torch.equal(gm_d, gm) and torch.equal(gm_f, gm)
    assert torch.isneginf(gm[:, 1]).all()  # the masked group
    if n > 256:
        assert torch.isneginf(gm[:, -1]).all()  # the NaN group
    # the mma.sync variant takes every depth: hold the two against each other
    old_gm, old_sm = _launch_variant("mma", G._KIND_F, q, v, extra, sub=32)
    _same(sm, old_sm)
    _same(gm, old_gm)


@pytest.mark.parametrize("sub", [8, 16, 32, 64])
@pytest.mark.parametrize("dual", [True, False])
@pytest.mark.parametrize("b,n,d", [(129, 1024, 392), (640, 4096, 384)])
def test_wgmma_subgroups(dev, sub, dual, b, n, d):
    q, v, extra = _stress_inputs(dev, b, n, d, seed=sub)
    before = G.LAUNCHES_BY_VARIANT["wgmma"]
    gm, sm = G.gmax_f_sub(q, v, extra, sub=sub, dual=dual)
    gm_other, _ = G.gmax_f_sub(q, v, extra, sub=sub, dual=not dual)
    torch.cuda.synchronize()
    assert G.LAUNCHES_BY_VARIANT["wgmma"] == before + 2
    want_gm, want_sm = G.gmax_f_sub_plain(q, v, extra, sub=sub)
    _same(sm, want_sm)
    _same(gm, want_gm)
    assert torch.equal(gm, gm_other)  # dual and single group maxes, bit for bit
    assert torch.equal(gm, sm.view(b, -1, 128 // sub).amax(-1))


def test_wgmma_many_items_with_odd_tile_counts(dev):
    """More (query tile, corpus range) items than the card has SMs, three
    groups to an item: a block then reloads its query tile between items and
    its two warpgroups swap which takes an item's first group."""
    b, n, d = 128 * 150 + 5, 384, 64
    q, v, extra = _stress_inputs(dev, b, n, d, seed=11)
    gm, sm = G.gmax_f_sub(q, v, extra, sub=32, dual=True)
    torch.cuda.synchronize()
    want_gm, want_sm = G.gmax_f_sub_plain(q, v, extra, sub=32)
    _same(sm, want_sm)
    _same(gm, want_gm)
    old_gm, old_sm = _launch_variant("mma", G._KIND_F, q, v, extra, sub=32)
    _same(sm, old_sm)
    _same(gm, old_gm)


def test_wgmma_refuses_a_depth_past_its_rule(dev):
    """Forced onto a shape it does not take, the wgmma entry point refuses;
    nothing else steps in."""
    q, v, extra = _stress_inputs(dev, 64, 256, 1024)
    before = dict(G.LAUNCHES_BY_VARIANT)
    with pytest.raises(RuntimeError, match="gmax_scan_wgmma launch failed"):
        _launch_variant("wgmma", G._KIND_F, q, v, extra, sub=32)
    assert G.LAUNCHES_BY_VARIANT == before


@pytest.mark.parametrize(
    "b,n,d",
    [(1, 256, 64), (63, 1024, 48), (77, 4096, 128), (129, 1024, 384), (640, 4096, 400),
     (128, 256, 768), (64, 1024, 1536), (129, 256, 1552), (640, 1024, 2048)],
)
def test_int8_scan_over_stress_shapes(dev, b, n, d):
    rng = np.random.default_rng(b + d)
    v = rng.standard_normal((n, d)).astype(np.float32)
    v[5] = 0.0  # zero-scale row: 0 + extra, not NaN
    v[n - 128 :] = 0.0  # a whole zero-scale group
    v_i8, sc = Q.quantize_rows(v)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
    q[0] = 0.0
    q_i8, q_scale = Q._quantize_device(q)
    mask = rng.random(n) < 0.9
    mask[128:256] = False
    rec = (rng.random(n) * 0.05).astype(np.float32)
    extra = G.make_extra(
        n, torch.from_numpy(mask).to(dev), torch.from_numpy(rec).to(dev), device=dev
    )
    v_t, sc_t = torch.from_numpy(v_i8).to(dev), torch.from_numpy(sc).to(dev)
    variant = G.kernel_variant(n, d, 1)
    assert variant == ("wgmma" if d <= 1536 else "mma")
    before = G.LAUNCHES_BY_VARIANT[variant]
    got = G.gmax_int8(q_i8, q_scale, v_t, sc_t, extra)
    torch.cuda.synchronize()
    assert G.LAUNCHES_BY_VARIANT[variant] == before + 1
    assert torch.equal(got, G.gmax_int8_plain(q_i8, q_scale, v_t, sc_t, extra))
    assert torch.isneginf(got[:, 1]).all()
    old, _ = _launch_variant("mma", G._KIND_INT8, q_i8, v_t, extra, qaux=q_scale, vaux=sc_t)
    assert torch.equal(got, old)


@pytest.mark.parametrize(
    "b,n,d", [(1, 256, 64), (63, 1024, 40), (129, 4096, 384), (640, 1024, 392), (77, 256, 768),
              (128, 1024, 1024)],
)
def test_jaccard_scan_over_stress_shapes(dev, b, n, d):
    rng = np.random.default_rng(b + d)
    vb = (rng.standard_normal((n, d)) > 0).astype(np.float32)
    vb[5] = 0.0
    vb[n - 128 :] = 0.0  # a whole group of empty rows
    qb = (rng.standard_normal((b, d)) > 0).astype(np.float32)
    qb[0] = 0.0  # an empty query: 0/0 against the empty rows
    mask = rng.random(n) < 0.9
    mask[128:256] = False
    extra = G.make_extra(n, torch.from_numpy(mask).to(dev), device=dev)
    qq, vv = torch.from_numpy(qb).to(dev).bfloat16(), torch.from_numpy(vb).to(dev).bfloat16()
    q_sum, aux = torch.from_numpy(qb.sum(1, keepdims=True)).to(dev), torch.from_numpy(vb.sum(1)).to(dev)
    variant = G.kernel_variant(n, d, 2)
    before = G.LAUNCHES_BY_VARIANT[variant]
    got = G.gmax_jaccard(qq, vv, q_sum, aux, extra)
    torch.cuda.synchronize()
    assert G.LAUNCHES_BY_VARIANT[variant] == before + 1
    assert torch.equal(got, G.gmax_jaccard_plain(qq, vv, q_sum, aux, extra))
    assert torch.isneginf(got[0, -1]) and torch.isneginf(got[:, 1]).all()
    old, _ = _launch_variant(
        "mma", G._KIND_JACCARD, qq, vv, extra, qaux=q_sum.reshape(b).contiguous(), vaux=aux
    )
    assert torch.equal(got, old)


@pytest.mark.parametrize("dens_q, dens_v", [(0.5, 0.5), (0.05, 0.9), (0.9, 0.05), (0.01, 0.01), (0.99, 0.99)])
@pytest.mark.parametrize("b,n,d", [(300, 2048, 384), (129, 1024, 768), (77, 1024, 40)])
def test_jaccard_division_over_count_ranges(dev, dens_q, dens_v, b, n, d):
    """The wgmma variant divides the counts without the branch of IEEE
    division's slow path; over sparse, dense and mixed rows (intersections
    from 0 to d, unions up to 2d, 0/0 and a/a among them) its group maxes
    equal the plain version's bit for bit."""
    rng = np.random.default_rng(int(1000 * dens_q) + d)
    pv = np.clip(2 * dens_v * rng.random((n, 1)), 0, 1)  # per-row densities: counts cover the range
    pq = np.clip(2 * dens_q * rng.random((b, 1)), 0, 1)
    vb = (rng.random((n, d)) < pv).astype(np.float32)
    qb = (rng.random((b, d)) < pq).astype(np.float32)
    vb[5], vb[7], qb[0], qb[1] = 0.0, 1.0, 0.0, 1.0  # empty and full rows and queries
    mask = rng.random(n) < 0.9
    extra = G.make_extra(n, torch.from_numpy(mask).to(dev), device=dev)
    qq, vv = torch.from_numpy(qb).to(dev).bfloat16(), torch.from_numpy(vb).to(dev).bfloat16()
    q_sum, aux = torch.from_numpy(qb.sum(1, keepdims=True)).to(dev), torch.from_numpy(vb.sum(1)).to(dev)
    assert G.kernel_variant(n, d, 2) == "wgmma"
    got = G.gmax_jaccard(qq, vv, q_sum, aux, extra)
    torch.cuda.synchronize()
    assert torch.equal(got, G.gmax_jaccard_plain(qq, vv, q_sum, aux, extra))


def _l1_inputs(dev, b, n, d, bf16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    v = rng.standard_normal((n, d)).astype(np.float32)
    v[300] = v[40]  # an exact tie across groups
    v[100, 5] = np.nan  # sinks its row only
    v[512:640, 0] = np.nan  # a whole group of NaN rows
    q[3, 7] = np.nan  # a NaN query: every group bottoms out
    mask = rng.random(n) < 0.9
    mask[128:256] = False  # one whole group masked
    vt = torch.from_numpy(v).to(dev)
    if bf16:
        vt = vt.bfloat16()
    extra = L.make_extra(n, torch.from_numpy(mask).to(dev), device=dev)
    return torch.from_numpy(q).to(dev), vt, extra


L1_SHAPES = [
    (64, 4096, 384, True), (77, 2048, 128, False), (300, 1024, 40, True), (8, 1024, 1000, True),
    (130, 1024, 384, False),
]


@pytest.mark.parametrize("b,n,d,bf16", L1_SHAPES)
def test_gmax_l1_kernel_matches_plain(dev, b, n, d, bf16):
    q, v, extra = _l1_inputs(dev, b, n, d, bf16, seed=b)
    before = L.LAUNCHES["gmax_l1"]
    got = L.gmax_l1(q, v, extra)
    torch.cuda.synchronize()
    assert L.LAUNCHES["gmax_l1"] == before + 1
    want = L.gmax_l1_plain(q, v, extra)
    assert not torch.isnan(got).any()
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = ~torch.isneginf(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)
    assert torch.isneginf(got[:, 1]).all() and torch.isneginf(got[:, 4]).all()
    assert torch.isneginf(got[3]).all()


@pytest.mark.parametrize("b,n,d,bf16", L1_SHAPES)
def test_gmax_l1t_kernel_matches_plain(dev, b, n, d, bf16):
    q, v, extra = _l1_inputs(dev, b, n, d, bf16, seed=b)
    vt = v.t().contiguous()
    before = L.LAUNCHES["gmax_l1t"]
    got = L.gmax_l1t(q, vt, extra)
    torch.cuda.synchronize()
    assert L.LAUNCHES["gmax_l1t"] == before + 1
    want = L.gmax_l1t_plain(q, vt, extra)
    assert not torch.isnan(got).any()
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    fin = ~torch.isposinf(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)
    assert torch.isposinf(got[:, 1]).all() and torch.isposinf(got[:, 4]).all()
    assert (got[3] >= 1e29).all()  # the NaN query, at the finite 1e30
    # the two contracts agree after negation wherever no query is NaN
    a = L.gmax_l1(q, v, extra)
    keep = torch.ones(b, dtype=torch.bool, device=dev)
    keep[3] = False
    torch.testing.assert_close(-got[keep], a[keep], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("l1t", [1, 0])
def test_manhattan_route_equals_stream_on_card(dev, monkeypatch, l1t):
    """The kernel route and the streamed scan rescore through one torch
    expression: identical ids and identical scores on the card."""
    from hyperdb_tpu_torch.config import CONFIG

    monkeypatch.setattr(CONFIG, "pallas_l1t", l1t)
    q, v, _ = _l1_inputs(dev, 64, 16384, 384, True, seed=5)
    mask = torch.from_numpy(np.random.default_rng(6).random(16384) < 0.9).to(dev)
    name = "gmax_l1t" if l1t else "gmax_l1"
    before = L.LAUNCHES[name]
    kv, ki = L.rank_top_k_manhattan_l1(q, v, 16, row_mask=mask)
    assert L.LAUNCHES[name] == before + 1
    sv, si = R.rank_top_k_manhattan_stream(q, v, 16, row_mask=mask, tile=4096)
    assert torch.equal(ki, si) and torch.equal(kv, sv)


@pytest.mark.parametrize("l1t", [1, 0])
def test_manhattan_db_on_card_matches_cpu(dev, monkeypatch, l1t):
    """Manhattan end to end, card against CPU: b = 64 through the kernel
    named by ``pallas_l1t``, recency and b = 16 through the streamed scan.
    The card's and the CPU's f32 sums run in different orders: 1e-5
    relative on the scores, ids equal but for near-ties."""
    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.config import CONFIG

    monkeypatch.setattr(CONFIG, "grouped_topk_min_rows", 4096)
    monkeypatch.setattr(CONFIG, "pallas_l1t", l1t)
    rng = np.random.default_rng(12)
    v = (rng.standard_normal((16384, 384)) / np.sqrt(384)).astype(np.float16)
    docs = [{"ts": float(i % 89) / 89.0} for i in range(16384)]
    q = (rng.standard_normal((64, 384)) / np.sqrt(384)).astype(np.float32)
    card = HyperDB(docs, v, fp_precision="float16", device=dev, metadata_keys=["ts"])
    cpu = HyperDB(docs, v, fp_precision="float16", device="cpu", metadata_keys=["ts"])
    name = "gmax_l1t" if l1t else "gmax_l1"

    def same(kw, qq):
        gi, gv = card.query_batch_arrays(qq, top_k=10, metric="manhattan_distance", **kw)
        pi, pv = cpu.query_batch_arrays(qq, top_k=10, metric="manhattan_distance", **kw)
        np.testing.assert_allclose(gv, pv, rtol=1e-5)
        assert (gi == pi).mean() > 0.99

    before = dict(L.LAUNCHES)
    same({}, q)
    assert L.LAUNCHES[name] == before[name] + 1
    same({}, q.astype(np.float16))  # the f16 wire takes the kernel too
    assert L.LAUNCHES[name] == before[name] + 2
    same({"recency_bias": 0.05, "timestamp_key": "ts"}, q)
    same({}, q[:16])
    assert sum(L.LAUNCHES.values()) == sum(before.values()) + 2


# ---------------------------------------------------------------- the text path

# the local-384 encoder, card against CPU (unit rows): largest element
# difference and smallest row cosine, as chip_smoke.py holds them (6.7e-4
# and 0.99999 measured on an H100 there)
ENC_MAX_ABS, ENC_MIN_COS = 5e-3, 0.9999


@pytest.fixture(scope="module")
def encoders():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from hyperdb_tpu_torch.models.minilm import MiniLMEmbedder

    return (MiniLMEmbedder.from_local_assets(device="cuda"),
            MiniLMEmbedder.from_local_assets(device="cpu"))


def _texts(n, seed, lo=4, hi=60):
    rng = np.random.default_rng(seed)
    words = ("pokemon sleeps hours fire water grass electric psychic ghost rock dragon "
             "flies swims attacks quickly slowly large small red blue ancient forest cave "
             "mountain sea river city night day").split()
    return [" ".join(rng.choice(words, size=rng.integers(lo, hi))) for _ in range(n)]


def test_encoder_card_matches_cpu(encoders):
    card, cpu = encoders
    texts = _texts(96, 0) + ["", "x"]
    got, want = card.encode(texts), cpu.encode(texts)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(got - want).max() <= ENC_MAX_ABS
    assert (got * want).sum(axis=1).min() >= ENC_MIN_COS
    block = card.encode_device(texts[:5])
    assert block.is_cuda and block.shape == (8, 384)
    np.testing.assert_array_equal(block[:5].cpu().numpy(), card.encode(texts[:5]))


@pytest.fixture(scope="module")
def text_db(encoders):
    """A float16 text DB embedded on the card, large enough (with the
    grouped threshold lowered per test) for the gmax route at b = 512."""
    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.models.embedder import make_embedding_function

    card, _ = encoders
    docs = [{"name": f"d{i}", "text": t} for i, t in enumerate(_texts(4096, 1, 8, 40))]
    return HyperDB(docs, embedding_function=make_embedding_function(card, card.chunk_tokenizer),
                   fp_precision="float16", device="cuda")


def test_text_block_matches_host_path(text_db, monkeypatch):
    """``encode_device`` -> ``query_batch_arrays`` gives the host path's
    embeddings, ids and scores, through ``gmax_f_sub`` at b = 512."""
    from hyperdb_tpu_torch.config import CONFIG
    from hyperdb_tpu_torch.query import engine as E

    monkeypatch.setattr(CONFIG, "grouped_topk_min_rows", 4096)
    texts = _texts(500, 2, 3, 16)
    before = G.LAUNCHES["gmax_f_sub"]
    block = E.generate_query_vectors_batch_device(text_db, texts)
    assert block.is_cuda and block.shape == (512, 384)
    ids, vals = text_db.query_batch_arrays(block, top_k=10, n_valid=500)
    assert G.LAUNCHES["gmax_f_sub"] == before + 1
    host = E.generate_query_vectors_batch(text_db, texts)
    np.testing.assert_array_equal(host, block[:500].cpu().numpy())
    hids, hvals = text_db.query_batch_arrays(host, top_k=10)
    assert ids.shape == (500, 10)
    np.testing.assert_array_equal(ids, hids)
    np.testing.assert_array_equal(vals, hvals)


def test_query_block_on_another_device_raises(text_db):
    from hyperdb_tpu_torch import HyperDB

    with pytest.raises(ValueError, match="query block is on cpu"):
        text_db.query_batch_arrays(torch.zeros((8, 384)), top_k=5)
    cpu_db = HyperDB([{"a": "b"}], np.ones((1, 384), np.float32), device="cpu")
    with pytest.raises(ValueError, match="query block is on cuda"):
        cpu_db.query_batch_arrays(torch.zeros((8, 384), device="cuda"), top_k=1)


@pytest.mark.parametrize("fmt", ["checkpoint", "pickle.gz"])
def test_save_load_on_card_bit_equal(text_db, tmp_path, monkeypatch, fmt):
    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.config import CONFIG
    from hyperdb_tpu_torch.query import engine as E

    monkeypatch.setattr(CONFIG, "grouped_topk_min_rows", 4096)
    block = E.generate_query_vectors_batch_device(text_db, _texts(512, 3, 3, 16))
    ids, vals = text_db.query_batch_arrays(block, top_k=10, n_valid=512)
    path = str(tmp_path / ("db" if fmt == "checkpoint" else "db.pickle.gz"))
    if fmt == "checkpoint":
        text_db.save(path, format="checkpoint")
        fresh = HyperDB(device="cuda")
        fresh.load(path, format="checkpoint", preload_ann_into_memory=True)
    else:
        text_db.save(path)
        fresh = HyperDB(fp_precision="float16", device="cuda")
        fresh.load(path)
    got_ids, got_vals = fresh.query_batch_arrays(block, top_k=10, n_valid=512)
    np.testing.assert_array_equal(got_ids, ids)
    np.testing.assert_array_equal(got_vals, vals)
    assert fresh.documents == text_db.documents and fresh.split_info == text_db.split_info


# ---------------------------------------------------------------- indexes


@pytest.mark.parametrize("b,n,d", [(1024, 1 << 14, 128), (256, 1 << 14, 64), (64, 4096, 96)])
def test_gmax_int8_equals_plain_at_projscan_depths(dev, b, n, d):
    """``gmax_int8`` at the depth projscan's stage A gives it (d' = 128: one
    128-byte TMA box) and at depths under one box: EQUAL to its plain
    version, with masks, recency and zero-scale rows."""
    rng = np.random.default_rng(d)
    v = rng.standard_normal((n, d)).astype(np.float32)
    v[5] = 0.0
    v_i8, sc = Q.quantize_rows(v)
    q_i8, q_scale = Q._quantize_device(torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev))
    mask = rng.random(n) < 0.9
    mask[256:384] = False
    rec = (rng.random(n) * 0.05).astype(np.float32)
    extra = G.make_extra(n, torch.from_numpy(mask).to(dev), torch.from_numpy(rec).to(dev), device=dev)
    args = (q_i8, q_scale, torch.from_numpy(v_i8).to(dev), torch.from_numpy(sc).to(dev), extra)
    assert G.kernel_variant(n, d, 1) == "wgmma"
    before = dict(G.LAUNCHES_BY_VARIANT)
    got = G.gmax_int8(*args)
    torch.cuda.synchronize()
    assert G.LAUNCHES_BY_VARIANT["wgmma"] == before["wgmma"] + 1
    assert torch.equal(got, G.gmax_int8_plain(*args))
    assert torch.isneginf(got[:, 2]).all()


def _clustered_rows(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((32, d)).astype(np.float32) * 3
    v = centers[rng.integers(0, 32, size=n)] + rng.standard_normal((n, d)).astype(np.float32)
    return v.astype(np.float32)


def test_ivf_db_on_card_matches_cpu(dev, monkeypatch):
    """An IVF DB built on the card against the same DB on the CPU: the
    build is deterministic (exact fixed-point centroid sums, f64
    assignment logits), so two builds on the card give the same lists and
    the CPU build gives them too; with the card's index state carried to the
    CPU DB, both probe the same candidates and answer the same (single
    queries and the batched frontier)."""
    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.config import CONFIG
    from hyperdb_tpu_torch.core import db as DB
    from hyperdb_tpu_torch.index.ivf import IVFIndex

    monkeypatch.setattr(DB, "IVF_THRESHOLD", 1000)
    monkeypatch.setattr(CONFIG, "batch_ivf_min_rows", 1000)
    v = _clustered_rows(20000, 64, 3)
    docs = list(range(len(v)))
    card = HyperDB(docs, v, device=dev)
    cpu = HyperDB(docs, v, device="cpu")
    assert isinstance(card.ann_index, IVFIndex) and card.ann_index.device.type == "cuda"
    again = HyperDB(docs, v, device=dev)
    np.testing.assert_array_equal(card.ann_index.row_order, again.ann_index.row_order)
    np.testing.assert_array_equal(card.ann_index.centroids, again.ann_index.centroids)
    np.testing.assert_array_equal(card.ann_index.row_order, cpu.ann_index.row_order)
    np.testing.assert_array_equal(card.ann_index.offsets, cpu.ann_index.offsets)
    cpu.ann_index = IVFIndex.from_state(card.ann_index.state(), device="cpu")
    q = v[:256] + 0.05
    for a in range(4):
        np.testing.assert_array_equal(card.ann_index.probe(q[a], 1000), cpu.ann_index.probe(q[a], 1000))
        g, c = card.query(q[a], top_k=10), cpu.query(q[a], top_k=10)
        assert [r[2] for r in g] == [r[2] for r in c]
        assert np.abs(np.array([r[1] for r in g]) - [r[1] for r in c]).max() <= ATOL
    gi, gv = card.query_batch_arrays(q, top_k=10)
    pi, pv = cpu.query_batch_arrays(q, top_k=10)
    assert np.abs(gv - pv).max() <= ATOL and ((gi == pi) | (np.abs(gv - pv) <= ATOL)).all()


def test_projscan_db_on_card_matches_cpu(dev, monkeypatch):
    """A projscan DB on the card (stage A on ``gmax_int8``, 128-row groups,
    once per batch) against the same DB on the CPU with the 128-row route
    forced there (the wrapper's plain version). Both DBs then take one
    index with an identity projection, so both quantize the same query
    bits: ids and scores must be identical."""
    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.config import CONFIG
    from hyperdb_tpu_torch.index import projscan as P

    monkeypatch.setattr(CONFIG, "projscan_threshold", 1)
    v = _clustered_rows(1 << 14, 128, 4)
    docs = list(range(len(v)))
    card = HyperDB(docs, v, device=dev, device_precision="int8-pure")
    cpu = HyperDB(docs, v, device="cpu", device_precision="int8-pure")
    assert card.ann_index.d_prime == 128 and card.ann_index.a_i8.is_cuda
    q = v[:1024] + 0.05
    before = G.LAUNCHES["gmax_int8"]
    card.query_batch_arrays(q, top_k=10)
    assert G.LAUNCHES["gmax_int8"] == before + 1

    dv = cpu._store.device_view(cpu.source_indices)
    a = dv["rowsn_q"].float() * dv["rown_scales"][:, None]
    a_i8, a_sc = Q._quantize_device(a)
    state = P.ProjScanIndex(np.eye(128, dtype=np.float32), a_i8, a_sc, dv["n_pad"],
                            num_valid=len(v)).state()
    card.ann_index = P.ProjScanIndex.from_state(state, device=dev)
    cpu.ann_index = P.ProjScanIndex.from_state(state, device="cpu")
    before = G.LAUNCHES["gmax_int8"]
    gi, gv = card.query_batch_arrays(q, top_k=10)
    assert G.LAUNCHES["gmax_int8"] == before + 1
    real = P._stage_a_on_kernel
    monkeypatch.setattr(P, "_stage_a_on_kernel", lambda qa, a, g: a.device.type == "cpu" or real(qa, a, g))
    pi, pv = cpu.query_batch_arrays(q, top_k=10)
    np.testing.assert_array_equal(gi, pi)
    np.testing.assert_array_equal(gv, pv)
    assert G.LAUNCHES["gmax_int8"] == before + 1  # the CPU ran the plain version


@pytest.mark.parametrize("front", ["native", "stdlib"])
def test_server_on_card_answers_exactly(dev, front):
    """A front end over a float16 DB on the card answers a binary query with
    the ids and scores of ``query_batch_arrays`` on the same float16 wire
    block, bit for bit; the native worker thread runs on the DB's card."""
    import threading

    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.client import HyperDBClient
    from hyperdb_tpu_torch.native.server import NativeQueryServer
    from hyperdb_tpu_torch.server import make_server

    rng = np.random.default_rng(12)
    v = rng.standard_normal((8192, 384)).astype(np.float16)
    q = rng.standard_normal(384).astype(np.float32)
    db = HyperDB([{"i": i} for i in range(8192)], v, fp_precision="float16", device="cuda")
    assert db.device == torch.device("cuda", torch.cuda.current_device())
    want_ids, want_vals = db.query_batch_arrays(q[None, :].astype(np.float16), top_k=10)
    if front == "native":
        srv = NativeQueryServer(db, port=0)
        port, stop = srv.port, srv.close
        assert srv.wire_f16
    else:
        httpd = make_server(db, port=0, dynamic_batch_ms=2.0)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        port = httpd.server_address[1]

        def stop():
            httpd.shutdown()
            httpd.batcher.close()
            httpd.server_close()
            th.join(timeout=30)
    try:
        with HyperDBClient("127.0.0.1", port, timeout=60) as c:
            ids, vals = c.query(q, top_k=10)
    finally:
        stop()
    np.testing.assert_array_equal(ids, want_ids[0])
    np.testing.assert_array_equal(vals, want_vals[0])


# ---------------------------------------------------------------- multi-device


def _sharded_pair(dev, n=20000, d=64, f16=False, seed=9):
    from hyperdb_tpu_torch import HyperDB

    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d)).astype(np.float32)
    docs = [{"i": i, "grp": "ab"[i % 2], "ts": float(i % 97)} for i in range(n)]
    kw = {"fp_precision": "float16"} if f16 else {}
    return HyperDB(docs, v, metadata_keys=["grp", "ts"], device=dev, **kw), v


def _tie_aware(got_ids, got_vals, want_ids, want_vals, atol):
    assert got_ids.shape == want_ids.shape
    assert np.abs(got_vals - want_vals).max() <= atol
    assert ((got_ids == want_ids) | (np.abs(got_vals - want_vals) <= atol)).all()


@pytest.mark.parametrize("metric", ["cosine_similarity", "dot_product", "euclidean_metric",
                                    "manhattan_distance", "pearson_correlation"])
def test_sharded_db_on_card_matches_single_device(dev, monkeypatch, metric):
    """A ShardedHyperDB of 4 shards on cuda:0 against the single-device DB
    it wraps, with the grouped routes (and their kernels) reached per shard:
    ids tie-aware equal, scores within 1e-5 (bf16 planes, f32 sums in other
    orders; 1e-8 for manhattan's ~1e-2 scores). Euclidean shards score the
    plain f64 form against the f32 query, which the single-device DB takes
    only below the grouped threshold: it keeps the default threshold here."""
    from hyperdb_tpu_torch.config import CONFIG
    from hyperdb_tpu_torch.parallel import make_mesh
    from hyperdb_tpu_torch.parallel.sharded_db import ShardedHyperDB

    if metric != "euclidean_metric":
        monkeypatch.setattr(CONFIG, "grouped_topk_min_rows", 2048)
    db, v = _sharded_pair(dev, f16=True)
    sdb = ShardedHyperDB(db, make_mesh(4, device=dev))
    assert sdb.mesh.local_devices() == [torch.device("cuda", 0)] * 4
    assert all(s.is_cuda for s in sdb.rows.shards) and len(sdb.rows.shards) == 4
    rng = np.random.default_rng(10)
    q = (v[rng.integers(0, len(v), 512)] + 0.1 * rng.standard_normal((512, v.shape[1]))).astype(np.float32)
    before = dict(G.LAUNCHES), dict(L.LAUNCHES)
    gi, gv = sdb.query_batch_arrays(q, top_k=10, metric=metric)
    wi, wv = db.query_batch_arrays(q, top_k=10, metric=metric)
    atol = 1e-8 if metric == "manhattan_distance" else ATOL
    _tie_aware(gi, gv, wi, wv, atol)
    if metric in ("cosine_similarity", "pearson_correlation"):
        assert G.LAUNCHES["gmax_f_sub"] >= before[0]["gmax_f_sub"] + 4  # every shard
    if metric == "manhattan_distance":
        assert L.LAUNCHES["gmax_l1t"] >= before[1]["gmax_l1t"] + 4
    fi, fv = sdb.query_batch_arrays(q[:64], top_k=10, metric=metric,
                                    filters=[("metadata", {"grp": "a"})])
    wfi, wfv = db.query_batch_arrays(q[:64], top_k=10, metric=metric,
                                     filters=[("metadata", {"grp": "a"})])
    _tie_aware(fi, fv, wfi, wfv, atol)
    assert not (fi % 2).any()


def test_sharded_int8_pure_on_card_matches_single_device(dev, monkeypatch):
    """int8-pure shards on cuda:0 (gmax_int8 per shard) against the
    single-device int8-pure DB: the same quantized scores."""
    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.config import CONFIG
    from hyperdb_tpu_torch.parallel import make_mesh
    from hyperdb_tpu_torch.parallel.sharded_db import ShardedHyperDB

    monkeypatch.setattr(CONFIG, "grouped_topk_min_rows", 2048)
    monkeypatch.setattr(Q, "_EPILOGUE_BUDGET_BYTES", 1 << 20)
    rng = np.random.default_rng(11)
    v = rng.standard_normal((16384, 128)).astype(np.float32)
    docs = list(range(len(v)))
    single = HyperDB(docs, v, device_precision="int8-pure", device=dev)
    sdb = ShardedHyperDB(HyperDB(docs, v, device=dev), make_mesh(4, device=dev), precision="int8-pure")
    q = rng.standard_normal((256, 128)).astype(np.float32)
    before = G.LAUNCHES["gmax_int8"]
    gi, gv = sdb.query_batch_arrays(q, top_k=10)
    assert G.LAUNCHES["gmax_int8"] == before + 4
    wi, wv = single.query_batch_arrays(q, top_k=10)
    _tie_aware(gi, gv, wi, wv, 1e-6)


def test_load_sharded_vectors_onto_the_card(dev, tmp_path):
    """A sharded checkpoint straight onto a 4-shard mesh on the card: each
    shard holds its rows (bf16 for a float16 master), zero rows pad each
    shard to 128; over an f32 master the served answers equal the
    host-built shards' (a float16 master's bf16 rows are normalized on the
    card there, its f16 rows on the host here, as in the JAX package)."""
    from hyperdb_tpu_torch.parallel import make_mesh
    from hyperdb_tpu_torch.parallel.sharded_db import ShardedHyperDB
    from hyperdb_tpu_torch.persist.checkpoint import load_sharded_vectors

    db, v = _sharded_pair(dev, n=5000, d=64, f16=True)
    path = str(tmp_path / "ckpt")
    db.save(path, format="checkpoint", rows_per_shard=1500)
    mesh = make_mesh(4, device=dev)
    rows, n = load_sharded_vectors(path, mesh)
    assert n == 5000 and rows.shape == (4 * 1280, 64) and rows.dtype == torch.bfloat16
    host = torch.from_numpy(v.astype(np.float16).astype(np.float32)).bfloat16()
    for j, shard in enumerate(rows.shards):
        assert shard.is_cuda and shard.shape == (1280, 64)
        lo, hi = j * 1280, min((j + 1) * 1280, 5000)
        assert torch.equal(shard[: hi - lo].cpu(), host[lo:hi])
        assert not shard[hi - lo:].any()
    db, v = _sharded_pair(dev, n=5000, d=64)
    path = str(tmp_path / "ckpt32")
    db.save(path, format="checkpoint", rows_per_shard=1500)
    sdb = ShardedHyperDB.from_checkpoint(path, mesh)
    assert sdb.rows.dtype == torch.float32 and sdb.db.device == torch.device("cuda", 0)
    ref = ShardedHyperDB(db, mesh)
    q = v[:32] + 0.05
    gi, gv = sdb.query_batch_arrays(q, top_k=10)
    wi, wv = ref.query_batch_arrays(q, top_k=10)
    assert np.array_equal(gi, wi) and np.abs(gv - wv).max() <= ATOL
