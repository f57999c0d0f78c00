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
