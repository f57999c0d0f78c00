"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: skipped where no CUDA device is present. On a machine with
a Hopper card run ``python -m pytest tests/test_torch_cuda.py -m cuda -q``.
Tolerance: 1e-5 absolute on unit-norm rows and queries — the kernel and
cuBLAS sum the same exact bf16 products in f32 in different orders, which
moves scores of magnitude <= 1 by a few f32 ulps (~1e-7 each); -inf positions must match exactly.
``gmax_int8`` and ``gmax_jaccard`` must EQUAL their plain versions: their
products are exact integers and their epilogues are the same sequence of
IEEE f32 operations, with no multiply-add contracted.
The stage-1 scans exist in two variants (``wgmma`` with a resident query
tile: 128 queries at rows of 10 boxes of 128 bytes or fewer, 64 in clusters
of two blocks at 11-12 boxes; ``wgmma_stream`` for deeper rows), chosen by
``gmax.kernel_variant``:
the shapes below stress both (ragged query tiles, depths that end inside a
128-byte box, 7 to 12 boxes of depth and one past them, batches of one
query tile (clusters of one block), of an odd tile count (a cluster's second
block holds no query) and of many tiles, group counts that a 256-row item
does not divide, the 768-d benchmark cells' two planes) and hold each
variant to the plain versions.
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
SETTER_ATOL = 1e-4


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


# Stage 3 (``ranking.gather_dot``): bf16 operands on the card take
# ``csrc/gather_dot.cu``. Its shapes: the cells' (b = 1024, k = 128, width 32,
# d = 768 and 1536) over a smaller plane, the served flush (b = 32), and
# stress shapes (d = 8 and 4480, width 128 and 256, b = 1, k = 1).
GATHER_DOT_SHAPES = [
    (1024, 128, 32, 768, 1 << 18), (1024, 128, 32, 1536, 1 << 18), (32, 128, 32, 768, 1 << 20),
    (5, 16, 32, 8, 4096), (3, 16, 32, 4480, 8192), (7, 16, 128, 768, 8192),
    (4, 9, 256, 1536, 8192), (1, 128, 32, 768, 1 << 16), (64, 1, 32, 384, 4096),
    (1, 1, 128, 4480, 1024),
]


def _gather_dot_operands(dev, b, k, width, d, n, seed):
    """Unit-scale queries and rows, run ids that hold the plane's last run
    and, where k > 1, the same run twice in one query's list."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, d), generator=g, device=dev).bfloat16()
    rows = torch.randn((n, d), generator=g, device=dev).bfloat16()
    cidx = torch.randint(0, n // width, (b, k), generator=g, device=dev)
    cidx[:, -1] = n // width - 1
    if k > 1:
        cidx[:, 0] = cidx[:, 1]
    return q, rows, cidx


def _magnitudes(q, rows, cidx, width):
    """sum over t of |q_t * v_t| for every output, in f32 (b, k, width)."""
    b, k = cidx.shape
    n, d = rows.shape
    out = torch.empty((b, k, width), dtype=torch.float32, device=q.device)
    r3 = rows.view(n // width, width, d)
    for a in range(0, b, 64):
        cand = r3[cidx[a : a + 64]].float().abs()
        c = cand.shape[0]
        out[a : a + c] = (cand.view(c, -1, d) @ q[a : a + c].float().abs()[:, :, None]).view(c, k, width)
    return out


@pytest.mark.parametrize("b,k,width,d,n", GATHER_DOT_SHAPES)
def test_gather_dot_kernel_matches_plain(dev, b, k, width, d, n):
    """Kernel against the plain form (gather, upcast, cuBLAS GEMV). Both sum
    the same d exact bf16 x bf16 products in f32, in different orders: each
    rounding is at most 2^-24 of a partial sum, and partial sums of products
    of random sign stay far below the sum of magnitudes, so the two lie within
    2^-20 * sum |q_t v_t| of each other (the worst case, d * 2^-24 of it, is
    for sums of one sign). A run listed twice gives the same bits twice."""
    q, rows, cidx = _gather_dot_operands(dev, b, k, width, d, n, seed=b + k + width + d)
    before = R.LAUNCHES["gather_dot"]
    got = R.gather_dot(q, rows, cidx, width)
    torch.cuda.synchronize()
    assert R.LAUNCHES["gather_dot"] == before + 1
    want = R.gather_dot_plain(q, rows, cidx, width)
    assert got.shape == want.shape == (b, k, width) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= 2.0**-20 * _magnitudes(q, rows, cidx, width)).all()
    if k > 1:
        assert torch.equal(got[:, 0], got[:, 1])


@pytest.mark.parametrize("b,k,width,d,n", [(5, 16, 32, 8, 4096), (3, 16, 128, 4480, 8192)])
def test_gather_dot_kernel_within_f32_rounding_of_exact(dev, b, k, width, d, n):
    """Against the float64 sum of the same values: within gamma_d = d u /
    (1 - d u), u = 2^-24, of the sum of magnitudes, whatever the order."""
    q, rows, cidx = _gather_dot_operands(dev, b, k, width, d, n, seed=7)
    got = R.gather_dot(q, rows, cidx, width).double()
    r3 = rows.view(n // width, width, d)[cidx].double()  # (b, k, width, d)
    q64 = q.double()[:, None, None, :]
    want = (r3 * q64).sum(-1)
    mag = (r3 * q64).abs().sum(-1)
    gamma = d * 2.0**-24 / (1 - d * 2.0**-24)
    assert ((got - want).abs() <= gamma * mag).all()


def test_gather_dot_kernel_is_deterministic(dev):
    q, rows, cidx = _gather_dot_operands(dev, 1024, 128, 32, 768, 1 << 18, seed=1)
    first = R.gather_dot(q, rows, cidx, 32)
    second = R.gather_dot(q, rows, cidx, 32)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_rescore_turns_a_nan_row_into_neg_inf(dev):
    """The kernel returns a NaN row's raw product; ``gmax._rescore`` scrubs it
    to -inf and adds ``extra``, as on the plain form."""
    q, rows, cidx = _gather_dot_operands(dev, 16, 8, 32, 384, 4096, seed=2)
    rows[cidx[3, 2] * 32 + 5] = float("nan")
    extra = torch.zeros(4096, device=dev)
    got = G._rescore(q, rows, extra, cidx, 32)
    raw = R.gather_dot(q, rows, cidx, 32)
    torch.cuda.synchronize()
    assert torch.isnan(raw[3, 2, 5])
    nan = torch.isnan(raw)
    assert torch.equal(torch.isneginf(got), nan) and not torch.isnan(got).any()
    assert torch.equal(got[~nan], raw[~nan])


def test_gather_dot_kernel_refuses_what_it_does_not_take(dev):
    q, rows, cidx = _gather_dot_operands(dev, 8, 4, 32, 64, 1024, seed=3)
    wide = torch.zeros((8, 128), dtype=torch.bfloat16, device=dev)[:, :64]  # not contiguous
    before = R.LAUNCHES["gather_dot"]
    with pytest.raises(ValueError, match="contiguous"):
        R.gather_dot(wide, rows, cidx, 32)  # bf16 on the card: the kernel's route
    with pytest.raises(ValueError, match="contiguous"):
        R.gather_dot_kernel(q, rows.t().contiguous().t(), cidx, 32)
    with pytest.raises(ValueError, match="bfloat16"):
        R.gather_dot_kernel(q.half(), rows.half(), cidx, 32)
    with pytest.raises(ValueError, match="int64"):
        R.gather_dot_kernel(q, rows, cidx.int(), 32)
    with pytest.raises(ValueError, match="shapes"):
        R.gather_dot_kernel(q, rows, cidx, 48)  # 1024 rows are no whole number of runs
    assert R.LAUNCHES["gather_dot"] == before
    # f16 and f32 rows on the card take the plain form
    assert R.gather_dot(q.half(), rows.half(), cidx, 32).shape == (8, 4, 32)
    assert R.gather_dot(q.float(), rows.float(), cidx, 32).shape == (8, 4, 32)
    assert R.LAUNCHES["gather_dot"] == before


def test_gather_dot_launches_on_every_grouped_route(dev, monkeypatch):
    """The dot route, the metric kernel route and the plain grouped metric
    route (recency keeps it plain) each launch the kernel once a plane."""
    q, v, _ = _inputs(dev, 512, 8192, 384, seed=5)
    v = torch.nan_to_num(v)
    sq = (v.float() ** 2).sum(-1)
    rec = torch.zeros(8192, device=dev)
    before = R.LAUNCHES["gather_dot"]
    G.rank_top_k_grouped_gmax(q, v, 16)
    assert R.LAUNCHES["gather_dot"] == before + 1
    G.rank_top_k_grouped_metric_gmax(q.float(), v, sq, 16, "euclidean_metric")
    assert R.LAUNCHES["gather_dot"] == before + 2
    R.rank_top_k_grouped_metric(q.float(), v, sq, 16, "euclidean_metric", recency=rec)
    assert R.LAUNCHES["gather_dot"] == before + 3


def test_vectors_setter_then_query_on_card_matches_cpu(dev, monkeypatch):
    """``db.vectors = ...`` on a card DB that has served a batch: the next
    batch scans the new rows through ``gmax_f_sub`` and returns exactly
    what a card DB built over those rows returns, and the CPU DB's ids
    (scores within ``SETTER_ATOL``: the card's and the CPU's f32 query
    norms differ in the last ulp, which can move a query element across a
    bf16 rounding step: a few 1e-5 of score on these rows)."""
    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.config import CONFIG

    monkeypatch.setattr(CONFIG, "grouped_topk_min_rows", 4096)
    rng = np.random.default_rng(16)
    v = (rng.standard_normal((16384, 384)) / np.sqrt(384)).astype(np.float16)
    v2 = (rng.standard_normal((16384, 384)) / np.sqrt(384)).astype(np.float16)
    docs = list(range(16384))
    q = rng.standard_normal((600, 384)).astype(np.float32)
    card = HyperDB(docs, v, fp_precision="float16", device=dev)
    cpu = HyperDB(docs, v, fp_precision="float16", device="cpu")
    card.query_batch_arrays(q, top_k=10)  # the old corpus's planes exist
    card.vectors = v2
    cpu.vectors = v2
    before = dict(G.LAUNCHES)
    gi, gv = card.query_batch_arrays(q, top_k=10)
    assert G.LAUNCHES["gmax_f_sub"] == before["gmax_f_sub"] + 1
    fi, fv = HyperDB(docs, v2, fp_precision="float16", device=dev).query_batch_arrays(q, top_k=10)
    assert np.array_equal(gi, fi) and np.array_equal(gv, fv)
    pi, pv = cpu.query_batch_arrays(q, top_k=10)
    assert np.abs(gv - pv).max() <= SETTER_ATOL
    diff = gi != pi
    assert (np.abs(gv - pv)[diff] <= SETTER_ATOL).all()
    q2 = v2[:8].astype(np.float32)
    gi, _ = card.query_batch_arrays(q2, top_k=1)
    assert list(gi[:, 0]) == list(range(8))


def _near_tie_aware(gi, gv, pi, pv, tol):
    """Scores within ``tol`` (per cell) of the reference's, and ids equal
    but where the reference ranks a near-tie: an id may differ only at a
    place whose reference score is within twice ``tol`` of a neighbour's,
    or at the last place (which may tie with a row past the list)."""
    tol = np.broadcast_to(tol, pv.shape)
    gap = np.abs(gv - pv)
    assert (gap <= tol).all(), float((gap - tol).max())
    step = np.abs(np.diff(pv, axis=1)) <= 2 * tol[:, 1:]
    near = np.zeros(pv.shape, dtype=bool)
    near[:, 1:] |= step
    near[:, :-1] |= step
    near[:, -1] = True
    assert near[gi != pi].all()


@pytest.mark.parametrize("metric,b,wire,kernels", [
    ("cosine_similarity", 600, np.float32, {"gmax_f_sub": 4}),
    ("dot_product", 600, np.float16, {"gmax_f_sub": 4}),
    ("manhattan_distance", 64, np.float32, {"gmax_l1t": 4}),
    ("euclidean_metric", 64, np.float32, {}),
])
def test_planar_db_on_card_matches_one_plane_and_cpu(dev, monkeypatch, metric, b, wire, kernels):
    """A planar DB on the card (``plane_rows`` lowered: four planes of 4096
    rows, a duplicate pair across two of them) launches its per-plane kernel
    once per plane (euclidean: the plain per-plane scores, no kernel), and
    answers as the same DB with one plane on the card (not euclidean: its
    one-plane grouped route multiplies a bf16-rounded query, as in the JAX
    package) and as the planar DB on the CPU. Dot takes the kernel route
    only over a low-precision query wire (float16 here); f32 dot queries
    rank in f32 without a kernel.

    Tolerances, checked tie-aware (ids may differ only where scores tie
    within them): planar against one plane on the card, 1e-5 relative plus
    ATOL (the same query bits, f32 sums in other orders). The card against
    the CPU, the same plus, for cosine, the query's bf16 rounding: each
    side normalizes the f32 query with its own sum order, so an element
    near a bf16 rounding boundary can round to a neighbour on one side;
    a query's scores then move by at most sum_i |dq_i| max_r |v_ri|, with
    dq the two sides' bf16 queries' difference (0 for most queries)."""
    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.config import CONFIG
    from hyperdb_tpu_torch.ops.metrics import normalize

    monkeypatch.setattr(CONFIG, "grouped_topk_min_rows", 4096)
    monkeypatch.setattr(CONFIG, "plane_rows", 4096)
    rng = np.random.default_rng(13)
    v = (rng.standard_normal((16384, 384)) / np.sqrt(384)).astype(np.float16)
    v[9000] = v[4]
    docs = list(range(16384))
    q = (rng.standard_normal((b, 384)) / np.sqrt(384)).astype(np.float32)
    q[0] = v[4]
    q = q.astype(wire)
    card = HyperDB(docs, v, fp_precision="float16", device=dev)
    cpu = HyperDB(docs, v, fp_precision="float16", device="cpu")
    assert card._store.is_planar(16384)
    before = {**G.LAUNCHES, **L.LAUNCHES}
    gi, gv = card.query_batch_arrays(q, top_k=10, metric=metric)
    after = {**G.LAUNCHES, **L.LAUNCHES}
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == kernels
    assert list(gi[0, :2]) == [4, 9000]
    if metric != "euclidean_metric":
        monkeypatch.setattr(CONFIG, "plane_rows", 0)
        oi, ov = card.query_batch_arrays(q, top_k=10, metric=metric)
        monkeypatch.setattr(CONFIG, "plane_rows", 4096)
        _near_tie_aware(gi, gv, oi, ov, 1e-5 * np.abs(ov) + ATOL)
    pi, pv = cpu.query_batch_arrays(q, top_k=10, metric=metric)
    flip = np.zeros((b, 1), dtype=np.float32)
    if metric == "cosine_similarity":
        rows = torch.cat(cpu._store.device_view(cpu.source_indices)["rows_norm_planes"]).float()
        sides = [
            normalize(torch.from_numpy(q).to(d)).bfloat16().float().cpu() for d in (dev, "cpu")
        ]
        flip = ((sides[0] - sides[1]).abs() @ rows.abs().amax(0)).numpy()[:, None]
    _near_tie_aware(gi, gv, pi, pv, 1e-5 * np.abs(pv) + ATOL + flip)


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("b", [1, 3, 32, 64, 128, 256])
def test_small_batches_take_the_kernels_over_planes(dev, monkeypatch, b, filtered):
    """On the card a batch under the JAX package's floor of 512 takes the
    stage-1 kernels: ``gmax_f_sub`` once a plane at every b, the subgroup
    form under 128 too. Over two bf16 planes, with
    and without a row mask and recency, it answers as the plain grouped
    route does (the kernels switched off): the same ids up to near-ties.
    A duplicate across the planes ties exactly on the kernel route and
    goes to the lower global id; the plain route's f32 products over
    planes of other lengths may sum it in other orders, so there it is a
    near-tie."""
    from hyperdb_tpu_torch.config import CONFIG

    monkeypatch.setattr(CONFIG, "grouped_topk_min_rows", 4096)
    rng = np.random.default_rng(30 + b)
    sizes = (16384, 8192)
    rows = [rng.standard_normal((n, 384)).astype(np.float32) for n in sizes]
    for v in rows:
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        v[777] = np.nan
    rows[1][100] = rows[0][3]
    q = rng.standard_normal((b, 384)).astype(np.float32)
    q[0] = rows[0][3]
    kw = {}
    if filtered:
        masks = [rng.random(n) < 0.9 for n in sizes]
        recs = [(rng.random(n) * 0.05).astype(np.float32) for n in sizes]
        masks[0][3] = masks[1][100] = True
        recs[0][3] = recs[1][100] = 0.0
        kw = {
            "row_masks": [torch.from_numpy(m).to(dev) for m in masks],
            "recencies": [torch.from_numpy(r).to(dev) for r in recs],
        }
    planes = [torch.from_numpy(v).to(dev).bfloat16() for v in rows]
    qt = torch.from_numpy(q).to(dev)
    before = G.LAUNCHES["gmax_f_sub"]
    gv, gi = R.rank_top_k_planar(qt, planes, 16, prenormalized=True, **kw)
    torch.cuda.synchronize()
    assert G.LAUNCHES["gmax_f_sub"] == before + len(planes)
    monkeypatch.setattr(CONFIG, "pallas_gmax", 0)
    pv, pi = R.rank_top_k_planar(qt, planes, 16, prenormalized=True, **kw)
    assert G.LAUNCHES["gmax_f_sub"] == before + len(planes)
    gv, gi, pv, pi = (t.cpu().numpy() for t in (gv, gi, pv, pi))
    _near_tie_aware(gi, gv, pi, pv, 1e-5 * np.abs(pv) + ATOL)
    assert sorted(gi[0, :2]) == sorted(pi[0, :2]) == [3, sizes[0] + 100]
    # the kernel route rescores both copies alike: an exact tie, to the lower id
    assert gv[0, 0] == gv[0, 1] and gi[0, 0] == 3


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


@pytest.mark.parametrize(
    "metric, kernel",
    [
        ("euclidean_metric", None),
        ("hamming_distance", None),
        ("jaccard_similarity", None),
        ("pearson_correlation", "gmax_f_sub"),
    ],
)
def test_metric_routes_keep_the_batch_floor_on_card(dev, monkeypatch, metric, kernel):
    """Under 512 queries the euclidean, hamming and jaccard routes stay on
    their plain form on the card as on the CPU; pearson, a dot scan, takes
    ``gmax_f_sub`` at any height. Answers as the CPU gives them."""
    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.config import CONFIG

    monkeypatch.setattr(CONFIG, "grouped_topk_min_rows", 4096)
    rng = np.random.default_rng(11)
    v = (rng.standard_normal((16384, 384)) / np.sqrt(384)).astype(np.float16)
    q = rng.standard_normal((64, 384)).astype(np.float32)
    card = HyperDB([{} for _ in range(16384)], v, fp_precision="float16", device=dev)
    cpu = HyperDB([{} for _ in range(16384)], v, fp_precision="float16", device="cpu")
    before = dict(G.LAUNCHES)
    gi, gv = card.query_batch_arrays(q, top_k=10, metric=metric)
    want = {**before, kernel: before[kernel] + 1} if kernel else before
    assert G.LAUNCHES == want
    pi, pv = cpu.query_batch_arrays(q, top_k=10, metric=metric)
    exact = metric in ("hamming_distance", "jaccard_similarity")
    assert np.abs(gv - pv).max() <= (0.0 if exact else ATOL)
    assert (gi == pi).all() if exact else (gi == pi).mean() > 0.99


# batches of one 64-query tile (1, 31, 63, 64), two (65, 77, 128), an odd
# count (129, 1000) and whole pairs (640, 1024); depths of 1 to 12 boxes
# (392 and 712 end inside a box) and one past them (1024); group counts odd
# (384, 1152: a last item of one group) and even
STRESS_B = [1, 31, 63, 64, 65, 77, 128, 129, 640, 1000, 1024]
STRESS_D = [40, 64, 128, 384, 392, 448, 640, 712, 768, 1024]
STRESS_N = [256, 384, 1024, 1152, 4096]
STRESS = [
    (b, STRESS_N[(i + j) % 5], d) for i, b in enumerate(STRESS_B) for j, d in enumerate(STRESS_D)
] + [
    # the streaming variant: ragged depths (776 and 1032 end inside a box;
    # 4480 is the default hybrid embedder's width), batches under one
    # cluster's two 128-query tiles (1, 64) and an odd tile count (640: the
    # last cluster's second block holds no query), and group counts that a
    # 256-row item does not divide (384, 640, 1152: a last item of one group)
    (129, 384, 776), (64, 1152, 1032), (300, 2048, 4480), (1, 256, 4480), (640, 640, 1024),
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


@pytest.mark.parametrize("b,n,d", STRESS)
def test_float_scans_over_stress_shapes(dev, b, n, d):
    """``gmax_f_sub`` (single and dual) and ``gmax_f`` through the variant the
    rule picks, against the plain versions."""
    q, v, extra = _stress_inputs(dev, b, n, d, seed=b + d)
    variant = G.kernel_variant(n, d, 2)
    assert variant == ("wgmma" if d <= 768 else "wgmma_stream")
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


@pytest.mark.parametrize("sub", [8, 16, 32, 64])
@pytest.mark.parametrize("dual", [True, False])
@pytest.mark.parametrize("b,n,d", [(129, 1024, 392), (640, 4096, 384), (129, 384, 1032)])
def test_wgmma_subgroups(dev, sub, dual, b, n, d):
    q, v, extra = _stress_inputs(dev, b, n, d, seed=sub)
    variant = G.kernel_variant(n, d, 2)  # wgmma_stream at d = 1032
    before = G.LAUNCHES_BY_VARIANT[variant]
    gm, sm = G.gmax_f_sub(q, v, extra, sub=sub, dual=dual)
    gm_other, _ = G.gmax_f_sub(q, v, extra, sub=sub, dual=not dual)
    torch.cuda.synchronize()
    assert G.LAUNCHES_BY_VARIANT[variant] == before + 2
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


@pytest.mark.parametrize("n", [1 << 21, 1 << 23])
def test_float_scan_over_the_cell_planes(dev, n):
    """The 768-d benchmark cells' two planes at a served flush's batch (b =
    32: one query tile, so clusters of one block and the corpus cut over
    every SM), subgroup and group maxes against the plain version; rows and
    queries drawn and normalised on the card."""
    b, d = 32, 768
    g = torch.Generator(device=dev).manual_seed(n)
    v = torch.randn((n, d), generator=g, device=dev)
    v = v.div_(v.norm(dim=1, keepdim=True)).bfloat16()
    q = torch.randn((b, d), generator=g, device=dev)
    q = q.div_(q.norm(dim=1, keepdim=True)).bfloat16()
    mask = torch.rand(n, generator=g, device=dev) < 0.9
    mask[128:256] = False  # one whole group masked
    extra = G.make_extra(n, mask, torch.rand(n, generator=g, device=dev) * 0.05, device=dev)
    assert G.kernel_variant(n, d, 2) == "wgmma"
    before = G.LAUNCHES_BY_VARIANT["wgmma"]
    gm, sm = G.gmax_f_sub(q, v, extra, sub=32, dual=True)
    torch.cuda.synchronize()
    assert G.LAUNCHES_BY_VARIANT["wgmma"] == before + 1
    want_gm, want_sm = G.gmax_f_sub_plain(q, v, extra, sub=32)
    _same(sm, want_sm)
    _same(gm, want_gm)
    assert torch.isneginf(gm[:, 1]).all()


def test_wgmma_refuses_a_depth_past_its_rule(dev):
    """Forced onto a shape it does not take, the wgmma entry point refuses;
    nothing else steps in."""
    q, v, extra = _stress_inputs(dev, 64, 256, 1024)
    sm = torch.empty((64, 256 // 32), dtype=torch.float32, device=dev)
    gm = torch.empty((64, 256 // 128), dtype=torch.float32, device=dev)
    before = dict(G.LAUNCHES_BY_VARIANT)
    with pytest.raises(RuntimeError, match="gmax_scan_wgmma launch failed"):
        G._launch(G._KIND_F, q, v, extra, sm, gm, 32, _variant="wgmma")
    assert G.LAUNCHES_BY_VARIANT == before


@pytest.mark.parametrize(
    "b,n,d",
    [(1, 256, 64), (63, 1024, 48), (77, 4096, 128), (129, 1024, 384), (640, 4096, 400),
     (128, 256, 768), (64, 1024, 1536), (129, 256, 1552), (640, 1024, 2048),
     (77, 384, 4480), (129, 1152, 1664), (640, 640, 2048), (1, 256, 1552),
     # rows of 7 to 12 boxes (1424 ends inside one) over one tile, two, an
     # odd count and many
     (65, 1152, 896), (1000, 384, 1152), (31, 4096, 1424), (1024, 1024, 1536)],
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
    assert variant == ("wgmma" if d <= 1536 else "wgmma_stream")
    before = G.LAUNCHES_BY_VARIANT[variant]
    got = G.gmax_int8(q_i8, q_scale, v_t, sc_t, extra)
    torch.cuda.synchronize()
    assert G.LAUNCHES_BY_VARIANT[variant] == before + 1
    assert torch.equal(got, G.gmax_int8_plain(q_i8, q_scale, v_t, sc_t, extra))
    assert torch.isneginf(got[:, 1]).all()


@pytest.mark.parametrize(
    "b,n,d", [(1, 256, 64), (63, 1024, 40), (129, 4096, 384), (640, 1024, 392), (77, 256, 768),
              # deep rows on wgmma_stream: at d = 4480 rows of density 1/2 have
              # unions near 3360, past the 2^11 that count_div is exact below
              (128, 1024, 1024), (64, 384, 2560), (300, 1152, 4480), (129, 256, 4480),
              # 10 to 12 boxes on the resident tile (712 ends inside one)
              (1024, 1152, 768), (65, 384, 640), (31, 4096, 712)],
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


# ---------------------------------------------------------------- training


def test_train_step_on_card_matches_cpu(dev):
    """One AdamW step of the shipped local-384 weights (bf16) on 16 pairs at
    seq 32, lr 3e-4, card against CPU: the CPU parity tests' bf16 bound
    (loss within 5e-3 relative, at most 5 % of the weights more than one
    ulp apart, none more than 4 ulps + 2.1 lr: Adam's normalised update,
    which bf16 moments round to at most 1 % past lr, of either sign)."""
    import os

    from hyperdb_tpu_torch.models import localdata
    from hyperdb_tpu_torch.models import train as T
    from hyperdb_tpu_torch.models.finetune import _tokenize_batch
    from hyperdb_tpu_torch.models.minilm import (
        ASSETS_DIR, MiniLM, MiniLMEmbedder, load_saved_params,
    )

    enc = MiniLMEmbedder.from_local_assets(device="cpu")
    params = load_saved_params(os.path.join(ASSETS_DIR, "encoder_local.npz"))
    pairs = localdata.training_pairs(16, seed=4)
    batch = {}
    for side, i in (("q", 0), ("d", 1)):
        batch[f"{side}_ids"], batch[f"{side}_mask"] = _tokenize_batch(
            [p[i] for p in pairs], enc._tokenizer, 32)
    lr, out = 3e-4, {}
    for where in ("cpu", dev):
        p = {k: v.to(where) for k, v in params.items()}
        step = T.make_train_step(None, MiniLM(enc.config, device=where), T.make_adamw(p, lr), p,
                                 donate=False)
        new, _, loss = step(p, T.init_opt_state(p), batch)
        out[str(where)] = (float(loss), {k: v.cpu().float() for k, v in new.items()})
    (cl, cp), (gl, gp) = out["cpu"], out[str(dev)]
    assert abs(gl - cl) <= 5e-3 * abs(cl)
    over = total = 0
    for k, w in cp.items():
        d = (gp[k] - w).abs()
        ulp = torch.maximum(gp[k].abs(), w.abs()) * (2.0 ** -7 if params[k].dtype == torch.bfloat16
                                                     else 2.0 ** -23)
        assert bool((d <= 4 * ulp + 2.1 * lr).all()), k
        over += int((d > ulp).sum())
        total += d.numel()
    assert over <= 0.05 * total


def test_finetune_on_card_serves_text_through_gmax_f_sub(dev, monkeypatch):
    """``finetune`` on the card, then the fine-tuned encoder behind a
    float16 DB (grouped route from 4096 rows here): a b = 512 text batch
    through the device block launches ``gmax_f_sub`` and gives the host
    path's ids."""
    from hyperdb_tpu_torch import HyperDB
    from hyperdb_tpu_torch.config import CONFIG
    from hyperdb_tpu_torch.core.chunker import default_tokenizer
    from hyperdb_tpu_torch.models import localdata
    from hyperdb_tpu_torch.models.embedder import make_embedding_function
    from hyperdb_tpu_torch.models.finetune import finetune
    from hyperdb_tpu_torch.query import engine as E

    monkeypatch.setattr(CONFIG, "grouped_topk_min_rows", 4096)
    emb = finetune(localdata.training_pairs(320, seed=2), epochs=1, batch_size=32, seq_len=32,
                   learning_rate=1e-4)
    assert emb.device.type == "cuda" and len(emb.losses) == 10
    assert np.mean(emb.losses[-3:]) < emb.losses[0]
    docs, queries, _ = localdata.retrieval_eval_set(num_docs=8192, num_queries=512, seed=5)
    db = HyperDB(documents=docs, vectors=emb.encode(docs), fp_precision="float16",
                 embedding_function=make_embedding_function(emb, default_tokenizer()))
    before = G.LAUNCHES["gmax_f_sub"]
    block = E.generate_query_vectors_batch_device(db, queries)
    ids, vals = db.query_batch_arrays(block, top_k=10, n_valid=512)
    assert G.LAUNCHES["gmax_f_sub"] == before + 1
    hids, hvals = db.query_batch_arrays(E.generate_query_vectors_batch(db, queries), top_k=10)
    assert np.array_equal(ids, hids) and np.array_equal(vals, hvals)


# the drop-in package: path L3's tolerances of chip_smoke.py (each side lies
# within them of a float64 reference; jaccard and hamming are exact counts)
COMPAT_ATOL = {
    "dot_product": 2e-4,
    "cosine_similarity": 1e-6,
    "euclidean_metric": 1e-8,
    "manhattan_distance": 1e-8,
    "jaccard_similarity": 1e-7,
    "pearson_correlation": 1e-6,
    "hamming_distance": 0.0,
}


def test_drop_in_package_on_card_matches_cpu(dev, monkeypatch):
    """``hyperdb_torch`` on the card over 2^17 x 384 rows: the seven
    reference-shaped functions and the sort equal the CPU within
    ``COMPAT_ATOL``; the compat class answers a b = 512 block (the grouped
    route lowered to 2^17 rows) with one ``gmax_f_sub`` launch on ``wgmma``
    and the engine's ids and scores, its constructor's metadata index
    empty."""
    import hyperdb_torch
    import hyperdb_torch.ranking_algorithm as TR
    from hyperdb_tpu_torch import HyperDB as Engine
    from hyperdb_tpu_torch.config import CONFIG

    n, d = 1 << 17, 384
    rng = np.random.default_rng(17)
    v = rng.standard_normal((n, d), dtype=np.float32).astype(np.float16)
    v[17] = v[4]
    v32 = v.astype(np.float32)
    q = rng.standard_normal(d, dtype=np.float32)
    for name, atol in COMPAT_ATOL.items():
        got = getattr(TR, name)(v32, q)  # the card by default
        want = getattr(TR, name)(v32, q, device="cpu")
        assert got.dtype == want.dtype == np.float32 and got.shape == (n,)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)
    for qq in (q, v32[4]):
        gi, gv = TR.hyperDB_ranking_algorithm_sort(v32, qq, top_k=10, device="cuda")
        wi, wv = TR.hyperDB_ranking_algorithm_sort(v32, qq, top_k=10, device="cpu")
        np.testing.assert_allclose(gv, wv, rtol=0, atol=COMPAT_ATOL["cosine_similarity"])
        cos = TR.cosine_similarity(v32, qq, device="cpu")
        np.testing.assert_allclose(cos[gi], cos[wi], rtol=0, atol=COMPAT_ATOL["cosine_similarity"])
    assert list(gi[:2]) == [4, 17]

    monkeypatch.setattr(CONFIG, "grouped_topk_min_rows", n)
    docs = [{"i": i} for i in range(n)]
    compat = hyperdb_torch.HyperDB(documents=docs, vectors=v, fp_precision="float16",
                                   metadata_keys=["i"])
    assert compat.device.type == "cuda" and compat._metadata_index == {}
    block = rng.standard_normal((512, d), dtype=np.float32)
    before = dict(G.LAUNCHES), dict(G.LAUNCHES_BY_VARIANT)
    ids, vals = compat.query_batch_arrays(block, top_k=10)
    assert G.LAUNCHES["gmax_f_sub"] == before[0]["gmax_f_sub"] + 1
    assert G.LAUNCHES_BY_VARIANT["wgmma"] == before[1]["wgmma"] + 1
    engine = Engine(documents=docs, vectors=v, fp_precision="float16", metadata_keys=["i"])
    want_ids, want_vals = engine.query_batch_arrays(block, top_k=10)
    assert np.array_equal(ids, want_ids) and np.array_equal(vals, want_vals)
