"""The projscan index: ``hyperdb_tpu_torch`` against ``hyperdb_tpu`` on the CPU.

Routes. On the CPU both packages run stage A as the group-16 scan (the
port's ``_stage_a_on_kernel`` is false for CPU tensors, the JAX package's
``_use_pallas_gmax`` false on its CPU backend). The 128-row route of the
card is reached here by forcing the port's predicate: its
``gmax.gmax_int8`` wrapper then runs the plain version on CPU tensors, and
the JAX side is ``pallas_gmax.gmax_int8(..., interpret=True)`` followed by
``projscan._stage_b``.

Tolerances. ``fit_projection`` and the host build are the same NumPy code
in both packages, so ``proj``, ``a_i8`` and ``a_scales`` of a host build are
EQUAL. The device build projects with torch's f32 matmul, the JAX package
with XLA's: a product may differ by an ulp, which can move an int8 code by
one at a rounding boundary, so codes must be equal except for at most 1 in
10^3, each off by exactly 1, and scales within 1e-6 relative. Where the
query projection is exact (a full-rank projection's top-k survives any
overfetch, or an identity projection) the ids must be identical and the
scores within 1e-6 relative (the same IEEE operations over exact integer
dots; XLA may fuse the last multiply-add). Low-rank recall must agree
within 0.05 between the packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hyperdb_tpu import HyperDB as JaxDB
from hyperdb_tpu.config import CONFIG as JAX_CONFIG
from hyperdb_tpu.index import projscan as JP
from hyperdb_tpu.ops import pallas_gmax as JG
from hyperdb_tpu.ops.quantized import _quantize_device as j_quantize
from hyperdb_tpu_torch import HyperDB as TorchDB
from hyperdb_tpu_torch.config import CONFIG as TORCH_CONFIG
from hyperdb_tpu_torch.index import projscan as TP
from hyperdb_tpu_torch.index.projscan import ProjScanIndex, fit_projection
from hyperdb_tpu_torch.ops import gmax as G
from hyperdb_tpu_torch.ops.quantized import _quantize_device, int8_scores, quantize_rows

RTOL = 1e-6


def _clustered(n, d, k=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32) * 3
    idx = rng.integers(0, k, size=n)
    return (centers[idx] + rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _int8_exact(q, v_i8, v_sc, k, mask=None, rec=None):
    qi, qs = _quantize_device(_t(q))
    s = int8_scores(qi, qs, _t(v_i8), _t(v_sc)).numpy()
    if rec is not None:
        s = s + rec[None, :]
    if mask is not None:
        s[:, ~mask] = -np.inf
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return order, np.take_along_axis(s, order, axis=1)


def _same_index_state(t, j, exact=True):
    np.testing.assert_array_equal(t.proj, np.asarray(j.proj))
    a_t, a_j = t.a_i8.numpy().astype(np.int32), np.asarray(j.a_i8).astype(np.int32)
    if exact:
        np.testing.assert_array_equal(a_t, a_j)
        np.testing.assert_array_equal(t.a_scales.numpy(), np.asarray(j.a_scales))
    else:
        diff = a_t != a_j
        assert diff.mean() <= 1e-3 and np.all(np.abs(a_t - a_j)[diff] == 1)
        np.testing.assert_allclose(t.a_scales.numpy(), np.asarray(j.a_scales), rtol=RTOL)
    assert (t.num_rows, t.num_valid, t.d_prime) == (j.num_rows, j.num_valid, j.d_prime)
    assert t.captured_variance == pytest.approx(j.captured_variance, rel=1e-6)


# ---------------------------------------------------------------- the index


def test_full_rank_projection_is_exact():
    """d' == d: stage A sees a rotation of the corpus, so the result is
    the int8-pure exact ranking, in both packages."""
    rng = np.random.default_rng(1)
    v = rng.standard_normal((2048, 64)).astype(np.float32)
    q = rng.standard_normal((4, 64)).astype(np.float32)
    v_i8, v_sc = quantize_rows(v)
    idx = ProjScanIndex.build(v, d_prime=64, device="cpu")
    jidx = JP.ProjScanIndex.build(v, d_prime=64)
    _same_index_state(idx, jidx)
    vals, got = idx.search(q, _t(v_i8), _t(v_sc), k=5, overfetch=128)
    want, want_vals = _int8_exact(q, v_i8, v_sc, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(vals.numpy(), want_vals, rtol=RTOL)
    jvals, jgot = jidx.search(q, jnp.asarray(v_i8), jnp.asarray(v_sc), k=5, overfetch=128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=RTOL)


def test_low_rank_recall_on_clustered_data():
    v = _clustered(4096, 128, k=12, seed=2)
    rng = np.random.default_rng(3)
    q = v[rng.integers(0, 4096, size=8)] + 0.1 * rng.standard_normal((8, 128)).astype(np.float32)
    v_i8, v_sc = quantize_rows(v)
    idx = ProjScanIndex.build(v, d_prime=16, device="cpu")
    jidx = JP.ProjScanIndex.build(v, d_prime=16)
    _same_index_state(idx, jidx)
    want, _ = _int8_exact(q, v_i8, v_sc, 10)

    def recall(got):
        return np.mean([len(set(got[i].tolist()) & set(want[i].tolist())) / 10 for i in range(8)])

    recalls = {}
    for overfetch in (256, 512):
        _, got = idx.search(q, _t(v_i8), _t(v_sc), k=10, overfetch=overfetch)
        _, jgot = jidx.search(q, jnp.asarray(v_i8), jnp.asarray(v_sc), k=10, overfetch=overfetch)
        recalls[overfetch] = recall(got.numpy())
        assert abs(recalls[overfetch] - recall(np.asarray(jgot))) <= 0.05
    assert recalls[256] >= 0.8 and recalls[512] >= 0.9 and recalls[512] >= recalls[256]


def test_mask_and_recency_thread_through():
    rng = np.random.default_rng(4)
    v = rng.standard_normal((1024, 32)).astype(np.float32)
    q = rng.standard_normal((2, 32)).astype(np.float32)
    v_i8, v_sc = quantize_rows(v)
    mask = np.zeros(1024, dtype=bool)
    mask[::3] = True
    rec = (rng.random(1024) * 0.2).astype(np.float32)
    idx = ProjScanIndex.build(v, d_prime=32, device="cpu")
    _, got = idx.search(q, _t(v_i8), _t(v_sc), k=5, overfetch=128,
                        row_mask=_t(mask), recency=_t(rec))
    want, _ = _int8_exact(q, v_i8, v_sc, 5, mask=mask, rec=rec)
    np.testing.assert_array_equal(got.numpy(), want)
    _, jgot = JP.ProjScanIndex.build(v, d_prime=32).search(
        q, jnp.asarray(v_i8), jnp.asarray(v_sc), k=5, overfetch=128,
        row_mask=jnp.asarray(mask), recency=jnp.asarray(rec),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))


def test_state_roundtrip_both_ways():
    v = _clustered(512, 32, seed=5)
    idx = ProjScanIndex.build(v, d_prime=8, device="cpu")
    q = np.random.default_rng(6).standard_normal((2, 32)).astype(np.float32)
    v_i8, v_sc = quantize_rows(v)
    _, a = idx.search(q, _t(v_i8), _t(v_sc), k=5)
    state = idx.state()
    assert state["kind"] == "projscan"
    again = ProjScanIndex.from_state(
        {k: np.asarray(x) for k, x in state.items()}, device="cpu"
    )
    _, b = again.search(q, _t(v_i8), _t(v_sc), k=5)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    # the JAX package reads the port's state, and the port the JAX package's
    j = JP.ProjScanIndex.from_state(state)
    _same_index_state(ProjScanIndex.from_state(j.state(), device="cpu"), j)
    _same_index_state(again, j)


def test_projection_shapes_and_orthogonality():
    v = _clustered(1024, 48, seed=7)
    p, captured = fit_projection(v, 12)
    assert p.shape == (48, 12)
    np.testing.assert_allclose(p.T @ p, np.eye(12), atol=1e-4)
    assert 0.0 < captured <= 1.0
    jp, jcap = JP.fit_projection(v, 12)
    np.testing.assert_array_equal(p, jp)
    assert captured == jcap


def test_captured_variance_separates_spectra(capsys):
    rng = np.random.default_rng(11)
    d, dp = 64, 8
    iso = rng.standard_normal((2048, d)).astype(np.float32)
    decay = iso * ((1.0 + np.arange(d)) ** -0.75)[None, :].astype(np.float32)
    _, cap_iso = fit_projection(iso, dp)
    _, cap_decay = fit_projection(decay, dp)
    assert abs(cap_iso - dp / d) < 0.1 and cap_decay > 0.6 > cap_iso
    idx = ProjScanIndex.build(iso, d_prime=dp, device="cpu")
    assert "flat spectrum" in capsys.readouterr().out and idx.captured_variance < 0.5
    idx2 = ProjScanIndex.build(decay, d_prime=dp, device="cpu")
    assert "flat spectrum" not in capsys.readouterr().out and idx2.captured_variance > 0.6
    st = idx2.state()
    assert ProjScanIndex.from_state(st, device="cpu").captured_variance == idx2.captured_variance
    st.pop("captured_variance")
    assert ProjScanIndex.from_state(st, device="cpu").captured_variance is None


def test_device_build_sample_and_planes(monkeypatch):
    """The projection is fit on about ``sample`` rows, as in the JAX
    package, and the device build matches the JAX package's within the
    stated code tolerance (float plane and int8 tuple plane)."""
    seen = {}
    real_fit = TP.fit_projection

    def spy(rows, d_prime, seed=0):
        seen["rows"] = rows
        return real_fit(rows, d_prime, seed)

    monkeypatch.setattr(TP, "fit_projection", spy)
    rng = np.random.default_rng(5)
    rows = (rng.standard_normal((600_000, 16)) * (1.0 + np.arange(16)) ** -0.5).astype(np.float32)
    idx = ProjScanIndex.build_from_device_rows(_t(rows), num_rows=600_000, d_prime=16, sample=2048)
    assert idx is not None and 0.9 * 2048 <= seen["rows"].shape[0] <= 1.5 * 2048
    monkeypatch.undo()
    v = _clustered(20000, 32, seed=8)
    v_i8, v_sc = quantize_rows(v / np.linalg.norm(v, axis=1, keepdims=True))
    for plane_t, plane_j in (
        (_t(v), jnp.asarray(v)),
        ((_t(v_i8), _t(v_sc)), (jnp.asarray(v_i8), jnp.asarray(v_sc))),
    ):
        t = ProjScanIndex.build_from_device_rows(plane_t, num_rows=20000, d_prime=8,
                                                 num_valid=19990)
        j = JP.ProjScanIndex.build_from_device_rows(plane_j, num_rows=20000, d_prime=8,
                                                    num_valid=19990)
        _same_index_state(t, j, exact=False)


def test_device_build_rounds_d_prime_and_declines(capsys):
    iso = np.random.default_rng(12).standard_normal((4096, 256)).astype(np.float32)
    idx = ProjScanIndex.build_from_device_rows(_t(iso), num_rows=4096, d_prime=96)
    assert idx.d_prime == 128  # rounded up to a multiple of 128 at d >= 128
    assert ProjScanIndex.build_from_device_rows(
        _t(iso), num_rows=4096, d_prime=96, min_variance=0.9
    ) is None
    assert "projscan declined" in capsys.readouterr().out


# ---------------------------------------------------------------- the 128-row route


def _identity_index(v_i8_plane, v_sc_plane, num_valid):
    """A projscan index whose projection is the identity (d' = d): the
    query projection is exact in both packages, so both quantize the same
    query bits and the routes can be held to identical ids."""
    d = v_i8_plane.shape[1]
    a = v_i8_plane.astype(np.float32) * v_sc_plane[:, None]
    a_i8, a_sc = quantize_rows(a)
    return np.eye(d, dtype=np.float32), a_i8, a_sc


@pytest.mark.parametrize("recency", [False, True])
def test_forced_128_row_route_matches_jax_interpret(monkeypatch, recency):
    rng = np.random.default_rng(13)
    n, d, b, k = 4096, 64, 8, 10
    v = _clustered(n, d, seed=14)
    v_i8, v_sc = quantize_rows(v)
    v_sc[7] = 0.0  # a zero-scale row
    v_i8[7] = 0
    proj, a_i8, a_sc = _identity_index(v_i8, v_sc, n)
    q = v[rng.integers(0, n, size=b)] + 0.05 * rng.standard_normal((b, d)).astype(np.float32)
    mask = rng.random(n) < 0.9
    mask[128:256] = False  # a whole group masked
    rec = (rng.random(n) * 0.5).astype(np.float32) if recency else None

    monkeypatch.setattr(TP, "_stage_a_on_kernel", lambda *a: True)
    calls = []
    real = G.gmax_int8
    monkeypatch.setattr(G, "gmax_int8", lambda *a: calls.append(a[2].shape) or real(*a))
    idx = ProjScanIndex(proj, _t(a_i8), _t(a_sc), n)
    vals, got = idx.search(q, _t(v_i8), _t(v_sc), k=k, overfetch=256,
                           row_mask=_t(mask), recency=None if rec is None else _t(rec))
    assert calls == [(n, d)]

    # the JAX route on the TPU, run in interpret mode: gmax_int8, top-G, _stage_b
    qj = jnp.asarray(q)
    qa_i8, qa_sc = j_quantize(jnp.dot(qj, jnp.asarray(proj)))
    extra = JG.make_extra(n, jnp.asarray(mask), None if rec is None else jnp.asarray(rec))
    gm = JG.gmax_int8(qa_i8, qa_sc, jnp.asarray(a_i8), jnp.asarray(a_sc), extra, interpret=True)
    G_ = min(n // 128, max(k, -(-256 // 128)))
    _, gidx = jax_top_k(gm, G_)
    jvals, jgot = JP._stage_b(qj, jnp.asarray(v_i8), jnp.asarray(v_sc), gidx, k, 128,
                              jnp.asarray(mask), None if rec is None else jnp.asarray(rec))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=RTOL)
    # and the group-16 route of the same index agrees on this clustered data
    monkeypatch.setattr(TP, "_stage_a_on_kernel", lambda *a: False)
    _, got16 = idx.search(q, _t(v_i8), _t(v_sc), k=k, overfetch=256,
                          row_mask=_t(mask), recency=None if rec is None else _t(rec))
    want, _ = _int8_exact(q, v_i8, v_sc, k, mask=mask, rec=rec)
    np.testing.assert_array_equal(got16.numpy(), want)
    assert len(calls) == 1


def jax_top_k(x, k):
    import jax

    return jax.lax.top_k(x, k)


def test_stage_a_route_predicate():
    """CPU tensors take the group-16 scan; the 128-row route needs the int8
    route's condition (n % 128, d' % 16, enough groups) off the CPU."""
    q8 = torch.zeros((4, 128), dtype=torch.int8)
    a8 = torch.zeros((1 << 14, 128), dtype=torch.int8)
    assert not TP._stage_a_on_kernel(q8, a8, 16)
    meta = [t.to("meta") for t in (q8, a8)]
    assert TP._stage_a_on_kernel(*meta, 16)
    assert not TP._stage_a_on_kernel(meta[0][:, :120], meta[1][:, :120], 16)  # d' % 16


# ---------------------------------------------------------------- the DB


@pytest.fixture
def projscan_on(monkeypatch):
    def set_(dprime, min_variance=0.5, overfetch=256):
        for cfg in (JAX_CONFIG, TORCH_CONFIG):
            monkeypatch.setattr(cfg, "projscan_threshold", 1)
            monkeypatch.setattr(cfg, "projscan_dprime", dprime)
            monkeypatch.setattr(cfg, "projscan_min_variance", min_variance)
            monkeypatch.setattr(cfg, "projscan_overfetch", overfetch)

    return set_


def _pure_pair(v, **kw):
    docs = [{"i": int(i)} for i in range(len(v))]
    j = JaxDB(documents=[dict(d) for d in docs], vectors=v, device_precision="int8-pure", **kw)
    t = TorchDB(documents=[dict(d) for d in docs], vectors=v, device_precision="int8-pure",
                device="cpu", **kw)
    return j, t


def _hits_equal(got, want):
    assert [h[2] for h in got] == [h[2] for h in want]
    np.testing.assert_allclose([h[1] for h in got], [h[1] for h in want], rtol=RTOL)


def test_projscan_engine_routing(projscan_on):
    """A full-rank projection through the engine reproduces the int8-pure
    exact results identically, in both packages."""
    projscan_on(32, overfetch=64)
    v = np.random.default_rng(0).standard_normal((300, 32)).astype(np.float32)
    jdb, tdb = _pure_pair(v)
    assert isinstance(tdb.ann_index, ProjScanIndex)
    _same_index_state(tdb.ann_index, jdb.ann_index, exact=False)
    exact = TorchDB(documents=[{"i": i} for i in range(300)], vectors=v,
                    device_precision="int8-pure", device="cpu")
    exact.ann_index = None
    q = (v[11] + 0.01 * np.random.default_rng(5).standard_normal(32)).astype(np.float32)
    got = tdb.query(q, top_k=5)
    _hits_equal(got, exact.query(q, top_k=5))
    _hits_equal(got, jdb.query(q, top_k=5))
    qb = v[:6] + 0.02
    ti, ts = tdb.query_batch_arrays(qb, top_k=4)
    ei, es = exact.query_batch_arrays(qb, top_k=4)
    ji, js = jdb.query_batch_arrays(qb, top_k=4)
    np.testing.assert_array_equal(ti, ei)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=RTOL)
    # filters thread through both stages
    t2 = TorchDB(documents=[{"i": i} for i in range(300)], vectors=v,
                 device_precision="int8-pure", metadata_keys=["i"], device="cpu")
    gotf = t2.query(q, top_k=3, filters=[("metadata", {"i": 11})])
    assert len(gotf) == 1 and gotf[0][0]["i"] == 11


def test_projscan_batch_takes_the_index(projscan_on, monkeypatch):
    projscan_on(16, min_variance=0.0)
    v = _clustered(2000, 32, seed=9)
    jdb, tdb = _pure_pair(v)
    calls = []
    real = TP.projscan_search
    monkeypatch.setattr(TP, "projscan_search", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q = v[:8] + 0.05
    ti, _ = tdb.query_batch_arrays(q, top_k=5)
    assert calls == [1]
    ji, _ = jdb.query_batch_arrays(q, top_k=5)
    # low rank, device-built codes: ids agree but for rare ulp flips
    assert np.mean(ti == ji) >= 0.95
    assert (ti[:, 0] == np.arange(8)).all()


def test_projscan_save_load_roundtrip(tmp_path, projscan_on):
    projscan_on(16, min_variance=0.0)
    v = np.random.default_rng(0).standard_normal((300, 32)).astype(np.float32)
    _, db = _pure_pair(v)
    path = str(tmp_path / "db.pickle")
    db.save(path)
    new_db = TorchDB(device_precision="int8-pure", device="cpu")
    new_db.load(path)
    assert isinstance(new_db.ann_index, ProjScanIndex) and new_db.ann_index.d_prime == 16
    assert new_db._ivf_built_rows == new_db.ann_index.num_rows
    assert new_db.query(v[3], top_k=3)[0][0]["i"] == 3


def test_checkpoint_roundtrip_projscan_index(tmp_path, projscan_on):
    projscan_on(16, min_variance=0.0)
    v = np.random.default_rng(21).standard_normal((64, 16)).astype(np.float32)
    _, db = _pure_pair(v)
    path = str(tmp_path / "ckpt_ps")
    db.save(path, format="checkpoint")
    new_db = TorchDB(device_precision="int8-pure", device="cpu")
    new_db.load(path, format="checkpoint")
    assert isinstance(new_db.ann_index, ProjScanIndex)
    assert new_db.ann_index.d_prime == db.ann_index.d_prime
    assert new_db._ivf_built_rows == new_db.ann_index.num_rows
    assert new_db.query(v[3], top_k=1)[0][0]["i"] == 3


def test_projscan_probe_never_returns_pad_rows(projscan_on):
    projscan_on(16, min_variance=0.0)
    v = np.random.default_rng(9).standard_normal((300, 32)).astype(np.float32)
    _, db = _pure_pair(v)  # 300 rows pad to 320
    assert db.ann_index.num_valid == 300 and db.ann_index.num_rows == 320
    cand = db.ann_index.probe(v[0], budget=10_000)
    assert cand.size and cand.max() < 300


def test_projscan_declines_flat_spectrum(capsys, projscan_on, monkeypatch):
    projscan_on(4)  # 4/32 iid dims: about 12 % of the variance
    v = np.random.default_rng(13).standard_normal((300, 32)).astype(np.float32)
    jdb, db = _pure_pair(v)
    assert db.ann_index is None and jdb.ann_index is None
    assert "projscan declined" in capsys.readouterr().out
    assert db.query(v[7], top_k=1)[0][0]["i"] == 7

    def boom(*a, **k):  # pragma: no cover - fails the test if called
        raise AssertionError("re-probed a declined corpus before 1.5x growth")

    monkeypatch.setattr(ProjScanIndex, "build_from_device_rows", boom)
    db.add_document({"i": 300}, vectors=v[0])
    assert db.ann_index is None
    res = db.query(v[17] + 0.01, top_k=20)
    assert len(res) == 20 and res[0][0]["i"] == 17


def test_projscan_rebuilds_after_mutation(projscan_on):
    projscan_on(32)
    v = np.random.default_rng(0).standard_normal((300, 32)).astype(np.float32)
    _, db = _pure_pair(v)
    first = db.ann_index
    extra = np.random.default_rng(3).standard_normal((4, 32)).astype(np.float32)
    db.add([{"i": 300 + j} for j in range(4)], vectors=extra)
    assert isinstance(db.ann_index, ProjScanIndex) and db.ann_index is not first
    assert db.query(extra[2], top_k=1)[0][0]["i"] == 302
    db.remove_document([0, 1])
    assert db.query(extra[2], top_k=1)[0][0]["i"] == 302


def test_projscan_single_query_skips_probe(projscan_on, monkeypatch, capsys):
    projscan_on(16, min_variance=0.0)
    v = np.random.default_rng(0).standard_normal((300, 32)).astype(np.float32)
    _, db = _pure_pair(v)

    def boom(*a, **k):  # pragma: no cover - fails the test if called
        raise AssertionError("single-query path paid the useless probe")

    monkeypatch.setattr(ProjScanIndex, "probe", boom)
    assert db.query(v[5] + 0.01, top_k=3)[0][0]["i"] == 5
    db.add_document({"i": 1}, vectors=np.ones((1, 16), np.float32))
    db.commit_pending()  # prints and rolls back, never raises
    assert "Rolling back" in capsys.readouterr().out and len(db.documents) == 300


@pytest.mark.parametrize("fmt", ["pickle", "checkpoint"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_projscan_files_cross_packages(tmp_path, projscan_on, fmt, direction):
    """A projscan DB saved by one package loads in the other with the same
    index state and answers the same (full-rank projection: exact)."""
    projscan_on(32, overfetch=64)
    v = np.random.default_rng(2).standard_normal((500, 32)).astype(np.float32)
    jdb, tdb = _pure_pair(v)
    saver, make = (jdb, lambda: TorchDB(device_precision="int8-pure", device="cpu")) if (
        direction == "jax_to_torch") else (tdb, lambda: JaxDB(device_precision="int8-pure"))
    path = str(tmp_path / ("db.pickle" if fmt == "pickle" else "ckpt"))
    saver.save(path, format=fmt)
    loaded = make()
    loaded.load(path, format=fmt)
    got, want = loaded.ann_index.state(), saver.ann_index.state()
    assert got["kind"] == "projscan" and loaded._ivf_built_rows == 512
    for key in ("proj", "a_i8", "a_scales", "num_rows", "num_valid"):
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))
    q = v[:5] + 0.03
    li, ls = loaded.query_batch_arrays(q, top_k=4)
    si, ss = saver.query_batch_arrays(q, top_k=4)
    np.testing.assert_array_equal(li, si)
    np.testing.assert_allclose(ls, ss, rtol=RTOL)
    _hits_equal(loaded.query(v[9], top_k=3), saver.query(v[9], top_k=3))
