"""The port's descriptors, ratio test, RANSAC and ICP against the JAX
package, on the CPU (the plain twins of K19-K22).

Inputs are made from numpy seeds and go through both packages. Stated
tolerances:

- kNN indices, owners, candidate pairs and validity flags: equal.
- Descriptors: translation-invariant ones bitwise (one subtraction each);
  rotation-invariant ones within atol 1e-4 (the frame's normalisations and
  3-term sums are rounded in another order than XLA's; values up to ~50,
  measured up to 5.8e-5).
- RANSAC on given hypotheses: the same inlier counts as a JAX composition
  of ``ops.models.fit_model(..., xp=jnp)`` and its inlier test, for every
  TRANSLATION and RIGID hypothesis. AFFINE: JAX solves the uncentred
  homogeneous normal equations in float32, the port the centred ones, so
  the two models of one 4-point sample differ (most where the sample is
  ill-conditioned); a count may differ by at most the candidates whose JAX
  error lies within the two models' disagreement at that candidate
  (+1e-3 px) of epsilon, and 95 % of counts are equal. The best count
  equal in every case.
- RANSAC and ICP outcomes: the gates of the JAX package's own tests
  (tests/test_matching.py): rotation within 1e-3, translation within 0.1,
  outliers rejected, the 40,000-candidate case, both consensus sets.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigstitcher_spark_tpu.ops.descriptors as JD
from bigstitcher_spark_tpu.ops import models as JM
from bigstitcher_spark_tpu_torch.ops import descriptors as TD
from bigstitcher_spark_tpu_torch.ops import models as TM

CPU = "cpu"
ROT_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(n=80, seed=0, lo=0.0, hi=200.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3))


def _rot(deg, axis=2):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    m = np.eye(3)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


# ------------------------------------------------------------ descriptors


@pytest.mark.parametrize("k", [2, 4, 8])
def test_knn_indices_match_jax(k):
    pts = np.random.default_rng(4).uniform(0, 100, (500, 3)).astype(np.float32)
    pts[7] = pts[8]  # equal distances: the lower index first
    want = np.asarray(JD.knn_indices(pts, k))
    got = TD.knn_indices(pts, k, device=CPU).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n,r", [(3, 1), (2, 2), (4, 2)])
@pytest.mark.parametrize("rot", [True, False], ids=["rotation", "translation"])
def test_build_descriptors_match_jax(n, r, rot):
    pts = np.random.default_rng(5).uniform(0, 150, (400, 3)).astype(np.float32)
    jd, jo = JD.build_descriptors(jnp.asarray(pts), n, r, rot)
    td, to = TD.build_descriptors(pts, n, r, rot, device=CPU)
    assert np.array_equal(to.numpy(), np.asarray(jo))
    if rot:
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                                   atol=ROT_ATOL)
    else:
        assert np.array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("k", [3, 4, 40])
def test_block_descriptors_batch_match_jax(k):
    """Masked form with invalid slots; k <= pool gives JAX's all-zero
    descriptors and no valid point."""
    rng = np.random.default_rng(6)
    pts = rng.uniform(0, 50, (3, k, 3)).astype(np.float32)
    valid = rng.uniform(size=(3, k)) > 0.3
    valid[1, :] = True
    jd, jv = JD.block_descriptors_batch(jnp.asarray(pts), jnp.asarray(valid),
                                        3, 1, True)
    td, tv = TD.block_descriptors_batch(torch.from_numpy(pts),
                                        torch.from_numpy(valid), 3, 1, True)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=ROT_ATOL)
    assert not td.numpy()[~tv.numpy()].any()


# ------------------------------------------------------------ ratio test

def _fixture_clouds(name):
    """The clouds of tests/test_matching.py:26-57 and :419-429."""
    if name == "translated60":
        a = _cloud(60, seed=1)
        return a, a + np.array([30.0, -12.0, 7.0])
    if name == "rotated60":
        a = _cloud(60, seed=2)
        return a, a @ (_rot(70) @ _rot(40, axis=0)).T + np.array([5.0, 8.0, -3.0])
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 300, (800, 3)).astype(np.float32)
    b = (a + np.array([2.0, -1.0, 0.5])
         + rng.normal(0, 0.1, a.shape)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("method", [JD.GEOMETRIC_HASHING, JD.FRGLDM, JD.RGLDM])
@pytest.mark.parametrize("cloud", ["translated60", "rotated60", "noisy800"])
def test_match_candidates_match_jax_dense(cloud, method):
    a, b = _fixture_clouds(cloud)
    want = JD.match_candidates(a, b, method=method)
    got = TD.match_candidates(a, b, method=method, device=CPU)
    assert np.array_equal(got, want)
    # raw offsets do not survive the 70/40 degree rotation
    assert len(got) > 0 or (cloud == "rotated60"
                            and method != JD.GEOMETRIC_HASHING)


@pytest.mark.parametrize("method", [JD.GEOMETRIC_HASHING, JD.FRGLDM, JD.RGLDM])
def test_match_candidates_match_jax_tiled(monkeypatch, method):
    """JAX's tiled regime (each column tile centred on its own mean) gives
    the dense result on this fixture (its own test asserts it); the port,
    one kernel centred on B's mean, gives it too."""
    a, b = _fixture_clouds("noisy800")
    monkeypatch.setattr(JD, "_TILE_ENTRIES", 1 << 12)
    want = JD.match_candidates(a, b, method=method)
    got = TD.match_candidates(a, b, method=method, device=CPU)
    assert len(got) > 400 and np.array_equal(got, want)


def test_match_ratio_test_entry():
    """``match_ratio_test`` keeps JAX's signature and dense semantics:
    the best different-owner distance decides."""
    rng = np.random.default_rng(8)
    db = rng.normal(0, 1, (300, 9)).astype(np.float32)
    ob = np.repeat(np.arange(75), 4).astype(np.int32)
    da = (db[::2] + rng.normal(0, 0.05, (150, 9))).astype(np.float32)
    oa = np.arange(150, dtype=np.int32)
    jm, ja = JD.match_ratio_test(jnp.asarray(da), jnp.asarray(oa),
                                 jnp.asarray(db), jnp.asarray(ob), 3.0)
    tm, ta = TD.match_ratio_test(torch.from_numpy(da), torch.from_numpy(oa),
                                 torch.from_numpy(db), torch.from_numpy(ob),
                                 3.0)
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert np.array_equal(ta.numpy(), np.asarray(ja))


# ----------------------------------------------------------------- RANSAC

@pytest.mark.parametrize("kind", ["TRANSLATION", "RIGID", "AFFINE"])
def test_ransac_counts_match_jax_on_given_hypotheses(kind):
    rng = np.random.default_rng(7)
    m = 300
    a = rng.uniform(0, 200, (m, 3))
    b = a @ _rot(10).T + np.array([5.0, -3.0, 2.0]) + rng.normal(0, 0.3,
                                                                 a.shape)
    b[:90] = rng.uniform(0, 200, (90, 3))
    idx = np.stack([rng.choice(m, 4, replace=False)
                    for _ in range(500)]).astype(np.int32)
    pa, pb = jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)
    models = JM.fit_model(kind, pa[idx], pb[idx], xp=jnp)
    pred = (jnp.einsum("iab,mb->ima", models[:, :, :3], pa)
            + models[:, None, :, 3])
    want = np.asarray((jnp.linalg.norm(pred - pb[None], axis=-1)
                       < 5.0).sum(-1))
    counts, _, best, _ = TD.ransac_score(
        torch.tensor(a, dtype=torch.float32),
        torch.tensor(b, dtype=torch.float32), torch.from_numpy(idx), 5.0,
        kind)
    got = counts.numpy()
    if kind == "AFFINE":
        err = np.asarray(jnp.linalg.norm(pred - pb[None], axis=-1))
        mine = TD.ransac_score(
            torch.tensor(a, dtype=torch.float32),
            torch.tensor(b, dtype=torch.float32), torch.from_numpy(idx), 5.0,
            kind)[1].double().numpy()
        pred_mine = (np.einsum("iab,mb->ima", mine[:, :, :3], a)
                     + mine[:, None, :, 3])
        gap = np.linalg.norm(pred_mine - np.asarray(pred, np.float64), axis=-1)
        near = (np.abs(err - 5.0) <= gap + 1e-3).sum(1)
        assert (np.abs(got - want) <= near).all()
        assert (got == want).mean() > 0.95
    else:
        assert np.array_equal(got, want)
    assert int(best[1]) == want.max() == got.max()
    assert int(best[0]) == int(np.argmax(got))


def test_draw_hypotheses_distinct_and_seeded():
    g = torch.Generator().manual_seed(3)
    idx = TD.draw_hypotheses(10, 4000, 4, g).numpy()
    assert idx.shape == (4000, 4) and idx.dtype == np.int32
    assert idx.min() >= 0 and idx.max() <= 9
    assert all(len(set(row)) == 4 for row in idx.tolist())
    # every value equally likely in a sample (Floyd's algorithm)
    freq = np.bincount(idx.ravel(), minlength=10) / idx.size
    assert np.abs(freq - 0.1).max() < 0.01
    again = TD.draw_hypotheses(10, 4000, 4, torch.Generator().manual_seed(3))
    assert np.array_equal(again.numpy(), idx)


def test_ransac_refit_matches_numpy_fit():
    """K22's twin: the inliers of the model and the float64
    fit_interpolated of them, as the numpy fit computes it."""
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 500, (2000, 3))
    b = a @ _rot(4).T + np.array([3.0, 1.0, -2.0]) + rng.normal(0, 0.5,
                                                                a.shape)
    b[:300] += 40.0
    model = torch.from_numpy(np.hstack([_rot(4), [[3.0], [1.0], [-2.0]]]))
    pa = torch.tensor(a, dtype=torch.float32)
    pb = torch.tensor(b, dtype=torch.float32)
    mask, count, out = TD.ransac_refit(pa, pb, model, 5.0, "AFFINE",
                                       "RIGID", 0.1)
    a32, b32 = pa.double().numpy(), pb.double().numpy()
    err = np.linalg.norm(a32 @ model.numpy()[:, :3].T + model.numpy()[:, 3]
                         - b32, axis=1)
    assert np.array_equal(mask.numpy(), err < 5.0) and int(count) == 1700
    want = JM.fit_interpolated("AFFINE", "RIGID", 0.1, a32[mask.numpy()],
                               b32[mask.numpy()])
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("kind", ["TRANSLATION", "RIGID", "AFFINE"])
def test_torch_fits_match_numpy(kind):
    rng = np.random.default_rng(10)
    p = rng.uniform(0, 300, (6, 40, 3))
    q = p @ _rot(25, 1).T + np.array([4.0, 5.0, 6.0]) + rng.normal(0, 0.2,
                                                                   p.shape)
    w = rng.uniform(0.2, 1.0, (6, 40))
    got = TM.torch_fit_model(kind, torch.from_numpy(p), torch.from_numpy(q),
                             torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, TM.fit_model(kind, p, q, w), rtol=0,
                               atol=1e-9)
    got32 = TM.torch_fit_interpolated(
        kind, "RIGID", 0.1, torch.tensor(p, dtype=torch.float32),
        torch.tensor(q, dtype=torch.float32)).double().numpy()
    np.testing.assert_allclose(got32, TM.fit_interpolated(kind, "RIGID", 0.1,
                                                          p, q),
                               rtol=0, atol=1e-3)


def test_ransac_recovers_rotation():
    a, b = _fixture_clouds("rotated60")
    cand = TD.match_candidates(a, b, method="FAST_ROTATION", device=CPU)
    assert len(cand) >= 0.7 * len(a)
    assert (cand[:, 0] == cand[:, 1]).mean() > 0.9
    res = TD.ransac(a[cand[:, 0]], b[cand[:, 1]], "RIGID", "NONE", 0.0,
                    epsilon=1.0, iterations=1000, min_inliers=5, device=CPU)
    assert res is not None
    np.testing.assert_allclose(res[0][:, :3], _rot(70) @ _rot(40, axis=0),
                               atol=1e-3)
    np.testing.assert_allclose(res[0][:, 3], [5.0, 8.0, -3.0], atol=0.1)


def test_ransac_rejects_outliers():
    rng = np.random.default_rng(3)
    a = _cloud(100, seed=3)
    t = np.array([12.0, -5.0, 9.0])
    b = a + t + rng.normal(0, 0.3, a.shape)
    b[:30] = rng.uniform(0, 200, (30, 3))
    res = TD.ransac(a, b, "TRANSLATION", "NONE", 0.0, epsilon=3.0,
                    iterations=2000, device=CPU)
    assert res is not None
    model, inliers = res
    assert inliers[30:].mean() > 0.95 and inliers[:30].mean() < 0.1
    np.testing.assert_allclose(model[:, 3], t, atol=0.2)


def test_ransac_affine():
    rng = np.random.default_rng(4)
    a = _cloud(150, seed=4)
    A = np.hstack([_rot(10) * 1.05, np.array([[4.0], [-2.0], [1.0]])])
    b = a @ A[:, :3].T + A[:, 3] + rng.normal(0, 0.2, a.shape)
    b[:20] = rng.uniform(0, 200, (20, 3))
    res = TD.ransac(a, b, "AFFINE", "NONE", 0.0, epsilon=2.0,
                    iterations=3000, device=CPU)
    assert res is not None
    np.testing.assert_allclose(res[0], A, atol=0.1)


def test_ransac_too_few_candidates_is_none():
    a = _cloud(8, seed=1)
    assert TD.ransac(a, a, device=CPU) is None  # 8 < min_inliers 12


def test_ransac_40000_candidates():
    """The size JAX scores in iteration chunks: one K21 launch here."""
    rng = np.random.default_rng(2)
    m = 40000
    a = rng.uniform(0, 500, (m, 3))
    t = np.array([3.2, -1.7, 0.9])
    b = a + t + rng.normal(0, 0.3, a.shape)
    b[:m // 4] = rng.uniform(0, 500, (m // 4, 3))
    res = TD.ransac(a.astype(np.float32), b.astype(np.float32),
                    model_kind="TRANSLATION", reg_kind="NONE",
                    iterations=2000, device=CPU)
    assert res is not None
    np.testing.assert_allclose(res[0][:, 3], t, atol=0.05)
    assert res[1].sum() >= 0.7 * (m - m // 4)


def test_ransac_multi_finds_both_translations():
    rng = np.random.default_rng(8)
    a1 = rng.uniform(0, 150, (60, 3))
    a2 = rng.uniform(0, 150, (60, 3))
    t1, t2 = np.array([5.0, -2.0, 1.0]), np.array([-12.0, 7.0, -4.0])
    cand_a = np.concatenate([a1, a2])
    cand_b = np.concatenate([a1 + t1, a2 + t2]) + rng.normal(0, 0.2, (120, 3))
    single = TD.ransac(cand_a, cand_b, "TRANSLATION", "NONE", 0.0,
                       epsilon=3.0, iterations=2000, device=CPU)
    assert single is not None and single[1].sum() <= 65
    sets = TD.ransac_multi(cand_a, cand_b, "TRANSLATION", "NONE", 0.0,
                           epsilon=3.0, iterations=2000, device=CPU)
    assert len(sets) == 2
    found = sorted(tuple(np.round(m[:, 3]).astype(int)) for m, _ in sets)
    assert found == sorted([tuple(np.round(t).astype(int)) for t in (t1, t2)])
    assert (sets[0][1] | sets[1][1]).sum() > 100
    assert (sets[0][1] & sets[1][1]).sum() == 0


@pytest.mark.parametrize("use_ransac", [False, True])
def test_icp_matches_jax(use_ransac):
    """ICP's host loop on K20's nearest mode: the JAX package's pairs and
    model (rtol 1e-9) on its own fixtures (tests/test_matching.py:90-100,
    :563-583)."""
    if use_ransac:
        rng = np.random.default_rng(13)
        a = rng.uniform(0, 200, (60, 3))
        t = np.array([1.0, -0.5, 0.5])
        b = a + t
        b[:10] = a[:10] + np.array([-2.5, 2.5, 0.0])
        kw = dict(use_ransac=True, ransac_epsilon=1.0, seed=3)
    else:
        a = _cloud(80, seed=5)
        t = np.array([1.5, -1.0, 0.8])
        b = a + t
        kw = {}
    want = JD.icp(a, b, "TRANSLATION", "NONE", 0.0, max_distance=4.0, **kw)
    got = TD.icp(a, b, "TRANSLATION", "NONE", 0.0, max_distance=4.0,
                 device=CPU, **kw)
    np.testing.assert_allclose(got[0][:, 3], t, atol=0.05)
    if use_ransac:
        assert (got[1][:, 0] >= 10).all()
    else:
        assert np.array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=1e-9)


def test_kernel_limits_are_refused():
    pts = torch.rand((1, 30, 3))
    with pytest.raises(ValueError, match="neighbours"):
        TD.knn_descriptors(pts, None, 6, 3, True)
    with pytest.raises(ValueError, match="K20"):
        TD.ratio_match(torch.rand(5, 27), torch.rand(5, 27), None, 3.0)
    with pytest.raises(ValueError, match="NONE"):
        TD.ransac_score(pts[0], pts[0], torch.zeros((2, 4), dtype=torch.int32),
                        1.0, "NONE")
