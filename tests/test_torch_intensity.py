"""The port's intensity-correction chain against the JAX package, on the CPU.

* K23's twin (``linefit_ransac_plain``) fed JAX's own hypotheses (``split``
  of ``PRNGKey(seed)`` over the pairs, then ``randint(k, (I, 2), 0, N)``,
  computed here) against ``_linefit_ransac_kernel``: inlier counts equal,
  a and b within 1e-5 (the float32 refit sums in another order).
* The port's own draws (a ``torch.Generator``) pass the JAX package's
  golden thresholds (tests/test_intensity.py::test_linefit_ransac).
* ``match_cells_histogram`` and the dense numpy solve against JAX's, within
  1e-12; the CG twin (``cg_plain``) against JAX's dense solve within rtol
  1e-6 / atol 1e-6 (the JAX package's documented CG contract).
* The slice as a whole on the JAX test's fixture (2 tiles 96x96x48,
  ``smooth_field=600``, setup 1 rescaled to 1.4 i + 30), with JAX's draws
  patched into ``draw_hypotheses``: the same cell pairs, stats within 1e-9
  relative, fits within 1e-6, grids within 1e-6, stores read both ways.
* The CLI chain match-intensities -> solve-intensities -> affine-fusion
  --intensityN5 with ``--device cpu`` against the JAX chain: corrected
  uint16 within |delta| <= 1, and the JAX test's seam gate.

The JAX solve imports ``jax.experimental.enable_x64``, which jax 0.9
removed: these tests reach it through ``x64_shim`` of
tests/test_torch_solver.py, which leaves nothing behind.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from bigstitcher_spark_tpu.io.spimdata import ViewId as JViewId
from bigstitcher_spark_tpu.ops import intensity as JI
from bigstitcher_spark_tpu_torch.cli.main import main as torch_main
from bigstitcher_spark_tpu_torch.io.chunkstore import ChunkStore
from bigstitcher_spark_tpu_torch.io.dataset_io import ViewLoader
from bigstitcher_spark_tpu_torch.io.spimdata import SpimData, ViewId
from bigstitcher_spark_tpu_torch.models import intensity as TI
from bigstitcher_spark_tpu_torch.ops import intensity as OI
from bigstitcher_spark_tpu_torch.ops import solve as TS
from bigstitcher_spark_tpu_torch.utils.testdata import make_synthetic_project
from test_torch_solver import x64_shim


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_draws(seed, P, N, iterations, device="cpu"):
    """The hypotheses ``_linefit_ransac_kernel`` draws for ``seed``."""
    keys = jax.random.split(jax.random.PRNGKey(seed), P)
    idx = np.stack([np.asarray(jax.random.randint(k, (iterations, 2), 0, N))
                    for k in keys])
    return torch.from_numpy(idx.astype(np.int32)).to(device)


def _golden_line(seed=0):
    """tests/test_intensity.py::test_linefit_ransac's samples."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, 200).astype(np.float32)
    y = 0.6 * x + 0.1 + rng.normal(0, 0.004, 200).astype(np.float32)
    y[:40] = rng.uniform(0, 1, 40)  # 20% outliers
    return x, y


def _batch(samples_a, samples_b):
    x, y, v = OI.pack_samples(samples_a, samples_b, "cpu")
    return x, y, v


# ---------------------------------------------------------------- (a), (b)


@pytest.mark.parametrize("case", ["golden", "padded3"])
def test_linefit_twin_matches_jax_on_jax_draws(case):
    if case == "golden":
        x, y = _golden_line()
        sa, sb, iters, eps = [x], [y], 500, 0.02
    else:
        rng = np.random.default_rng(7)
        sa, sb = [], []
        for n, (a, b) in zip((37, 150, 90), ((1.3, 0.05), (0.7, 0.2),
                                             (1.0, -0.1))):
            xs = rng.uniform(0.1, 0.9, n).astype(np.float32)
            ys = (a * xs + b + rng.normal(0, 0.005, n)).astype(np.float32)
            ys[: n // 5] = rng.uniform(0, 1, n // 5)
            sa.append(xs)
            sb.append(ys)
        iters, eps = 300, 0.02
    x, y, v = _batch(sa, sb)
    P, N = x.shape
    seed = 5
    hyp = jax_draws(seed, P, N, iters)
    got = OI.linefit_ransac_plain(x, y, v, hyp, eps)
    ja, jb, jn = JI._linefit_ransac_kernel(
        x.numpy(), y.numpy(), v.numpy(), jax.random.PRNGKey(seed),
        np.float32(eps), iters)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(jn))
    np.testing.assert_allclose(got.a.numpy(), np.asarray(ja), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.b.numpy(), np.asarray(jb), rtol=0,
                               atol=1e-5)
    # the best hypothesis is the first with the most inliers
    c = got.counts.numpy()
    assert (c.max(1) == got.count.numpy()).all()
    assert (c.argmax(1) == got.best.numpy()).all()


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_linefit_own_draws_pass_jax_golden_thresholds(seed):
    x, y = _golden_line()
    (fit,) = OI.match_cells_ransac([x], [y], epsilon=0.02, iterations=500,
                                   seed=seed)
    a, b, n = fit
    assert abs(a - 0.6) < 0.05
    assert abs(b - 0.1) < 0.03
    assert n > 140


def test_draws_are_uniform_with_replacement_over_padding():
    hyp = OI.draw_hypotheses(3, 2, 16, 4000, "cpu")
    assert hyp.shape == (2, 4000, 2) and hyp.dtype == torch.int32
    assert int(hyp.min()) == 0 and int(hyp.max()) == 15
    assert (hyp[..., 0] == hyp[..., 1]).any()  # with replacement
    assert torch.equal(hyp, OI.draw_hypotheses(3, 2, 16, 4000, "cpu"))
    assert OI.sample_bucket(200) == 256 and OI.sample_bucket(3) == 8


# ---------------------------------------------------------------- (c), (d)


def test_histogram_matches_jax():
    rng = np.random.default_rng(1)
    sa = [rng.uniform(0.2, 0.8, 500), rng.uniform(0, 1, 5),
          np.full(40, 0.3)]
    sb = [rng.permutation(1.5 * sa[0] - 0.1), rng.uniform(0, 1, 5),
          rng.uniform(0, 1, 40)]
    got = OI.match_cells_histogram(sa, sb)
    ref = JI.match_cells_histogram(sa, sb)
    assert [g is None for g in got] == [r is None for r in ref]
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-12, atol=0)


def _system(seed=0, n_views=3, dims=(4, 4, 4), n_matches=300):
    """tests/test_solve_device.py::TestIntensityDevice._system, rebuilt."""
    rng = np.random.default_rng(seed)
    ncell = int(np.prod(dims))
    C = ncell * n_views
    matches = []
    for _ in range(n_matches):
        ca, cb = rng.integers(0, C, 2)
        if ca == cb:
            continue
        x = rng.uniform(100, 1000, 50)
        a, b = rng.uniform(0.8, 1.2), rng.uniform(-20, 20)
        y = a * x + b + rng.normal(0, 5, 50)
        matches.append((int(ca), int(cb), *OI.match_stats(x / 500, y / 500)))
    return C, matches, TI.smoothness_pairs(dims, n_views)


def test_dense_solve_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(10, 100, 500)
    y = 0.5 * x - 5.0
    C, matches, smooth = _system()
    with x64_shim():
        for args, kw in (((2, [(0, 1, *OI.match_stats(x, y))], 1e-4), {}),
                         ((C, matches, 0.1), {"smooth_pairs": smooth})):
            got = OI.solve_intensity_coefficients(*args, backend="numpy", **kw)
            ref = JI.solve_intensity_coefficients(*args, backend="numpy", **kw)
            np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    assert JI.match_stats(x, y) == OI.match_stats(x, y)


@pytest.mark.parametrize("seed", [0, 1])
def test_cg_plain_matches_jax_dense_solve(seed):
    C, matches, smooth = _system(seed=seed)
    with x64_shim():
        dense = JI.solve_intensity_coefficients(C, matches, 0.1,
                                                smooth_pairs=smooth,
                                                backend="numpy")
    rows, diag, rhs, sidx, sw = OI.intensity_system(C, matches, 0.1, smooth)
    sysm = TS.assemble_cg(C, rows, diag, rhs, sidx, sw, "cpu")
    out = TS.cg_plain(sysm)
    assert 0 < out.iterations < sysm.max_iter
    assert out.card_seconds == out.seconds > 0  # no card: the loop's wall
    assert sysm.max_iter == min(4 * 2 * TS.bucket(C, 16) + 64, 20000)
    np.testing.assert_allclose(out.x.numpy().reshape(C, 2), dense, rtol=1e-6,
                               atol=1e-6)
    # the public entry on the CPU takes the same loop (the kernels' twins)
    dev = OI.solve_intensity_coefficients(C, matches, 0.1,
                                          smooth_pairs=smooth,
                                          backend="device", device="cpu")
    np.testing.assert_allclose(dev, dense, rtol=1e-6, atol=1e-6)


def test_cg_unmatched_cells_solve_to_identity():
    C, matches, _ = _system(seed=3, n_views=2, n_matches=200)
    # matches among the first half only, no smoothness: the rest is free
    half = [m for m in matches if m[0] < C // 2 and m[1] < C // 2]
    rows, diag, rhs, sidx, sw = OI.intensity_system(C, half, 0.1)
    out = TS.cg_plain(TS.assemble_cg(C, rows, diag, rhs, sidx, sw, "cpu"))
    sol = out.x.numpy().reshape(C, 2)
    np.testing.assert_allclose(sol[C // 2:, 0], 1.0, rtol=0, atol=1e-12)
    np.testing.assert_allclose(sol[C // 2:, 1], 0.0, rtol=0, atol=1e-12)
    empty = OI.solve_intensity_coefficients(16, [], 0.1, backend="device",
                                            device="cpu")
    np.testing.assert_allclose(empty, np.tile([1.0, 0.0], (16, 1)))


def test_cg_assembly_matches_the_matvec():
    """The CSR lists hold the JAX matvec: A v by the lists equals the data
    term + smoothness Laplacian + diagonal computed term by term."""
    C, matches, smooth = _system(seed=4, n_matches=80)
    rows, diag, rhs, sidx, sw = OI.intensity_system(C, matches, 0.1, smooth)
    sysm = TS.assemble_cg(C, rows, diag, rhs, sidx, sw, "cpu")
    v = np.random.default_rng(0).normal(size=2 * C)
    ref = diag * v
    for ca, cb, n, sx, sy, sxx, syy, sxy in rows:
        ia, ib = 2 * int(ca), 2 * int(cb)
        sa, oa, sb, ob = v[ia], v[ia + 1], v[ib], v[ib + 1]
        ref[ia] += sxx * sa + sx * oa - sxy * sb - sx * ob
        ref[ia + 1] += sx * sa + n * oa - sy * sb - n * ob
        ref[ib] += -sxy * sa - sy * oa + syy * sb + sy * ob
        ref[ib + 1] += -sx * sa - n * oa + sy * sb + n * ob
    for (i, j), w in zip(sidx, sw):
        ref[i] += w * (v[i] - v[j])
        ref[j] -= w * (v[i] - v[j])
    terms = sysm.vals * torch.from_numpy(v)[sysm.cols.long()]
    got = torch.segment_reduce(terms, "sum", lengths=sysm.row_len).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------- (e), (f)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """The JAX test's 2-tile project; tile 1's stored data rescaled
    (i -> 1.4 i + 30): the miscalibration the tools must recover."""
    proj = make_synthetic_project(
        str(tmp_path_factory.mktemp("intensity") / "proj"),
        n_tiles=(2, 1, 1), tile_size=(96, 96, 48), overlap=40, jitter=0.0,
        seed=21, n_beads_per_tile=30, smooth_field=600.0)
    store = ChunkStore.open(os.path.join(os.path.dirname(proj.xml_path),
                                         "dataset.n5"))
    ds = store.open_dataset("setup1/timepoint0/s0")
    img = ds.read_full().astype(np.float64)
    ds.write(np.clip(1.4 * img + 30, 0, 65535).astype(np.uint16), (0, 0, 0))
    return proj


def _copy(project, tmp_path, name):
    d = tmp_path / name
    shutil.copytree(os.path.dirname(project.xml_path), d)
    return str(d / "dataset.xml")


def _jax_side(xml):
    from bigstitcher_spark_tpu.io.dataset_io import ViewLoader as JLoader
    from bigstitcher_spark_tpu.io.spimdata import SpimData as JSpimData

    sd = JSpimData.load(xml)
    return sd, JLoader(sd), sorted(sd.registrations)


def _key(m):
    return (m.view_a.setup, m.view_b.setup, m.cell_a, m.cell_b)


@pytest.mark.parametrize("trim", [False, True], ids=["jax-test", "maxTrust"])
def test_match_and_solve_match_jax(project, tmp_path, monkeypatch, trim):
    from bigstitcher_spark_tpu.models import intensity as JMI

    monkeypatch.setattr(OI, "draw_hypotheses", jax_draws)
    extra = ({} if trim else dict(min_threshold=0.0, max_trust=float("inf")))
    kw = dict(coefficients=(2, 2, 2), render_scale=0.5, **extra)
    sd = SpimData.load(project.xml_path)
    views = sorted(sd.registrations)
    mine = TI.match_intensities(sd, ViewLoader(sd), views,
                                TI.IntensityParams(**kw), progress=False,
                                device="cpu")
    jsd, jloader, jviews = _jax_side(project.xml_path)
    ref = JMI.match_intensities(jsd, jloader, jviews,
                                JMI.IntensityParams(**kw), progress=False)
    assert len(mine) > 0
    assert [_key(m) for m in mine] == [_key(m) for m in ref]
    for m, r in zip(mine, ref):
        np.testing.assert_allclose(m.stats, r.stats, rtol=1e-9, atol=0)
        np.testing.assert_allclose(m.fit, r.fit, rtol=0, atol=1e-6)
    with x64_shim():
        jgrid = JMI.solve_intensities(ref, jviews, (2, 2, 2), lam=0.01,
                                      progress=False)
    grid = TI.solve_intensities(mine, views, (2, 2, 2), lam=0.01,
                                progress=False, device="cpu")
    for v in views:
        np.testing.assert_allclose(grid[v], jgrid[JViewId(v.timepoint,
                                                          v.setup)],
                                   rtol=1e-6, atol=1e-6)
    if not trim:
        # the JAX test's equalization gate on the port's grids (that test
        # neutralises the candidate filters, as this case does)
        c0 = grid[ViewId(0, 0)].reshape(-1, 2).mean(axis=0)
        c1 = grid[ViewId(0, 1)].reshape(-1, 2).mean(axis=0)
        for i in (100.0, 500.0, 2000.0):
            lhs = c0[0] * i + c0[1]
            rhs = c1[0] * (1.4 * i + 30.0) + c1[1]
            assert abs(lhs - rhs) / max(lhs, 1.0) < 0.12

    # stores, both ways: the port's read by JAX and JAX's by the port
    ts = TI.IntensityStore(str(tmp_path / "port.n5"))
    ts.save_matches(mine, (2, 2, 2))
    js = JMI.IntensityStore(str(tmp_path / "jax.n5"))
    js.save_matches(ref, (2, 2, 2))
    for v in views:
        ts.save_coefficients(v, grid[v])
        js.save_coefficients(JViewId(v.timepoint, v.setup),
                             jgrid[JViewId(v.timepoint, v.setup)])
    back_j = JMI.IntensityStore(str(tmp_path / "port.n5"))
    back_t = TI.IntensityStore(str(tmp_path / "jax.n5"))
    assert back_j.coefficient_dims() == back_t.coefficient_dims() == (2, 2, 2)
    for a, b in ((back_j.load_all_matches(), mine),
                 (back_t.load_all_matches(), ref)):
        assert sorted(map(_key, a)) == sorted(map(_key, b))
        for m, r in zip(sorted(a, key=_key), sorted(b, key=_key)):
            assert tuple(m.stats) == tuple(r.stats)
            assert tuple(m.fit) == tuple(r.fit)
    for v in views:
        jv = JViewId(v.timepoint, v.setup)
        np.testing.assert_array_equal(back_j.load_coefficients(jv), grid[v])
        np.testing.assert_array_equal(back_t.load_coefficients(v), jgrid[jv])


def _fuse_seam(xml, tmp_path, tag, coefficients):
    """The JAX test's FIRST_WINS float32 fusion of the whole project
    through the port's fuse_volume; returns the seam jump."""
    from bigstitcher_spark_tpu_torch.io.chunkstore import StorageFormat
    from bigstitcher_spark_tpu_torch.models.affine_fusion import fuse_volume
    from bigstitcher_spark_tpu_torch.utils.viewselect import (
        maximal_bounding_box)

    sd = SpimData.load(xml)
    views = sorted(sd.registrations)
    bbox = maximal_bounding_box(sd, views, None)
    cstore = ChunkStore.create(str(tmp_path / f"{tag}.n5"), StorageFormat.N5)
    ds = cstore.create_dataset("f", bbox.shape, (64, 64, 48), "float32")
    fuse_volume(sd, ViewLoader(sd), views, ds, bbox, block_size=(64, 64, 48),
                block_scale=(1, 1, 1), fusion_type="FIRST_WINS",
                out_dtype="float32", min_intensity=0.0, max_intensity=1.0,
                device="cpu", coefficients=coefficients)
    out = ds.read_full()
    x_seam = 96 - bbox.min[0]
    left = out[x_seam - 3:x_seam, 8:88, 8:40].mean()
    right = out[x_seam + 1:x_seam + 4, 8:88, 8:40].mean()
    return abs(left - right) / right


def test_cli_chain_matches_jax_and_passes_seam_gate(project, tmp_path):
    from bigstitcher_spark_tpu.cli.main import cli

    xml_t = _copy(project, tmp_path, "port")
    xml_j = _copy(project, tmp_path, "jax")
    args = ["--coefficients", "2,2,2", "--renderScale", "0.5"]
    m, stats = torch_main(["match-intensities", "-x", xml_t, *args,
                           "--device", "cpu"])
    assert len(m) > 0 and stats.pairs == 1
    torch_main(["solve-intensities", "-x", xml_t, "--lambda", "0.01",
                "--device", "cpu"])
    runner = CliRunner()
    with x64_shim():
        for cmd in (["match-intensities", "-x", xml_j, *args],
                    ["solve-intensities", "-x", xml_j, "--lambda", "0.01"]):
            res = runner.invoke(cli, cmd)
            assert res.exit_code == 0, res.output

    outs = {}
    for side, xml in (("port", xml_t), ("jax", xml_j)):
        out = str(tmp_path / f"{side}.zarr")
        torch_main(["create-fusion-container", "-x", xml, "-o", out, "-s",
                    "ZARR", "-d", "UINT16"])
        if side == "port":
            torch_main(["affine-fusion", "-o", out, "--device", "cpu",
                        "--intensityN5"])
        else:
            with x64_shim():
                res = runner.invoke(cli, ["affine-fusion", "-o", out,
                                          "--intensityN5", "--devices", "1"])
            assert res.exit_code == 0, res.output
        a = ChunkStore.open(out).open_dataset("0").read_full()
        outs[side] = a.reshape(a.shape[:3])
    raw = str(tmp_path / "raw.zarr")
    torch_main(["create-fusion-container", "-x", xml_t, "-o", raw, "-s",
                "ZARR", "-d", "UINT16"])
    torch_main(["affine-fusion", "-o", raw, "--device", "cpu"])
    raw_v = ChunkStore.open(raw).open_dataset("0").read_full()
    d = np.abs(outs["port"].astype(np.int64) - outs["jax"].astype(np.int64))
    assert d.max() <= 1
    assert np.abs(outs["port"].astype(np.int64)
                  - raw_v.reshape(raw_v.shape[:3]).astype(np.int64)).max() > 50

    # the seam gate of tests/test_intensity.py::test_cli_and_corrected_fusion
    store = TI.IntensityStore.for_project(SpimData.load(xml_t))
    views = sorted(SpimData.load(xml_t).registrations)
    coeffs = {v: store.load_coefficients(v).astype(np.float32)
              for v in views}
    jump_raw = _fuse_seam(xml_t, tmp_path, "raw", None)
    jump_cor = _fuse_seam(xml_t, tmp_path, "corrected", coeffs)
    assert jump_raw > 0.15
    assert jump_cor < jump_raw / 3


def test_per_block_route_matches_composite_with_coefficients(project,
                                                             tmp_path):
    """The same correction through K3's twin (the per-block route, forced
    by a 1-byte device budget) and K1's twin (composite): |delta| <= 1."""
    xml = _copy(project, tmp_path, "routes")
    torch_main(["match-intensities", "-x", xml, "--coefficients", "2,2,2",
                "--renderScale", "0.5", "--device", "cpu"])
    torch_main(["solve-intensities", "-x", xml, "--lambda", "0.01",
                "--device", "cpu"])
    vols = {}
    for route, budget in (("composite", None), ("per-block", "1")):
        out = str(tmp_path / f"{route}.zarr")
        torch_main(["create-fusion-container", "-x", xml, "-o", out, "-s",
                    "ZARR", "-d", "UINT16"])
        old = os.environ.pop("BST_DEVICE_TILE_BUDGET", None)
        if budget:
            os.environ["BST_DEVICE_TILE_BUDGET"] = budget
        try:
            (st,) = torch_main(["affine-fusion", "-o", out, "--device", "cpu",
                                "--intensityN5"])
        finally:
            os.environ.pop("BST_DEVICE_TILE_BUDGET", None)
            if old is not None:
                os.environ["BST_DEVICE_TILE_BUDGET"] = old
        assert st.path == route
        if route == "per-block":
            assert st.kernel_blocks["gather"] > 0
            assert st.kernel_blocks["shift"] == st.kernel_blocks["sep"] == 0
        vols[route] = ChunkStore.open(out).open_dataset("0").read_full()
    d = np.abs(vols["composite"].astype(np.int64)
               - vols["per-block"].astype(np.int64))
    assert d.max() <= 1


@pytest.mark.parametrize("noise", [0.0, 8.0], ids=["noise-off", "noise-on"])
def test_cell_slopes_recover_the_map_but_for_noise_in_x(tmp_path, noise):
    """Why a cell's own slope misses 1.4 where its intensity spread is near
    the noise: the JAX fixture registered to the truth, cut into 8x8x8 cells
    at renderScale 1. Without sensor noise every slope of setup 1 lies
    within 0.05 of 1.4. With it (sigma 8), the least-squares slopes are
    attenuated to a (1 - sigma^2 / var x) (errors in variables): their
    median lies > 0.05 from 1.4 but < 0.03 from that prediction, while the
    inliers pooled over the cells still give 1.4 within 0.05. Each fit is
    the least-squares line of its inliers' sums within 1e-9 relative."""
    from bigstitcher_spark_tpu_torch.utils.geometry import translation_affine
    from bigstitcher_spark_tpu_torch.utils.testdata import (
        append_view_transforms)

    proj = make_synthetic_project(
        str(tmp_path / "proj"), n_tiles=(2, 1, 1), tile_size=(96, 96, 48),
        overlap=40, jitter=0.0, seed=21, n_beads_per_tile=30,
        smooth_field=600.0, noise_sigma=noise)
    ds = ChunkStore.open(os.path.join(os.path.dirname(proj.xml_path),
                                      "dataset.n5")).open_dataset(
        "setup1/timepoint0/s0")
    img = ds.read_full().astype(np.float64)
    ds.write(np.clip(1.4 * img + 30, 0, 65535).astype(np.uint16), (0, 0, 0))
    append_view_transforms(proj.xml_path, {
        s: translation_affine(proj.true_offsets[s] - proj.nominal_offsets[s])
        for s in proj.true_offsets}, name="registration")
    sd = SpimData.load(proj.xml_path)
    matches = TI.match_intensities(
        sd, ViewLoader(sd), sorted(sd.registrations),
        TI.IntensityParams(coefficients=(8, 8, 8), render_scale=1.0,
                           min_num_candidates=100), progress=False,
        device="cpu")
    assert len(matches) > 100
    st = np.array([m.stats for m in matches])
    a = np.array([m.fit[0] for m in matches])
    b = np.array([m.fit[1] for m in matches])
    assert {(m.view_a.setup, m.view_b.setup) for m in matches} == {(0, 1)}
    n, sx, sy, sxx, _syy, sxy = st.T
    var = sxx / n - (sx / n) ** 2
    lsq = (sxy / n - sx * sy / n ** 2) / var
    np.testing.assert_allclose(a, lsq, rtol=1e-9, atol=0)
    np.testing.assert_allclose(b, (sy - lsq * sx) / n, rtol=1e-9, atol=1e-9)
    N, SX, SY, SXX, _, SXY = st.sum(axis=0)
    assert abs((SXY - SX * SY / N) / (SXX - SX * SX / N) - 1.4) < 0.05
    if noise == 0.0:
        assert np.abs(a - 1.4).max() < 0.05
    else:
        assert np.median(np.abs(a - 1.4)) > 0.05
        assert np.median(np.abs(a - 1.4 * (1 - noise ** 2 / var))) < 0.03
