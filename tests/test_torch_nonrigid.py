"""The port's nonrigid-fusion slice against the JAX package, on the CPU.

* ``fit_control_grid`` is float64 numpy copied line for line: bit for bit
  on JAX's three golden fixtures, a random one and an empty one.
* ``build_unique_points`` returns the same points in the same order.
* ``nonrigid_fuse_block_plain`` (K26's twin) against JAX's
  ``nonrigid_fuse_block`` over the fusion types, uint16 and float32
  patches, identity / constant-translation / fitted grids and a block
  partly off its grid (the clamp rule), with 3 views padded to 4 at a
  block origin near (1500, 900, 60). Tolerance, derived: XLA rounds the
  grid's dot products on the CPU one way at small shapes and another at
  the main path's (the twin follows the latter), so each interpolated
  coefficient may differ by an ulp; the deform multiplies it by world
  coordinates of ~1500, so sample positions may differ by a few ulps of
  the largest world coordinate. The test bounds the position error by 16
  ulps of it and the fused value error by that times the patch's steepest
  slope, plus 16 ulps of the largest value (the 8-term trilinear sum and
  the combine). JAX's two golden kernel cases hold at their atol 0.5.
* ``fuse_nonrigid_volume`` on JAX's pipeline fixture (2 tiles of
  96x96x48, jitter 3, seed 13; detection and matching run once by the
  JAX package, read by both): float32 within the same derived bound and
  uint16 within |delta| <= 1 wherever the port's weight sum is at least
  1e-6. Below that lies the foot of the blend ramp on the volume's outer
  planes: a voxel whose every covering view sits within ~1e-4 px of its
  image edge, where one ulp of sample position decides between the view's
  value and nothing (wsum > 0 or not). There each voxel equals JAX's as
  above, or is such a flip, 0 on one side; the flips are under 2 %. The
  port's volume passes JAX's recovery gate.
* Sparse correspondences: on 2x2 tiles JAX's own volume misses beads of
  the recovery gate where a view's fits extrapolate, and the port's
  misses the same beads by the same distances (the open fault behind
  chip_smoke's misses on full-size tiles).
* Views with no correspondence near a block take identity grids: the
  block fuses as affine fusion does (uint16 |delta| <= 1).
* The CLI with ``--device cpu``, on a container and in direct-output mode,
  equals the library call.
"""

import numpy as np
import pytest
import torch

from bigstitcher_spark_tpu.io.chunkstore import ChunkStore as JStore
from bigstitcher_spark_tpu.io.chunkstore import StorageFormat as JFormat
from bigstitcher_spark_tpu.io.dataset_io import ViewLoader as JViewLoader
from bigstitcher_spark_tpu.io.interestpoints import (
    InterestPointStore as JIPStore,
)
from bigstitcher_spark_tpu.io.spimdata import SpimData as JSpimData
from bigstitcher_spark_tpu.models import nonrigid_fusion as jnr
from bigstitcher_spark_tpu.ops import nonrigid as jops
from bigstitcher_spark_tpu_torch.cli.main import main as torch_main
from bigstitcher_spark_tpu_torch.io.chunkstore import ChunkStore, StorageFormat
from bigstitcher_spark_tpu_torch.io.container import read_container_meta
from bigstitcher_spark_tpu_torch.io.dataset_io import ViewLoader
from bigstitcher_spark_tpu_torch.io.interestpoints import InterestPointStore
from bigstitcher_spark_tpu_torch.io.spimdata import SpimData
from bigstitcher_spark_tpu_torch.models import affine_fusion as taf
from bigstitcher_spark_tpu_torch.models import nonrigid_fusion as tnr
from bigstitcher_spark_tpu_torch.ops import dog as TD
from bigstitcher_spark_tpu_torch.ops import nonrigid as tops
from bigstitcher_spark_tpu_torch.utils.geometry import translation_affine
from bigstitcher_spark_tpu_torch.utils.testdata import append_view_transforms
from bigstitcher_spark_tpu_torch.utils.viewselect import maximal_bounding_box

FTYPES = ("AVG", "AVG_BLEND", "MAX_INTENSITY", "FIRST_WINS", "LAST_WINS")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- fits


def _fit_case(name):
    """(targets, view_world, grid_origin, dims, spacing) of JAX's golden
    fixtures (tests/test_nonrigid.py), a random one and an empty one."""
    if name == "global_affine":
        rng = np.random.default_rng(0)
        A = np.array([[1.02, 0.03, 0.0, 5.0], [-0.02, 0.99, 0.01, -3.0],
                      [0.0, 0.01, 1.01, 2.0]])
        t = rng.uniform(0, 100, (60, 3))
        return t, t @ A[:, :3].T + A[:, 3], np.zeros(3), (5, 5, 5), 25.0
    if name == "local_deformation":
        rng = np.random.default_rng(1)
        t = np.concatenate([rng.uniform(2, 28, (40, 3)),
                            rng.uniform(72, 98, (40, 3))])
        shift = np.zeros((80, 3))
        shift[40:, 0] = 4.0
        return t, t + shift, np.zeros(3), (11, 11, 11), 10.0
    if name == "few_points":
        return (np.array([[10.0, 10, 10], [20.0, 20, 20]]),
                np.array([[12.0, 10, 10], [22.0, 20, 20]]), np.zeros(3),
                (3, 3, 3), 10.0)
    if name == "empty":
        return np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(3), (4, 3, 2), 10.0
    rng = np.random.default_rng(7)
    origin = np.array([1490.0, 890.0, 50.0])
    t = origin + rng.uniform(0, 60, (37, 3))
    vw = t + rng.normal(0, 1.5, (37, 3)) + [2.0, -1.0, 0.5]
    return t, vw, origin, (7, 6, 5), 10.0


@pytest.mark.parametrize("name", ["global_affine", "local_deformation",
                                  "few_points", "random", "empty"])
def test_fit_control_grid_equals_jax(name):
    args = _fit_case(name)
    got = tops.fit_control_grid(*args)
    want = jops.fit_control_grid(*args)
    assert got.dtype == np.float32 and got.shape == (*args[3], 12)
    assert np.array_equal(got, want)


# ---------------------------------------------------------------- K26 twin


def _smooth_patch(shape, dtype):
    x = np.indices(shape).astype(np.float64)
    p = (600 + 250 * np.sin(x[0] / 6.0) * np.cos(x[1] / 8.0)
         + 150 * np.sin(x[2] / 5.0 + 0.3))
    return p.astype(np.float32) if dtype == "float32" else np.round(p).astype(
        np.uint16)


def _block_case(grid_kind, dtype, seed=5):
    """Kernel inputs of one block of (16, 20, 12) voxels at world origin
    (1500.25, 900.5, 60.75) with 3 views padded to 4."""
    rng = np.random.default_rng(seed)
    bs = (16, 20, 12)
    bo = np.array([1500.25, 900.5, 60.75], np.float32)
    V, vb = 3, 4
    if grid_kind == "off_grid":
        # the grid starts inside the block and ends before its far side:
        # positions clamp at both ends
        gdims, go, cpd = (3, 3, 3), bo + np.float32(2.0), 4.0
    else:
        gdims = tnr.control_grid_dims(bs, 10.0)
        go, cpd = bo - np.float32(10.0), 10.0
    grids = np.zeros((vb, *gdims, 12), np.float32)
    grids[..., 0] = grids[..., 5] = grids[..., 10] = 1.0
    for v in range(V):
        if grid_kind == "translation":
            grids[v, ..., [3, 7, 11]] = np.array(
                [1.3, -0.7, 0.4], np.float32)[:, None, None, None] * (v + 1)
        elif grid_kind in ("fitted", "off_grid"):
            t = bo + rng.uniform(-10, 30, (40, 3))
            vw = (t + rng.normal(0, 0.8, (40, 3))
                  + 0.03 * (t - bo) * [1, -1, 0.5] + [1.5, -2.0, 0.7])
            grids[v] = tops.fit_control_grid(t, vw, go.astype(np.float64),
                                             gdims, cpd)
    pshape = tuple(s + 24 for s in bs)
    patches = np.zeros((vb, *pshape), dtype)
    vaff = np.zeros((vb, 3, 4), np.float32)
    offsets = np.zeros((vb, 3), np.float32)
    for v in range(V):
        patches[v] = _smooth_patch(pshape, dtype)[::1 if v != 1 else -1]
        lin = np.eye(3)
        if v == 2:  # a small rotation about z
            c, s = np.cos(0.05), np.sin(0.05)
            lin = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        vaff[v, :, :3] = lin
        vaff[v, :, 3] = (-lin @ bo.astype(np.float64) + 12.0
                         + rng.uniform(-0.5, 0.5, 3))
        offsets[v] = rng.integers(0, 30, 3)
    dims = np.tile(np.array([[70.5, 80.5, 60.5]], np.float32), (vb, 1))
    dims[:V] = offsets[:V] + np.array(pshape) + rng.integers(5, 20, (V, 3))
    dims[0, 0] = offsets[0, 0] + 22.5  # view 0's image ends inside the block
    borders = np.zeros((vb, 3), np.float32)
    ranges = np.ones((vb, 3), np.float32)
    borders[:V] = rng.uniform(0, 2, (V, 3))
    ranges[:V] = rng.uniform(4, 12, (V, 3))
    valid = np.array([1, 1, 1, 0], np.float32)
    arrays = (patches, grids, vaff, offsets, dims, borders, ranges, valid, bo,
              go.astype(np.float32), np.full(3, cpd, np.float32))
    return arrays, bs


def _derived_tol(images, w_max):
    """|delta| bound of a fused value: 16 ulps of the largest world
    coordinate times the source images' steepest slope, plus 16 ulps of
    their largest value."""
    slope = vmax = 0.0
    for im in images:
        p = np.asarray(im, np.float64)
        slope = max([slope] + [float(np.abs(np.diff(p, axis=d)).max())
                               for d in range(3)])
        vmax = max(vmax, float(np.abs(p).max()))
    return (16 * float(np.spacing(np.float32(w_max))) * slope
            + 16 * float(np.spacing(np.float32(vmax))))


@pytest.mark.parametrize("grid_kind", ["identity", "translation", "fitted",
                                       "off_grid"])
@pytest.mark.parametrize("dtype", ["uint16", "float32"])
@pytest.mark.parametrize("fusion_type", FTYPES)
def test_nonrigid_block_twin_matches_jax(fusion_type, dtype, grid_kind):
    arrays, bs = _block_case(grid_kind, dtype)
    jf, jw = jops.nonrigid_fuse_block(*arrays, block_shape=bs,
                                      fusion_type=fusion_type)
    tf, tw = tops.nonrigid_fuse_block(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in arrays], bs,
        fusion_type)
    jf, jw = np.asarray(jf), np.asarray(jw)
    assert tf.shape == bs and tf.dtype == torch.float32
    assert (jw > 0).mean() > 0.5  # the views cover most of the block
    tol = _derived_tol(arrays[0][:3], 1600.0)
    assert tol < 0.5
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0, atol=tol)
    np.testing.assert_allclose(tw.numpy(), jw, rtol=0, atol=1e-4)


def test_off_grid_case_clamps_positions():
    """The off-grid case puts grid coordinates below 0 and above c - 1,
    where the clamp rule (not _trilinear_vec's clip) holds the end
    vertices: the twin's coefficients there equal the end vertices'."""
    arrays, bs = _block_case("off_grid", "float32")
    grid, bo, go, cpd = arrays[1][0], arrays[8], arrays[9], arrays[10]
    so = torch.from_numpy(grid)
    for d in range(3):
        i = torch.arange(bs[d], dtype=torch.float32)
        p = ((torch.tensor(bo[d]) + i) - torch.tensor(go[d])) / float(cpd[d])
        assert p.min() < 0 and p.max() > grid.shape[d] - 1
        so = tops._lerp_axis(so, d, p)
    assert torch.equal(so[0, 0, 0], torch.from_numpy(grid[0, 0, 0]))
    assert torch.equal(so[-1, -1, -1], torch.from_numpy(grid[-1, -1, -1]))


def _golden(translate_x):
    rng = np.random.default_rng(2 if translate_x == 0 else 3)
    patch = rng.uniform(0, 1000, (40, 40, 40)).astype(np.float32)
    grids = np.zeros((1, 5, 5, 5, 12), np.float32)
    grids[..., 0] = grids[..., 5] = grids[..., 10] = 1.0
    grids[..., 3] = translate_x
    ident = np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32)
    args = (patch[None], grids, ident[None], np.zeros((1, 3), np.float32),
            np.full((1, 3), 40.0, np.float32), np.zeros((1, 3), np.float32),
            np.full((1, 3), 1e-6, np.float32), np.ones(1, np.float32),
            np.zeros(3, np.float32), np.zeros(3, np.float32),
            np.full(3, 10.0, np.float32))
    fused, _w = tops.nonrigid_fuse_block(
        *[torch.from_numpy(a) for a in args], (32, 32, 32), "AVG")
    return fused.numpy(), patch


def test_identity_grid_matches_direct_sampling():
    fused, patch = _golden(0.0)
    np.testing.assert_allclose(fused, patch[:32, :32, :32], atol=0.5)


def test_constant_translation_grid_shifts_sampling():
    fused, patch = _golden(3.0)
    np.testing.assert_allclose(fused, patch[3:35, :32, :32], atol=0.5)


# ---------------------------------------------------------------- pipeline


def _matched_project(root, n_tiles, tile_size, overlap, seed, n_beads):
    """A synthetic project at jitter 3 whose beads the JAX package detects
    and matches once, as JAX's pipeline test does, saved into
    interestpoints.n5 and the XML."""
    from bigstitcher_spark_tpu.models.detection import (
        DetectionParams, detect_interest_points, save_detections)
    from bigstitcher_spark_tpu.models.matching import (
        MatchingParams, match_interest_points, save_matches)
    from bigstitcher_spark_tpu.utils.testdata import make_synthetic_project

    proj = make_synthetic_project(
        str(root / "proj"), n_tiles=n_tiles, tile_size=tile_size,
        overlap=overlap, jitter=3.0, seed=seed, n_beads_per_tile=n_beads)
    sd = JSpimData.load(proj.xml_path)
    views = sorted(sd.registrations)
    dets = detect_interest_points(
        sd, JViewLoader(sd), views,
        DetectionParams(downsample_xy=1, downsample_z=1,
                        block_size=tile_size), progress=False)
    store = JIPStore(str(root / "proj" / "interestpoints.n5"))
    save_detections(sd, store, dets, DetectionParams())
    mparams = MatchingParams(ransac_min_inliers=5, ransac_iterations=2000,
                             model="TRANSLATION", regularization="NONE")
    res = match_interest_points(sd, views, mparams, store, progress=False)
    save_matches(sd, store, res, mparams, views)
    sd.save(proj.xml_path)
    return proj


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """JAX's pipeline fixture (tests/test_nonrigid.py): 2 tiles of
    96x96x48, overlap 40, seed 13, 40 beads a tile."""
    return _matched_project(tmp_path_factory.mktemp("nonrigid"), (2, 1, 1),
                            (96, 96, 48), 40, 13, 40)


def _key(v):
    return (v.timepoint, v.setup)


def _torch_unique(xml):
    sd = SpimData.load(xml)
    views = sorted(sd.registrations)
    return sd, views, tnr.build_unique_points(
        sd, InterestPointStore.for_project(sd), views, ["beads"])


def test_build_unique_points_equals_jax(pipeline):
    proj = pipeline
    jsd = JSpimData.load(proj.xml_path)
    jviews = sorted(jsd.registrations)
    want = jnr.build_unique_points(jsd, JIPStore.for_project(jsd), jviews,
                                   ["beads"])
    _sd, views, got = _torch_unique(proj.xml_path)
    assert [_key(v) for v in views] == [_key(v) for v in jviews]
    for v, jv in zip(views, jviews):
        assert len(got.targets[v]) > 0
        assert np.array_equal(got.targets[v], want.targets[jv])
        assert np.array_equal(got.view_world[v], want.view_world[jv])


def _jax_volume(proj, out_dir, dtype):
    jsd = JSpimData.load(proj.xml_path)
    jviews = sorted(jsd.registrations)
    unique = jnr.build_unique_points(jsd, JIPStore.for_project(jsd), jviews,
                                     ["beads"])
    from bigstitcher_spark_tpu.utils.viewselect import (
        maximal_bounding_box as jbox)

    bbox = jbox(jsd, jviews, None)
    out = JStore.create(str(out_dir / f"jax_{dtype}.n5"), JFormat.N5
                        ).create_dataset("fused", bbox.shape, (64, 64, 48),
                                         dtype)
    jnr.fuse_nonrigid_volume(
        jsd, JViewLoader(jsd), jviews, unique, out, bbox,
        block_size=(64, 64, 48), block_scale=(1, 1, 1), cpd=10.0,
        out_dtype=dtype, devices=1,
        **({"min_intensity": 0.0, "max_intensity": 1.0}
           if dtype == "float32" else {}))
    return out.read_full()


def _torch_volume(proj, out_dir, dtype, wsum_out=None):
    """The port's volume; with ``wsum_out`` (a dict), also its weight sum
    over the volume, gathered from K26's twin."""
    sd, views, unique = _torch_unique(proj.xml_path)
    bbox = maximal_bounding_box(sd, views, None)
    out = ChunkStore.create(str(out_dir / f"torch_{dtype}.n5"),
                            StorageFormat.N5).create_dataset(
        "fused", bbox.shape, (64, 64, 48), dtype)
    real = tnr.nonrigid_fuse_block
    wsum = np.zeros(bbox.shape, np.float32)

    def spy(*a, **k):
        fused, w = real(*a, **k)
        o = a[8].numpy().astype(np.int64) - np.asarray(bbox.min)
        sl = tuple(slice(o[d], o[d] + w.shape[d]) for d in range(3))
        dst = wsum[sl]
        dst[...] = w.numpy()[tuple(slice(0, s) for s in dst.shape)]
        return fused, w

    tnr.nonrigid_fuse_block = spy
    try:
        stats = tnr.fuse_nonrigid_volume(
            sd, ViewLoader(sd), views, unique, out, bbox,
            block_size=(64, 64, 48), block_scale=(1, 1, 1), cpd=10.0,
            out_dtype=dtype, device="cpu",
            **({"min_intensity": 0.0, "max_intensity": 1.0}
               if dtype == "float32" else {}))
    finally:
        tnr.nonrigid_fuse_block = real
    assert stats.voxels == bbox.num_elements
    assert stats.kernel_blocks["nonrigid"] == stats.blocks
    assert set(stats.timings) == {"plan", "read", "h2d", "kernel", "d2h",
                                  "write"}
    if wsum_out is not None:
        wsum_out["wsum"] = wsum
        wsum_out["bbox"] = bbox
    return out.read_full()


@pytest.mark.parametrize("dtype", ["float32", "uint16"])
def test_fuse_nonrigid_volume_matches_jax(pipeline, tmp_path, dtype):
    proj = pipeline
    want = _jax_volume(proj, tmp_path, dtype).astype(np.float64)
    extra = {}
    got = _torch_volume(proj, tmp_path, dtype, extra).astype(np.float64)
    assert got.shape == want.shape
    solid = extra["wsum"] >= 1e-6
    foot = (extra["wsum"] > 0) & ~solid
    assert solid.mean() > 0.9
    err = np.abs(got - want)
    if dtype == "uint16":
        tol = 1.0
    else:
        sd = SpimData.load(proj.xml_path)
        loader = ViewLoader(sd)
        w_max = float(np.abs(np.asarray(extra["bbox"].max)).max()) + 1
        tol = _derived_tol([loader.open(v).read_full()
                            for v in sorted(sd.registrations)], w_max)
        assert 0 < tol < 0.5
    assert err[solid].max() <= tol, (err[solid].max(), tol)
    # on the foot each voxel equals JAX's as on the solid part, or one side
    # has the view's value and the other nothing (0)
    flip = foot & (err > tol) & ((got == 0) | (want == 0))
    assert np.all(err[foot & ~flip] <= tol)
    assert flip.mean() < 0.02, flip.sum()


def test_port_volume_passes_recovery_gate(pipeline, tmp_path):
    """tests/test_nonrigid.py's gate on the port's float32 volume, with
    the port's own DoG: each bead well inside both tiles lies within
    1.5 px of its truth plus the mean registration error, and no second
    detection lies within 4 px."""
    proj = pipeline
    extra = {}
    vol = _torch_volume(proj, tmp_path, "float32", extra)
    bbox = extra["bbox"]
    dogv, mask = TD.dog_block(torch.from_numpy(vol), float(vol.min()),
                              float(vol.max()), 0.01, 1.8,
                              stages=TD.PLAIN)
    coords = np.argwhere(mask.numpy())
    subs, _ = TD.localize_quadratic(dogv.numpy(), coords)
    fused_pts = subs + np.array(bbox.min)
    drift = 0.5 * ((proj.nominal_offsets[0] - proj.true_offsets[0])
                   + (proj.nominal_offsets[1] - proj.true_offsets[1]))
    checked = 0
    for bead in proj.bead_positions:
        inside = [np.all((bead - proj.true_offsets[s] >= 8)
                         & (bead - proj.true_offsets[s] <= [88, 88, 40]))
                  for s in (0, 1)]
        if not all(inside):
            continue
        near = np.sort(np.linalg.norm(fused_pts - (bead + drift), axis=1))[:2]
        assert near[0] < 1.5, f"bead {bead} unmatched (nearest {near[0]:.2f})"
        assert near[1] > 4.0, f"bead {bead} double-imaged ({near})"
        checked += 1
    assert checked >= 3


def test_sparse_correspondences_miss_beads_as_jax_does(tmp_path):
    """The open fault behind chip_smoke's recovery-gate misses on full-size
    tiles, shown on JAX's own fusion. Where a view's block sees few
    correspondences, or those of neighbours that registered apart, its
    per-vertex affine fits extrapolate, and the warp places a bead away
    from its truth plus the mean registration error. On 2x2 tiles of
    128x128x48 (overlap 32, 25 beads a tile, seed 17) JAX's float32 volume
    misses beads by more than 1.5 px. Held to chip_smoke's recovery gate,
    the port's volume checks the same beads and misses the same ones by
    the same distances (within 0.01 px), and in both volumes every checked
    bead lies within 1.5 px of where the fitted warps place it
    (chip_smoke.warp_placement) with no double image: the gate raises
    otherwise."""
    import chip_smoke as CS

    proj = _matched_project(tmp_path, (2, 2, 1), (128, 128, 48), 32, 17, 25)
    sd, views, unique = _torch_unique(proj.xml_path)
    bbox = maximal_bounding_box(sd, views, None)
    gates = {}
    for name, fuse in (("jax", _jax_volume), ("torch", _torch_volume)):
        vol = fuse(proj, tmp_path, "float32")
        gates[name] = CS.recovery_gate(proj, sd, unique, vol, bbox,
                                       (64, 64, 48), torch.device("cpu"),
                                       tiny=True)
    (n_j, met_j, _w, miss_j, _o), (n_t, met_t, _w, miss_t, _o) = (
        gates["jax"], gates["torch"])
    assert n_j == n_t and met_j == met_t and miss_j
    assert [tuple(b) for b, _e in miss_j] == [tuple(b) for b, _e in miss_t]
    assert np.allclose([e for _b, e in miss_j], [e for _b, e in miss_t],
                       rtol=0, atol=0.01)


def test_identity_grids_fuse_like_affine(tmp_path, monkeypatch):
    """With no correspondences every view takes identity grids (M = 0):
    the volume equals affine fusion's within |delta| <= 1 (uint16). The
    views carry sub-voxel translations, as chip_smoke's projects do."""
    from bigstitcher_spark_tpu_torch.utils.testdata import (
        make_synthetic_project)

    proj = make_synthetic_project(
        str(tmp_path / "p"), n_tiles=(2, 1, 1), tile_size=(48, 40, 20),
        overlap=12, seed=3, block_size=(32, 32, 16))
    rng = np.random.default_rng(5)
    append_view_transforms(proj.xml_path, {
        s: translation_affine(rng.uniform(-0.5, 0.5, 3)) for s in range(2)})
    sd = SpimData.load(proj.xml_path)
    views = sorted(sd.registrations)
    bbox = maximal_bounding_box(sd, views, None)
    empty = tnr.UniquePoints({v: np.zeros((0, 3)) for v in views},
                             {v: np.zeros((0, 3)) for v in views})
    cs = ChunkStore.create(str(tmp_path / "o.n5"), StorageFormat.N5)
    kw = dict(block_size=(32, 32, 16), block_scale=(2, 2, 1),
              out_dtype="uint16", device="cpu")
    nonrigid = cs.create_dataset("nonrigid", bbox.shape, (32, 32, 16),
                                 "uint16")
    tnr.fuse_nonrigid_volume(sd, ViewLoader(sd), views, empty, nonrigid,
                             bbox, **kw)
    affine = cs.create_dataset("affine", bbox.shape, (32, 32, 16), "uint16")
    monkeypatch.setenv("BST_DEVICE_TILE_BUDGET", "1")  # per block, as K26
    stats = taf.fuse_volume(sd, ViewLoader(sd), views, affine, bbox, **kw)
    assert stats.path == "per-block"
    vols = {name: ds.read_full().astype(np.int64)
            for name, ds in (("nonrigid", nonrigid), ("affine", affine))}
    assert vols["affine"].max() > 100
    assert np.abs(vols["nonrigid"] - vols["affine"]).max() <= 1


@pytest.mark.parametrize("mode", ["container", "direct"])
def test_cli_equals_library_call(pipeline, tmp_path, mode):
    proj = pipeline
    out = str(tmp_path / "fused.ome.zarr")
    if mode == "container":
        torch_main(["create-fusion-container", "-x", proj.xml_path, "-o", out,
                    "-d", "UINT16", "--blockSize", "64,64,48"])
        args = ["-o", out]
    else:
        args = ["-o", out, "-x", proj.xml_path, "-p", "UINT16"]
    (stats,) = torch_main(["nonrigid-fusion", *args, "-l", "beads",
                           "--blockScale", "1,1,1", "--device", "cpu"])
    store = ChunkStore.open(out)
    meta = read_container_meta(store)
    got = store.open_dataset(meta.mr_infos[0][0].dataset.strip("/")
                             ).read_full()[..., 0, 0]
    assert stats.voxels == meta.bbox.num_elements
    sd, views, unique = _torch_unique(proj.xml_path)
    ref = ChunkStore.create(str(tmp_path / "ref.n5"), StorageFormat.N5
                            ).create_dataset("f", meta.bbox.shape,
                                             tuple(meta.block_size), "uint16")
    tnr.fuse_nonrigid_volume(
        sd, ViewLoader(sd), views, unique, ref, meta.bbox,
        block_size=tuple(meta.block_size), block_scale=(1, 1, 1),
        out_dtype="uint16", device="cpu")
    want = ref.read_full()
    assert tuple(meta.block_size) == ((64, 64, 48) if mode == "container"
                                      else (128, 128, 128))
    assert got.max() > 100 and np.array_equal(got, want)
