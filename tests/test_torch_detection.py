"""The port's ``detect-interestpoints`` against the JAX package, on the CPU.

The JAX package's own fixture (tests/test_detection.py): a 2x1x1 project of
96x96x48 uint16 tiles, overlap 24, 30 beads a tile (seed 5). The port runs
with ``device="cpu"`` (the plain twins of K6 and K15-K18), the JAX package
on the CPU with its mirrored blur (``BST_DOG_BLUR=gemm``, set for this
module with ``jax.clear_caches()`` before and after) on one device.
Points are matched one to one within 1e-4 px (the response differs from
JAX's in the last float32 bits and the subpixel fit amplifies that), with
equal counts; the one exception allowed is a point within 1e-4 px of an
overlap box face, which such a difference may move across the face (the
crop keeps points on the box). Refined values within 1e-6, sampled
intensities within rtol 1e-5. The store and the XML the port's CLI
writes are read back by both packages' stores.

Minima (``--type MIN``/``BOTH``) at low thresholds and stored pyramid
levels meet a weaker contract, checked on each block's candidates (spies
on both packages' ``dog_block_topk_batch``, same inputs). Its reason: the
port's separable passes and JAX's Toeplitz products round the response
differently (measured <= 1.02e-6 apart), and weak minima sit on nearly
flat ground, where the quadratic fit divides by Hessian eigenvalues down
to 5e-7. On those cases:

- the responses of a block agree within ``RESP_TOL`` = 2e-6;
- the candidate voxels agree except near-tie flips: a voxel found by one
  package only has a 3x3x3 neighbour whose tie-broken response is within
  ``TIE_TOL`` = 4e-6 of its own, or its |response| is within ``RESP_TOL`` of
  the threshold; at most ``MAX_FLIPS`` = 2 such flips a view;
- a candidate found by both is fitted within ``max(PX_TOL, FIT_GAIN /
  lam)`` det-res px, ``FIT_GAIN`` = 1e-6, where ``lam`` is the smallest
  |eigenvalue| of the port's Hessian along its moves (first-order
  perturbation of ``-H^-1 g`` by a response error of ~1e-6; measured
  |d sub| * lam <= 4.2e-7), and its value within ``VAL_ATOL + 0.01 |d sub|``;
- the final points then match one to one within that largest fit
  difference (times the downsampling factor), apart from the flipped ones.
"""

import os
import shutil
import warnings

import jax
import numpy as np
import pytest
import torch

from bigstitcher_spark_tpu.cli.main import cli as jax_cli
from bigstitcher_spark_tpu.io.dataset_io import ViewLoader as JViewLoader
from bigstitcher_spark_tpu.io.interestpoints import (
    InterestPointStore as JStore,
)
from bigstitcher_spark_tpu.io.spimdata import SpimData as JSpimData
from bigstitcher_spark_tpu.io.spimdata import ViewId as JViewId
from bigstitcher_spark_tpu.models import detection as JD
from bigstitcher_spark_tpu.utils.testdata import make_synthetic_project
from bigstitcher_spark_tpu_torch import NotYetPorted
from bigstitcher_spark_tpu_torch.cli.main import main as torch_main
from bigstitcher_spark_tpu_torch.io.dataset_io import ViewLoader
from bigstitcher_spark_tpu_torch.io.interestpoints import InterestPointStore
from bigstitcher_spark_tpu_torch.io.spimdata import SpimData, ViewId
from bigstitcher_spark_tpu_torch.models import detection as TD

PX_TOL = 1e-4
VAL_ATOL = 1e-6
# the weaker contract of minima and stored levels (module docstring)
RESP_TOL = 2e-6
TIE_TOL = 2 * RESP_TOL
MAX_FLIPS = 2
FIT_GAIN = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_mirrored_jax_blur():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BST_DOG_BLUR", "gemm")
        jax.clear_caches()
        yield
    jax.clear_caches()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    return make_synthetic_project(
        str(tmp_path_factory.mktemp("det") / "proj"),
        n_tiles=(2, 1, 1), tile_size=(96, 96, 48), overlap=24,
        jitter=2.0, seed=5, n_beads_per_tile=30,
    )


@pytest.fixture(scope="module")
def project_levels(tmp_path_factory):
    """The same project stored with two pyramid levels."""
    return make_synthetic_project(
        str(tmp_path_factory.mktemp("det_levels") / "proj"),
        n_tiles=(2, 1, 1), tile_size=(96, 96, 48), overlap=24,
        jitter=2.0, seed=5, n_beads_per_tile=30,
        downsampling_factors=((1, 1, 1), (2, 2, 1), (4, 4, 2)),
    )


def _run_both(xml, **kw):
    """(JAX detections, port detections, port stats, port SpimData)."""
    jsd = JSpimData.load(xml)
    jd = JD.detect_interest_points(jsd, JViewLoader(jsd),
                                   sorted(jsd.registrations),
                                   JD.DetectionParams(**kw), progress=False,
                                   devices=1)
    tsd = SpimData.load(xml)
    stats = TD.DetectionStats()
    td = TD.detect_interest_points(tsd, ViewLoader(tsd),
                                   sorted(tsd.registrations),
                                   TD.DetectionParams(**kw), progress=False,
                                   device="cpu", stats=stats)
    return jd, td, stats, tsd


def _near_face(p, boxes, tol=PX_TOL):
    return any(np.all((p >= np.array(b.min) - tol) & (p <= np.array(b.max)
                                                      + tol))
               and np.any((np.abs(p - np.array(b.min)) <= tol)
                          | (np.abs(p - np.array(b.max)) <= tol))
               for b in boxes)


def _match(a, b, boxes=None):
    """One-to-one pairs (i, j) of a.points and b.points within PX_TOL; an
    unmatched point must lie on an overlap box face (``boxes``, full-res)."""
    if len(a.points) == 0 or len(b.points) == 0:
        assert len(a.points) == len(b.points) == 0
        return [], []
    d = np.linalg.norm(a.points[:, None] - b.points[None], axis=2)
    ia, ib = d.argmin(1), d.argmin(0)
    pairs = [(i, int(ia[i])) for i in range(len(a.points))
             if ib[ia[i]] == i and d[i, ia[i]] <= PX_TOL]
    ma = {i for i, _ in pairs}
    mb = {j for _, j in pairs}
    loose = ([a.points[i] for i in range(len(a.points)) if i not in ma]
             + [b.points[j] for j in range(len(b.points)) if j not in mb])
    for p in loose:
        assert boxes is not None and _near_face(p, boxes), (
            f"unmatched point {p} (not on an overlap box face)")
    if boxes is None:
        assert len(a.points) == len(b.points) == len(pairs)
    return [i for i, _ in pairs], [j for _, j in pairs]


def _full_res_boxes(tsd, view, ds):
    plan = TD._ViewPlan(ViewLoader(tsd), view, ds)
    boxes = TD._overlap_boxes_det(tsd, view, sorted(tsd.registrations),
                                  plan.det_dims, ds)
    f = np.array(ds, np.float64)
    return [type(b)(tuple(np.array(b.min) * f + (f - 1) / 2),
                    tuple(np.array(b.max) * f + (f - 1) / 2)) for b in boxes]


def _compare(jd, td, tsd, kw):
    assert [(v.view.timepoint, v.view.setup) for v in jd] == [
        (v.view.timepoint, v.view.setup) for v in td]
    for a, b in zip(jd, td):
        boxes = (_full_res_boxes(tsd, b.view, TD.DetectionParams(
            **kw).downsampling) if kw.get("overlapping_only") else None)
        ia, ib = _match(a, b, boxes)
        np.testing.assert_allclose(b.values[ib], a.values[ia], rtol=0,
                                   atol=VAL_ATOL)
        if kw.get("store_intensities") and len(ia):
            np.testing.assert_allclose(b.intensities[ib], a.intensities[ia],
                                       rtol=1e-5)
        else:
            assert b.intensities is None or not len(b.points)


CASES = {
    "ds1": dict(downsample_xy=1, downsample_z=1, block_size=(48, 48, 48)),
    "ds2": dict(downsample_xy=2, block_size=(24, 24, 48)),
    "overlap+intensities": dict(downsample_xy=1, downsample_z=1,
                                overlapping_only=True,
                                store_intensities=True,
                                block_size=(48, 48, 48)),
    "maxSpots": dict(downsample_xy=1, downsample_z=1, max_spots=5,
                     block_size=(48, 48, 48)),
    "maxSpotsPerOverlap": dict(downsample_xy=2, overlapping_only=True,
                               max_spots=6, max_spots_per_overlap=True,
                               store_intensities=True,
                               block_size=(24, 24, 48)),
    "medianFilter": dict(downsample_xy=2, median_radius=8, min_intensity=0.0,
                         max_intensity=10.0, block_size=(24, 24, 48)),
    "localization NONE": dict(downsample_xy=1, downsample_z=1,
                              localization="NONE", block_size=(48, 48, 48)),
}


# minima and stored levels, on ``project_levels`` (module docstring)
NEAR_TIE_CASES = {
    "MIN ds1": dict(find_max=False, find_min=True, downsample_xy=1,
                    downsample_z=1, threshold=0.002, block_size=(48, 48, 48)),
    "BOTH ds2 (stored level 1)": dict(find_max=True, find_min=True,
                                      downsample_xy=2, threshold=0.004,
                                      block_size=(24, 24, 48)),
    "MAX ds4,2 (stored level 2)": dict(downsample_xy=4, downsample_z=2),
}


def _spy(monkeypatch, module, record, to_numpy):
    real = module.dog_block_topk_batch

    def spy(*args, **kw):
        out = real(*args, **kw)
        record.append((args, [to_numpy(o) for o in out]))
        return out

    monkeypatch.setattr(module, "dog_block_topk_batch", spy)


def _fit_lambda(dog, p, shape):
    """Smallest |eigenvalue| of the quadratic fit's Hessian (float64) along
    the moves the fit takes from voxel ``p``."""
    p = np.array(p, np.int64)
    eye = np.eye(3, dtype=np.int64)
    lam = np.inf
    for _ in range(4):
        if np.any(p < 1) or np.any(p > np.array(shape) - 2):
            break
        at = lambda q: float(dog[tuple(q)])
        c = at(p)
        g = np.array([0.5 * (at(p + eye[d]) - at(p - eye[d])) for d in range(3)])
        h = np.zeros((3, 3))
        for d in range(3):
            h[d, d] = at(p + eye[d]) - 2 * c + at(p - eye[d])
            for e in range(d + 1, 3):
                h[d, e] = h[e, d] = 0.25 * (
                    at(p + eye[d] + eye[e]) - at(p + eye[d] - eye[e])
                    - at(p - eye[d] + eye[e]) + at(p - eye[d] - eye[e]))
        lam = min(lam, float(np.abs(np.linalg.eigvalsh(h)).min()))
        if abs(np.linalg.det(h)) <= 1e-12:
            break
        off = np.clip(-np.linalg.solve(h, g), -1.0, 1.0)
        moved = np.abs(off) > 0.5
        if not moved.any():
            break
        p = p + np.where(moved, np.sign(off).astype(np.int64), 0)
    return lam


def _compare_candidates(jrec, trec):
    """The near-tie contract on each block's candidates; returns (flips,
    largest fit difference in det-res px)."""
    import jax.numpy as jnp
    from bigstitcher_spark_tpu.ops import dog as JO
    from bigstitcher_spark_tpu_torch.ops import dog as TO

    assert len(jrec) == len(trec)
    flips, worst = 0, 0.0
    for (jargs, jout), (targs, tout) in zip(jrec, trec):
        blocks = np.asarray(jargs[0])
        assert np.array_equal(blocks, targs[0].numpy())
        lo, hi, thr, org = (np.asarray(v) for v in jargs[1:5])
        sigma, fmax, fmin, _, _, rel = jargs[5:]
        x = torch.from_numpy(blocks)
        if tuple(rel) != (1, 1, 1):
            x = TO.downsample_block_plain(x, tuple(rel))
        tdog, _ = TO.dog_block_batch(x, lo, hi, thr, sigma, fmax, fmin, org,
                                     stages=TO.PLAIN)
        tdog = tdog.numpy()
        for b in range(len(blocks)):
            jdog = np.asarray(JO.dog_block(
                jnp.asarray(x[b].numpy()), lo[b], hi[b], thr[b], sigma, fmax,
                fmin, jnp.asarray(org[b]))[0])
            assert np.abs(jdog - tdog[b]).max() <= RESP_TOL
            cands = []
            for idx, sub, val, valid, _ in (jout, tout):
                cands.append({tuple(int(v) for v in i): (s, float(v))
                              for i, s, v, ok in zip(idx[b], sub[b], val[b],
                                                     valid[b]) if ok})
            jc, tc = cands
            tb = np.asarray(JO._tiebreak(tdog[b].shape, jnp.asarray(org[b])))
            for key in set(jc) ^ set(tc):
                flips += 1
                p = np.array(key)
                win = tuple(slice(max(v - 1, 0), v + 2) for v in p)
                near = abs(abs(tdog[b][key]) - thr[b]) <= RESP_TOL
                for field in (tdog[b] + tb, tdog[b] - tb):
                    gaps = np.sort(np.abs(field[win].ravel() - field[key]))
                    near |= bool(gaps[1] <= TIE_TOL)
                assert near, f"candidate {key} flipped without a near tie"
            for key in set(jc) & set(tc):
                d = float(np.linalg.norm(jc[key][0] - tc[key][0]))
                if d > PX_TOL:
                    lam = _fit_lambda(tdog[b].astype(np.float64), key,
                                      tdog[b].shape)
                    assert d <= FIT_GAIN / lam, (key, d, lam)
                assert abs(jc[key][1] - tc[key][1]) <= VAL_ATOL + 0.01 * d
                worst = max(worst, d)
    return flips, worst


def _compare_near_ties(jd, td, kw, flips, worst):
    """Final points one to one within the largest fit difference, apart
    from at most ``flips`` points (all views)."""
    tol = PX_TOL + worst * max(TD.DetectionParams(**kw).downsampling)
    loose = 0
    for a, b in zip(jd, td):
        assert (a.view.timepoint, a.view.setup) == (b.view.timepoint,
                                                    b.view.setup)
        assert abs(len(a.points) - len(b.points)) <= MAX_FLIPS
        d = np.linalg.norm(a.points[:, None] - b.points[None], axis=2)
        # greedy by distance: two candidates may fit to one position
        used_a, used_b = set(), set()
        for i, j in zip(*np.unravel_index(np.argsort(d, axis=None), d.shape)):
            if d[i, j] > tol:
                break
            if i not in used_a and j not in used_b:
                used_a.add(i)
                used_b.add(j)
        loose += len(a.points) + len(b.points) - 2 * len(used_a)
    assert loose <= flips


@pytest.mark.parametrize("case", sorted(CASES) + sorted(NEAR_TIE_CASES))
def test_detect_interest_points_matches_jax(request, monkeypatch, case):
    if case in NEAR_TIE_CASES:
        kw = NEAR_TIE_CASES[case]
        project = request.getfixturevalue("project_levels")
        jrec, trec = [], []
        _spy(monkeypatch, JD, jrec, np.asarray)
        _spy(monkeypatch, TD, trec, lambda t: t.numpy())
        jd, td, stats, tsd = _run_both(project.xml_path, **kw)
        flips, worst = _compare_candidates(jrec, trec)
        _compare_near_ties(jd, td, kw, flips, worst)
    else:
        kw = CASES[case]
        project = request.getfixturevalue("project")
        jd, td, stats, tsd = _run_both(project.xml_path, **kw)
        _compare(jd, td, tsd, kw)
    assert sum(len(d.points) for d in td) > 0
    assert stats.blocks > 0 and stats.core_voxels > 0
    assert stats.points == sum(len(d.points) for d in td)
    if kw.get("max_spots") and not kw.get("max_spots_per_overlap"):
        assert all(len(d.points) == kw["max_spots"] for d in td)


def test_truncation_warns_and_matches_jax(project):
    """K = 4 candidates a block: the same 4 strongest of each block as the
    JAX package, and a warning naming the truncation."""
    kw = dict(downsample_xy=1, downsample_z=1, block_size=(96, 96, 48),
              max_candidates_per_block=4)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        jd, td, stats, tsd = _run_both(project.xml_path, **kw)
    assert sum("strongest" in str(x.message) for x in w) == 4  # 2 + 2
    assert stats.truncated == 2
    _compare(jd, td, tsd, kw)
    assert [len(d.points) for d in td] == [4, 4]


def test_port_recovers_the_beads(project):
    """The JAX package's own gate (tests/test_detection.py:112) on the
    port: most true beads 6 px inside a view are found within 1 px."""
    sd = SpimData.load(project.xml_path)
    dets = TD.detect_interest_points(
        sd, ViewLoader(sd), sorted(sd.registrations),
        TD.DetectionParams(downsample_xy=1, downsample_z=1,
                           block_size=(64, 64, 64)),
        progress=False, device="cpu")
    for det in dets:
        local = project.bead_positions - project.true_offsets[det.view.setup]
        inside = np.all((local >= 6) & (local <= np.array([96, 96, 48]) - 7),
                        axis=1)
        local = local[inside]
        assert len(det.points) >= 0.7 * len(local)
        d = np.linalg.norm(local[:, None] - det.points[None], axis=2)
        assert (d.min(axis=1) < 1.0).mean() > 0.8


def test_cli_writes_store_and_xml_like_jax(project, tmp_path):
    """The port's CLI and the JAX CLI on two copies of the project: the
    same points in each store (read by both packages' stores), and the same
    label and parameter string in each XML."""
    from click.testing import CliRunner

    src = os.path.dirname(project.xml_path)
    name = os.path.basename(project.xml_path)
    copies = {}
    for who in ("jax", "port"):
        d = str(tmp_path / who)
        shutil.copytree(src, d, ignore=shutil.ignore_patterns(
            "interestpoints.n5"))
        copies[who] = os.path.join(d, name)
    args = ["-x", None, "-dsxy", "1", "-dsz", "1", "--blockSize", "48,48,48",
            "-l", "beads", "--storeIntensities"]
    args[1] = copies["jax"]
    res = CliRunner().invoke(jax_cli, ["detect-interestpoints", *args])
    assert res.exit_code == 0, res.output
    args[1] = copies["port"]
    run = torch_main(["detect-interestpoints", *args, "--device", "cpu"])
    assert run.stats.timings["store"] > 0
    jsd, tsd = JSpimData.load(copies["jax"]), SpimData.load(copies["port"])
    for det in run.detections:
        t, s = det.view.timepoint, det.view.setup
        jl = jsd.interest_points[JViewId(t, s)]["beads"]
        tl = tsd.interest_points[ViewId(t, s)]["beads"]
        assert (tl.label, tl.params, tl.path) == (jl.label, jl.params,
                                                  jl.path)
        mine = [InterestPointStore.for_project(tsd).load_points(
                    ViewId(t, s), "beads"),
                JStore.for_project(JSpimData.load(copies["port"])
                                   ).load_points(JViewId(t, s), "beads")]
        for ids, locs in mine:
            assert np.array_equal(ids, np.arange(len(det.points)))
            np.testing.assert_allclose(locs, det.points, rtol=0, atol=1e-12)
        jids, jlocs = JStore.for_project(jsd).load_points(JViewId(t, s),
                                                          "beads")
        d = np.linalg.norm(jlocs[:, None] - det.points[None], axis=2)
        assert len(jlocs) == len(det.points) and d.min(1).max() <= PX_TOL


def test_cli_dry_run_saves_nothing(project, tmp_path):
    d = str(tmp_path / "dry")
    shutil.copytree(os.path.dirname(project.xml_path), d,
                    ignore=shutil.ignore_patterns("interestpoints.n5"))
    xml = os.path.join(d, os.path.basename(project.xml_path))
    run = torch_main(["detect-interestpoints", "-x", xml, "-dsxy", "2",
                      "--blockSize", "24,24,48", "--device", "cpu",
                      "--dryRun", "--type", "BOTH"])
    assert sum(len(x.points) for x in run.detections) > 0
    assert not os.path.exists(os.path.join(d, "interestpoints.n5"))
    assert not SpimData.load(xml).interest_points


def test_params_string_equals_jax():
    for kw in ({}, dict(sigma=2.0, threshold=0.01, overlapping_only=True,
                        min_intensity=0.0, max_intensity=5.0,
                        downsample_xy=4, downsample_z=2)):
        assert (TD.DetectionParams(**kw).params_string()
                == JD.DetectionParams(**kw).params_string())


def test_not_yet_ported_paths_are_refused():
    # descriptor extraction is ported: it runs (here on no view), and only
    # a pool beyond K19's 8 neighbours a point is refused
    assert TD.detect_interest_points(None, None, [], TD.DetectionParams(
        extract_descriptors=True), device="cpu") == []
    with pytest.raises(ValueError, match="neighbours a point"):
        TD.detect_interest_points(None, None, [], TD.DetectionParams(
            extract_descriptors=True, descriptor_neighbors=6,
            descriptor_redundancy=3), device="cpu")
    # the sharded route is ported: it runs (here on no view)
    assert TD.detect_interest_points(None, None, [], devices=2,
                                     device="cpu") == []

    class Streamed:  # a dataset served from a streamed producer's blocks
        shape = (8, 8, 8)
        read_device = staticmethod(lambda lo, size: None)

    class Loader:
        def open(self, view, level):
            return Streamed()

    with pytest.raises(NotYetPorted, match="read_device"):
        TD._read_mirror(Loader(), None, 0, (0, 0, 0), (4, 4, 4))


# ------------------------------------------------ detection with descriptors

ROT_ATOL = 1e-4  # tests/test_torch_descriptors.py's frame tolerance


def _bead_blocks(shape, n, seed):
    """Two uint16 blocks of Gaussian beads (sigma 1.8, amplitude 1000) on
    a noisy background of 100."""
    rng = np.random.default_rng(seed)
    grid = np.meshgrid(*(np.arange(s, dtype=np.float64) for s in shape),
                       indexing="ij")
    out = []
    for _ in range(2):
        vol = rng.normal(100.0, 2.0, shape)
        for p in rng.uniform(0, np.array(shape) - 1, (n, 3)):
            vol += 1000.0 * np.exp(-sum((g - c) ** 2 for g, c in zip(grid, p))
                                   / (2 * 1.8 ** 2))
        out.append(np.round(vol).astype(np.uint16))
    return np.stack(out)


@pytest.mark.parametrize("rel", [(1, 1, 1), (2, 2, 1)], ids=str)
@pytest.mark.parametrize("find_min", [False, True], ids=["MAX", "BOTH"])
def test_dog_detect_extract_batch_matches_jax(find_min, rel):
    """The detect-and-extract program on 2 random bead blocks of 32x32x16
    at detection resolution, k = 64: its DoG part is dog_block_topk_batch
    bit for bit and meets this module's candidate contract against JAX's
    (_compare_candidates); dvalid equals JAX's; the descriptors are within
    ROT_ATOL of JAX's descriptor half run on the port's own candidates (the
    fits differ from JAX's by up to the contract's bound, and a frame built
    on offsets of a few px turns such differences into larger ones)."""
    import jax.numpy as jnp
    from bigstitcher_spark_tpu.ops import descriptors as JDS
    from bigstitcher_spark_tpu.ops import dog as JO
    from bigstitcher_spark_tpu_torch.ops import dog as TO

    blocks = _bead_blocks((32 * rel[0], 32 * rel[1], 16 * rel[2]),
                          14 * rel[0] * rel[1], 30)
    args = (blocks, np.zeros(2, np.float32), np.full(2, 1100.0, np.float32),
            np.full(2, 0.004, np.float32),
            np.array([[-3, -3, -3], [29, -3, 13]], np.int32), 1.8, True,
            find_min, 64, 3, rel)
    want = [np.asarray(a) for a in JO.dog_detect_extract_batch(
        *args, 3, 1, True)]
    targs = (torch.from_numpy(blocks), *args[1:])
    got = TO.dog_detect_extract_batch(*targs, 3, 1, True)
    topk = TO.dog_block_topk_batch(*targs)
    assert all(torch.equal(a, b) for a, b in zip(got[:5], topk))
    got = [t.numpy() for t in got]
    _compare_candidates([(args, want[:5])], [(targs, got[:5])])
    assert np.array_equal(got[3], want[3]) and np.array_equal(got[6], want[6])
    assert got[6].sum() > 5 and not got[5][~got[6]].any()
    jdesc, jdv = JDS.block_descriptors_batch(jnp.asarray(got[1]),
                                             jnp.asarray(got[3]), 3, 1, True)
    assert np.array_equal(got[6], np.asarray(jdv))
    np.testing.assert_allclose(got[5], np.asarray(jdesc), rtol=0,
                               atol=ROT_ATOL)


@pytest.fixture(scope="module")
def project_desc(tmp_path_factory):
    """tests/test_megafusion.py's detect-and-extract fixture."""
    return make_synthetic_project(
        str(tmp_path_factory.mktemp("det_desc") / "proj"),
        n_tiles=(2, 1, 1), tile_size=(64, 64, 32), overlap=16, jitter=1.0,
        n_beads_per_tile=20, seed=7)


DESC_CASES = {
    "ds1": dict(downsample_xy=1, block_size=(64, 64, 32)),
    "ds2 overlappingOnly": dict(downsample_xy=2, overlapping_only=True,
                                block_size=(32, 32, 32)),
    "maxSpots": dict(downsample_xy=1, block_size=(64, 64, 32), max_spots=12),
    "medianFilter": dict(downsample_xy=2, median_radius=8, min_intensity=0.0,
                         max_intensity=10.0, block_size=(32, 32, 32)),
    "empty views, n 2 r 2": dict(downsample_xy=1, block_size=(64, 64, 32),
                                 threshold=10.0, descriptor_neighbors=2,
                                 descriptor_redundancy=2),
}


@pytest.mark.parametrize("case", sorted(DESC_CASES))
def test_detect_with_descriptors_matches_jax(project_desc, case):
    """detect_interest_points(extract_descriptors=True) against the JAX
    package's (its fused program): points and values as in
    test_detect_interest_points_matches_jax; each point's descriptors
    (S, 3n) float32 within ROT_ATOL of JAX's and its validity equal; a
    view without points carries JAX's (0, S, 3n) and (0,) riders."""
    # 64 candidate slots a block (20 beads a tile), as test_megafusion.py
    kw = dict(DESC_CASES[case], extract_descriptors=True,
              max_candidates_per_block=64)
    jd, td, stats, tsd = _run_both(project_desc.xml_path, **kw)
    _compare(jd, td, tsd, kw)
    p = TD.DetectionParams(**kw)
    n = p.descriptor_neighbors
    S = len(TD.subset_combinations(n + p.descriptor_redundancy, n))
    for a, b in zip(jd, td):
        assert b.descriptors.dtype == np.float32
        assert b.descriptor_valid.dtype == bool
        assert b.descriptors.shape == (len(b.points), S, 3 * n)
        assert b.descriptors.shape == a.descriptors.shape
        assert b.descriptor_valid.shape == a.descriptor_valid.shape
        boxes = (_full_res_boxes(tsd, b.view, p.downsampling)
                 if p.overlapping_only else None)
        ia, ib = _match(a, b, boxes)
        assert np.array_equal(b.descriptor_valid[ib], a.descriptor_valid[ia])
        np.testing.assert_allclose(b.descriptors[ib], a.descriptors[ia],
                                   rtol=0, atol=ROT_ATOL)
    total = sum(len(d.points) for d in td)
    assert (total == 0) == (p.threshold > 1.0)
    if total:
        assert sum(int(d.descriptor_valid.sum()) for d in td) > 0
