"""The port's ``shard_jit`` routes on the CPU: detection, the downsample
stage and nonrigid fusion over a mesh of ``[cpu] * 4``.

* Each sharded route's output equals the port's one-device output bitwise
  (every per-row program is independent of its batch and its neighbours):
  detection's points, values and descriptors, the downsample stage's
  levels, nonrigid fusion's volume.
* Against the JAX package's sharded routes on the suite's 8 virtual XLA
  devices, with the fixtures of JAX tests/test_mesh_stages.py:
  detection under the contract of tests/test_torch_detection.py (points
  one to one within 1e-4 px, values within 1e-6; the JAX side blurs with
  mirrored edges, ``BST_DOG_BLUR=gemm``), the downsample stage bitwise
  (with the numpy 2x2x2 golden), nonrigid fusion within |delta| <= 1
  (uint16; float32 sums round differently in XLA and torch).
* K26's batch twin equals the per-block twin row by row, bitwise, with a
  padding row (zeros) and each fusion type.
* ``shard_batch`` on a stand-in program: the row split, the replicated
  arguments, the per-device outputs; ``make_sharded_fuser`` built on it
  gives the batch kernel and K28's twin's outputs unchanged.
* The CLI: ``nonrigid-fusion --devices 4`` writes the container of
  ``--devices 1``; ``affine-fusion --devices 4 --pyramid`` hands
  ``devices`` to the downsample stage.
"""

import jax
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
from bigstitcher_spark_tpu.models import detection as JD
from bigstitcher_spark_tpu.models import downsample_driver as JDS
from bigstitcher_spark_tpu.models import nonrigid_fusion as JNR
from bigstitcher_spark_tpu.utils.grid import create_grid as jax_grid
from bigstitcher_spark_tpu.utils.testdata import make_synthetic_project
from bigstitcher_spark_tpu.utils.viewselect import (
    maximal_bounding_box as jax_bbox,
)
from bigstitcher_spark_tpu_torch.cli.main import main as torch_main
from bigstitcher_spark_tpu_torch.io import container as TC
from bigstitcher_spark_tpu_torch.io.chunkstore import ChunkStore, StorageFormat
from bigstitcher_spark_tpu_torch.io.dataset_io import ViewLoader
from bigstitcher_spark_tpu_torch.io.interestpoints import InterestPointStore
from bigstitcher_spark_tpu_torch.io.spimdata import SpimData
from bigstitcher_spark_tpu_torch.models import detection as TD
from bigstitcher_spark_tpu_torch.models import downsample_driver as TDS
from bigstitcher_spark_tpu_torch.models import nonrigid_fusion as TNR
from bigstitcher_spark_tpu_torch.ops import epilogue as E
from bigstitcher_spark_tpu_torch.ops import nonrigid as NR
from bigstitcher_spark_tpu_torch.parallel import mesh as M
from bigstitcher_spark_tpu_torch.utils.grid import create_grid
from bigstitcher_spark_tpu_torch.utils.viewselect import maximal_bounding_box

CPU = torch.device("cpu")
CPU4 = [CPU] * 4
PX_TOL = 1e-4   # tests/test_torch_detection.py's contract against JAX
VAL_ATOL = 1e-6
FTYPES = ("AVG", "AVG_BLEND", "MAX_INTENSITY", "FIRST_WINS", "LAST_WINS")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_mirrored_jax_blur():
    # torch's CPU pool is far slower than one thread on small tensors here;
    # JAX's CPU blur defaults to an FFT with circular edges
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
    """JAX tests/test_mesh_stages.py's project."""
    return make_synthetic_project(
        str(tmp_path_factory.mktemp("mesh_stages") / "proj"),
        n_tiles=(2, 2, 1), tile_size=(48, 48, 24), overlap=12,
        jitter=2.0, seed=17, block_size=(16, 16, 8), n_beads_per_tile=15,
    )


# ---------------------------------------------------------- shard_batch


@pytest.mark.parametrize("n_rows,n_mesh", [(8, 4), (6, 4), (3, 4), (5, 1)])
def test_shard_batch_rows_replicas_and_outputs(n_rows, n_mesh):
    mesh = M.make_mesh(devices=[CPU] * n_mesh)
    calls = []

    def fn(scale, offs, x, y):
        calls.append((scale, offs, int(x.shape[0])))
        return x * scale + offs, y.sum(dim=1)

    x = np.arange(n_rows * 3, dtype=np.float32).reshape(n_rows, 3)
    y = torch.arange(n_rows * 2, dtype=torch.int64).reshape(n_rows, 2)
    offs = np.float32([10, 20, 30])
    shards = M.shard_batch(fn, mesh, n_repl=2)(None, 2.0, offs, x, y)
    cuts = [(a, b) for a, b in M._rows_of(n_rows, n_mesh) if b > a]
    assert [(s.row0, int(s.outs[0].shape[0])) for s in shards] == [
        (a, b - a) for a, b in cuts]
    for s, (a, b) in zip(shards, cuts):
        assert s.device == CPU and s.start is None and s.end is None
        assert len(s.outs) == 2 and s.h2d >= 0 and s.host_kernel >= 0
        assert np.array_equal(s.outs[0].numpy(), x[a:b] * 2 + offs)
        assert np.array_equal(s.outs[1].numpy(), y[a:b].sum(1).numpy())
    # scalars as they are; an array uploaded once for the repeated device
    assert all(c[0] == 2.0 for c in calls)
    assert all(isinstance(c[1], torch.Tensor) for c in calls)
    assert len({id(c[1]) for c in calls}) == 1
    assert sum(c[2] for c in calls) == n_rows


def test_shard_batch_single_output_is_a_tuple():
    shards = M.shard_batch(lambda x: x + 1, M.make_mesh(devices=CPU4))(
        None, np.zeros((4, 2), np.float32))
    assert [len(s.outs) for s in shards] == [1] * 4
    assert all(float(s.outs[0].sum()) == 2.0 for s in shards)


def test_group_items():
    assert M.group_items(range(10), 4, 1) == [[0, 1, 2, 3], [4, 5, 6, 7],
                                              [8, 9]]
    assert M.group_items(range(5), 1, 4) == [[0, 1, 2, 3], [4]]
    assert M.group_items([], 4, 4) == []


def _fuser_inputs(kind, rng, B=4, V=2, bs=(12, 10, 8)):
    """A bucket's stacked inputs in the fuser's order, the last row
    padding (zero patches, valid 0)."""
    shape = (B, V)

    def pv(lo, hi):
        return rng.uniform(lo, hi, (*shape, 3)).astype(np.float32)

    if kind == "shift":
        patches = rng.integers(0, 4000, (*shape, *(s + 1 for s in bs)))
        fr = pv(0, 1)
        head = (fr, pv(-5, 20) + fr)
    else:
        patches = rng.integers(0, 4000, (*shape, 16, 14, 10))
        if kind == "sep":
            head = (pv(0.5, 1.5), pv(-2, 4), pv(0, 30))
        else:
            aff = np.zeros((*shape, 3, 4), np.float32)
            a = np.deg2rad(rng.uniform(-10, 10, shape))
            aff[..., 0, 0] = aff[..., 1, 1] = np.cos(a)
            aff[..., 0, 1], aff[..., 1, 0] = -np.sin(a), np.sin(a)
            aff[..., 2, 2] = 1.0
            aff[..., 3] = rng.uniform(-2, 4, (*shape, 3))
            head = (aff, pv(0, 30))
    patches = patches.astype(np.uint16)
    patches[-1] = 0
    valid = np.ones(shape, np.float32)
    valid[-1] = 0
    tail = (np.tile(np.float32([40, 30, 20]), (*shape, 1)), pv(0, 3),
            pv(5, 30), valid, pv(0, 2))
    return (patches, *head, *tail), bs


@pytest.mark.parametrize("kind", ["shift", "sep", "gather"])
def test_make_sharded_fuser_outputs_unchanged(kind):
    """The fuser on shard_batch: each device's rows are the batch kernel's
    and K28's twin's on those rows (uint16 with a (2, 2, 2) level)."""
    stacked, bs = _fuser_inputs(kind, np.random.default_rng(41))
    fuser = M.make_sharded_fuser(M.make_mesh(devices=CPU4), bs,
                                 kernel=kind, out_dtype="uint16",
                                 pyramid=((2, 2, 2),))
    shards = fuser(0.0, 3000.0, *stacked)
    run = M._BATCH_KERNELS[kind]
    ts = [torch.from_numpy(a) for a in stacked]
    fused, wsum = run(*ts[:-1], bs, "AVG_BLEND", inside_offs=ts[-1])
    want = E.block_epilogue(fused, wsum, 0.0, 3000.0, "uint16", False,
                            ((2, 2, 2),))
    assert [s.row0 for s in shards] == [0, 1, 2, 3]
    for s in shards:
        assert len(s.outs) == len(want) == 2
        for got, ref in zip(s.outs, want):
            assert torch.equal(got, ref[s.row0:s.row0 + 1])
    assert int(want[0][0].to(torch.int32).max()) > 0


# -------------------------------------------------------- K26 batch twin


def _nonrigid_rows(rng, B=3, V=3, bs=(10, 12, 8), cpd=4.0):
    """B distinct rows of K26's inputs (uint16 patches, grids fitted to
    displaced points, rotated views, one view off in row 1) and a padding
    row (all zeros)."""
    ps = tuple(b + 8 for b in bs)
    gdims = TNR.control_grid_dims(bs, cpd)
    rows = []
    for b in range(B):
        bo = np.float32([300.0 + 7 * b, 200.5, 40.25 + b])
        go = bo - np.float32(cpd)
        grids = np.zeros((V, *gdims, 12), np.float32)
        vaff = np.zeros((V, 3, 4), np.float32)
        for v in range(V):
            t = bo + rng.uniform(-4, 16, (12, 3))
            vw = t + rng.normal(0, 0.6, (12, 3))
            grids[v] = NR.fit_control_grid(t, vw, go.astype(np.float64),
                                           gdims, cpd)
            ang = 0.04 * (v + b)
            lin = np.array([[np.cos(ang), -np.sin(ang), 0],
                            [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
            vaff[v, :, :3] = lin
            vaff[v, :, 3] = -lin @ bo + 4.0 + rng.uniform(-0.5, 0.5, 3)
        valid = np.ones(V, np.float32)
        if b == 1:
            valid[0] = 0.0
        rows.append((
            rng.integers(90, 4000, (V, *ps)).astype(np.uint16), grids, vaff,
            rng.uniform(0, 6, (V, 3)).astype(np.float32),
            np.tile(np.float32([60, 60, 30]), (V, 1)),
            rng.uniform(0, 2, (V, 3)).astype(np.float32),
            rng.uniform(4, 12, (V, 3)).astype(np.float32), valid, bo, go,
            np.full(3, cpd, np.float32)))
    rows.append(tuple(np.zeros_like(a) for a in rows[0]))
    return [torch.from_numpy(np.stack([r[j] for r in rows]))
            for j in range(11)], bs


@pytest.mark.parametrize("fusion_type", FTYPES)
def test_nonrigid_batch_twin_equals_per_block_twin(fusion_type):
    args, bs = _nonrigid_rows(np.random.default_rng(7))
    fused, wsum = NR.nonrigid_fuse_block_batch(*args, bs, fusion_type)
    assert fused.shape == wsum.shape == (4, *bs)
    # the padding row (grid spacing 0) is no input of the per-block twin
    for b in range(3):
        f, w = NR.nonrigid_fuse_block_plain(*(a[b] for a in args), bs,
                                            fusion_type)
        assert torch.equal(fused[b], f) and torch.equal(wsum[b], w)
    assert len({float(f.sum()) for f in fused[:3]}) == 3
    assert float(wsum[0].max()) > 0
    assert not fused[-1].any() and not wsum[-1].any()  # the padding row
    # the batch form launches nothing on the CPU
    assert NR.nonrigid_fuse_block_batch.launches == 0


# ------------------------------------------------------------ detection


# one block shape a case (one JAX compile on 8 devices each)
DET_CASES = {
    "ds1": dict(downsample_xy=1, downsample_z=1, block_size=(24, 24, 24)),
    "ds2": dict(downsample_xy=2, downsample_z=1, block_size=(24, 24, 24)),
}


def _port_detect(xml, devices, **kw):
    sd = SpimData.load(xml)
    stats = TD.DetectionStats()
    dets = TD.detect_interest_points(sd, ViewLoader(sd),
                                     sorted(sd.registrations),
                                     TD.DetectionParams(**kw), progress=False,
                                     devices=devices, device="cpu",
                                     stats=stats)
    return dets, stats


def _match(a, b):
    """One-to-one pairs of a.points and b.points within PX_TOL, every
    point paired (tests/test_torch_detection.py's contract)."""
    assert len(a.points) == len(b.points)
    if not len(a.points):
        return [], []
    d = np.linalg.norm(a.points[:, None] - b.points[None], axis=2)
    ia, ib = d.argmin(1), d.argmin(0)
    pairs = [(i, int(ia[i])) for i in range(len(a.points))
             if ib[ia[i]] == i and d[i, ia[i]] <= PX_TOL]
    assert len(pairs) == len(a.points)
    return [i for i, _ in pairs], [j for _, j in pairs]


@pytest.mark.parametrize("case", sorted(DET_CASES))
def test_sharded_detection_equals_one_device_and_jax(project, case):
    kw = DET_CASES[case]
    one, _ = _port_detect(project.xml_path, 1, **kw)
    four, stats = _port_detect(project.xml_path, 4, **kw)
    assert stats.mesh == ("cpu",) * 4 and stats.batches > 0
    rel = 4 if case == "ds2" else 1
    assert stats.per_dev == [max(1, 2 // rel)] * stats.buckets
    assert sum(len(d.points) for d in four) > 0
    for a, b in zip(one, four):
        assert a.view == b.view
        assert np.array_equal(a.points, b.points)
        assert np.array_equal(a.values, b.values)
    jsd = JSpimData.load(project.xml_path)
    jd = JD.detect_interest_points(jsd, JViewLoader(jsd),
                                   sorted(jsd.registrations),
                                   JD.DetectionParams(**kw), progress=False,
                                   devices=8)
    assert [(v.view.timepoint, v.view.setup) for v in jd] == [
        (v.view.timepoint, v.view.setup) for v in four]
    for a, b in zip(jd, four):
        ia, ib = _match(a, b)
        np.testing.assert_allclose(b.values[ib], a.values[ia], rtol=0,
                                   atol=VAL_ATOL)


def test_sharded_detection_with_descriptors_equals_one_device(project):
    """Eight block shapes (edge blocks), in one loop; 256 candidate slots
    a block keep K19's twin quick."""
    kw = dict(downsample_xy=1, downsample_z=1, block_size=(32, 32, 16),
              extract_descriptors=True, max_candidates_per_block=256)
    one, _ = _port_detect(project.xml_path, 1, **kw)
    four, stats = _port_detect(project.xml_path, 4, **kw)
    assert stats.mesh == ("cpu",) * 4 and stats.buckets == 8
    assert sum(int(d.descriptor_valid.sum()) for d in four) > 0
    for a, b in zip(one, four):
        assert np.array_equal(a.points, b.points)
        assert np.array_equal(a.values, b.values)
        assert np.array_equal(a.descriptors, b.descriptors)
        assert np.array_equal(a.descriptor_valid, b.descriptor_valid)


# ------------------------------------------------------------ downsample


def test_sharded_downsample_equals_single_golden_and_jax(tmp_path):
    """JAX tests/test_mesh_stages.py's case: a (48, 40, 24) uint16 volume
    averaged 2x2x2 in (16, 16, 8) blocks."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 60000, (48, 40, 24)).astype(np.uint16)
    rel = (2, 2, 2)
    dims = [s // f for s, f in zip(data.shape, rel)]
    outs = {}
    for who in ("torch", "jax"):
        store = (ChunkStore.create(str(tmp_path / f"{who}.n5"),
                                   StorageFormat.N5) if who == "torch" else
                 JStore.create(str(tmp_path / f"{who}.n5"), JFormat.N5))
        src = store.create_dataset("s0", data.shape, (16, 16, 8), "uint16")
        src.write(data, (0, 0, 0))
        drv = TDS if who == "torch" else JDS
        for label, n_dev in (("multi", 8 if who == "jax" else 4),
                             ("single", 1)):
            dst = store.create_dataset(f"s1_{label}", dims, (16, 16, 8),
                                       "uint16")

            def read_job(blk, src=src, drv=drv):
                return drv.read_padded(
                    src.read, src.shape,
                    [o * f for o, f in zip(blk.offset, rel)],
                    [s * f for s, f in zip(blk.size, rel)])

            def write_job(blk, out, dst=dst, drv=drv):
                dst.write(drv._convert_to_dtype(out, dst.dtype), blk.offset)

            grid = (jax_grid if who == "jax" else create_grid)(dims,
                                                               (16, 16, 8))
            if who == "jax":
                JDS.run_sharded_downsample(grid, read_job, write_job, rel,
                                           devices=n_dev)
            elif n_dev > 1:
                n = TDS.run_sharded_downsample(grid, read_job, write_job,
                                               rel, n_dev, device="cpu")
                # one batch a source shape: no bucket holds 16 blocks
                assert n == len({tuple(b.size) for b in grid})
            else:
                TDS.run_downsample(grid, read_job, write_job, rel,
                                   device="cpu")
            outs[who, label] = dst.read_full()
    ref = data.reshape(24, 2, 20, 2, 12, 2).mean(axis=(1, 3, 5))
    ref = np.clip(np.round(ref), 0, 65535).astype(np.uint16)
    for key, got in outs.items():
        assert np.array_equal(got, ref), key


# -------------------------------------------------------------- nonrigid


@pytest.fixture(scope="module")
def nonrigid_project(tmp_path_factory):
    """JAX tests/test_mesh_stages.py's nonrigid case: 2 tiles of 64x64x32,
    overlap 24, seed 19, detected and matched by the JAX package."""
    from bigstitcher_spark_tpu.models.matching import (
        MatchingParams, match_interest_points, save_matches)

    root = tmp_path_factory.mktemp("nr_mesh")
    proj = make_synthetic_project(
        str(root / "proj"), n_tiles=(2, 1, 1), tile_size=(64, 64, 32),
        overlap=24, jitter=2.0, seed=19, n_beads_per_tile=25)
    sd = JSpimData.load(proj.xml_path)
    views = sorted(sd.registrations)
    dets = JD.detect_interest_points(
        sd, JViewLoader(sd), views,
        JD.DetectionParams(downsample_xy=1, downsample_z=1,
                           block_size=(64, 64, 32)), progress=False,
        devices=1)
    store = JIPStore(str(root / "proj" / "interestpoints.n5"))
    JD.save_detections(sd, store, dets, JD.DetectionParams())
    mparams = MatchingParams(ransac_min_inliers=5, ransac_iterations=2000,
                             model="TRANSLATION", regularization="NONE")
    res = match_interest_points(sd, views, mparams, store, progress=False)
    save_matches(sd, store, res, mparams, views)
    sd.save(proj.xml_path)
    return proj


NR_ARGS = dict(block_size=(32, 32, 16), block_scale=(1, 1, 1), cpd=10.0,
               out_dtype="uint16", min_intensity=0.0, max_intensity=65535.0)


def test_sharded_nonrigid_equals_single_and_jax(nonrigid_project, tmp_path):
    sd = SpimData.load(nonrigid_project.xml_path)
    views = sorted(sd.registrations)
    unique = TNR.build_unique_points(sd, InterestPointStore.for_project(sd),
                                     views, ["beads"])
    bbox = maximal_bounding_box(sd, views, None)
    vols, stats = {}, {}
    for n_dev in (4, 1):
        out = ChunkStore.create(str(tmp_path / f"nr{n_dev}.n5"),
                                StorageFormat.N5).create_dataset(
            "fused", bbox.shape, (32, 32, 16), "uint16")
        stats[n_dev] = TNR.fuse_nonrigid_volume(
            sd, ViewLoader(sd), views, unique, out, bbox, device="cpu",
            devices=n_dev, **NR_ARGS)
        assert stats[n_dev].voxels == bbox.num_elements
        vols[n_dev] = out.read_full()
    st = stats[4]
    assert st.path == "sharded" and st.mesh == ("cpu",) * 4
    assert st.batches == sum(b["batches"] for b in st.buckets) > 0
    assert st.kernel_blocks["nonrigid"] == sum(b["blocks"]
                                               for b in st.buckets)
    assert set(st.timings) == {"plan", "read", "h2d", "kernel", "d2h",
                               "write"}
    assert vols[4].std() > 0
    assert np.array_equal(vols[4], vols[1])

    jsd = JSpimData.load(nonrigid_project.xml_path)
    jviews = sorted(jsd.registrations)
    junique = JNR.build_unique_points(jsd, JIPStore.for_project(jsd), jviews,
                                      ["beads"])
    jb = jax_bbox(jsd, jviews, None)
    jout = JStore.create(str(tmp_path / "jax.n5"), JFormat.N5
                         ).create_dataset("fused", jb.shape, (32, 32, 16),
                                          "uint16")
    JNR.fuse_nonrigid_volume(jsd, JViewLoader(jsd), jviews, junique, jout,
                             jb, devices=8, **NR_ARGS)
    want = jout.read_full()
    assert want.shape == vols[4].shape
    assert np.abs(vols[4].astype(np.int64) - want.astype(np.int64)).max() <= 1


def _s0(path):
    store = ChunkStore.open(path)
    return [store.open_dataset(m.dataset.strip("/")).read_full()
            for m in TC.read_container_meta(store).mr_infos[0]]


def test_nonrigid_fusion_cli_devices_4(nonrigid_project, tmp_path):
    """``--devices 4 --device cpu`` runs (no NotYetPorted) and writes the
    container of ``--devices 1``, its pyramid through the sharded
    downsample stage."""
    vols = {}
    for n in ("4", "1"):
        out = str(tmp_path / f"nr{n}.ome.zarr")
        torch_main(["create-fusion-container", "-x",
                    nonrigid_project.xml_path, "-o", out, "-d", "UINT16",
                    "--blockSize", "32,32,16", "-ds", "1,1,1", "-ds",
                    "2,2,1"])
        (stats,) = torch_main(["nonrigid-fusion", "-o", out, "-l", "beads",
                               "--blockScale", "1,1,1", "--device", "cpu",
                               "--devices", n])
        assert stats.path == ("sharded" if n == "4" else "nonrigid")
        vols[n] = _s0(out)
    assert len(vols["4"]) == 2 and vols["4"][0].std() > 0
    for a, b in zip(vols["4"], vols["1"]):
        assert np.array_equal(a, b)


def test_affine_fusion_pyramid_hands_devices_to_downsample_stage(
        project, tmp_path, monkeypatch):
    """``affine-fusion --devices 4 --pyramid``: the epilogue makes level 1,
    the downsample stage the rest through ``run_sharded_downsample`` with
    ``devices`` 4; every level equals the one-device per-block run's."""
    seen = []
    real = TDS.run_sharded_downsample

    def spy(jobs, read_job, write_job, rel, devices, *a, **k):
        seen.append((tuple(rel), devices))
        return real(jobs, read_job, write_job, rel, devices, *a, **k)

    monkeypatch.setattr(TDS, "run_sharded_downsample", spy)
    levels = {}
    for n in ("4", "1"):
        out = str(tmp_path / f"a{n}.ome.zarr")
        torch_main(["create-fusion-container", "-x", project.xml_path, "-o",
                    out, "-s", "ZARR", "-d", "UINT16", "--blockSize",
                    "16,16,8", "-ds", "1,1,1", "-ds", "2,2,1", "-ds",
                    "4,4,2"])
        if n == "1":   # the per-block route, whose s0 the sharded equals
            monkeypatch.setenv("BST_DEVICE_TILE_BUDGET", "1")
        (stats,) = torch_main(["affine-fusion", "-o", out, "--device", "cpu",
                               "--devices", n, "--pyramid"])
        if n == "4":
            assert stats.path == "sharded" and stats.pyramid_levels == 1
        levels[n] = _s0(out)
    assert seen == [((2, 2, 2), 4)]
    assert len(levels["4"]) == 3 and levels["4"][2].std() > 0
    for a, b in zip(levels["4"], levels["1"]):
        assert np.array_equal(a, b)
