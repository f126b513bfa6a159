"""The port's ``stitching`` tool against the JAX package, on the CPU.

The JAX package's own fixture (tests/test_stitching.py): a 2x2x1 grid of
96x96x48 uint16 tiles, overlap 28, nominal offsets jittered by up to 3 px
(seed 3). The port runs with ``device="cpu"`` (the plain twins of K6-K10),
the JAX package on the CPU. A spy on the driver's ``pcm_peaks_batch``
captures the stacks the port sends to its PCM, and JAX's
``pcm_peaks_batch`` runs on the same stacks: where the peaks agree, the
port's shifts and correlations must equal JAX's bit for bit (float64 numpy
refinement of identical crops); elsewhere within 1e-6 px. Ground truth
within 0.75 px at ds 1,1,1 and 1.5 px at ds 2,2,1, as the JAX package's
tests hold JAX.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from bigstitcher_spark_tpu.cli.main import cli as jax_cli
from bigstitcher_spark_tpu.io.dataset_io import ViewLoader as JViewLoader
from bigstitcher_spark_tpu.io.spimdata import SpimData as JSpimData
from bigstitcher_spark_tpu.models import stitching as JS
from bigstitcher_spark_tpu.ops.phasecorr import pcm_peaks_batch as jax_peaks
from bigstitcher_spark_tpu.utils.testdata import make_synthetic_project
from bigstitcher_spark_tpu_torch.cli.main import main as torch_main
from bigstitcher_spark_tpu_torch.io.dataset_io import ViewLoader
from bigstitcher_spark_tpu_torch.io.spimdata import SpimData
from bigstitcher_spark_tpu_torch.models import stitching as TS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stitch_project(tmp_path_factory):
    return make_synthetic_project(
        str(tmp_path_factory.mktemp("stitch") / "proj"),
        n_tiles=(2, 2, 1), tile_size=(96, 96, 48), overlap=28,
        jitter=3.0, seed=3, n_beads_per_tile=60,
    )


def _key(res):
    return (tuple((v.timepoint, v.setup) for v in res.views_a),
            tuple((v.timepoint, v.setup) for v in res.views_b))


def _run_port(xml, params):
    """The port's results and, per pair key, whether its peaks equal the
    peaks JAX computes from the same stacks."""
    agree = {}
    staged = []
    stage, peaks_batch = TS._stage_bucket, TS.pcm_peaks_batch

    def stage_spy(jobs, shp, device):
        staged.append(jobs)
        return stage(jobs, shp, device)

    def peaks_spy(a, b, ea, eb, n_peaks, fade_frac):
        peaks = peaks_batch(a, b, ea, eb, n_peaks, fade_frac)
        ref = np.asarray(jax_peaks(a.numpy(), b.numpy(), ea.numpy(),
                                   eb.numpy(), n_peaks, fade_frac))
        for k, j in enumerate(staged[-1]):
            key = (tuple((v.timepoint, v.setup) for v in j.group_a.views),
                   tuple((v.timepoint, v.setup) for v in j.group_b.views))
            agree[key] = bool((peaks[k].numpy() == ref[k]).all())
        return peaks

    sd = SpimData.load(xml)
    TS._stage_bucket, TS.pcm_peaks_batch = stage_spy, peaks_spy
    try:
        res = TS.stitch_all_pairs(sd, ViewLoader(sd), sd.view_ids(), params,
                                  device="cpu", progress=False)
    finally:
        TS._stage_bucket, TS.pcm_peaks_batch = stage, peaks_batch
    return res, agree


def _run_jax(xml, params):
    sd = JSpimData.load(xml)
    return JS.stitch_all_pairs(sd, JViewLoader(sd), sd.view_ids(), params,
                               progress=False)


def _assert_same_results(mine, ref, agree):
    assert [_key(r) for r in mine] == [_key(r) for r in ref]
    for m, r in zip(mine, ref):
        if agree[_key(m)]:
            assert np.array_equal(m.transform, r.transform)
            assert m.correlation == r.correlation
        else:
            np.testing.assert_allclose(m.transform, r.transform, atol=1e-6)
        assert m.hash == r.hash and m.hash != 0.0
        assert tuple(m.bbox.min) == tuple(r.bbox.min)
        assert tuple(m.bbox.max) == tuple(r.bbox.max)


def _expected(proj, res):
    sa, sb = res.views_a[0].setup, res.views_b[0].setup
    return ((proj.true_offsets[sa] - proj.nominal_offsets[sa])
            - (proj.true_offsets[sb] - proj.nominal_offsets[sb]))


@pytest.mark.parametrize("ds,atol", [((1, 1, 1), 0.75), ((2, 2, 1), 1.5)],
                         ids=["ds111", "ds221"])
def test_stitching_matches_jax_and_ground_truth(stitch_project, ds, atol):
    params = dict(downsampling=ds)
    mine, agree = _run_port(stitch_project.xml_path,
                            TS.StitchingParams(**params))
    ref = _run_jax(stitch_project.xml_path, JS.StitchingParams(**params))
    assert len(mine) == 6  # 4 edge-adjacent + 2 diagonal corner overlaps
    assert all(agree.values())
    _assert_same_results(mine, ref, agree)
    checked = 0
    for res in mine:
        if res.correlation > 0.5:
            np.testing.assert_allclose(res.transform[:, 3],
                                       _expected(stitch_project, res),
                                       atol=atol)
            checked += 1
    assert checked >= 4


def test_pair_planning_matches_jax(stitch_project):
    sd, jsd = (SpimData.load(stitch_project.xml_path),
               JSpimData.load(stitch_project.xml_path))
    groups = TS.build_groups(sd, sd.view_ids())
    jgroups = JS.build_groups(jsd, jsd.view_ids())
    assert [g.key for g in groups] == [g.key for g in jgroups]
    pairs = TS.plan_pairs(sd, groups)
    jpairs = JS.plan_pairs(jsd, jgroups)
    assert [(a.key, b.key, tuple(o.min), tuple(o.max)) for a, b, o in pairs] \
        == [(a.key, b.key, tuple(o.min), tuple(o.max)) for a, b, o in jpairs]


def test_segmented_pipeline_matches_single_segment(stitch_project):
    """A 1-byte in-flight budget drains every bucket on its own; the
    results equal the one-segment run (scheduling, not math)."""
    one, _ = _run_port(stitch_project.xml_path,
                       TS.StitchingParams(downsampling=(1, 1, 1)))
    many, _ = _run_port(stitch_project.xml_path,
                        TS.StitchingParams(downsampling=(1, 1, 1),
                                           inflight_bytes=1, batch_size=1))
    assert [_key(r) for r in one] == [_key(r) for r in many]
    for a, b in zip(one, many):
        assert np.array_equal(a.transform, b.transform)
        assert a.correlation == b.correlation


def test_stitching_reads_stored_mipmap_level(tmp_path, monkeypatch):
    """With a stored 2,2,1 level and ds=2,2,1 the crops come from s1
    (residual 1,1,1, so K6 does not run) and match JAX."""
    proj = make_synthetic_project(
        str(tmp_path / "proj"), n_tiles=(2, 1, 1), tile_size=(96, 96, 48),
        overlap=28, jitter=3.0, seed=5,
        downsampling_factors=((1, 1, 1), (2, 2, 1)),
    )
    levels_read = []
    orig = ViewLoader.read_block

    def spy(self, view, level, offset, shape, pad_value=0.0):
        levels_read.append(level)
        return orig(self, view, level, offset, shape, pad_value)

    monkeypatch.setattr(ViewLoader, "read_block", spy)
    params = dict(downsampling=(2, 2, 1))
    mine, agree = _run_port(proj.xml_path, TS.StitchingParams(**params))
    assert levels_read and all(lv == 1 for lv in levels_read)
    _assert_same_results(mine, _run_jax(proj.xml_path,
                                        JS.StitchingParams(**params)), agree)
    (res,) = mine
    np.testing.assert_allclose(res.transform[:, 3], _expected(proj, res),
                               atol=1.5)


@pytest.fixture(scope="module")
def rotated_project(tmp_path_factory):
    """tests/test_stitching.py's rotated pair: view B registered with a 3
    degree z rotation, its content carrying a known world error."""
    from scipy.ndimage import affine_transform

    from bigstitcher_spark_tpu_torch.io.chunkstore import (
        ChunkStore, StorageFormat)
    from bigstitcher_spark_tpu_torch.io.dataset_io import (
        create_bdv_view_datasets)
    from bigstitcher_spark_tpu_torch.io.spimdata import (
        AttributeEntity, ImageLoader, ViewId, ViewSetup, ViewTransform)
    from bigstitcher_spark_tpu_torch.utils.geometry import translation_affine
    from bigstitcher_spark_tpu_torch.utils.testdata import make_bead_volume

    out = tmp_path_factory.mktemp("rotproj")
    world, _ = make_bead_volume((120, 96, 40), n_beads=160, seed=21)
    tile_size = (72, 96, 40)
    theta = np.deg2rad(3.0)
    rot = np.array([[np.cos(theta), -np.sin(theta), 0.0],
                    [np.sin(theta), np.cos(theta), 0.0],
                    [0.0, 0.0, 1.0]])
    t_b = np.array([44.0, 0.0, 0.0])
    err = np.array([2.0, -1.0, 1.0])
    img_a = world[:tile_size[0], :, :]
    img_b = affine_transform(world, rot, offset=t_b + err,
                             output_shape=tile_size, order=1)
    noise = np.random.default_rng(3).normal(0, 4.0, tile_size)
    store = ChunkStore.create(str(out / "dataset.n5"), StorageFormat.N5)
    sd = SpimData()
    sd.image_loader = ImageLoader(format="bdv.n5", path="dataset.n5")
    sd.timepoints = [0]
    for attr in ("illumination", "angle", "channel"):
        sd.attributes[attr][0] = AttributeEntity(0, "0")
    for tid in (0, 1):
        sd.attributes["tile"][tid] = AttributeEntity(tid, str(tid))
    for sid, img in ((0, img_a), (1, img_b)):
        sd.setups[sid] = ViewSetup(
            id=sid, name=f"tile{sid}", size=tile_size,
            attributes={"illumination": 0, "channel": 0, "tile": sid,
                        "angle": 0})
        ds = create_bdv_view_datasets(store, sid, 0, tile_size, (32, 32, 16),
                                      "uint16")
        ds[0].write(np.clip(img + noise, 0, 65535).astype(np.uint16),
                    (0, 0, 0))
    sd.registrations[ViewId(0, 0)] = [
        ViewTransform("identity", translation_affine((0, 0, 0)))]
    sd.registrations[ViewId(0, 1)] = [
        ViewTransform("rigid", np.hstack([rot, t_b.reshape(3, 1)]))]
    xml = str(out / "dataset.xml")
    sd.save(xml)
    return xml, err


@pytest.mark.parametrize("ds,atol", [((1, 1, 1), 1.0), ((2, 2, 1), 2.0)],
                         ids=["ds111", "ds221"])
def test_rendered_path_matches_jax(rotated_project, ds, atol):
    """Unequal linear parts route both groups through fuse_grid_block (the
    fusion twins here, K2/K3/K4 on the card) over the overlap."""
    xml, err = rotated_project
    sd = SpimData.load(xml)
    (pair,) = TS.plan_pairs(sd, TS.build_groups(sd, sd.view_ids()))
    job = TS._extract_pair_job(sd, ViewLoader(sd), *pair,
                               TS.StitchingParams(downsampling=ds),
                               torch.device("cpu"))
    assert job is not None and job.linear is None
    mine, agree = _run_port(xml, TS.StitchingParams(downsampling=ds))
    ref = _run_jax(xml, JS.StitchingParams(downsampling=ds))
    (res,) = mine
    assert res.correlation > 0.5
    np.testing.assert_allclose(res.transform[:, 3], -err, atol=atol)
    # the rendered crops are float32 sums that XLA and torch round in
    # different orders: the same peaks, shifts within 1e-6 px
    assert [_key(r) for r in mine] == [_key(r) for r in ref]
    np.testing.assert_allclose(res.transform, ref[0].transform, atol=1e-6)
    np.testing.assert_allclose(res.correlation, ref[0].correlation,
                               atol=1e-6)


def _mk(shift, r, mod):
    return mod.PairwiseStitchingResult(
        views_a=(mod.ViewId(0, 0),), views_b=(mod.ViewId(0, 1),),
        transform=np.hstack([np.eye(3), np.reshape(shift, (3, 1))]),
        correlation=r, hash=0.5)


@pytest.mark.parametrize("kw", [
    dict(min_r=0.5), dict(max_r=0.95),
    dict(max_shift=(10.0, 10.0, 10.0), max_shift_total=12.0),
    dict(max_shift=(np.inf, 0.5, np.inf)),
], ids=["minR", "maxR", "maxShift", "maxShiftY"])
def test_filters_match_jax(kw):
    import bigstitcher_spark_tpu.io.spimdata as jmod
    import bigstitcher_spark_tpu_torch.io.spimdata as tmod

    cases = [((1, 0, 0), 0.9), ((2, 0, 0), 0.2), ((1.0, 1.0, 0.0), 0.97),
             ((11.0, 0.0, 0.0), 0.9), ((8.0, 8.0, 8.0), 0.9)]
    mine = TS.filter_results([_mk(s, r, tmod) for s, r in cases],
                             TS.StitchingParams(**kw), verbose=False)
    ref = JS.filter_results([_mk(s, r, jmod) for s, r in cases],
                            JS.StitchingParams(**kw), verbose=False)
    assert [(tuple(m.transform[:, 3]), m.correlation) for m in mine] == \
        [(tuple(m.transform[:, 3]), m.correlation) for m in ref]
    assert 0 < len(mine) < len(cases)


def test_store_results_clears_recomputed_pairs():
    import bigstitcher_spark_tpu_torch.io.spimdata as tmod

    sd = SpimData()
    old, new = _mk((1, 0, 0), 0.9, tmod), _mk((2, 0, 0), 0.2, tmod)
    sd.stitching_results[old.pair_key] = old
    TS.store_results(sd, [], computed=[new])
    assert sd.stitching_results == {}
    TS.store_results(sd, [new])
    assert sd.stitching_results[new.pair_key] is new


def test_cli_writes_the_results_jax_writes(stitch_project, tmp_path):
    """``stitching -x <xml>`` on copies of one project: the XML each CLI
    saves parses to the same StitchingResults (pairs, shifts, r, hash,
    overlap box)."""
    src = os.path.dirname(stitch_project.xml_path)
    xmls = {}
    for who in ("jax", "port"):
        d = tmp_path / who
        shutil.copytree(src, d)
        xmls[who] = str(d / "dataset.xml")
    res = CliRunner().invoke(jax_cli, ["stitching", "-x", xmls["jax"],
                                       "-ds", "2,2,1"],
                             catch_exceptions=False)
    assert res.exit_code == 0, res.output
    run = torch_main(["stitching", "-x", xmls["port"], "-ds", "2,2,1",
                      "--device", "cpu"])
    assert run.stats.pairs == 6 and len(run.kept) >= 4
    assert run.stats.fft_voxels > 0
    assert all(run.stats.timings[k] > 0 for k in
               ("extract", "stage", "launch", "wait", "refine", "device"))
    mine = SpimData.load(xmls["port"]).stitching_results
    ref = JSpimData.load(xmls["jax"]).stitching_results
    key = lambda k: tuple(tuple((v.timepoint, v.setup) for v in g) for g in k)
    assert sorted(key(k) for k in mine) == sorted(key(k) for k in ref)
    by_key = {key(k): v for k, v in ref.items()}
    for k, m in mine.items():
        r = by_key[key(k)]
        np.testing.assert_array_equal(m.transform, r.transform)
        assert m.correlation == r.correlation and m.hash == r.hash != 0.0
        assert (tuple(m.bbox.min), tuple(m.bbox.max)) == \
            (tuple(r.bbox.min), tuple(r.bbox.max))


def test_cli_dry_run_and_filters_save_nothing_extra(stitch_project, tmp_path):
    d = tmp_path / "p"
    shutil.copytree(os.path.dirname(stitch_project.xml_path), d)
    xml = str(d / "dataset.xml")
    run = torch_main(["stitching", "-x", xml, "-ds", "2,2,1", "--device",
                      "cpu", "--dryRun"])
    assert len(run.results) == 6
    assert SpimData.load(xml).stitching_results == {}
    run = torch_main(["stitching", "-x", xml, "-ds", "2,2,1", "--device",
                      "cpu", "--minR", "0.95", "--maxShiftX", "6"])
    kept = SpimData.load(xml).stitching_results
    assert len(kept) == len(run.kept) < 6
    for r in kept.values():
        assert r.correlation >= 0.95 and abs(r.transform[0, 3]) <= 6


def test_pair_loop_dispatches_each_segment_before_draining_the_last():
    """Segments of up to half the byte budget; segment k+1 is dispatched
    before segment k drains, so the card computes while the host refines."""
    from bigstitcher_spark_tpu_torch.parallel.pairsched import (
        PairTask, run_pair_tasks)

    log = []
    tasks = [PairTask(index=i, nbytes=40) for i in range(5)]

    def dispatch(t):
        log.append(("dispatch", t.index))
        return t.index * 10

    def drain(ts, handles):
        log.append(("drain", [t.index for t in ts]))
        return [h + 1 for h in handles]

    out = run_pair_tasks(tasks, dispatch, drain, device=torch.device("cpu"),
                         budget_bytes=160)
    assert out == [1, 11, 21, 31, 41]
    assert log == [("dispatch", 0), ("dispatch", 1), ("dispatch", 2),
                   ("dispatch", 3), ("drain", [0, 1]), ("dispatch", 4),
                   ("drain", [2, 3]), ("drain", [4])]


def test_cli_refuses_more_peaks_than_k10_keeps(stitch_project):
    with pytest.raises(ValueError, match="256"):
        torch_main(["stitching", "-x", stitch_project.xml_path, "-p", "257",
                    "--device", "cpu"])
