"""Multi-resolution fusion output and the per-block anisotropic route of the
port against the JAX package, on the CPU.

* ``create-fusion-container --multiRes`` / ``-ds``: both packages write the
  same datasets, dims, ``downsamplingFactors`` and multiscales metadata,
  and each reads the other's epilogue markers.
* ``affine-fusion --pyramid`` end to end on a small synthetic project: s0
  within |delta| <= 1 of JAX's; the port's epilogue levels bitwise equal to
  the port's own reread path and to JAX's ``downsample_pyramid_level`` run
  on a copy of the port's container (integer storage, power-of-two
  factors: every sum is exact).
* The anisotropic per-block route (device budget forced to 1 byte) takes
  the separable kernel in both packages and agrees within |delta| <= 1.
* ``downsample`` (with ``--skip-existing``) mirrors tests/test_epilogue.py.
"""

import shutil

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import bigstitcher_spark_tpu.models.affine_fusion as jaf
from bigstitcher_spark_tpu.cli.main import cli as jax_cli
from bigstitcher_spark_tpu.io import container as JC
from bigstitcher_spark_tpu.io.chunkstore import ChunkStore as JStore
from bigstitcher_spark_tpu.io.chunkstore import StorageFormat as JFormat
from bigstitcher_spark_tpu.io.dataset_io import ViewLoader as JViewLoader
from bigstitcher_spark_tpu.io.spimdata import SpimData as JSpimData
from bigstitcher_spark_tpu.models.downsample_driver import (
    downsample_pyramid_level as jax_downsample_level,
)
from bigstitcher_spark_tpu.utils.geometry import Interval as JInterval
from bigstitcher_spark_tpu.utils.grid import GridBlock as JGridBlock
from bigstitcher_spark_tpu.utils.testdata import make_synthetic_project
from bigstitcher_spark_tpu_torch.cli.main import main as torch_main
from bigstitcher_spark_tpu_torch.io import container as TC
from bigstitcher_spark_tpu_torch.io.chunkstore import ChunkStore, StorageFormat
from bigstitcher_spark_tpu_torch.io.dataset_io import ViewLoader
from bigstitcher_spark_tpu_torch.io.spimdata import SpimData
from bigstitcher_spark_tpu_torch.models import affine_fusion as taf
from bigstitcher_spark_tpu_torch.models.downsample_driver import (
    downsample_pyramid_level,
)
from bigstitcher_spark_tpu_torch.ops import fusion as TF
from bigstitcher_spark_tpu_torch.utils.geometry import (
    Interval,
    translation_affine,
)
from bigstitcher_spark_tpu_torch.utils.testdata import append_view_transforms

STEPS = ["-ds", "1,1,1", "-ds", "2,2,2", "-ds", "4,4,2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's CPU pool is far slower than one thread on small tensors here
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def xml(tmp_path_factory):
    """2x2x1 tiles with sub-pixel translations appended (the generator
    rounds its jitter to whole voxels)."""
    proj = make_synthetic_project(
        str(tmp_path_factory.mktemp("pyr") / "p"), n_tiles=(2, 2, 1),
        tile_size=(48, 40, 20), overlap=12, seed=3, block_size=(32, 32, 16))
    rng = np.random.default_rng(5)
    append_view_transforms(proj.xml_path, {
        s: translation_affine(rng.uniform(-0.5, 0.5, 3)) for s in range(4)})
    return proj.xml_path


@pytest.fixture()
def jax_paths(monkeypatch):
    """Routes the JAX driver reported (its end-of-stage summary)."""
    seen = []
    monkeypatch.setattr(jaf, "_record_fusion_stage",
                        lambda stage, stats, path: seen.append(path))
    return seen


def _jax(args):
    r = CliRunner().invoke(jax_cli, args, catch_exceptions=False)
    assert r.exit_code == 0, r.output
    return r.output


def _create(who, xml, out, storage, extra):
    args = ["create-fusion-container", "-x", xml, "-o", out, "-s", storage,
            "-d", "UINT16", "--blockSize", "16,16,8", "--minIntensity", "0",
            "--maxIntensity", "3000", *extra]
    if who == "jax":
        _jax(args)
    else:
        torch_main(args)


def _levels(path):
    store = ChunkStore.open(path)
    mr = TC.read_container_meta(store).mr_infos[0]
    return [store.open_dataset(m.dataset.strip("/")).read_full() for m in mr]


def _max_delta(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


# --------------------------------------------------------------- containers


@pytest.mark.parametrize("dims,aniso", [
    ((1952, 1952, 132), float("nan")), ((1952, 1952, 44), 3.0),
    ((89, 72, 22), float("nan")), ((500, 300, 40), 1.6), ((64, 64, 64), 2.0),
])
def test_estimate_multires_pyramid_matches_jax(dims, aniso):
    assert (TC.estimate_multires_pyramid(dims, aniso)
            == JC.estimate_multires_pyramid(dims, aniso))


def _root_and_datasets(path):
    """Everything the container contract fixes: root attributes (with
    InputXML) and every dataset's shape, chunking, dtype and attributes."""
    store = ChunkStore.open(path)
    meta = TC.read_container_meta(store)
    out = {"root": store.get_attributes("")}
    for levels in meta.mr_infos:
        for m in levels:
            ds = store.open_dataset(m.dataset.strip("/"))
            out[m.dataset] = (ds.shape, ds.block_size, ds.dtype.name,
                              store.get_attributes(m.dataset.strip("/"))
                              .get("downsamplingFactors"))
    return out


@pytest.mark.parametrize("storage,extra", [
    ("ZARR", ["--multiRes"]),
    ("N5", STEPS),
    ("N5", ["--multiRes", "--preserveAnisotropy", "--anisotropyFactor", "3"]),
    ("ZARR", ["--preserveAnisotropy", "--anisotropyFactor", "2", "-ds",
              "1,1,1", "-ds", "2,2,1"]),
])
def test_container_pyramid_matches_jax(xml, tmp_path, storage, extra):
    got = {}
    for who in ("jax", "torch"):
        out = str(tmp_path / f"{who}.{'n5' if storage == 'N5' else 'zarr'}")
        _create(who, xml, out, storage, extra)
        got[who] = _root_and_datasets(out)
    assert got["torch"] == got["jax"]
    mr = got["torch"]["root"]["Bigstitcher-Spark"]["MultiResolutionInfos"][0]
    assert len(mr) > 1
    if storage == "ZARR":
        ngff = got["torch"]["root"]["multiscales"][0]
        assert len(ngff["datasets"]) == len(mr)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_epilogue_markers_cross_read(xml, tmp_path, writer):
    out = str(tmp_path / "m.n5")
    _create("torch", xml, out, "N5", STEPS)
    pkgs = {"jax": (JC, JStore), "torch": (TC, ChunkStore)}
    (wmod, wstore), (rmod, rstore) = (
        pkgs[writer], pkgs["torch" if writer == "jax" else "jax"])
    store = wstore.open(out)
    wmod.set_epilogue_written(store, "ch0tp0/s1", (0, 0), True)
    wmod.set_epilogue_written(store, "ch0tp0/s2", (0, 0), False)
    store = rstore.open(out)
    assert rmod.epilogue_written(store, "ch0tp0/s1", (0, 0))
    assert not rmod.epilogue_written(store, "ch0tp0/s2", (0, 0))
    assert not rmod.epilogue_written(store, "ch0tp0/s1", (1, 0))


# --------------------------------------------------------------- end to end


def test_pyramid_epilogue_matches_reread_and_jax(xml, tmp_path, jax_paths):
    """``--pyramid`` on the composite route: s0 within |delta| <= 1 of JAX's
    run, the epilogue's levels bitwise equal to the port's reread path and
    to JAX's downsample of the port's own s0."""
    outs = {}
    for who in ("jax", "torch"):
        out = str(tmp_path / f"{who}.ome.zarr")
        _create(who, xml, out, "ZARR", STEPS)
        if who == "jax":
            assert "epilogue: 2 pyramid level(s)" in _jax(
                ["affine-fusion", "-o", out, "--pyramid", "--devices", "1"])
        else:
            (stats,) = torch_main(["affine-fusion", "-o", out, "--pyramid",
                                   "--device", "cpu"])
            assert stats.path == "composite" and stats.pyramid_levels == 2
        outs[who] = out
    assert jax_paths == ["composite"]
    port = _levels(outs["torch"])
    assert _max_delta(port[0], _levels(outs["jax"])[0]) <= 1
    assert all(lv.std() > 0 for lv in port)
    store = ChunkStore.open(outs["torch"])
    mr = TC.read_container_meta(store).mr_infos[0]
    assert all(TC.epilogue_written(store, m.dataset, (0, 0)) for m in mr[1:])

    reread, jcopy = (str(tmp_path / n) for n in ("reread.zarr", "j.zarr"))
    for copy in (reread, jcopy):
        shutil.copytree(outs["torch"], copy)
    rstore = ChunkStore.open(reread)
    jstore = JStore.open(jcopy)
    jmr = JC.read_container_meta(jstore).mr_infos[0]
    for lvl in range(1, len(mr)):
        downsample_pyramid_level(rstore, mr[lvl - 1], mr[lvl], True, (0, 0),
                                 device="cpu")
        jax_downsample_level(jstore, jmr[lvl - 1], jmr[lvl], True, (0, 0))
    for lvl, (a, b, c) in enumerate(zip(port, _levels(reread), _levels(jcopy))):
        np.testing.assert_array_equal(b, a, err_msg=f"reread level {lvl}")
        np.testing.assert_array_equal(c, a, err_msg=f"JAX level {lvl}")


def test_cli_pyramid_marks_then_revokes(xml, tmp_path):
    """The epilogue marks its levels and the downsample stage skips them;
    a later run without ``--pyramid`` revokes the marks and the stage
    recomputes the same bytes (tests/test_epilogue.py's CLI case)."""
    out = str(tmp_path / "cli.ome.zarr")
    _create("torch", xml, out, "ZARR", ["-ds", "1,1,1", "-ds", "2,2,2"])
    torch_main(["affine-fusion", "-o", out, "--pyramid", "--device", "cpu"])
    store = ChunkStore.open(out)
    mr = TC.read_container_meta(store).mr_infos[0]
    assert TC.epilogue_written(store, mr[1].dataset, (0, 0))
    assert downsample_pyramid_level(store, mr[0], mr[1], True, (0, 0),
                                    device="cpu", skip_existing=True) == 0
    first = _levels(out)
    (stats,) = torch_main(["affine-fusion", "-o", out, "--device", "cpu"])
    assert stats.pyramid_levels == 0
    assert not TC.epilogue_written(store, mr[1].dataset, (0, 0))
    for a, b in zip(first, _levels(out)):
        np.testing.assert_array_equal(b, a)


def test_pyramid_on_per_block_route_is_left_to_the_stage(xml, tmp_path,
                                                         monkeypatch):
    """``--pyramid`` on the per-block route makes no epilogue level (as in
    JAX): no marker is set and the downsample stage writes every level,
    equal to JAX's downsample of the port's s0."""
    monkeypatch.setenv("BST_DEVICE_TILE_BUDGET", "1")
    out = str(tmp_path / "pb.zarr")
    _create("torch", xml, out, "ZARR", STEPS)
    (stats,) = torch_main(["affine-fusion", "-o", out, "--pyramid",
                           "--device", "cpu"])
    assert stats.path == "per-block" and stats.pyramid_levels == 0
    store = ChunkStore.open(out)
    mr = TC.read_container_meta(store).mr_infos[0]
    assert not any(TC.epilogue_written(store, m.dataset, (0, 0))
                   for m in mr[1:])
    port = _levels(out)
    copy = str(tmp_path / "pb_j.zarr")
    shutil.copytree(out, copy)
    jstore = JStore.open(copy)
    jmr = JC.read_container_meta(jstore).mr_infos[0]
    for lvl in range(1, len(jmr)):
        jax_downsample_level(jstore, jmr[lvl - 1], jmr[lvl], True, (0, 0))
    for a, b in zip(port[1:], _levels(copy)[1:]):
        assert a.std() > 0
        np.testing.assert_array_equal(b, a)


def test_thin_axis_edge_pad_epilogue(tmp_path_factory, tmp_path):
    """A level window wider than the axis (z factor 8 over ~6 planes) takes
    the read_padded edge rule in the epilogue too (tests/test_epilogue.py's
    thin case)."""
    proj = make_synthetic_project(
        str(tmp_path_factory.mktemp("thin") / "proj"), n_tiles=(2, 1, 1),
        tile_size=(32, 32, 6), overlap=8, jitter=0.0, seed=7,
        block_size=(16, 16, 4), n_beads_per_tile=8)
    out = str(tmp_path / "thin.zarr")
    torch_main(["create-fusion-container", "-x", proj.xml_path, "-o", out,
                "-s", "ZARR", "-d", "UINT16", "--blockSize", "16,16,4",
                "-ds", "1,1,1", "-ds", "2,2,8"])
    (stats,) = torch_main(["affine-fusion", "-o", out, "--pyramid",
                           "--device", "cpu"])
    assert stats.pyramid_levels == 1
    epi = _levels(out)
    assert epi[1].shape[2] == 1
    copy = str(tmp_path / "thin_j.zarr")
    shutil.copytree(out, copy)
    jstore = JStore.open(copy)
    jmr = JC.read_container_meta(jstore).mr_infos[0]
    jax_downsample_level(jstore, jmr[0], jmr[1], True, (0, 0))
    np.testing.assert_array_equal(_levels(copy)[1], epi[1])


def test_anisotropic_per_block_matches_jax(xml, tmp_path, jax_paths,
                                           monkeypatch):
    """``--preserveAnisotropy`` over the device budget: both packages fuse
    every block with the separable kernel; s0 and the downsample stage's
    levels agree within |delta| <= 1 (levels are computed from each
    package's own s0)."""
    monkeypatch.setenv("BST_DEVICE_TILE_BUDGET", "1")
    extra = ["--preserveAnisotropy", "--anisotropyFactor", "2", "-ds",
             "1,1,1", "-ds", "2,2,1"]
    outs = {}
    for who in ("jax", "torch"):
        out = str(tmp_path / f"{who}.n5")
        _create(who, xml, out, "N5", extra)
        if who == "jax":
            _jax(["affine-fusion", "-o", out, "--devices", "1"])
        else:
            (stats,) = torch_main(["affine-fusion", "-o", out,
                                   "--device", "cpu"])
        outs[who] = out
    assert jax_paths == ["per-block"]
    assert stats.path == "per-block" and stats.kernel_blocks["sep"] > 1
    assert stats.kernel_blocks["shift"] == stats.kernel_blocks["gather"] == 0
    a, b = _levels(outs["jax"]), _levels(outs["torch"])
    assert (b[0] > 0).mean() > 0.6
    for lvl in range(len(a)):
        assert _max_delta(a[lvl], b[lvl]) <= 1, f"level {lvl}"


def test_diagonal_plans_stage_like_jax(xml):
    """The sep route's staging equals JAX ``_sep_inputs`` on the same plans,
    and its kernel inputs carry over as a port StagedBlock."""
    jsd, tsd = JSpimData.load(xml), SpimData.load(xml)
    jl, tl = JViewLoader(jsd), ViewLoader(tsd)
    aniso = taf.anisotropy_transform(2.0)
    bg = Interval.from_shape((32, 32, 16), (16, 16, 0))
    jplans = jaf.plan_block(jsd, jl, jsd.view_ids(),
                            JInterval(bg.min, bg.max), aniso)
    plans = taf.composite_plan_from_reference(jplans)
    assert plans and all(p.is_diagonal and not p.is_translation
                         for p in plans)
    pshape = TF.bucket_shape(np.max([p.patch_interval.shape for p in plans],
                                    axis=0))
    vb = TF.bucket_views(len(plans))
    ref = jaf._sep_inputs(jsd, jl, jplans, pshape, vb, jaf.BlendParams(),
                          (0.0, 0.0, 0.0))
    mine = taf._sep_inputs(tl, plans, pshape, vb, taf.BlendParams(),
                           (0.0, 0.0, 0.0))
    assert len(mine) == len(ref)
    for m, r in zip(mine, ref):
        np.testing.assert_array_equal(m, r)
    block = JGridBlock((16, 16, 0), (32, 32, 16), (1, 1, 0))
    staged = taf.staged_from_reference(block, (32, 32, 16), ref, "sep")
    fused, wsum = taf.run_staged_block(staged, "AVG_BLEND",
                                       torch.device("cpu"))
    jf, jw = jaf.F.fuse_block_sep(*ref[:-1], block_shape=(32, 32, 16),
                                  fusion_type="AVG_BLEND", inside_offs=ref[-1])
    np.testing.assert_allclose(fused.numpy(),
                               np.asarray(jf).reshape(32, 32, 16),
                               rtol=1e-5, atol=1e-3)
    assert (wsum > 0).float().mean() > 0.5


def test_pyramid_levels_carry_over_from_jax(xml, tmp_path):
    out = str(tmp_path / "carry.zarr")
    _create("jax", xml, out, "ZARR", STEPS)
    jstore = JStore.open(out)
    jpyr = jaf.pyramid_from_mr(jstore, JC.read_container_meta(jstore)
                               .mr_infos[0])
    store = ChunkStore.open(out)
    mine = taf.pyramid_from_mr(store, TC.read_container_meta(store)
                               .mr_infos[0])
    ref = taf.pyramid_from_reference(jpyr)
    assert [(p.rel, p.abs_factor, p.dims, p.ds.path, p.ds.shape)
            for p in ref] == [(p.rel, p.abs_factor, p.dims, p.ds.path,
                               p.ds.shape) for p in mine]
    assert [p.rel for p in mine] == [(2, 2, 2), (2, 2, 1)]


# ---------------------------------------------------------------- downsample


def test_downsample_cmd_skip_existing_matches_jax(tmp_path, capsys):
    """``downsample --skip-existing`` skips a step whose output exists with
    matching dims and factors (tests/test_epilogue.py's case); the port's
    levels equal JAX's downsample tool on the same input bit for bit."""
    vol = np.random.default_rng(3).integers(0, 1000, (44, 40, 22)).astype(
        np.uint16)
    roots = {}
    for who, mk, fmt in (("jax", JStore, JFormat.N5),
                         ("torch", ChunkStore, StorageFormat.N5)):
        roots[who] = str(tmp_path / f"{who}.n5")
        mk.create(roots[who], fmt).create_dataset(
            "vol/s0", vol.shape, (16, 16, 8), "uint16").write(vol, (0, 0, 0))
    args = ["downsample", "-i", roots["torch"], "-di", "vol/s0", "-ds",
            "2,2,2; 2,2,1", "--skip-existing", "--device", "cpu"]
    assert torch_main(args) == ["vol/s1", "vol/s2"]
    assert "skipped" not in capsys.readouterr().out
    store = ChunkStore.open(roots["torch"])
    first = store.open_dataset("vol/s1").read_full()
    assert store.get_attribute("vol/s2", "downsamplingFactors") == [4, 4, 2]
    torch_main(args)
    assert capsys.readouterr().out.count("skipped") == 2
    np.testing.assert_array_equal(store.open_dataset("vol/s1").read_full(),
                                  first)
    _jax(["downsample", "-i", roots["jax"], "-di", "vol/s0", "-ds",
          "2,2,2; 2,2,1"])
    jstore = JStore.open(roots["jax"])
    for lvl in ("vol/s1", "vol/s2"):
        np.testing.assert_array_equal(
            store.open_dataset(lvl).read_full(),
            jstore.open_dataset(lvl).read_full())
