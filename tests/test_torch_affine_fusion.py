"""The port's main path end to end against the JAX package, on the CPU.

The JAX generator writes a small 2x2x1-tile project; non-integer
translations are appended to its registrations (the generator rounds its
jitter to whole voxels, which would never exercise the trilinear weights),
and one variant also rotates a view about z. Both CLIs then run
``create-fusion-container`` + ``affine-fusion``: the JAX one with
``--devices 1`` (the single-device routes), the port with ``--device cpu``
(the plain-torch twins of the kernels). Fused integers agree within 1
(float32 sums round differently in XLA and torch); float32 output within
rtol 1e-5 / atol 1e-3. Each test also asserts which route both took.
"""

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import bigstitcher_spark_tpu.models.affine_fusion as jaf
from bigstitcher_spark_tpu.cli.main import cli as jax_cli
from bigstitcher_spark_tpu.io.chunkstore import ChunkStore as JStore
from bigstitcher_spark_tpu.io.dataset_io import ViewLoader as JViewLoader
from bigstitcher_spark_tpu.io.spimdata import SpimData as JSpimData
from bigstitcher_spark_tpu.utils.geometry import Interval as JInterval
from bigstitcher_spark_tpu.utils.testdata import make_synthetic_project
from bigstitcher_spark_tpu_torch.cli.main import main as torch_main
from bigstitcher_spark_tpu_torch.io.chunkstore import ChunkStore as TStore
from bigstitcher_spark_tpu_torch.io.dataset_io import ViewLoader
from bigstitcher_spark_tpu_torch.io.spimdata import SpimData
from bigstitcher_spark_tpu_torch import ops as TOps
from bigstitcher_spark_tpu_torch.models import affine_fusion as taf
from bigstitcher_spark_tpu_torch.utils.geometry import Interval, translation_affine
from bigstitcher_spark_tpu_torch.utils.testdata import (
    append_view_transforms,
    rotation_about_z,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _project(root, rotate: bool):
    proj = make_synthetic_project(
        str(root), n_tiles=(2, 2, 1), tile_size=(48, 40, 20), overlap=12,
        seed=3, block_size=(32, 32, 16))
    rng = np.random.default_rng(5)
    tr = {s: translation_affine(rng.uniform(-0.5, 0.5, 3)) for s in range(4)}
    if rotate:  # tile 1, about its own centre: the per-block gather route
        tr[1] = rotation_about_z(4.0, (60, 20, 10)) @ np.vstack(
            [tr[1], [0, 0, 0, 1]])
    append_view_transforms(proj.xml_path, tr)
    return proj.xml_path


@pytest.fixture(scope="module")
def shifted_xml(tmp_path_factory):
    return _project(tmp_path_factory.mktemp("shift") / "p", rotate=False)


@pytest.fixture(scope="module")
def rotated_xml(tmp_path_factory):
    return _project(tmp_path_factory.mktemp("rot") / "p", rotate=True)


@pytest.fixture()
def jax_paths(monkeypatch):
    """Routes the JAX driver reported (its end-of-stage summary)."""
    seen = []
    monkeypatch.setattr(jaf, "_record_fusion_stage",
                        lambda stage, stats, path: seen.append(path))
    return seen


def _run_both(xml, tmp_path, storage, dtype, fusion_args, container_args=()):
    ext = "n5" if storage == "N5" else "ome.zarr"
    outs = {}
    for who in ("jax", "torch"):
        out = str(tmp_path / f"{who}.{ext}")
        create = ["create-fusion-container", "-x", xml, "-o", out, "-s",
                  storage, "-d", dtype, "--blockSize", "32,32,16",
                  "--minIntensity", "0", "--maxIntensity", "3000",
                  *container_args]
        fuse = ["affine-fusion", "-o", out, *fusion_args]
        if who == "jax":
            for args in (create, fuse + ["--devices", "1"]):
                r = CliRunner().invoke(jax_cli, args)
                assert r.exit_code == 0, (r.output, r.exception)
        else:
            torch_main(create)
            stats = torch_main(fuse + ["--device", "cpu"])
        outs[who] = out
    path = "ch0tp0/s0" if storage == "N5" else "0"
    a = JStore.open(outs["jax"]).open_dataset(path).read_full()
    b = TStore.open(outs["torch"]).open_dataset(path).read_full()
    if storage != "N5":
        a, b = a[..., 0, 0], b[..., 0, 0]
    return a, b, stats


def _assert_match(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == np.float32:
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-3)
    else:
        assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 1
    assert (a > 0).mean() > 0.6  # tiles cover most of the bounding box


@pytest.mark.parametrize("storage,dtype,fusion_args", [
    ("ZARR", "UINT16", ["--fusionType", "AVG_BLEND"]),
    ("N5", "UINT8", ["--masks", "--maskOffset", "1.5,1.5,0.5"]),
    ("N5", "FLOAT32", ["--fusionType", "MAX_INTENSITY"]),
])
def test_composite_route_matches_jax(shifted_xml, tmp_path, jax_paths,
                                     storage, dtype, fusion_args):
    a, b, stats = _run_both(shifted_xml, tmp_path, storage, dtype, fusion_args)
    assert jax_paths == ["composite"]
    assert [s.path for s in stats] == ["composite"]
    _assert_match(a, b)


@pytest.mark.parametrize("storage,dtype,fusion_args", [
    ("ZARR", "UINT16", ["--fusionType", "AVG_BLEND"]),
    ("N5", "UINT16", ["--fusionType", "FIRST_WINS", "--blockScale", "1,1,1"]),
])
def test_per_block_shift_route_matches_jax(shifted_xml, tmp_path, jax_paths,
                                           monkeypatch, storage, dtype,
                                           fusion_args):
    monkeypatch.setenv("BST_DEVICE_TILE_BUDGET", "1")
    a, b, stats = _run_both(shifted_xml, tmp_path, storage, dtype, fusion_args)
    assert jax_paths == ["per-block"]
    assert [s.path for s in stats] == ["per-block"]
    assert stats[0].kernel_blocks["shift"] > 1
    assert stats[0].kernel_blocks["gather"] == 0
    _assert_match(a, b)


def test_gather_route_matches_jax(rotated_xml, tmp_path, jax_paths):
    a, b, stats = _run_both(rotated_xml, tmp_path, "ZARR", "UINT16",
                            ["--fusionType", "AVG_BLEND"])
    assert jax_paths == ["per-block"]
    assert [s.path for s in stats] == ["per-block"]
    assert stats[0].kernel_blocks["gather"] > 0
    _assert_match(a, b)


def test_anisotropic_composite_matches_jax(shifted_xml, tmp_path, jax_paths):
    """Diagonal views (z scaled by --preserveAnisotropy) take K1's "sep"."""
    a, b, stats = _run_both(
        shifted_xml, tmp_path, "ZARR", "UINT16", [],
        container_args=["--preserveAnisotropy", "--anisotropyFactor", "1.6"])
    assert jax_paths == ["composite"]
    assert [s.path for s in stats] == ["composite"]
    _assert_match(a, b)


def test_diagonal_per_block_fuses_through_sep_like_jax(shifted_xml, tmp_path, jax_paths,
                                      monkeypatch):
    """Per-block fusion of diagonal views was refused until the separable
    kernel (K5) was ported; it now fuses every block through it and
    matches the JAX per-block route."""
    monkeypatch.setenv("BST_DEVICE_TILE_BUDGET", "1")
    a, b, stats = _run_both(
        shifted_xml, tmp_path, "N5", "UINT16", [],
        container_args=["--preserveAnisotropy", "--anisotropyFactor", "2"])
    assert jax_paths == ["per-block"]
    assert [s.path for s in stats] == ["per-block"]
    assert stats[0].kernel_blocks["sep"] > 1
    assert stats[0].kernel_blocks["shift"] == 0
    _assert_match(a, b)


def _jax_and_torch_loaders(xml):
    jsd, tsd = JSpimData.load(xml), SpimData.load(xml)
    return jsd, JViewLoader(jsd), tsd, ViewLoader(tsd)


def test_composite_plan_matches_jax_planner(shifted_xml):
    jsd, jl, tsd, tl = _jax_and_torch_loaders(shifted_xml)
    views = tsd.view_ids()
    bbox = Interval((0, -2, 0), (89, 71, 21))
    jplan = jaf.plan_composite_volume(
        jsd, jl, jsd.view_ids(), JInterval(bbox.min, bbox.max), None,
        jaf.BlendParams(), masks=True, mask_offset=(1.5, 0.0, 0.5))
    tplan = taf.plan_composite_volume(
        tsd, tl, views, bbox, None, taf.BlendParams(), masks=True,
        mask_offset=(1.5, 0.0, 0.5))
    ref = taf.composite_plan_from_reference(jplan)
    for f in ("out_shape", "windows", "n_offs", "pad", "kinds"):
        assert getattr(tplan, f) == getattr(ref, f), f
    for f in ("fracs", "img_dims", "borders", "ranges", "inside_offs",
              "diags", "offs"):
        torch.testing.assert_close(getattr(tplan, f), getattr(ref, f),
                                   rtol=0, atol=0)
    assert [p.view for p in tplan.plans] == [p.view for p in ref.plans]
    # identical kernel inputs give identical fused volumes
    tiles = [torch.from_numpy(tl.open(p.view).read_full()) for p in tplan.plans]
    out = [taf.dispatch_composite(p, tiles, "AVG_BLEND", "uint16", False,
                                  0.0, 3000.0) for p in (tplan, ref)]
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)


def test_block_plans_match_jax_planner(rotated_xml):
    jsd, jl, tsd, tl = _jax_and_torch_loaders(rotated_xml)
    for lo in ((0, 0, 0), (32, 32, 0), (64, 0, 16)):
        bg = Interval.from_shape((32, 32, 16), lo)
        ref = taf.composite_plan_from_reference(jaf.plan_block(
            jsd, jl, jsd.view_ids(), JInterval(bg.min, bg.max), None))
        mine = taf.plan_block(tsd, tl, tsd.view_ids(), bg, None)
        assert [p.view for p in mine] == [p.view for p in ref]
        for p, q in zip(mine, ref):
            assert p.patch_interval == q.patch_interval
            np.testing.assert_array_equal(p.affine, q.affine)
            np.testing.assert_array_equal(p.patch_offset, q.patch_offset)
            assert (p.is_translation, p.is_diagonal) == \
                (q.is_translation, q.is_diagonal)


def test_fuse_grid_block_returns_device_tensors(shifted_xml):
    sd = SpimData.load(shifted_xml)
    loader = ViewLoader(sd)
    bbox = Interval((0, -2, 0), (89, 71, 21))
    blocks = taf.create_grid(bbox.shape, (32, 32, 16))
    fused, wsum = taf.fuse_grid_block(sd, loader, sd.view_ids(), blocks[0],
                                      bbox, device="cpu")
    assert fused.dtype == torch.float32 and tuple(fused.shape) == (32, 32, 16)
    assert (wsum > 0).float().mean() > 0.5
    assert TOps.launch_counts() == dict.fromkeys(TOps.kernel_wrappers(), 0)
