"""The port's sharded affine-fusion route (``--devices N``) on the CPU.

* The route end to end (mesh ``[cpu] * 4``) against the JAX package's
  sharded route on the suite's 8 virtual XLA devices (``--devices 8``):
  uint16 within |delta| <= 1 (float32 sums round differently in XLA and
  torch) for a shift, a gather (one view rotated about z), a sep
  (anisotropic container) and a masks project, and with intensity
  coefficients through the API; and bitwise against the port's own
  per-block route (the same plain twins on the same staged inputs).
* The per-block epilogue (K28's twin): its levels bitwise equal to the
  port's container-reread downsample of its own s0, with the prefix +
  fallback and the ineligible cases of tests/test_epilogue.py;
  ``eligible_epilogue_levels`` against JAX's function case by case;
  ``block_epilogue_plain`` against JAX's per-block chain
  (parallel/mesh.py:223-242) bitwise on integer storage.
* The batch forms' plain twins against per-row calls of the per-block
  plain functions (bitwise), padding rows zero.
* ``run_sharded_batches``: padding rows are never consumed, each drain
  worker copies exactly its device's rows, a retry round re-runs only the
  failed batch; writes come from the writer pool only, each block once.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

import bigstitcher_spark_tpu.models.affine_fusion as jaf
from bigstitcher_spark_tpu.cli.main import cli as jax_cli
from bigstitcher_spark_tpu.io.chunkstore import ChunkStore as JStore
from bigstitcher_spark_tpu.io.container import (
    read_container_meta as jax_read_meta,
)
from bigstitcher_spark_tpu.io.dataset_io import ViewLoader as JViewLoader
from bigstitcher_spark_tpu.io.spimdata import SpimData as JSpimData
from bigstitcher_spark_tpu.ops import downsample as JD
from bigstitcher_spark_tpu.ops import fusion as JF
from bigstitcher_spark_tpu.utils.testdata import make_synthetic_project
from bigstitcher_spark_tpu_torch.cli.main import main as torch_main
from bigstitcher_spark_tpu_torch.io import container as TC
from bigstitcher_spark_tpu_torch.io.chunkstore import ChunkStore
from bigstitcher_spark_tpu_torch.io.dataset_io import ViewLoader
from bigstitcher_spark_tpu_torch.io.spimdata import SpimData
from bigstitcher_spark_tpu_torch.models import affine_fusion as taf
from bigstitcher_spark_tpu_torch.models.downsample_driver import (
    downsample_pyramid_level,
)
from bigstitcher_spark_tpu_torch.ops import epilogue as E
from bigstitcher_spark_tpu_torch.ops import fusion as F
from bigstitcher_spark_tpu_torch.parallel import mesh as M
from bigstitcher_spark_tpu_torch.parallel import retry as R
from bigstitcher_spark_tpu_torch.utils.geometry import translation_affine
from bigstitcher_spark_tpu_torch.utils.testdata import (
    append_view_transforms,
    rotation_about_z,
)

CPU4 = [torch.device("cpu")] * 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's CPU pool is far slower than one thread on small tensors here
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _project(root, rotate: bool):
    """2x2x1 tiles with sub-pixel translations appended (the generator
    rounds its jitter to whole voxels); ``rotate``: tile 1 turned 4 degrees
    about z (its blocks take the gather kernel)."""
    proj = make_synthetic_project(
        str(root), n_tiles=(2, 2, 1), tile_size=(48, 40, 20), overlap=12,
        seed=3, block_size=(32, 32, 16))
    rng = np.random.default_rng(5)
    tr = {s: translation_affine(rng.uniform(-0.5, 0.5, 3)) for s in range(4)}
    if rotate:
        tr[1] = rotation_about_z(4.0, (60, 20, 10)) @ np.vstack(
            [tr[1], [0, 0, 0, 1]])
    append_view_transforms(proj.xml_path, tr)
    return proj.xml_path


@pytest.fixture(scope="module")
def xmls(tmp_path_factory):
    return {rot: _project(tmp_path_factory.mktemp(f"sh{rot}") / "p", rot)
            for rot in (False, True)}


@pytest.fixture()
def jax_paths(monkeypatch):
    """Routes the JAX driver reported (its end-of-stage summary)."""
    seen = []
    monkeypatch.setattr(jaf, "_record_fusion_stage",
                        lambda stage, stats, path: seen.append(path))
    return seen


def _create(who, xml, out, dtype, extra=()):
    args = ["create-fusion-container", "-x", xml, "-o", out, "-s", "ZARR",
            "-d", dtype, "--blockSize", "16,16,8", "--minIntensity", "0",
            "--maxIntensity", "3000", *extra]
    if who == "jax":
        r = CliRunner().invoke(jax_cli, args, catch_exceptions=False)
        assert r.exit_code == 0, r.output
    else:
        torch_main(args)


def _s0(path, who="torch"):
    store = (ChunkStore if who == "torch" else JStore).open(path)
    return store.open_dataset("0").read_full()[..., 0, 0]


def _levels(path):
    store = ChunkStore.open(path)
    mr = TC.read_container_meta(store).mr_infos[0]
    return [store.open_dataset(m.dataset.strip("/")).read_full()
            for m in mr]


def _max_delta(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


# ------------------------------------------------------------ end to end

CASES = {
    "shift": (False, "UINT16", [], ["--fusionType", "AVG_BLEND"]),
    "gather": (True, "UINT16", [], ["--fusionType", "AVG_BLEND"]),
    "sep": (False, "UINT16",
            ["--preserveAnisotropy", "--anisotropyFactor", "2"], []),
    "masks": (False, "UINT8", [], ["--masks", "--maskOffset", "1.5,1.5,0.5"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_route_matches_jax_and_per_block(xmls, tmp_path, jax_paths,
                                                 monkeypatch, capsys, case):
    rotate, dtype, container, fusion = CASES[case]
    xml = xmls[rotate]
    outs = {}
    for who in ("jax", "torch", "per-block"):
        out = str(tmp_path / f"{who}.ome.zarr")
        _create("jax" if who == "jax" else "torch", xml, out, dtype,
                container)
        if who == "jax":
            r = CliRunner().invoke(jax_cli, ["affine-fusion", "-o", out,
                                             "--devices", "8", *fusion],
                                   catch_exceptions=False)
            assert r.exit_code == 0, r.output
        elif who == "torch":
            capsys.readouterr()
            (stats,) = torch_main(["affine-fusion", "-o", out, "--device",
                                   "cpu", "--devices", "4", *fusion])
            assert "mesh: 4 devices (cpu, cpu, cpu, cpu) for --devices 4" \
                in capsys.readouterr().out
        else:
            monkeypatch.setenv("BST_DEVICE_TILE_BUDGET", "1")
            (pb,) = torch_main(["affine-fusion", "-o", out, "--device",
                                "cpu", *fusion])
        outs[who] = out
    assert jax_paths == ["sharded"]
    assert stats.path == "sharded" and pb.path == "per-block"
    assert stats.mesh == ("cpu",) * 4
    assert stats.kernel_blocks == pb.kernel_blocks
    kinds = {k for k, n in stats.kernel_blocks.items() if n}
    assert kinds == {"shift": {"shift"}, "gather": {"shift", "gather"},
                     "sep": {"sep"}, "masks": {"shift"}}[case]
    assert sum(b["blocks"] for b in stats.buckets) == \
        stats.blocks - stats.skipped_empty
    a, b, c = _s0(outs["jax"], "jax"), _s0(outs["torch"]), \
        _s0(outs["per-block"])
    assert _max_delta(a, b) <= 1
    np.testing.assert_array_equal(b, c)
    assert (b > 0).mean() > 0.6


def _coefficients(views, seed=9):
    rng = np.random.default_rng(seed)
    out = {}
    for v in views:
        g = np.empty((2, 3, 2, 2), np.float32)
        g[..., 0] = rng.uniform(0.8, 1.25, g.shape[:3])
        g[..., 1] = rng.uniform(-40.0, 40.0, g.shape[:3])
        out[int(v.setup)] = g
    return out


@pytest.mark.parametrize("rotate", [False, True], ids=["shift", "gather"])
def test_sharded_route_with_coefficients(xmls, tmp_path, jax_paths,
                                         monkeypatch, rotate):
    """Intensity grids send every block to K3's batch form (its
    coefficient branch): within 1 of JAX's sharded route, bitwise the
    port's per-block route."""
    xml = xmls[rotate]
    jsd, tsd = JSpimData.load(xml), SpimData.load(xml)
    grids = _coefficients(tsd.view_ids())
    outs = {}
    for who in ("jax", "torch", "per-block"):
        out = str(tmp_path / f"{who}.ome.zarr")
        _create("jax" if who == "jax" else "torch", xml, out, "UINT16")
        if who == "jax":
            store = JStore.open(out)
            meta = jax_read_meta(store)
            st = jaf.fuse_volume(
                jsd, JViewLoader(jsd), jsd.view_ids(),
                store.open_dataset("0"), meta.bbox, (16, 16, 8),
                out_dtype="uint16", min_intensity=0.0, max_intensity=3000.0,
                zarr_ct=(0, 0), devices=8,
                coefficients={v: grids[int(v.setup)]
                              for v in jsd.view_ids()})
        else:
            if who == "per-block":
                monkeypatch.setenv("BST_DEVICE_TILE_BUDGET", "1")
            store = ChunkStore.open(out)
            meta = TC.read_container_meta(store)
            st = taf.fuse_volume(
                tsd, ViewLoader(tsd), tsd.view_ids(),
                store.open_dataset("0"), meta.bbox, (16, 16, 8),
                out_dtype="uint16", min_intensity=0.0, max_intensity=3000.0,
                zarr_ct=(0, 0), device="cpu",
                devices=4 if who == "torch" else None,
                coefficients={v: grids[int(v.setup)]
                              for v in tsd.view_ids()})
            if who == "torch":
                assert st.path == "sharded"
                assert st.kernel_blocks["gather"] == \
                    st.blocks - st.skipped_empty
                assert {b["key"][0] for b in st.buckets} == {"gather"}
            else:
                assert st.path == "per-block"
        outs[who] = out
    assert jax_paths == ["sharded"]
    a, b, c = (_s0(outs["jax"], "jax"), _s0(outs["torch"]),
               _s0(outs["per-block"]))
    assert _max_delta(a, b) <= 1
    np.testing.assert_array_equal(b, c)
    # the grids move the volume
    plain = str(tmp_path / "plain.ome.zarr")
    _create("torch", xml, plain, "UINT16")
    torch_main(["affine-fusion", "-o", plain, "--device", "cpu",
                "--devices", "4"])
    assert _max_delta(_s0(plain), b) > 20


# ------------------------------------------------------------- epilogue


@pytest.fixture(scope="module")
def epi_project(tmp_path_factory):
    """tests/test_epilogue.py's fixture."""
    return make_synthetic_project(
        str(tmp_path_factory.mktemp("epi") / "proj"),
        n_tiles=(2, 2, 1), tile_size=(48, 48, 24), overlap=12,
        jitter=2.0, seed=13, block_size=(16, 16, 8), n_beads_per_tile=15)


ANISO_STEPS = ["-ds", "1,1,1", "-ds", "2,2,1", "-ds", "4,4,2"]


def _fuse_epi(xml, out, steps, pyramid):
    _create("torch", xml, out, "UINT16", steps)
    args = ["affine-fusion", "-o", out, "--device", "cpu", "--devices", "4"]
    (stats,) = torch_main(args + (["--pyramid"] if pyramid else []))
    return stats


def _reread(src, dst, xml, steps):
    """The epilogue run's own s0 copied into a fresh container, every level
    made by the container-reread downsample stage."""
    _create("torch", xml, dst, "UINT16", steps)
    store = ChunkStore.open(dst)
    mr = TC.read_container_meta(store).mr_infos[0]
    store.open_dataset("0").write(_levels(src)[0], (0,) * 5)
    for lvl in range(1, len(mr)):
        downsample_pyramid_level(store, mr[lvl - 1], mr[lvl], True, (0, 0),
                                 device="cpu")
    return _levels(dst)


def test_sharded_prefix_plus_fallback_bit_identical(epi_project, tmp_path):
    """The epilogue makes the chunk-aligned prefix (level 1: its (16, 16, 8)
    pieces of a (32, 32, 8) block are whole chunks; level 2's (8, 8, 4)
    are not); the downsample stage tops up the rest from level 1; every
    level bitwise equal to the reread flow (tests/test_epilogue.py:174)."""
    out = str(tmp_path / "sh.zarr")
    st = _fuse_epi(epi_project.xml_path, out, ANISO_STEPS, True)
    assert st.path == "sharded"
    assert st.pyramid_levels == 1 and st.pyramid_voxels > 0
    store = ChunkStore.open(out)
    mr = TC.read_container_meta(store).mr_infos[0]
    assert TC.epilogue_written(store, mr[1].dataset, (0, 0))
    assert not TC.epilogue_written(store, mr[2].dataset, (0, 0))
    assert st.pyramid_voxels == int(np.prod(mr[1].dimensions[:3]))
    got = _levels(out)
    want = _reread(out, str(tmp_path / "ref.zarr"), epi_project.xml_path,
                   ANISO_STEPS)
    for lvl, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"level {lvl}")
        assert a.std() > 0


def test_sharded_ineligible_factors_fall_back_whole(epi_project, tmp_path):
    """Factors that do not divide the compute block make no prefix; the
    downsample stage fills the pyramid (tests/test_epilogue.py:198)."""
    out = str(tmp_path / "odd.zarr")
    steps = ["-ds", "1,1,1", "-ds", "3,3,3"]
    st = _fuse_epi(epi_project.xml_path, out, steps, True)
    assert st.pyramid_levels == 0 and st.pyramid_voxels == 0
    got = _levels(out)
    assert got[1].std() > 0
    np.testing.assert_array_equal(
        got[1], _reread(out, str(tmp_path / "ref.zarr"),
                        epi_project.xml_path, steps)[1])


class _Ds:
    def __init__(self, block):
        self.block_size = tuple(block)


class _Lv:
    def __init__(self, rel, absf, block):
        self.rel, self.abs_factor, self.ds = rel, absf, _Ds(block)


# (levels as (rel, abs, chunk), compute block, volume dims)
ELIGIBILITY = {
    "prefix 1 of 2": ([((2, 2, 1), (2, 2, 1), (16, 16, 8)),
                       ((2, 2, 2), (4, 4, 2), (16, 16, 8))],
                      (32, 32, 8), (86, 86, 24)),
    "both": ([((2, 2, 1), (2, 2, 1), (16, 16, 8)),
              ((2, 2, 1), (4, 4, 1), (8, 8, 8))],
             (32, 32, 8), (86, 86, 24)),
    "indivisible": ([((3, 3, 3), (3, 3, 3), (16, 16, 8))],
                    (32, 32, 8), (86, 86, 24)),
    "wider than the axis": ([((2, 2, 64), (2, 2, 64), (16, 16, 1))],
                            (32, 32, 64), (86, 86, 24)),
    "edge volume thinner than the block": (
        [((2, 2, 2), (2, 2, 2), (16, 16, 4))], (32, 32, 8), (40, 40, 5)),
    "chunk straddle": ([((2, 2, 2), (2, 2, 2), (16, 16, 8))],
                       (32, 32, 8), (86, 86, 24)),
    "route A block": ([((2, 2, 2), (2, 2, 2), (128, 128, 32)),
                       ((2, 2, 2), (4, 4, 4), (128, 128, 32))],
                      (256, 256, 64), (1952, 1952, 132)),
    "no pyramid": ([], (32, 32, 8), (86, 86, 24)),
}


@pytest.mark.parametrize("case", sorted(ELIGIBILITY))
def test_eligible_epilogue_levels_matches_jax(case):
    specs, block, dims = ELIGIBILITY[case]
    levels = [_Lv(*s) for s in specs]
    ours = taf.eligible_epilogue_levels(levels, block, dims)
    assert ours == jaf.eligible_epilogue_levels(levels, block, dims)
    assert all(a is b for a, b in zip(ours, levels))


def _jax_chain(fused, wsum, mn, mx, out_dtype, masks, rels):
    """JAX ``parallel/mesh.py:223-242``'s epilogue of one block."""
    fused, wsum = jnp.asarray(fused), jnp.asarray(wsum)
    if masks:
        fused = (wsum > 0).astype(jnp.float32)
        if out_dtype != "float32":
            fused = (fused * float(np.iinfo(np.dtype(out_dtype)).max)
                     ).astype(np.dtype(out_dtype))
    else:
        fused = JF._convert_intensity_expr(fused, np.float32(mn),
                                           np.float32(mx), out_dtype)
    out, cur = [fused], fused
    for r in rels:
        cur = JD.convert_storage(JD.downsample_block(cur, r), out_dtype)
        out.append(cur)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("out_dtype,masks,rels", [
    ("uint16", False, ((2, 2, 1), (2, 2, 2))),
    ("uint8", False, ((2, 2, 2),)),
    ("uint16", True, ((2, 2, 1),)),
    ("uint8", True, ()),
    ("float32", True, ((2, 1, 2),)),
    ("uint16", False, ((4, 2, 1), (1, 2, 2))),
])
def test_block_epilogue_plain_matches_jax_chain(out_dtype, masks, rels):
    rng = np.random.default_rng(21)
    B, shape = 3, (16, 8, 8)
    fused = rng.uniform(-50, 3300, (B, *shape)).astype(np.float32)
    wsum = np.where(rng.random((B, *shape)) < 0.3, 0.0,
                    rng.uniform(0, 2, (B, *shape))).astype(np.float32)
    got = E.block_epilogue(torch.from_numpy(fused), torch.from_numpy(wsum),
                           0.0, 3000.0, out_dtype, masks, rels)
    assert len(got) == 1 + len(rels)
    for b in range(B):
        want = _jax_chain(fused[b], wsum[b], 0.0, 3000.0, out_dtype, masks,
                          rels)
        for lvl, (g, w) in enumerate(zip(got, want)):
            assert g[b].numpy().dtype == w.dtype
            np.testing.assert_array_equal(g[b].numpy(), w,
                                          err_msg=f"row {b} level {lvl}")


def test_block_epilogue_refuses_indivisible_factors():
    with pytest.raises(ValueError, match="do not divide"):
        E.block_epilogue_plain(torch.zeros((1, 6, 6, 4)), None, 0.0, 1.0,
                               "uint16", False, ((4, 4, 1),))


# ------------------------------------------------------ batch forms' twins


def _per_view(rng, shape, lo, hi):
    return torch.from_numpy(rng.uniform(lo, hi, (*shape, 3)).astype(
        np.float32))


def _batch_inputs(kind, rng, B=3, V=2, bs=(12, 10, 8), coeffs=False):
    """A batch of random kernel inputs for ``kind``, the last row padding
    (valid 0, zero patches)."""
    shape = (B, V)
    if kind == "shift":
        patches = rng.integers(0, 4000, (*shape, *(s + 1 for s in bs)))
        fr = _per_view(rng, shape, 0, 1)
        head = (fr, torch.from_numpy(rng.uniform(-5, 20, (*shape, 3))
                                     .astype(np.float32)) + fr)
    else:
        patches = rng.integers(0, 4000, (*shape, 16, 14, 10))
        if kind == "sep":
            head = (_per_view(rng, shape, 0.5, 1.5),
                    _per_view(rng, shape, -2, 4), _per_view(rng, shape, 0, 30))
        else:
            aff = np.zeros((*shape, 3, 4), np.float32)
            a = np.deg2rad(rng.uniform(-10, 10, shape))
            aff[..., 0, 0] = aff[..., 1, 1] = np.cos(a)
            aff[..., 0, 1], aff[..., 1, 0] = -np.sin(a), np.sin(a)
            aff[..., 2, 2] = 1.0
            aff[..., 3] = rng.uniform(-2, 4, (*shape, 3))
            head = (torch.from_numpy(aff), _per_view(rng, shape, 0, 30))
    patches = torch.from_numpy(patches.astype(np.uint16))
    patches[-1] = 0
    valid = torch.ones(shape)
    valid[-1] = 0
    valid[0, -1] = 0
    tail = (torch.from_numpy(np.tile(np.float32([40, 30, 20]), (*shape, 1))),
            _per_view(rng, shape, 0, 3), _per_view(rng, shape, 5, 30), valid)
    extra = {}
    if coeffs:
        g = rng.uniform(0.8, 1.2, (*shape, 2, 2, 3, 2)).astype(np.float32)
        ca = np.zeros((*shape, 3, 4), np.float32)
        ca[..., :3, :3] = np.eye(3) * 0.05
        extra = dict(coeffs=torch.from_numpy(g),
                     coeff_affines=torch.from_numpy(ca))
    return (patches, *head, *tail), _per_view(rng, shape, 0, 2), bs, extra


BATCH = {"shift": (F.fuse_block_shift_batch_plain, F.fuse_block_shift_plain,
                   F.fuse_block_shift_batch),
         "sep": (F.fuse_block_sep_batch_plain, F.fuse_block_sep_plain,
                 F.fuse_block_sep_batch),
         "gather": (F.fuse_block_batch_plain, F.fuse_block_plain,
                    F.fuse_block_batch)}


@pytest.mark.parametrize("kind,coeffs", [("shift", False), ("sep", False),
                                         ("gather", False), ("gather", True)])
@pytest.mark.parametrize("fusion_type", ["AVG_BLEND", "FIRST_WINS"])
def test_batch_plain_equals_per_row_plain(kind, coeffs, fusion_type):
    batch_plain, plain, wrapper = BATCH[kind]
    args, ioffs, bs, extra = _batch_inputs(kind, np.random.default_rng(31),
                                           coeffs=coeffs)
    got = batch_plain(*args, bs, fusion_type, ioffs, **extra)
    via_wrapper = wrapper(*args, bs, fusion_type, ioffs, **extra)
    for b in range(args[0].shape[0]):
        row = {k: v[b] for k, v in extra.items()}
        want = plain(*(a[b] for a in args), bs, fusion_type, ioffs[b], **row)
        for g, w, v in zip(got, want, via_wrapper):
            torch.testing.assert_close(g[b], w, rtol=0, atol=0)
            torch.testing.assert_close(v[b], w, rtol=0, atol=0)
    assert got[1][0].max() > 0
    assert not got[0][-1].any() and not got[1][-1].any()  # the padding row


# -------------------------------------------------------------- the loop


def _row_kernel(mesh, calls):
    """A stand-in fuser: row r of each shard's output is stacked input 0's
    row r, placed as make_sharded_fuser places rows."""

    def kernel(batch, *stacked):
        calls.append(int(stacked[0].shape[0]))
        return [M.Shard(dev, r0, (torch.from_numpy(stacked[0][r0:r1]),),
                        None, None, 0.0, 0.0)
                for dev, (r0, r1) in zip(mesh.devices,
                                         M._rows_of(len(stacked[0]),
                                                    len(mesh)))
                if r1 > r0]

    return kernel


def _batches(items, group):
    items = list(items)
    return [items[i:i + group] for i in range(0, len(items), group)]


def _spy_fetch(monkeypatch, lock):
    """Record each drain worker's copy: (its shard's first row, the first
    column of the rows it copied, its thread)."""
    fetched, real = [], M._fetch

    def fetch(shard, timings=None):
        datas = real(shard, timings)
        with lock:
            fetched.append((shard.row0, datas[0][:, 0].tolist(),
                            threading.get_ident()))
        return datas

    monkeypatch.setattr(M, "_fetch", fetch)
    return fetched


@pytest.mark.parametrize("n_mesh", [4, 1], ids=["mesh4", "mesh1"])
@pytest.mark.parametrize("early", ["1", "0"], ids=["ahead", "one-by-one"])
@pytest.mark.parametrize("n_items,per_dev", [(10, 1), (7, 2), (16, 4)])
def test_run_sharded_batches_rows_and_devices(monkeypatch, early, n_items,
                                              per_dev, n_mesh):
    """``n_dev`` 4 on a mesh of 4 devices or of one (``--devices 4`` on a
    one-card host)."""
    monkeypatch.setenv("BST_EARLY_DISPATCH", early)
    mesh = M.make_mesh(devices=[torch.device("cpu")] * n_mesh)
    calls, seen, lock = [], [], threading.Lock()
    fetched = _spy_fetch(monkeypatch, lock)

    def consume(item, row):
        with lock:
            seen.append((item, int(row[0]), threading.get_ident()))

    from concurrent.futures import ThreadPoolExecutor

    group = 4 * per_dev
    with ThreadPoolExecutor(2) as pool:
        n = M.run_sharded_batches(
            _batches(range(n_items), group),
            lambda it: (np.full((3,), it, np.int64),),
            _row_kernel(mesh, calls), consume, pool, mesh)
    driver = threading.get_ident()
    assert n == len(calls) == -(-n_items // group)
    # each batch padded to a multiple of the mesh only
    assert calls == [-(-min(group, n_items - i) // n_mesh) * n_mesh
                     for i in range(0, n_items, group)]
    # every real item consumed once, with its own row, padding never, off
    # the driver thread
    assert sorted(s[0] for s in seen) == list(range(n_items))
    assert all(item == row and tid != driver for item, row, tid in seen)
    # each drain worker copied exactly the rows of its device, once (the
    # padding rows are zeros)
    want = [(r0, [bi * group + r if bi * group + r < n_items else 0
                  for r in range(r0, r1)])
            for bi, n_rows in enumerate(calls)
            for r0, r1 in M._rows_of(n_rows, n_mesh) if r1 > r0]
    assert sorted(f[:2] for f in fetched) == sorted(want)
    assert all(tid != driver for *_x, tid in fetched)


@pytest.mark.parametrize("early", ["1", "0"], ids=["ahead", "one-by-one"])
def test_run_sharded_batches_mixes_buckets(monkeypatch, early):
    """Batches of two buckets (inputs of different widths) in one loop:
    each batch reaches the kernel with its own items and widths, and every
    row is consumed once, at its bucket's width."""
    monkeypatch.setenv("BST_EARLY_DISPATCH", early)
    mesh = M.make_mesh(devices=CPU4)
    calls, seen, lock = [], [], threading.Lock()
    widths = {"a": 3, "b": 5}
    batches = [[("a", i) for i in range(4)], [("b", i) for i in range(4, 8)],
               [("b", 8)], [("a", 9), ("a", 10)]]
    kernel = _row_kernel(mesh, calls)

    def checked(batch, *stacked):
        assert {k for k, _ in batch} == {batch[0][0]}
        assert stacked[0].shape[1] == widths[batch[0][0]]
        return kernel(batch, *stacked)

    def consume(item, row):
        with lock:
            seen.append((item, int(row.shape[0]), int(row[0])))

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        n = M.run_sharded_batches(
            batches, lambda it: (np.full((widths[it[0]],), it[1], np.int64),),
            checked, consume, pool, mesh)
    assert n == len(calls) == 4
    assert sorted(seen) == sorted((it, widths[it[0]], it[1])
                                  for b in batches for it in b)


def test_retry_reruns_only_the_failed_batch(monkeypatch):
    monkeypatch.setattr(R.time, "sleep", lambda s: None)
    mesh = M.make_mesh(devices=CPU4)
    calls, built, consumed = [], [], []
    failed = []

    def build(it):
        built.append(it)
        return (np.full((2,), it, np.int64),)

    def consume(item, row):
        if item == 5 and not failed:
            failed.append(item)
            raise OSError("transient write failure")
        consumed.append(item)

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        M.run_sharded_batches(_batches(range(12), 4), build,
                              _row_kernel(mesh, calls), consume, pool, mesh)
    assert failed == [5]
    assert len(calls) == 4          # three batches and one retry
    assert sorted(built) == sorted(list(range(12)) + [4, 5, 6, 7])
    assert sorted(set(consumed)) == list(range(12))
    assert consumed.count(5) == 1


def test_retry_gives_up_after_max_rounds(monkeypatch):
    monkeypatch.setattr(R.time, "sleep", lambda s: None)

    def boom(it):
        raise ValueError(it)

    with pytest.raises(R.RetryError, match="ValueError x3"):
        R.run_with_retry([1], boom, max_retries=2, verbose=False)


def test_writes_come_from_drain_workers_disjoint(epi_project, tmp_path,
                                                 monkeypatch):
    """Every block and epilogue piece is copied back by the drain worker of
    the device that computed it and written by the writer pool, off the
    driver thread, exactly once (tests/test_epilogue.py:332)."""
    driver = threading.get_ident()
    writes, lock = [], threading.Lock()
    real = taf._write
    fetched = _spy_fetch(monkeypatch, lock)

    def spy(ds, data, offset, zarr_ct):
        cur = threading.current_thread()
        with lock:
            writes.append((ds.path, tuple(offset), cur.name, cur.ident))
        real(ds, data, offset, zarr_ct)

    monkeypatch.setattr(taf, "_write", spy)
    st = _fuse_epi(epi_project.xml_path, str(tmp_path / "w.zarr"),
                   ANISO_STEPS[:4], True)
    n_blocks = st.blocks - st.skipped_empty
    s0 = [w for w in writes if w[0] == "0"]
    assert len(s0) == n_blocks > 4
    assert len(writes) == 2 * n_blocks   # and one level-1 piece each
    assert all(name.startswith("bst-write") and t != driver
               for _p, _o, name, t in writes)
    assert len({(p, o) for p, o, _n, _t in writes}) == len(writes)
    # a 16-row batch's rows were copied by one drain worker a mesh device
    assert {0, 4, 8, 12} <= {r0 for r0, _rows, _t in fetched}
    assert all(t != driver for *_x, t in fetched)


def test_make_mesh():
    assert M.make_mesh(devices=CPU4).devices == tuple(CPU4)
    assert len(M.make_mesh(3, platform="cpu")) == 3
    with pytest.raises(ValueError):
        M.make_mesh(2, platform="tpu")


def test_add_time_under_contention():
    """The drain workers' shared timings lose no update (32 threads, a
    short switch interval)."""
    import sys

    timings, n, per = {}, 32, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            M.add_time(timings, "write", 1.0) for _ in range(per)])
            for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert timings["write"] == n * per
