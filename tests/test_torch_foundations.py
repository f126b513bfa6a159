"""The port's host layer against the JAX package: XML, chunk IO, containers.

The state both packages share is the project on disk, so these tests
carry it across in both directions: the port reads what the JAX package
wrote (SpimData XML, N5 and OME-ZARR datasets) and the JAX package reads
what the port wrote. Equality here is exact.
"""

import json
import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from bigstitcher_spark_tpu.cli.main import cli as jax_cli
from bigstitcher_spark_tpu.io.chunkstore import ChunkStore as JStore
from bigstitcher_spark_tpu.io.chunkstore import StorageFormat as JFormat
from bigstitcher_spark_tpu.io.spimdata import SpimData as JSpimData
from bigstitcher_spark_tpu.utils import viewselect as jviewselect
from bigstitcher_spark_tpu.utils.grid import create_grid as jcreate_grid
from bigstitcher_spark_tpu.utils.testdata import make_synthetic_project
from bigstitcher_spark_tpu_torch import NotYetPorted
from bigstitcher_spark_tpu_torch.cli.main import main as torch_main
from bigstitcher_spark_tpu_torch.io import zstd
from bigstitcher_spark_tpu_torch.io.chunkstore import ChunkStore as TStore
from bigstitcher_spark_tpu_torch.io.chunkstore import StorageFormat as TFormat
from bigstitcher_spark_tpu_torch.io.container import read_container_meta
from bigstitcher_spark_tpu_torch.io.dataset_io import ViewLoader
from bigstitcher_spark_tpu_torch.io.spimdata import SpimData as TSpimData
from bigstitcher_spark_tpu_torch.io.spimdata import ViewId
from bigstitcher_spark_tpu_torch.utils import viewselect as tviewselect
from bigstitcher_spark_tpu_torch.utils.grid import create_grid as tcreate_grid
from bigstitcher_spark_tpu_torch.utils.testdata import (
    make_synthetic_project as torch_make_synthetic_project,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    return make_synthetic_project(
        str(tmp_path_factory.mktemp("found") / "p"), n_tiles=(2, 2, 1),
        tile_size=(40, 36, 16), overlap=10, block_size=(16, 16, 8))


def test_xml_round_trip_is_byte_identical(project, tmp_path):
    # an unknown section must survive both packages' load/save unchanged
    tree = ET.parse(project.xml_path)
    extra = ET.SubElement(tree.getroot(), "CustomSection", kind="x")
    ET.SubElement(extra, "item").text = "kept"
    src = str(tmp_path / "in.xml")
    tree.write(src, encoding="unicode", xml_declaration=True)
    a, b = str(tmp_path / "jax.xml"), str(tmp_path / "torch.xml")
    JSpimData.load(src).save(a)
    TSpimData.load(src).save(b)
    with open(a) as fa, open(b) as fb:
        ta, tb = fa.read(), fb.read()
    assert ta == tb
    assert "<CustomSection" in tb and "kept" in tb


def test_generator_matches_jax(project, tmp_path):
    mine = torch_make_synthetic_project(
        str(tmp_path / "p"), n_tiles=(2, 2, 1), tile_size=(40, 36, 16),
        overlap=10, block_size=(16, 16, 8))
    with open(project.xml_path) as fa, open(mine.xml_path) as fb:
        assert fa.read() == fb.read()
    lj = ViewLoader(TSpimData.load(project.xml_path))
    lt = ViewLoader(TSpimData.load(mine.xml_path))
    for s in range(4):
        np.testing.assert_array_equal(lj.open(ViewId(0, s)).read_full(),
                                      lt.open(ViewId(0, s)).read_full())
    assert mine.true_offsets.keys() == project.true_offsets.keys()
    np.testing.assert_array_equal(mine.bead_positions, project.bead_positions)


def _data(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.normal(0, 100, shape).astype(dtype)
    return rng.integers(0, np.iinfo(dtype).max, shape).astype(dtype)


CODECS = [("N5", "zstd"), ("N5", "gzip"), ("N5", "raw"), ("ZARR", "zstd"),
          ("ZARR", "gzip"), ("ZARR", "raw")]


@pytest.mark.parametrize("fmt,codec", CODECS)
def test_port_reads_jax_written(tmp_path, fmt, codec):
    js = JStore.create(str(tmp_path / f"c.{fmt.lower()}"), JFormat(fmt))
    shape, block = (37, 20, 11), (16, 8, 4)  # ragged edge chunks
    for dtype in ("uint16", "float32"):
        data = _data(dtype, shape, 1)
        js.create_dataset(f"d/{dtype}", shape, block, dtype,
                          compression=codec).write(data, (0, 0, 0))
        ts = TStore.open(js.root)
        ds = ts.open_dataset(f"d/{dtype}")
        assert ds.shape == shape and ds.block_size == block
        np.testing.assert_array_equal(ds.read_full(), data)
        np.testing.assert_array_equal(ds.read((5, 3, 2), (20, 9, 7)),
                                      data[5:25, 3:12, 2:9])


@pytest.mark.parametrize("fmt,codec", CODECS + [("N5", "bzip2"), ("N5", "xz")])
def test_jax_reads_port_written(tmp_path, fmt, codec):
    ts = TStore.create(str(tmp_path / f"c.{fmt.lower()}"), TFormat(fmt))
    shape, block = (37, 20, 11), (16, 8, 4)
    data = _data("uint16", shape, 2)
    ds = ts.create_dataset("d", shape, block, "uint16", compression=codec)
    ds.write(data[:20], (0, 0, 0))            # whole and partial chunks
    ds.write(data[20:], (20, 0, 0))           # read-modify-write at x=16..31
    js = JStore.open(ts.root)
    np.testing.assert_array_equal(js.open_dataset("d").read_full(), data)
    np.testing.assert_array_equal(ds.read_full(), data)


def test_port_metadata_files_match_tensorstore(tmp_path):
    for fmt, name in (("N5", "attributes.json"), ("ZARR", ".zarray")):
        for codec in ("zstd", "gzip", "raw"):
            js = JStore.create(str(tmp_path / f"j{codec}.{fmt}"), JFormat(fmt))
            ts = TStore.create(str(tmp_path / f"t{codec}.{fmt}"), TFormat(fmt))
            js.create_dataset("a/s0", (9, 8, 7), (4, 4, 4), "uint16",
                              compression=codec)
            ts.create_dataset("a/s0", (9, 8, 7), (4, 4, 4), "uint16",
                              compression=codec)
            with open(os.path.join(js.root, "a/s0", name)) as fa, \
                    open(os.path.join(ts.root, "a/s0", name)) as fb:
                assert json.load(fa) == json.load(fb)


def test_zstd_binding_round_trip():
    raw = bytes(range(256)) * 512
    assert zstd.decompress(zstd.compress(raw, 3), len(raw)) == raw
    with pytest.raises(ValueError):
        zstd.decompress(b"not a frame", 10)


def test_not_yet_ported_storage(tmp_path):
    with pytest.raises(NotYetPorted, match="ROADMAP.md"):
        TStore.create(str(tmp_path / "x.n5"), TFormat.N5).create_dataset(
            "d", (4, 4, 4), (2, 2, 2), "uint8", compression="lz4")
    with pytest.raises(NotYetPorted):
        TStore("s3://bucket/x.zarr", TFormat.ZARR)
    with pytest.raises(NotYetPorted):
        TStore(str(tmp_path / "x.h5"), TFormat.HDF5)


def test_view_selection_bbox_and_grid_match_jax(project):
    jsd, tsd = JSpimData.load(project.xml_path), TSpimData.load(project.xml_path)
    for kw in ({}, {"tile_ids": "1,3"}, {"vi": ["0,2"]}):
        jv = jviewselect.select_views(jsd, **kw)
        tv = tviewselect.select_views(tsd, **kw)
        assert [(v.timepoint, v.setup) for v in jv] == \
            [(v.timepoint, v.setup) for v in tv]
        jb = jviewselect.maximal_bounding_box(jsd, jv)
        tb = tviewselect.maximal_bounding_box(tsd, tv)
        assert (jb.min, jb.max) == (tb.min, tb.max)
    for dims, cb, sb in (((100, 90, 20), (32, 32, 16), (16, 16, 8)),
                         ((7, 9, 3), (4, 4, 2), None)):
        assert [tuple(vars(b).values()) for b in jcreate_grid(dims, cb, sb)] \
            == [tuple(vars(b).values()) for b in tcreate_grid(dims, cb, sb)]


@pytest.mark.parametrize("storage,extra", [
    ("N5", ["-c", "gzip"]),
    ("ZARR", ["-c", "zstd", "-cl", "5", "--preserveAnisotropy"]),
])
def test_create_fusion_container_attributes_match_jax(project, tmp_path,
                                                      storage, extra):
    args = ["create-fusion-container", "-x", project.xml_path, "-s", storage,
            "-d", "UINT16", "--blockSize", "16,16,8", "--minIntensity", "0",
            "--maxIntensity", "3000", *extra]
    ext = "n5" if storage == "N5" else "ome.zarr"
    a, b = str(tmp_path / f"jax.{ext}"), str(tmp_path / f"torch.{ext}")
    r = CliRunner().invoke(jax_cli, args + ["-o", a])
    assert r.exit_code == 0, r.output
    torch_main(args + ["-o", b])
    ja, ta = JStore.open(a), TStore.open(b)
    assert ja.get_attributes("") == ta.get_attributes("")
    for root, _dirs, files in os.walk(a):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), a)
            with open(os.path.join(a, rel)) as fa, open(os.path.join(b, rel)) as fb:
                assert json.load(fa) == json.load(fb), rel
    meta = read_container_meta(ta)
    assert meta.fusion_format == ("N5" if storage == "N5" else "OME-ZARR")
    assert meta.data_type == "uint16"
