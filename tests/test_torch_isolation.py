"""The port stands alone: no JAX, no JAX package, cuda by default.

* An AST walk over every module of ``bigstitcher_spark_tpu_torch`` and over
  ``chip_smoke.py`` finds no import of ``jax`` or ``bigstitcher_spark_tpu``.
* Entry points default to ``cuda`` and raise where there is none.
* The port's argparse accepts every option spelling of the four JAX click
  commands it ports; the options not yet ported are refused with a pointer
  to ROADMAP.md instead of doing something else.
"""

import ast
import os

import pytest
import torch

import bigstitcher_spark_tpu_torch as port
from bigstitcher_spark_tpu.cli.fusion_tools import (
    affine_fusion_cmd as jax_affine_fusion,
    create_fusion_container_cmd as jax_create_container,
)
from bigstitcher_spark_tpu.cli.resave_tools import downsample_cmd as jax_downsample
from bigstitcher_spark_tpu.cli.stitching_tools import (
    stitching_cmd as jax_stitching,
)
from bigstitcher_spark_tpu_torch import NotYetPorted
from bigstitcher_spark_tpu_torch.cli.main import main as torch_main
from bigstitcher_spark_tpu_torch.cli.main import tool_parser
from bigstitcher_spark_tpu_torch.models.affine_fusion import fuse_volume
from bigstitcher_spark_tpu_torch.models.stitching import stitch_all_pairs
from bigstitcher_spark_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(port.__file__)


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "bigstitcher_spark_tpu")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert not bad, f"{path} imports {bad}"


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        fuse_volume(None, None, [], None, None, (8, 8, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_main(["affine-fusion", "-o", str(tmp_path / "missing.zarr")])
    assert tool_parser("affine-fusion").parse_args(
        ["-o", "x"]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        stitch_all_pairs(None, None, [])
    assert tool_parser("stitching").parse_args(["-x", "x"]).device == "cuda"


def _click_spellings(cmd):
    out = set()
    for p in cmd.params:
        out.update(o for o in p.opts + p.secondary_opts if o.startswith("-"))
    return out


@pytest.mark.parametrize("tool,cmd", [
    ("create-fusion-container", jax_create_container),
    ("affine-fusion", jax_affine_fusion),
    ("downsample", jax_downsample),
    ("stitching", jax_stitching),
])
def test_argparse_accepts_every_jax_spelling(tool, cmd):
    mine = set(tool_parser(tool)._option_string_actions)
    missing = sorted(_click_spellings(cmd) - mine)
    assert not missing, f"{tool} lacks {missing}"


@pytest.mark.parametrize("tool,args,what", [
    ("create-fusion-container", ["-s", "HDF5"], "-s HDF5"),
    ("create-fusion-container", ["-s", "HDF5", "--multiRes"], "-s HDF5"),
    ("create-fusion-container", ["-c", "blosc"], "blosc"),
    ("create-fusion-container", ["-c", "lz4"], "lz4"),
    ("create-fusion-container", ["--bdv"], "--bdv"),
    ("create-fusion-container", ["--s3Region", "us-east-1"], "--s3Region"),
    ("affine-fusion", ["--intensityN5"], "--intensityN5"),
    ("affine-fusion", ["--devices", "4"], "--devices"),
    ("affine-fusion", ["--trace"], "--trace"),
    ("downsample", ["-s", "HDF5"], "-s HDF5"),
    ("downsample", ["--telemetry-dir", "t"], "--telemetry-dir"),
    ("stitching", ["--profile"], "--profile"),
    ("stitching", ["--s3Region", "us-east-1"], "--s3Region"),
])
def test_not_yet_ported_options_are_refused(tool, args, what):
    base = {"create-fusion-container": ["-x", "unused.xml", "-o",
                                        "unused.zarr"],
            "affine-fusion": ["-o", "unused.zarr"],
            "downsample": ["-i", "unused.n5", "-di", "s0", "-ds", "2,2,1"],
            "stitching": ["-x", "unused.xml"],
            }[tool]
    with pytest.raises(NotYetPorted, match="ROADMAP.md") as e:
        torch_main([tool, *base, *args])
    assert what in str(e.value)


def test_remote_roots_are_refused():
    with pytest.raises(NotYetPorted, match="s3://"):
        torch_main(["affine-fusion", "-o", "s3://bucket/fused.zarr",
                    "--device", "cpu"])
