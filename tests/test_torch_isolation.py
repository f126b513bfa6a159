"""The port stands alone: no JAX, no JAX package, cuda by default.

* An AST walk over every module of ``bigstitcher_spark_tpu_torch``, over
  ``chip_smoke.py`` and ``scripts/kernel_yardsticks.py`` finds no import of
  ``jax`` or ``bigstitcher_spark_tpu``.
* Entry points default to ``cuda`` and raise where there is none.
* The port's argparse accepts every option spelling of the ten JAX click
  commands it ports; the options not yet ported are refused with a pointer
  to ROADMAP.md instead of doing something else.
"""

import ast
import os

import numpy as np
import pytest
import torch

import bigstitcher_spark_tpu_torch as port
from bigstitcher_spark_tpu.cli.detection_tools import (
    detect_interestpoints_cmd as jax_detect,
    match_interestpoints_cmd as jax_match,
)
from bigstitcher_spark_tpu.cli.fusion_tools import (
    affine_fusion_cmd as jax_affine_fusion,
    create_fusion_container_cmd as jax_create_container,
    nonrigid_fusion_cmd as jax_nonrigid_fusion,
)
from bigstitcher_spark_tpu.cli.intensity_tools import (
    match_intensities_cmd as jax_match_intensities,
    solve_intensities_cmd as jax_solve_intensities,
)
from bigstitcher_spark_tpu.cli.resave_tools import downsample_cmd as jax_downsample
from bigstitcher_spark_tpu.cli.solver_tools import solver_cmd as jax_solver
from bigstitcher_spark_tpu.cli.stitching_tools import (
    stitching_cmd as jax_stitching,
)
from bigstitcher_spark_tpu_torch import NotYetPorted
from bigstitcher_spark_tpu_torch.cli.main import main as torch_main
from bigstitcher_spark_tpu_torch.cli.main import tool_parser
from bigstitcher_spark_tpu_torch.models.affine_fusion import fuse_volume
from bigstitcher_spark_tpu_torch.models.detection import detect_interest_points
from bigstitcher_spark_tpu_torch.models.intensity import (
    match_intensities,
    solve_intensities,
)
from bigstitcher_spark_tpu_torch.models.matching import match_interest_points
from bigstitcher_spark_tpu_torch.models.nonrigid_fusion import (
    fuse_nonrigid_volume,
)
from bigstitcher_spark_tpu_torch.models.stitching import stitch_all_pairs
from bigstitcher_spark_tpu_torch.ops.downsample import (
    halfpixel_downsample2x_axis,
)
from bigstitcher_spark_tpu_torch.ops.fusion import fuse_volume_scan
from bigstitcher_spark_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(port.__file__)


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "scripts", "kernel_yardsticks.py")]
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
    assert tool_parser("solver").parse_args(
        ["-x", "x", "-s", "IP"]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_main(["solver", "-x", str(tmp_path / "missing.xml"), "-s",
                    "STITCHING"])
    with pytest.raises(RuntimeError, match="CUDA"):
        detect_interest_points(None, None, [])
    assert tool_parser("detect-interestpoints").parse_args(
        ["-x", "x"]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_main(["detect-interestpoints", "-x",
                    str(tmp_path / "missing.xml")])
    with pytest.raises(RuntimeError, match="CUDA"):
        match_interest_points(None, [])
    assert tool_parser("match-interestpoints").parse_args(
        ["-x", "x"]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_main(["match-interestpoints", "-x",
                    str(tmp_path / "missing.xml")])
    with pytest.raises(RuntimeError, match="CUDA"):
        match_intensities(None, None, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_intensities([], [], (2, 2, 2))
    for tool in ("match-intensities", "solve-intensities"):
        assert tool_parser(tool).parse_args(["-x", "x"]).device == "cuda"
        with pytest.raises(RuntimeError, match="CUDA"):
            torch_main([tool, "-x", str(tmp_path / "missing.xml")])
    with pytest.raises(RuntimeError, match="CUDA"):
        fuse_nonrigid_volume(None, None, [], None, None, None, (8, 8, 8))
    assert tool_parser("nonrigid-fusion").parse_args(
        ["-o", "x"]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_main(["nonrigid-fusion", "-o", str(tmp_path / "missing.zarr")])
    # the two device programs without a tool: arrays go to cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        fuse_volume_scan(np.zeros((1, 4, 4, 4), np.uint16), *[None] * 9,
                         0.0, 1.0, (2, 2, 2), (2, 2, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        halfpixel_downsample2x_axis(np.zeros(4, np.float32), 0)


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
    ("solver", jax_solver),
    ("detect-interestpoints", jax_detect),
    ("match-interestpoints", jax_match),
    ("match-intensities", jax_match_intensities),
    ("solve-intensities", jax_solve_intensities),
    ("nonrigid-fusion", jax_nonrigid_fusion),
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
    ("match-intensities", ["--trace"], "--trace"),
    ("affine-fusion", ["--trace"], "--trace"),
    ("downsample", ["-s", "HDF5"], "-s HDF5"),
    ("downsample", ["--telemetry-dir", "t"], "--telemetry-dir"),
    ("stitching", ["--profile"], "--profile"),
    ("stitching", ["--s3Region", "us-east-1"], "--s3Region"),
    ("solver", ["--trace"], "--trace"),
    ("detect-interestpoints", ["--trace"], "--trace"),
    ("detect-interestpoints", ["--profile"], "--profile"),
    ("detect-interestpoints", ["--telemetry-dir", "t"], "--telemetry-dir"),
    ("detect-interestpoints", ["--s3Region", "us-east-1"], "--s3Region"),
    ("match-interestpoints", ["--profile"], "--profile"),
    ("match-interestpoints", ["--telemetry-dir", "t"], "--telemetry-dir"),
    ("nonrigid-fusion", ["--profile"], "--profile"),
    ("nonrigid-fusion", ["--trace"], "--trace"),
    ("nonrigid-fusion", ["--bdv"], "--bdv"),
    ("nonrigid-fusion", ["-s", "HDF5"], "-s HDF5"),
])
def test_not_yet_ported_options_are_refused(tool, args, what):
    base = {"create-fusion-container": ["-x", "unused.xml", "-o",
                                        "unused.zarr"],
            "affine-fusion": ["-o", "unused.zarr"],
            "downsample": ["-i", "unused.n5", "-di", "s0", "-ds", "2,2,1"],
            "stitching": ["-x", "unused.xml"],
            "solver": ["-x", "unused.xml", "-s", "IP"],
            "detect-interestpoints": ["-x", "unused.xml"],
            "match-interestpoints": ["-x", "unused.xml"],
            "match-intensities": ["-x", "unused.xml"],
            "nonrigid-fusion": ["-o", "unused.zarr"],
            }[tool]
    with pytest.raises(NotYetPorted, match="ROADMAP.md") as e:
        torch_main([tool, *base, *args])
    assert what in str(e.value)


def test_remote_roots_are_refused():
    with pytest.raises(NotYetPorted, match="s3://"):
        torch_main(["affine-fusion", "-o", "s3://bucket/fused.zarr",
                    "--device", "cpu"])
