"""Command line of the port: one subcommand per ported tool, with the JAX
package's tool names and option spellings.

Run: ``python -m bigstitcher_spark_tpu_torch.cli.main <tool> [options]``
"""

from __future__ import annotations

import argparse
import sys

from .. import NotYetPorted
from . import (
    detection_tools,
    fusion_tools,
    intensity_tools,
    resave_tools,
    solver_tools,
    stitching_tools,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="bst-torch", allow_abbrev=False,
        description="BigStitcher-Spark tools on PyTorch/CUDA (ported slice)")
    sub = parser.add_subparsers(dest="tool", required=True)
    fusion_tools.add_create_fusion_container(sub)
    fusion_tools.add_affine_fusion(sub)
    fusion_tools.add_nonrigid_fusion(sub)
    resave_tools.add_downsample(sub)
    stitching_tools.add_stitching(sub)
    solver_tools.add_solver(sub)
    detection_tools.add_detect_interestpoints(sub)
    detection_tools.add_match_interestpoints(sub)
    intensity_tools.add_match_intensities(sub)
    intensity_tools.add_solve_intensities(sub)
    return parser


def tool_parser(name: str) -> argparse.ArgumentParser:
    """The parser of one tool (tests read its option spellings)."""
    parser = build_parser()
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            return action.choices[name]
    raise KeyError(name)


def main(argv=None):
    """Parse ``argv`` and run the tool; returns what the tool returns."""
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    try:
        main()
    except (NotYetPorted, ValueError, FileNotFoundError, RuntimeError) as e:
        sys.exit(f"error: {e}")
