"""``solver`` command: global optimization of view registrations.

Port of ``bigstitcher_spark_tpu/cli/solver_tools.py`` on argparse, with the
same option spellings (reference: Solver.java:104-158 options +
AbstractRegistration.java:62-77). The relaxation runs in the relax kernels
K11-K14 on the card (``--solverBackend device``, the default through
``BST_SOLVE_DEVICE``), in their plain twins with ``--device cpu``, or in the
JAX package's host numpy path with ``--solverBackend numpy``; the corrections
are preconcatenated to the views' registrations in the XML.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np

from ..io.spimdata import SpimData, ViewId
from ..models import solver as S
from ..ops.solve import resolve_backend
from ..utils.device import resolve_device
from .common import (
    add_infrastructure_options,
    add_view_selection_options,
    add_xml_option,
    check_infrastructure,
    check_xml,
    select_views_from_args,
)

_METHODS = ("ONE_ROUND_SIMPLE", "ONE_ROUND_ITERATIVE", "TWO_ROUND_SIMPLE",
            "TWO_ROUND_ITERATIVE")
_MODELS = ("TRANSLATION", "RIGID", "AFFINE")
_REGS = ("NONE", "IDENTITY", "TRANSLATION", "RIGID", "AFFINE")


@dataclass
class SolverRun:
    """What the command computed: the solve, its parameters, and the host
    seconds of the whole command by phase ("matches", "warm_start",
    "relax" from the solve, "store" for the XML, "total")."""

    result: S.SolveResult
    params: S.SolverParams
    timings: dict


def _upper(s: str) -> str:
    return s.upper()


def add_solver(sub) -> argparse.ArgumentParser:
    p = sub.add_parser("solver", allow_abbrev=False,
                       help="globally optimize per-view transforms from "
                            "stitching shifts or corresponding interest "
                            "points")
    add_xml_option(p)
    add_view_selection_options(p)
    add_infrastructure_options(p)
    p.add_argument("--device", default="cuda",
                   help="torch device of the device backend: cuda "
                        "(default) or cpu")
    p.add_argument("-s", "--sourcePoints", dest="source", required=True,
                   type=_upper, choices=("IP", "STITCHING"),
                   help="source of the solve: IP (interest points) or "
                        "STITCHING")
    p.add_argument("-l", "--label", dest="labels", action="append",
                   default=[], help="interest-point label(s) used for "
                                    "registration")
    p.add_argument("-lw", "--labelweights", dest="label_weights",
                   action="append", type=float, default=[],
                   help="weight per label (default 1.0)")
    p.add_argument("--method", default="ONE_ROUND_SIMPLE", choices=_METHODS,
                   help="two-round handles unconnected tiles, iterative "
                        "drops wrong links")
    p.add_argument("-tm", "--transformationModel", dest="model",
                   default="TRANSLATION", choices=_MODELS,
                   help="transformation model (default TRANSLATION for "
                        "stitching)")
    p.add_argument("-rm", "--regularizationModel", dest="regularization",
                   default="NONE", choices=_REGS)
    p.add_argument("--lambda", dest="lam", type=float, default=0.1,
                   help="regularizer interpolation weight (default 0.1)")
    p.add_argument("--maxError", dest="max_error", type=float, default=5.0)
    p.add_argument("--maxIterations", dest="max_iterations", type=int,
                   default=10000)
    p.add_argument("--maxPlateauwidth", dest="max_plateau_width", type=int,
                   default=200)
    p.add_argument("--relativeThreshold", dest="relative_threshold",
                   type=float, default=3.5)
    p.add_argument("--absoluteThreshold", dest="absolute_threshold",
                   type=float, default=7.0)
    p.add_argument("--disableFixedViews", dest="disable_fixed_views",
                   action="store_true")
    p.add_argument("-fv", "--fixedViews", dest="fixed_views",
                   action="append", default=[],
                   help="fixed view ids 'timepoint,setup' (default: first "
                        "per subset)")
    p.add_argument("--groupIllums", dest="group_illums",
                   action=argparse.BooleanOptionalAction, default=None)
    p.add_argument("--groupChannels", dest="group_channels",
                   action=argparse.BooleanOptionalAction, default=None)
    p.add_argument("--groupTiles", dest="group_tiles", action="store_true")
    p.add_argument("--splitTimepoints", dest="split_timepoints",
                   action="store_true")
    p.add_argument("--solverBackend", dest="backend", default="auto",
                   choices=("auto", "device", "numpy"),
                   help="global-optimization backend: device = the relax "
                        "kernels on --device (their plain twins on the "
                        "CPU), numpy = host reference path, auto = the "
                        "BST_SOLVE_DEVICE knob (default on)")
    p.set_defaults(func=solver_cmd)
    return p


def solver_cmd(args: argparse.Namespace) -> SolverRun:
    """Globally optimize per-view transforms from stitching shifts or
    corresponding interest points; writes the result into the XML unless
    --dryRun."""
    check_infrastructure(args)
    backend = None if args.backend == "auto" else args.backend
    if resolve_backend(backend) == "device":
        resolve_device(args.device)  # no card: raise before any work
    t0 = time.perf_counter()
    xml = check_xml(args.xml)
    sd = SpimData.load(xml)
    views = select_views_from_args(sd, args)
    params = S.SolverParams(
        source=args.source,
        method=args.method,
        model=args.model,
        regularization=args.regularization,
        lam=args.lam,
        max_error=args.max_error,
        max_iterations=args.max_iterations,
        max_plateau_width=args.max_plateau_width,
        relative_threshold=args.relative_threshold,
        absolute_threshold=args.absolute_threshold,
        disable_fixed_views=args.disable_fixed_views,
        fixed_views=[ViewId(*map(int, fv.split(","))) for fv in args.fixed_views],
        labels=list(args.labels),
        label_weights=list(args.label_weights),
        group_illums=args.group_illums,
        group_channels=args.group_channels,
        group_tiles=args.group_tiles,
        split_timepoints=args.split_timepoints,
        backend=backend,
        device=args.device,
    )
    result = S.solve(sd, views, params)
    for key, corr in sorted(result.corrections.items())[:50]:
        print(f"  {key[0]}{'+' + str(len(key) - 1) if len(key) > 1 else ''}: "
              f"t={np.round(corr[:, 3], 3)}")
    if len(result.corrections) > 50:
        print(f"  ... ({len(result.corrections)} tiles)")
    timings = dict(result.timings)
    if args.dry_run:
        print("dryRun: not saving XML")
    else:
        t1 = time.perf_counter()
        S.store_corrections(sd, result, params)
        sd.save(xml)
        timings["store"] = time.perf_counter() - t1
        print(f"saved {xml}")
    timings["total"] = time.perf_counter() - t0
    return SolverRun(result, params, timings)
