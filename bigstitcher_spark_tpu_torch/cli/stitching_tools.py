"""``stitching`` command (SparkPairwiseStitching equivalent).

Port of ``bigstitcher_spark_tpu/cli/stitching_tools.py`` on argparse, with
the same option spellings (SparkPairwiseStitching.java:76-106). FFT phase
correlation of every overlapping tile pair on one device (K7-K10, K6 for
the crop downsampling); the results and their registration hashes land in
the XML's StitchingResults for the solver.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np

from ..io.dataset_io import ViewLoader
from ..io.spimdata import PairwiseStitchingResult, SpimData
from ..models.stitching import (
    StitchingParams,
    StitchingStats,
    filter_results,
    stitch_all_pairs,
    store_results,
)
from ..ops.phasecorr import MAX_PEAKS
from .common import (
    add_infrastructure_options,
    add_view_selection_options,
    add_xml_option,
    check_infrastructure,
    check_xml,
    parse_csv_ints,
    select_views_from_args,
)

_COMBINE = ("AVERAGE", "PICK_BRIGHTEST")


@dataclass
class StitchingRun:
    """What the command computed: every pair's result, the kept ones, and
    the run's counts and seconds."""

    results: list[PairwiseStitchingResult]
    kept: list[PairwiseStitchingResult]
    stats: StitchingStats


def add_stitching(sub) -> argparse.ArgumentParser:
    p = sub.add_parser("stitching", allow_abbrev=False,
                       help="pairwise phase-correlation stitching of "
                            "overlapping tiles")
    add_xml_option(p)
    add_view_selection_options(p)
    add_infrastructure_options(p)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("-ds", "--downsampling", dest="downsampling",
                   default="2,2,1",
                   help="downsampling for the correlation, e.g. 4,4,1")
    p.add_argument("-p", "--peaksToCheck", dest="peaks", type=int, default=5,
                   help="phase-correlation peaks to verify by "
                        f"cross-correlation (1 to {MAX_PEAKS})")
    p.add_argument("--disableSubpixelResolution", dest="no_subpixel",
                   action="store_true")
    p.add_argument("--minR", dest="min_r", type=float, default=0.3,
                   help="minimum required cross correlation")
    p.add_argument("--maxR", dest="max_r", type=float, default=1.0)
    p.add_argument("--maxShiftX", dest="max_shift_x", type=float, default=None)
    p.add_argument("--maxShiftY", dest="max_shift_y", type=float, default=None)
    p.add_argument("--maxShiftZ", dest="max_shift_z", type=float, default=None)
    p.add_argument("--maxShiftTotal", dest="max_shift_total", type=float,
                   default=None)
    p.add_argument("--channelCombine", dest="channel_combine",
                   choices=_COMBINE, default="AVERAGE")
    p.add_argument("--illumCombine", dest="illum_combine", choices=_COMBINE,
                   default="PICK_BRIGHTEST")
    p.set_defaults(func=stitching_cmd)
    return p


def stitching_cmd(args: argparse.Namespace) -> StitchingRun:
    """Pairwise phase-correlation stitching of overlapping tiles; saves the
    kept results into the XML unless --dryRun."""
    check_infrastructure(args)
    if not 1 <= args.peaks <= MAX_PEAKS:
        raise ValueError(f"--peaksToCheck {args.peaks}: 1 to {MAX_PEAKS}")
    xml = check_xml(args.xml)
    sd = SpimData.load(xml)
    loader = ViewLoader(sd)
    views = select_views_from_args(sd, args)

    inf = float("inf")
    params = StitchingParams(
        downsampling=tuple(parse_csv_ints(args.downsampling, 3)),
        peaks_to_check=args.peaks,
        subpixel=not args.no_subpixel,
        min_r=args.min_r, max_r=args.max_r,
        max_shift=tuple(inf if v is None else v for v in (
            args.max_shift_x, args.max_shift_y, args.max_shift_z)),
        max_shift_total=(inf if args.max_shift_total is None
                         else args.max_shift_total),
        channel_combine=args.channel_combine,
        illum_combine=args.illum_combine,
    )
    stats = StitchingStats()
    results = stitch_all_pairs(sd, loader, views, params, device=args.device,
                               stats=stats)
    for res in results:
        shift = res.transform[:, 3]
        print(f"  {res.views_a} <-> {res.views_b}: "
              f"shift={np.round(shift, 2)} r={res.correlation:.3f}")
    kept = filter_results(results, params)
    print(f"{len(kept)}/{len(results)} pairs pass filters")
    run = StitchingRun(results, kept, stats)
    if args.dry_run:
        print("(dry run, not saving)")
        return run
    store_results(sd, kept, computed=results)
    sd.save(xml)
    print(f"saved StitchingResults -> {xml}")
    return run
