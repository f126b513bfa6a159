"""``detect-interestpoints`` command (SparkInterestPointDetection equivalent).

Port of ``detect_interestpoints_cmd`` in
``bigstitcher_spark_tpu/cli/detection_tools.py`` on argparse, with the same
option spellings (SparkInterestPointDetection.java:116-170). DoG detection
of every selected view on one device (K6 pooling, K15-K18), points saved
into ``interestpoints.n5`` beside the XML and registered in the XML under
their label, in the JAX package's format. ``match-interestpoints`` is not
yet ported.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

from ..io.dataset_io import ViewLoader
from ..io.interestpoints import InterestPointStore
from ..io.spimdata import SpimData
from ..models.detection import (
    DetectionParams,
    DetectionStats,
    ViewDetections,
    detect_interest_points,
    save_detections,
)
from ..utils.device import resolve_device
from .common import (
    add_infrastructure_options,
    add_view_selection_options,
    add_xml_option,
    check_infrastructure,
    check_xml,
    parse_csv_ints,
    select_views_from_args,
)


@dataclass
class DetectionRun:
    """What the command computed: each view's detections, the parameters,
    and the run's counts and seconds (``stats.timings["store"]`` holds the
    seconds of writing the store and the XML)."""

    detections: list[ViewDetections]
    params: DetectionParams
    stats: DetectionStats


def add_detect_interestpoints(sub) -> argparse.ArgumentParser:
    p = sub.add_parser("detect-interestpoints", allow_abbrev=False,
                       help="difference-of-Gaussian interest-point "
                            "detection")
    add_xml_option(p)
    add_view_selection_options(p)
    add_infrastructure_options(p)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("-l", "--label", default="beads",
                   help="interest point label")
    p.add_argument("-s", "--sigma", type=float, default=1.8,
                   help="DoG sigma (at detection resolution)")
    p.add_argument("-t", "--threshold", type=float, default=0.008,
                   help="DoG response threshold")
    p.add_argument("-dsxy", "--downsampleXY", dest="downsample_xy", type=int,
                   default=2)
    p.add_argument("-dsz", "--downsampleZ", dest="downsample_z", type=int,
                   default=1)
    p.add_argument("-i0", "--minIntensity", dest="min_intensity", type=float,
                   default=None)
    p.add_argument("-i1", "--maxIntensity", dest="max_intensity", type=float,
                   default=None)
    p.add_argument("--localization", default="QUADRATIC",
                   choices=("NONE", "QUADRATIC"),
                   help="subpixel localization method")
    p.add_argument("--onlyCompareOverlapTiles", dest="only_tiles",
                   action="store_true",
                   help="with --overlappingOnly, test overlap only against "
                        "views of the same timepoint+channel (i.e. across "
                        "tiles)")
    p.add_argument("--prefetch", action="store_true",
                   help="accepted for reference compatibility; the next "
                        "batch's reads always run ahead")
    p.add_argument("--type", dest="extrema", default="MAX",
                   choices=("MAX", "MIN", "BOTH"),
                   help="detect maxima, minima or both")
    p.add_argument("--overlappingOnly", dest="overlapping_only",
                   action="store_true",
                   help="only detect in regions overlapping other selected "
                        "views")
    p.add_argument("--maxSpots", dest="max_spots", type=int, default=0,
                   help="keep only the brightest N spots per view (0 = all)")
    p.add_argument("--maxSpotsPerOverlap", dest="max_spots_per_overlap",
                   action="store_true",
                   help="distribute --maxSpots over overlap regions by "
                        "volume")
    p.add_argument("--keepTemporaryN5", action="store_true",
                   help="accepted for compatibility: detections are "
                        "compacted on the device, no temporary N5 is staged")
    p.add_argument("--storeIntensities", dest="store_intensities",
                   action="store_true",
                   help="sample + store per-point image intensities")
    p.add_argument("--medianFilter", dest="median_radius", type=int,
                   default=0,
                   help="background-divide by per-slice median of this "
                        "radius (0=off)")
    p.add_argument("--blockSize", dest="block_size", default="512,512,128",
                   help="detection block size at detection resolution")
    p.set_defaults(func=detect_interestpoints_cmd)
    return p


def detect_interestpoints_cmd(args: argparse.Namespace) -> DetectionRun:
    """DoG interest-point detection of the selected views; saves the points
    and the XML unless --dryRun."""
    check_infrastructure(args)
    device = resolve_device(args.device)
    xml = check_xml(args.xml)
    sd = SpimData.load(xml)
    views = select_views_from_args(sd, args)
    params = DetectionParams(
        label=args.label, sigma=args.sigma, threshold=args.threshold,
        downsample_xy=args.downsample_xy, downsample_z=args.downsample_z,
        min_intensity=args.min_intensity, max_intensity=args.max_intensity,
        find_max=args.extrema in ("MAX", "BOTH"),
        find_min=args.extrema in ("MIN", "BOTH"),
        overlapping_only=args.overlapping_only,
        localization=args.localization,
        only_compare_overlap_tiles=args.only_tiles,
        max_spots=args.max_spots,
        max_spots_per_overlap=args.max_spots_per_overlap,
        store_intensities=args.store_intensities,
        median_radius=args.median_radius,
        block_size=tuple(parse_csv_ints(args.block_size, 3)),
    )
    stats = DetectionStats()
    detections = detect_interest_points(sd, ViewLoader(sd), views, params,
                                        device=device, stats=stats)
    total = sum(len(d.points) for d in detections)
    print(f"detected {total} interest points over {len(detections)} views")
    run = DetectionRun(detections, params, stats)
    if args.dry_run:
        print("dryRun: not saving")
        return run
    t0 = time.perf_counter()
    save_detections(sd, InterestPointStore.for_project(sd), detections,
                    params)
    sd.save(xml)
    stats.timings["store"] += time.perf_counter() - t0
    print(f"saved interest points '{params.label}' + XML")
    return run
