"""``detect-interestpoints`` and ``match-interestpoints`` commands
(SparkInterestPointDetection, SparkGeometricDescriptorMatching equivalents).

Port of ``detect_interestpoints_cmd`` and ``match_interestpoints_cmd`` in
``bigstitcher_spark_tpu/cli/detection_tools.py`` on argparse, with the same
option spellings (SparkInterestPointDetection.java:116-170,
SparkGeometricDescriptorMatching.java:82-189). Detection: DoG of every
selected view on one device (K6 pooling, K15-K18), points saved into
``interestpoints.n5`` beside the XML and registered in the XML under their
label, in the JAX package's format. Matching: descriptors, ratio test and
RANSAC or ICP per overlapping view pair on one device (K19-K22), the
inliers saved symmetrically as ``correspondences`` in ``interestpoints.n5``,
which ``solver -s IP`` reads.
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
from ..models.matching import (
    MatchingParams,
    MatchingStats,
    PairMatchResult,
    match_interest_points,
    save_matches,
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


@dataclass
class MatchingRun:
    """What ``match-interestpoints`` computed: each pair's result, the
    parameters, and the run's counts and seconds (``stats.timings["store"]``
    holds the seconds of writing the correspondences)."""

    results: list[PairMatchResult]
    params: MatchingParams
    stats: MatchingStats


def add_match_interestpoints(sub) -> argparse.ArgumentParser:
    p = sub.add_parser("match-interestpoints", allow_abbrev=False,
                       help="pairwise interest-point matching")
    add_xml_option(p)
    add_view_selection_options(p)
    add_infrastructure_options(p)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("-l", "--label", dest="labels", action="append",
                   default=None,
                   help="interest point label(s); repeat for multiple "
                        "(default beads)")
    p.add_argument("--matchAcrossLabels", dest="match_across",
                   action="store_true",
                   help="with multiple -l labels, also match between label "
                        "classes")
    p.add_argument("-m", "--method", default="FAST_ROTATION",
                   choices=("FAST_ROTATION", "FAST_TRANSLATION",
                            "PRECISE_TRANSLATION", "ICP"),
                   help="matching method (SparkGeometricDescriptorMatching "
                        "enum)")
    p.add_argument("--transformationModel", dest="model", default="AFFINE",
                   choices=("TRANSLATION", "RIGID", "AFFINE"))
    p.add_argument("--regularizationModel", dest="reg", default="RIGID",
                   choices=("NONE", "IDENTITY", "TRANSLATION", "RIGID",
                            "AFFINE"))
    p.add_argument("--lambda", dest="lam", type=float, default=0.1,
                   help="regularization weight")
    p.add_argument("-rtp", "--registrationTP", dest="registration_tp",
                   default="TIMEPOINTS_INDIVIDUALLY",
                   choices=("TIMEPOINTS_INDIVIDUALLY", "ALL_TO_ALL",
                            "ALL_TO_ALL_WITH_RANGE", "REFERENCE_TIMEPOINT"))
    p.add_argument("--referenceTP", dest="reference_tp", type=int, default=0)
    p.add_argument("--rangeTP", dest="range_tp", type=int, default=5)
    p.add_argument("-s", "--significance", dest="ratio_of_distance",
                   type=float, default=3.0,
                   help="descriptor ratio-of-distance threshold")
    p.add_argument("-n", "--numNeighbors", dest="n_neighbors", type=int,
                   default=3)
    p.add_argument("-r", "--redundancy", dest="redundancy", type=int,
                   default=1)
    p.add_argument("-rit", "--ransacIterations", dest="ransac_iterations",
                   type=int, default=10000)
    p.add_argument("-rme", "--ransacMaxError", "--ransacMaxEpsilon",
                   dest="ransac_max_epsilon", type=float, default=5.0)
    p.add_argument("-rmir", "--ransacMinInlierRatio",
                   dest="ransac_min_inlier_ratio", type=float, default=0.1)
    p.add_argument("-rmni", "--ransacMinNumInliers",
                   dest="ransac_min_inliers", type=int, default=12)
    p.add_argument("-rmc", "--ransacMultiConsensus", dest="ransac_multi",
                   action="store_true",
                   help="ransac performs multiconsensus matching")
    p.add_argument("-ime", "--icpMaxError", "--icpMaxDistance",
                   dest="icp_max_distance", type=float, default=2.5)
    p.add_argument("-iit", "--icpIterations", "--icpMaxIterations",
                   dest="icp_max_iterations", type=int, default=200)
    p.add_argument("--icpUseRANSAC", dest="icp_use_ransac",
                   action="store_true",
                   help="ICP filters correspondences with RANSAC every "
                        "iteration")
    p.add_argument("-sr", "--searchRadius", dest="search_radius", type=float,
                   default=None,
                   help="limit corresponding points to this distance in "
                        "global coordinates")
    p.add_argument("-vr", "--viewReg", dest="view_reg",
                   default="OVERLAPPING_ONLY",
                   choices=("OVERLAPPING_ONLY", "ALL_AGAINST_ALL"),
                   help="which view pairs to match")
    p.add_argument("--interestPointsForOverlapOnly",
                   dest="overlap_only_points", action="store_true",
                   help="match only points inside the pair overlap")
    p.add_argument("-ipfr", "--interestpointsForReg", dest="ipfr",
                   default=None, choices=("ALL", "OVERLAPPING_ONLY"),
                   help="which interest points to use for pairwise "
                        "registrations (OVERLAPPING_ONLY is "
                        "--interestPointsForOverlapOnly)")
    p.add_argument("--clearCorrespondences", dest="clear_corrs",
                   action="store_true",
                   help="drop existing correspondences instead of merging")
    p.add_argument("--groupTiles", dest="group_tiles", action="store_true",
                   help="merge all tiles of one angle/channel/illum/"
                        "timepoint")
    p.add_argument("--groupChannels", dest="group_channels",
                   action="store_true",
                   help="merge all channels of one angle/illum/tile/"
                        "timepoint")
    p.add_argument("--groupIllums", dest="group_illums", action="store_true",
                   help="merge all illuminations of one angle/channel/tile/"
                        "timepoint")
    p.add_argument("--splitTimepoints", dest="split_timepoints",
                   action="store_true",
                   help="treat each timepoint as one grouped view")
    p.add_argument("--interestPointMergeDistance", dest="merge_distance",
                   type=float, default=5.0,
                   help="merge radius (px) for grouped interest points")
    p.set_defaults(func=match_interestpoints_cmd)
    return p


def match_interestpoints_cmd(args: argparse.Namespace) -> MatchingRun:
    """Pairwise matching of the selected views; saves the correspondences
    unless --dryRun."""
    check_infrastructure(args)
    device = resolve_device(args.device)
    xml = check_xml(args.xml)
    sd = SpimData.load(xml)
    views = select_views_from_args(sd, args)
    labels = list(args.labels or ["beads"])
    params = MatchingParams(
        label=labels[0], labels=tuple(labels[1:]),
        match_across_labels=args.match_across,
        method=args.method, model=args.model, regularization=args.reg,
        lam=args.lam, n_neighbors=args.n_neighbors,
        redundancy=args.redundancy,
        ratio_of_distance=args.ratio_of_distance,
        ransac_iterations=args.ransac_iterations,
        ransac_max_epsilon=args.ransac_max_epsilon,
        ransac_min_inlier_ratio=args.ransac_min_inlier_ratio,
        ransac_min_inliers=args.ransac_min_inliers,
        ransac_multi_consensus=args.ransac_multi,
        search_radius=args.search_radius,
        icp_max_distance=args.icp_max_distance,
        icp_max_iterations=args.icp_max_iterations,
        icp_use_ransac=args.icp_use_ransac,
        overlap_filter=args.view_reg == "OVERLAPPING_ONLY",
        registration_tp=args.registration_tp,
        reference_tp=args.reference_tp, range_tp=args.range_tp,
        interest_points_for_overlap_only=(
            args.overlap_only_points or args.ipfr == "OVERLAPPING_ONLY"),
        clear_correspondences=args.clear_corrs,
        group_tiles=args.group_tiles, group_channels=args.group_channels,
        group_illums=args.group_illums,
        split_timepoints=args.split_timepoints,
        merge_distance=args.merge_distance,
    )
    store = InterestPointStore.for_project(sd)
    stats = MatchingStats()
    results = match_interest_points(sd, views, params, store, device=device,
                                    stats=stats)
    total = sum(len(r.ids_a) for r in results)
    print(f"matched {total} correspondences over {len(results)} pairs")
    run = MatchingRun(results, params, stats)
    if args.dry_run:
        print("dryRun: not saving")
        return run
    t0 = time.perf_counter()
    save_matches(sd, store, results, params, views)
    stats.timings["store"] += time.perf_counter() - t0
    print("saved correspondences")
    return run
