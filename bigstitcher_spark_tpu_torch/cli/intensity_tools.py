"""CLI: match-intensities and solve-intensities (reference tools
SparkIntensityMatching.java / IntensitySolver.java), with the JAX
package's option spellings (``bigstitcher_spark_tpu/cli/intensity_tools.py``)."""

from __future__ import annotations

import argparse
import time

from .common import (
    add_infrastructure_options,
    add_view_selection_options,
    add_xml_option,
    check_infrastructure,
    check_xml,
    parse_csv_ints,
    select_views_from_args,
)


def add_match_intensities(sub) -> argparse.ArgumentParser:
    p = sub.add_parser("match-intensities", allow_abbrev=False,
                       help="pairwise per-cell intensity matching")
    add_xml_option(p)
    add_view_selection_options(p)
    add_infrastructure_options(p)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--numCoefficients", "--coefficients", dest="coefficients",
                   default="8,8,8",
                   help="number of coefficients per dimension (default: 8,8,8)")
    p.add_argument("--renderScale", dest="render_scale", type=float,
                   default=0.25,
                   help="at which scale to sample images (default: 0.25)")
    p.add_argument("-m", "--method", choices=("RANSAC", "HISTOGRAM"),
                   default="RANSAC")
    p.add_argument("--maxEpsilon", "--ransacEpsilon", dest="ransac_epsilon",
                   type=float, default=0.02,
                   help="maximal transfer error relative to the "
                        "[0,1]-normalized intensity range (default: 0.02)")
    p.add_argument("--numIterations", "--ransacIterations",
                   dest="ransac_iterations", type=int, default=1000,
                   help="number of RANSAC iterations (default: 1000)")
    p.add_argument("--minSamples", dest="min_samples", type=int, default=10)
    p.add_argument("--minThreshold", dest="min_threshold", type=float,
                   default=1.0,
                   help="discard intensities below this value (default: 1)")
    p.add_argument("--maxThreshold", dest="max_threshold", type=float,
                   default=float("nan"),
                   help="discard intensities above this value (default: none)")
    p.add_argument("--minNumCandidates", dest="min_num_candidates", type=int,
                   default=1000,
                   help="minimum overlapping samples per coefficient-cell "
                        "pair (default: 1000)")
    p.add_argument("--minInlierRatio", dest="min_inlier_ratio", type=float,
                   default=0.1,
                   help="minimal inliers/candidates ratio (default: 0.1)")
    p.add_argument("--minNumInliers", dest="min_num_inliers", type=int,
                   default=10, help="minimally required inliers (default: 10)")
    p.add_argument("--maxTrust", dest="max_trust", type=float, default=3.0,
                   help="reject candidates with residual > maxTrust * median "
                        "(default: 3)")
    p.add_argument("-o", "--outputPath", "--intensityN5", dest="intensity_n5",
                   default=None,
                   help="output N5 for pairwise matches (default: "
                        "intensity.n5 next to the XML)")
    p.set_defaults(func=match_intensities_cmd)
    return p


def match_intensities_cmd(args: argparse.Namespace):
    """Pairwise per-cell intensity matching. Returns (matches,
    IntensityStats)."""
    from ..io.dataset_io import ViewLoader
    from ..io.spimdata import SpimData
    from ..models.intensity import (
        IntensityParams,
        IntensityStats,
        IntensityStore,
        match_intensities,
    )
    from ..utils.device import resolve_device

    check_infrastructure(args)
    device = resolve_device(args.device)
    sd = SpimData.load(check_xml(args.xml))
    views = select_views_from_args(sd, args)
    params = IntensityParams(
        coefficients=tuple(parse_csv_ints(args.coefficients, 3)),
        render_scale=args.render_scale, method=args.method,
        ransac_epsilon=args.ransac_epsilon,
        ransac_iterations=args.ransac_iterations,
        min_samples_per_cell=args.min_samples,
        min_threshold=args.min_threshold, max_threshold=args.max_threshold,
        min_num_candidates=args.min_num_candidates,
        min_inlier_ratio=args.min_inlier_ratio,
        min_num_inliers=args.min_num_inliers, max_trust=args.max_trust,
    )
    stats = IntensityStats()
    matches = match_intensities(sd, ViewLoader(sd), views, params,
                                device=device, stats=stats)
    print(f"matched {len(matches)} coefficient-cell pairs "
          f"({stats.cell_pairs} cell pairs fitted over {stats.pairs} view "
          f"pairs)")
    if args.dry_run:
        print("dryRun: not saving")
        return matches, stats
    t0 = time.perf_counter()
    store = (IntensityStore(args.intensity_n5) if args.intensity_n5
             else IntensityStore.for_project(sd))
    store.save_matches(matches, params.coefficients)
    stats.timings["store"] += time.perf_counter() - t0
    print(f"saved matches to {store.root}")
    return matches, stats


def add_solve_intensities(sub) -> argparse.ArgumentParser:
    p = sub.add_parser("solve-intensities", allow_abbrev=False,
                       help="global solve of per-view intensity grids")
    add_xml_option(p)
    add_view_selection_options(p)
    add_infrastructure_options(p)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--lambda", dest="lam", type=float, default=0.1,
                   help="regularization toward identity")
    p.add_argument("--numCoefficients", dest="num_coefficients", default=None,
                   help="expected coefficients per dimension; validated "
                        "against the stored matches")
    p.add_argument("--matchesPath", dest="matches_path", default=None,
                   help="N5 with pairwise matches (default: the intensity N5)")
    p.add_argument("--maxIterations", dest="max_iterations", type=int,
                   default=2000,
                   help="accepted for compatibility: the CG runs to its own "
                        "convergence rule")
    p.add_argument("-o", "--intensityN5Path", "--intensityN5",
                   dest="intensity_n5", default=None,
                   help="N5 for matches/coefficients (default: intensity.n5 "
                        "next to the XML)")
    p.add_argument("-s", "--intensityN5Storage", dest="intensity_storage",
                   default=None,
                   help="storage format of the intensity N5 (validated)")
    p.add_argument("--intensityN5Group", dest="intensity_group", default=None,
                   help="group holding the coefficients (default: "
                        "coefficients)")
    p.add_argument("--intensityN5Dataset", dest="intensity_dataset",
                   default=None,
                   help="dataset name of each view's coefficients (default: "
                        "coefficients)")
    p.set_defaults(func=solve_intensities_cmd)
    return p


def solve_intensities_cmd(args: argparse.Namespace):
    """Global solve of per-view intensity coefficient grids. Returns
    {view: (cx, cy, cz, 2) grid}."""
    from ..io.spimdata import SpimData
    from ..models.intensity import IntensityStore, solve_intensities
    from ..utils.device import resolve_device

    check_infrastructure(args)
    device = resolve_device(args.device)
    sd = SpimData.load(check_xml(args.xml))
    views = select_views_from_args(sd, args)
    match_root = args.matches_path or args.intensity_n5
    store = (IntensityStore(match_root) if match_root
             else IntensityStore.for_project(sd))
    fmt = store.store.format.name.lower()
    if args.intensity_storage and not fmt.startswith(
            args.intensity_storage.lower().replace("ome-", "")):
        raise ValueError(f"--intensityN5Storage {args.intensity_storage} "
                         f"does not match the store at {store.root} ({fmt})")
    matches = store.load_all_matches()
    dims = store.coefficient_dims()
    if not matches or dims is None:
        raise ValueError(f"no intensity matches in {store.root}; run "
                         "match-intensities first")
    if args.num_coefficients is not None:
        want = tuple(parse_csv_ints(args.num_coefficients, 3))
        if want != tuple(dims):
            raise ValueError(f"--numCoefficients {want} does not match the "
                             f"stored matches ({tuple(dims)})")
    coeffs = solve_intensities(matches, views, dims, args.lam, device=device)
    if args.dry_run:
        for v, c in sorted(coeffs.items()):
            print(f"  {v}: scale [{c[..., 0].min():.3f}, "
                  f"{c[..., 0].max():.3f}] offset [{c[..., 1].min():.1f}, "
                  f"{c[..., 1].max():.1f}]")
        print("dryRun: not saving")
        return coeffs
    out_store = (IntensityStore(args.intensity_n5)
                 if args.intensity_n5 and args.intensity_n5 != match_root
                 else store)
    for v, c in coeffs.items():
        out_store.save_coefficients(v, c, group=args.intensity_group,
                                    dataset=args.intensity_dataset)
    print(f"saved coefficients for {len(coeffs)} views to {out_store.root}")
    return coeffs
