"""``create-fusion-container``, ``affine-fusion`` and ``nonrigid-fusion``
commands.

Port of ``bigstitcher_spark_tpu/cli/fusion_tools.py`` on argparse, with
the same option spellings. Options this slice does not implement are
accepted by the parser and refused with
:class:`~bigstitcher_spark_tpu_torch.NotYetPorted` when used.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from .. import NotYetPorted
from ..io.chunkstore import StorageFormat
from ..io.container import (
    create_fusion_container,
    estimate_multires_pyramid,
    open_container,
    read_container_meta,
)
from ..io.dataset_io import ViewLoader
from ..io.spimdata import SpimData
from ..ops.fusion import FUSION_TYPES
from ..utils.geometry import Interval
from ..utils.viewselect import anisotropy_factor_from_voxel_sizes, maximal_bounding_box
from .common import (
    add_infrastructure_options,
    add_view_selection_options,
    add_xml_option,
    check_infrastructure,
    check_xml,
    parse_csv_ints,
    select_views_from_args,
)

_DTYPES = ("UINT8", "UINT16", "FLOAT32")


def add_create_fusion_container(sub) -> argparse.ArgumentParser:
    p = sub.add_parser("create-fusion-container", allow_abbrev=False,
                       help="create an empty fusion output container")
    add_xml_option(p)
    add_view_selection_options(p)
    add_infrastructure_options(p)
    p.add_argument("-o", "--outputPath", "--output", dest="output",
                   required=True, help="output container path (.n5 / .zarr)")
    p.add_argument("-s", "--storage", choices=("N5", "ZARR", "HDF5"),
                   default="ZARR", help="storage format (HDF5: not yet ported)")
    p.add_argument("-d", "--dataType", dest="data_type", choices=_DTYPES,
                   default="FLOAT32")
    p.add_argument("--blockSize", dest="block_size", default="128,128,128",
                   help="block size, e.g. 128,128,64")
    p.add_argument("-ch", "--numChannels", dest="num_channels_opt", type=int,
                   default=None, help="number of container channels")
    p.add_argument("-tp", "--numTimepoints", dest="num_timepoints_opt",
                   type=int, default=None,
                   help="number of container timepoints")
    p.add_argument("--bdv", action="store_true",
                   help="BDV-project layout (not yet ported)")
    p.add_argument("-xo", "--xmlout", dest="xml_out", default=None,
                   help="output XML path for --bdv (not yet ported)")
    p.add_argument("--multiRes", dest="multi_res", action="store_true",
                   help="automatically estimate a multiresolution pyramid")
    p.add_argument("-ds", "--downsampling", dest="downsampling",
                   action="append", default=None,
                   help="absolute pyramid steps, e.g. -ds 1,1,1 -ds 2,2,1 "
                        "(repeatable; overrides --multiRes)")
    p.add_argument("--preserveAnisotropy", dest="preserve_anisotropy",
                   action="store_true")
    p.add_argument("--anisotropyFactor", dest="anisotropy_factor", type=float,
                   default=float("nan"))
    p.add_argument("--minIntensity", dest="min_intensity", type=float,
                   default=None)
    p.add_argument("--maxIntensity", dest="max_intensity", type=float,
                   default=None)
    p.add_argument("-b", "--boundingBox", dest="bounding_box", default=None,
                   help="named bounding box from the XML")
    p.add_argument("-c", "--compression", default="zstd",
                   choices=("zstd", "gzip", "raw", "blosc", "bzip2", "xz",
                            "lz4"),
                   help="codec (blosc and lz4: not yet ported)")
    p.add_argument("-cl", "--compressionLevel", dest="compression_level",
                   type=int, default=None, help="codec-specific level")
    p.set_defaults(func=create_fusion_container_cmd)
    return p


def create_fusion_container_cmd(args: argparse.Namespace):
    """Create an empty fusion output container + metadata (driver-only)."""
    check_infrastructure(args)
    if args.storage == "HDF5":
        raise NotYetPorted("-s HDF5")
    if args.compression in ("blosc", "lz4"):
        raise NotYetPorted(f"-c {args.compression}")
    if args.bdv:
        raise NotYetPorted("--bdv")
    xml = check_xml(args.xml)
    sd = SpimData.load(xml)
    views = select_views_from_args(sd, args)
    storage_format = StorageFormat(args.storage)
    compression = args.compression
    if compression == "xz" and storage_format != StorageFormat.N5:
        raise ValueError(f"{compression} compression is only available for "
                         "N5 containers")
    if args.compression_level is not None:
        compression = f"{compression}:{args.compression_level}"

    channels = sorted({sd.setups[v.setup].attributes.get("channel", 0)
                       for v in views})
    tps = sorted({v.timepoint for v in views})
    num_channels = (args.num_channels_opt if args.num_channels_opt is not None
                    else len(channels))
    num_timepoints = (args.num_timepoints_opt
                      if args.num_timepoints_opt is not None else len(tps))

    anisotropy_factor = args.anisotropy_factor
    if args.preserve_anisotropy and not np.isfinite(anisotropy_factor):
        anisotropy_factor = anisotropy_factor_from_voxel_sizes(sd, views)

    from ..models.affine_fusion import anisotropy_transform

    aniso = (anisotropy_transform(anisotropy_factor)
             if args.preserve_anisotropy else None)
    if args.bounding_box is not None:
        if args.bounding_box not in sd.bounding_boxes:
            raise ValueError(f"bounding box {args.bounding_box!r} not in XML; "
                             f"have {sorted(sd.bounding_boxes)}")
        bbox = sd.bounding_boxes[args.bounding_box]
        if aniso is not None:
            mn = list(bbox.min)
            mx = list(bbox.max)
            mn[2] = int(np.round(mn[2] / anisotropy_factor))
            mx[2] = int(np.round(mx[2] / anisotropy_factor))
            bbox = Interval(mn, mx)
    else:
        bbox = maximal_bounding_box(sd, views, aniso)

    bs = parse_csv_ints(args.block_size, 3)
    if args.downsampling:
        ds = [parse_csv_ints(d, 3) for d in args.downsampling]
    elif args.multi_res:
        ds = estimate_multires_pyramid(
            bbox.shape, anisotropy_factor if args.preserve_anisotropy
            else float("nan"))
    else:
        ds = [[1, 1, 1]]
    print(f"BoundingBox: {bbox.min} -> {bbox.max} dims={bbox.shape}")
    print(f"numChannels={num_channels} numTimepoints={num_timepoints}")
    print(f"pyramid: {ds}")
    if args.dry_run:
        print("(dry run, not writing)")
        return None

    meta = create_fusion_container(
        args.output, storage_format, os.path.abspath(xml),
        num_timepoints, num_channels, bbox,
        data_type=args.data_type.lower(), block_size=bs, downsamplings=ds,
        compression=compression, bdv=False,
        preserve_anisotropy=args.preserve_anisotropy,
        anisotropy_factor=anisotropy_factor,
        min_intensity=args.min_intensity, max_intensity=args.max_intensity,
    )
    print(f"created {meta.fusion_format} container at {args.output}")
    return meta


def add_affine_fusion(sub) -> argparse.ArgumentParser:
    p = sub.add_parser("affine-fusion", allow_abbrev=False,
                       help="fuse all views into the prepared container")
    add_infrastructure_options(p)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("-o", "--n5Path", "--output", dest="output", required=True,
                   help="fusion container created by create-fusion-container")
    p.add_argument("-s", "--storage", dest="storage_opt", default=None,
                   choices=("N5", "ZARR", "HDF5"),
                   help="container storage format (validated against the "
                        "container's own metadata)")
    add_view_selection_options(p)
    p.add_argument("-f", "--fusion", "--fusionType", dest="fusion_type",
                   type=str.upper, choices=FUSION_TYPES, default="AVG_BLEND")
    p.add_argument("--blockScale", dest="block_scale", default="2,2,1",
                   help="how many container blocks per compute block")
    p.add_argument("--masks", action="store_true",
                   help="write coverage masks instead of fused data")
    p.add_argument("--maskOffset", dest="mask_offset", default="0.0,0.0,0.0")
    p.add_argument("--blendingRange", dest="blending_range", default="40,40,40")
    p.add_argument("--blendingBorder", dest="blending_border", default="0,0,0")
    p.add_argument("-c", "--channelIndex", dest="channel_index", type=int,
                   default=None,
                   help="process only this channel index of the container")
    p.add_argument("-t", "--timepointIndex", dest="timepoint_index", type=int,
                   default=None,
                   help="process only this timepoint index of the container")
    p.add_argument("--prefetch", dest="prefetch", action="store_true",
                   default=True, help="read source blocks ahead (default)")
    p.add_argument("--no-prefetch", dest="prefetch", action="store_false",
                   help="one reader thread")
    p.add_argument("--intensityN5", dest="intensity_n5", nargs="?", const="",
                   default=None,
                   help="apply the intensity-correction coefficients of "
                        "solve-intensities from this N5 (no value: "
                        "intensity.n5 next to the XML)")
    p.add_argument("--devices", dest="devices", type=int, default=None,
                   help="above 1: the sharded route, blocks batched N x "
                        "per_dev at a time over a mesh of the first N cards "
                        "(fewer if the host has fewer: one card runs the "
                        "route on a one-device mesh; N CPU devices with "
                        "--device cpu), and the downsample stage after it "
                        "sharded the same way; default one device")
    p.add_argument("--pyramid", dest="pyramid_epilogue", action="store_true",
                   default=False,
                   help="compute the container's downsample pyramid on the "
                        "device from the fused volume and write it in the "
                        "same drain (composite route: every level; sharded "
                        "route: the block-local prefix; bit-identical to the "
                        "downsample stage, which then skips those levels)")
    p.add_argument("--no-pyramid", dest="pyramid_epilogue",
                   action="store_false")
    p.set_defaults(func=affine_fusion_cmd)
    return p


def affine_fusion_cmd(args: argparse.Namespace):
    """Fuse all views into the prepared container. Returns the list of
    :class:`FusionStats`, one per fused (channel, timepoint) slot."""
    from ..models.affine_fusion import (
        BlendParams,
        fuse_volume,
        pyramid_from_mr,
    )
    from ..utils.device import resolve_device

    check_infrastructure(args)
    device = resolve_device(args.device)
    t_start = time.time()
    store = open_container(args.output)
    if args.storage_opt is not None and store.format != StorageFormat(
            args.storage_opt):
        raise ValueError(f"--storage {args.storage_opt} does not match the "
                         f"container at {args.output} ({store.format.name})")
    meta = read_container_meta(store)
    print(f"FusionFormat: {meta.fusion_format}; bbox {meta.bbox.min}->"
          f"{meta.bbox.max}; dataType {meta.data_type}")
    sd = SpimData.load(meta.input_xml)
    loader = ViewLoader(sd)
    all_views = select_views_from_args(sd, args)
    coefficients = None
    if args.intensity_n5 is not None:
        from ..models.intensity import IntensityStore

        istore = (IntensityStore(args.intensity_n5) if args.intensity_n5
                  else IntensityStore.for_project(sd))
        coefficients = {}
        for v in all_views:
            c = istore.load_coefficients(v)
            if c is not None:
                coefficients[v] = c.astype(np.float32)
        print(f"intensity correction: coefficients for "
              f"{len(coefficients)}/{len(all_views)} views from {istore.root}")
    blend = BlendParams(
        border=tuple(float(v) for v in args.blending_border.split(",")),
        range=tuple(float(v) for v in args.blending_range.split(",")),
    )
    bscale = parse_csv_ints(args.block_scale, 3)
    is_zarr5d = meta.fusion_format in ("OME-ZARR", "BDV/OME-ZARR")
    channels = sorted({sd.setups[v.setup].attributes.get("channel", 0)
                       for v in all_views})
    tps = sorted({v.timepoint for v in all_views})
    c_indices = ([args.channel_index] if args.channel_index is not None
                 else list(range(len(channels))))
    t_indices = ([args.timepoint_index] if args.timepoint_index is not None
                 else list(range(len(tps))))
    moff = tuple(float(v) for v in args.mask_offset.split(","))

    total_vox = 0
    results = []
    for ti in t_indices:
        t = tps[ti]
        for ci in c_indices:
            c = channels[ci]
            views = [v for v in all_views if v.timepoint == t
                     and sd.setups[v.setup].attributes.get("channel", 0) == c]
            if not views:
                continue
            mr = meta.mr_infos[ci + ti * meta.num_channels]
            ds = store.open_dataset(mr[0].dataset.strip("/"))
            print(f"fusing channel {c} timepoint {t}: {len(views)} views "
                  f"-> {mr[0].dataset}")
            if args.dry_run:
                continue
            pyr = (pyramid_from_mr(store, mr)
                   if args.pyramid_epilogue and len(mr) > 1 else None)
            stats = fuse_volume(
                sd, loader, views, ds, meta.bbox,
                block_size=tuple(meta.block_size), block_scale=tuple(bscale),
                fusion_type=args.fusion_type, blend=blend,
                anisotropy_factor=(meta.anisotropy_factor
                                   if meta.preserve_anisotropy
                                   else float("nan")),
                out_dtype=meta.data_type,
                min_intensity=meta.min_intensity,
                max_intensity=meta.max_intensity,
                masks=args.masks, mask_offset=moff,
                zarr_ct=(ci, ti) if is_zarr5d else None,
                io_threads=4 if args.prefetch else 1,
                device=device,
                pyramid=pyr,
                coefficients=coefficients,
                devices=args.devices,
            )
            total_vox += stats.voxels
            results.append(stats)
            tm = " ".join(f"{k}={v:.3f}s" for k, v in stats.timings.items())
            print(f"  path={stats.path} kernels={stats.kernel_blocks} "
                  f"{stats.voxels} voxels in {stats.seconds:.2f}s "
                  f"({stats.voxels / max(stats.seconds, 1e-9):,.0f} vox/s; "
                  f"{stats.skipped_empty} empty blocks skipped) {tm}")
            if stats.path == "sharded":
                _print_mesh(stats, args.devices)
            if stats.pyramid_levels:
                rate = ((stats.voxels + stats.pyramid_voxels)
                        / max(stats.seconds, 1e-9))
                print(f"  epilogue: {stats.pyramid_levels} pyramid level(s), "
                      f"{stats.pyramid_voxels} voxels written in the fusion "
                      f"drain ({rate:,.0f} vox/s incl. pyramid)")
            if len(mr) > 1:
                _write_pyramid(store, mr, is_zarr5d, (ci, ti), device,
                               epilogue_levels=stats.pyramid_levels,
                               devices=args.devices)
    print(f"done, {total_vox} voxels, took {time.time() - t_start:.1f}s")
    return results


def _print_mesh(stats, devices) -> None:
    """A sharded route's mesh line: its devices, and each bucket's blocks,
    per_dev and batches."""
    n = len(stats.mesh)
    print(f"  mesh: {n} device{'s' if n != 1 else ''} "
          f"({', '.join(stats.mesh)}) for --devices {devices}; " + "; ".join(
              f"{b['key'][0]} bucket of {b['blocks']} blocks, "
              f"per_dev {b['per_dev']}, {b['batches']} batches"
              for b in stats.buckets))


def _write_pyramid(store, mr_levels, is_zarr5d, ct, device,
                   epilogue_levels=0, devices=None):
    """Downsample s0 into the remaining pyramid levels
    (SparkAffineFusion.java:703-782). ``epilogue_levels``: how many leading
    levels the fusion epilogue already wrote this run; their container
    markers are set (and stale ones from earlier runs revoked) first, then
    ``downsample_pyramid_level(skip_existing=True)`` skips exactly those.
    ``devices``: above 1, the sharded downsample stage (the tool's
    ``--devices``)."""
    from ..io.container import set_epilogue_written
    from ..models.downsample_driver import downsample_pyramid_level

    for lvl in range(1, len(mr_levels)):
        set_epilogue_written(store, mr_levels[lvl].dataset, ct,
                             lvl <= epilogue_levels)
    for lvl in range(1, len(mr_levels)):
        downsample_pyramid_level(store, mr_levels[lvl - 1], mr_levels[lvl],
                                 is_zarr5d, ct, device=device,
                                 skip_existing=True, devices=devices)


def add_nonrigid_fusion(sub) -> argparse.ArgumentParser:
    p = sub.add_parser("nonrigid-fusion", allow_abbrev=False,
                       help="non-rigid fusion driven by corresponding "
                            "interest points")
    add_infrastructure_options(p)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("-o", "--n5Path", "--output", dest="output", required=True,
                   help="fusion container created by create-fusion-container, "
                        "or a fresh path with -x/--dataType (direct-output "
                        "mode)")
    p.add_argument("-x", "--xml", dest="xml", default=None,
                   help="dataset XML (direct-output mode only; containers "
                        "carry their InputXML)")
    add_view_selection_options(p)
    p.add_argument("-ip", "--interestPoints", "-l", "--label", dest="labels",
                   action="append", default=None,
                   help="interest point label(s) defining the deformation "
                        "(repeatable; default beads)")
    p.add_argument("-cpd", "--controlPointDistance", dest="cpd", type=float,
                   default=10.0, help="control point grid spacing in px")
    p.add_argument("--alpha", type=float, default=1.0,
                   help="inverse-distance weight exponent")
    p.add_argument("--fusionType", dest="fusion_type", type=str.upper,
                   choices=FUSION_TYPES, default="AVG_BLEND")
    p.add_argument("--blockScale", dest="block_scale", default="2,2,1")
    p.add_argument("--blendingRange", dest="blending_range", default="40,40,40")
    p.add_argument("--blendingBorder", dest="blending_border", default="0,0,0")
    p.add_argument("--channelIndex", dest="channel_index", type=int,
                   default=None)
    p.add_argument("--timepointIndex", dest="timepoint_index", type=int,
                   default=None)
    p.add_argument("-s", "--storage", dest="storage_opt", default=None,
                   choices=("N5", "ZARR", "HDF5"),
                   help="storage format for direct-output mode (default ZARR; "
                        "HDF5: not yet ported)")
    p.add_argument("-d", "--n5Dataset", dest="n5_dataset", default=None,
                   help="accepted for compatibility; the container layout "
                        "fixes the dataset names")
    p.add_argument("-p", "--dataType", dest="data_type", default=None,
                   choices=_DTYPES, help="output data type (direct-output mode)")
    p.add_argument("--minIntensity", dest="min_intensity", type=float,
                   default=None)
    p.add_argument("--maxIntensity", dest="max_intensity", type=float,
                   default=None)
    p.add_argument("-b", "--boundingBox", dest="bounding_box", default=None,
                   help="named bounding box (direct-output mode)")
    p.add_argument("--bdv", action="store_true",
                   help="also write a BDV project XML (not yet ported)")
    p.add_argument("-xo", "--xmlout", dest="xml_out", default=None,
                   help="output XML path for --bdv (direct-output mode)")
    p.add_argument("--devices", dest="devices", type=int, default=None,
                   help="above 1: the sharded route, blocks batched N at a "
                        "time over a mesh of the first N cards (fewer if "
                        "the host has fewer: one card runs the route on a "
                        "one-device mesh; N CPU devices with --device cpu); "
                        "default one device")
    p.set_defaults(func=nonrigid_fusion_cmd)
    return p


def nonrigid_fusion_cmd(args: argparse.Namespace):
    """Non-rigid fusion driven by corresponding interest points
    (SparkNonRigidFusion). Returns the list of :class:`FusionStats`, one
    per fused (channel, timepoint) slot."""
    from ..io.interestpoints import InterestPointStore
    from ..models.affine_fusion import BlendParams
    from ..models.nonrigid_fusion import (
        build_unique_points,
        fuse_nonrigid_volume,
    )
    from ..utils.device import resolve_device

    check_infrastructure(args)
    if args.bdv:
        raise NotYetPorted("--bdv")
    if args.storage_opt == "HDF5":
        raise NotYetPorted("-s HDF5")
    device = resolve_device(args.device)
    t_start = time.time()
    try:
        store = open_container(args.output)
        meta = read_container_meta(store)
    except (ValueError, FileNotFoundError) as e:
        # direct-output mode (the reference's SparkNonRigidFusion writes
        # straight to an N5/ZARR, no create-fusion-container step): create
        # the container here from -x/--dataType/--boundingBox
        if args.xml is None or args.data_type is None:
            raise ValueError(
                f"{args.output} is not a fusion container ({e}); for direct "
                "output pass -x <dataset.xml> and -p/--dataType (plus "
                "optionally -s, -b, --minIntensity/--maxIntensity)") from e
        create_fusion_container_cmd(argparse.Namespace(
            **{k: getattr(args, k) for k in (
                "xml", "output", "data_type", "min_intensity",
                "max_intensity", "bounding_box", "xml_out", "angle_ids",
                "channel_ids", "illumination_ids", "tile_ids",
                "timepoint_ids", "vi", "s3_region", "telemetry_dir",
                "profile", "trace")},
            storage=args.storage_opt or "ZARR", block_size="128,128,128",
            num_channels_opt=None, num_timepoints_opt=None, bdv=False,
            multi_res=False, downsampling=None, preserve_anisotropy=False,
            anisotropy_factor=float("nan"), compression="zstd",
            compression_level=None, dry_run=False))
        print(f"direct output: created container at {args.output}")
        store = open_container(args.output)
        meta = read_container_meta(store)
    sd = SpimData.load(meta.input_xml)
    loader = ViewLoader(sd)
    all_views = select_views_from_args(sd, args)
    ip_store = InterestPointStore.for_project(sd)
    labels = args.labels or ["beads"]

    blend = BlendParams(
        border=tuple(float(v) for v in args.blending_border.split(",")),
        range=tuple(float(v) for v in args.blending_range.split(",")),
    )
    bscale = parse_csv_ints(args.block_scale, 3)
    is_zarr5d = meta.fusion_format in ("OME-ZARR", "BDV/OME-ZARR")
    channels = sorted({sd.setups[v.setup].attributes.get("channel", 0)
                       for v in all_views})
    tps = sorted({v.timepoint for v in all_views})
    c_indices = ([args.channel_index] if args.channel_index is not None
                 else list(range(len(channels))))
    t_indices = ([args.timepoint_index] if args.timepoint_index is not None
                 else list(range(len(tps))))

    total_vox = 0
    results = []
    for ti in t_indices:
        t = tps[ti]
        for ci in c_indices:
            c = channels[ci]
            views = [v for v in all_views if v.timepoint == t
                     and sd.setups[v.setup].attributes.get("channel", 0) == c]
            if not views:
                continue
            # deformation may use IPs of ALL views of this timepoint
            # (corresponding views need not be restricted to the channel)
            ip_views = [v for v in all_views if v.timepoint == t]
            unique = build_unique_points(sd, ip_store, ip_views, labels)
            mr = meta.mr_infos[ci + ti * meta.num_channels]
            ds = store.open_dataset(mr[0].dataset.strip("/"))
            print(f"nonrigid fusing channel {c} timepoint {t}: "
                  f"{len(views)} views -> {mr[0].dataset}")
            if args.dry_run:
                continue
            stats = fuse_nonrigid_volume(
                sd, loader, views, unique, ds, meta.bbox,
                block_size=tuple(meta.block_size), block_scale=tuple(bscale),
                cpd=args.cpd, alpha=args.alpha, fusion_type=args.fusion_type,
                blend=blend,
                anisotropy_factor=(meta.anisotropy_factor
                                   if meta.preserve_anisotropy
                                   else float("nan")),
                out_dtype=meta.data_type, min_intensity=meta.min_intensity,
                max_intensity=meta.max_intensity,
                zarr_ct=(ci, ti) if is_zarr5d else None, device=device,
                devices=args.devices)
            total_vox += stats.voxels
            results.append(stats)
            tm = " ".join(f"{k}={v:.3f}s" for k, v in stats.timings.items())
            print(f"  {stats.blocks} blocks ({stats.skipped_empty} empty), "
                  f"{stats.voxels} voxels in {stats.seconds:.2f}s "
                  f"({stats.voxels / max(stats.seconds, 1e-9):,.0f} vox/s) "
                  f"{tm}")
            if stats.path == "sharded":
                _print_mesh(stats, args.devices)
            if len(mr) > 1:
                _write_pyramid(store, mr, is_zarr5d, (ci, ti), device,
                               devices=args.devices)
    print(f"done, {total_vox} voxels, took {time.time() - t_start:.1f}s")
    return results
