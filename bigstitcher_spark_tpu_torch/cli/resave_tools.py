"""``downsample`` command (SparkDownsample.java: pyramid creation for an
existing dataset).

Port of ``downsample_cmd`` and ``parse_pyramid`` of
``bigstitcher_spark_tpu/cli/resave_tools.py`` on argparse, with the same
option spellings (SparkDownsample.java:60-76). ``resave`` is not yet
ported.
"""

from __future__ import annotations

import argparse
import os

from .. import NotYetPorted
from ..io.chunkstore import ChunkStore, StorageFormat
from ..models.downsample_driver import (
    _convert_to_dtype,
    read_padded,
    run_downsample,
)
from ..utils.grid import create_grid
from .common import (
    add_infrastructure_options,
    check_infrastructure,
    parse_csv_ints,
)


def parse_pyramid(spec_list) -> list[list[int]] | None:
    """Parse ``-ds 1,1,1 -ds 2,2,1`` or a single ``'1,1,1; 2,2,1'`` string
    (reference ';'-separated pyramid specs, Import.java:261-287)."""
    if not spec_list:
        return None
    parts: list[str] = []
    for s in spec_list:
        parts.extend(p for p in s.split(";") if p.strip())
    return [parse_csv_ints(p.strip(), 3) for p in parts]


def add_downsample(sub) -> argparse.ArgumentParser:
    p = sub.add_parser("downsample", allow_abbrev=False,
                       help="chained downsampling of an existing dataset")
    add_infrastructure_options(p)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("-i", "--n5PathIn", dest="path_in", required=True,
                   help="container path, e.g. /home/fused.n5")
    p.add_argument("-di", "--n5DatasetIn", dest="dataset_in", required=True,
                   help="input dataset, e.g. /ch488/s0")
    p.add_argument("-do", "--n5DatasetsOut", dest="datasets_out",
                   default=None,
                   help="output dataset(s), ';'-separated, e.g. "
                        "/ch488/s1;/ch488/s2")
    p.add_argument("-ds", "--downsampling", dest="downsampling",
                   required=True,
                   help="consecutive steps, ';'-separated, e.g. "
                        "'2,2,1; 2,2,1; 2,2,2'")
    p.add_argument("-s", "--storage", dest="storage_opt", default=None,
                   choices=("N5", "ZARR", "HDF5"),
                   help="container storage format (validated against the "
                        "path; HDF5: not yet ported)")
    p.add_argument("--blockScale", dest="block_scale", default="1,1,1")
    p.add_argument("--threads", type=int, default=8)
    p.add_argument("--skip-existing", dest="skip_existing",
                   action="store_true",
                   help="skip steps whose output dataset already exists with "
                        "matching dimensions and downsampling factors (e.g. "
                        "levels a fusion --pyramid epilogue wrote)")
    p.set_defaults(func=downsample_cmd)
    return p


def downsample_cmd(args: argparse.Namespace):
    """Chained downsampling of an existing 3-D dataset (pyramid levels).
    Returns the list of output dataset paths written or skipped."""
    from ..utils.device import resolve_device

    check_infrastructure(args)
    if args.storage_opt == "HDF5":
        raise NotYetPorted("-s HDF5")
    device = resolve_device(args.device)
    store = ChunkStore.open(args.path_in)
    if args.storage_opt is not None and store.format != StorageFormat(
            args.storage_opt):
        raise ValueError(f"--storage {args.storage_opt} does not match the "
                         f"container at {args.path_in} ({store.format.name})")
    src_path = args.dataset_in.strip("/")
    steps = parse_pyramid([args.downsampling])
    if args.datasets_out:
        outs = [p.strip().strip("/") for p in args.datasets_out.split(";")
                if p.strip()]
    else:
        # default: s{N} siblings of the input (the reference requires -do;
        # it is derived when the input ends in s{N})
        base, name = os.path.split(src_path)
        if not (name.startswith("s") and name[1:].isdigit()):
            raise ValueError("-do required unless input ends in /s<N>")
        n0 = int(name[1:])
        outs = [f"{base}/s{n0 + i + 1}".strip("/") for i in range(len(steps))]
    if len(outs) != len(steps):
        raise ValueError(f"{len(outs)} output datasets but {len(steps)} "
                         "downsampling steps")

    src = store.open_dataset(src_path)
    if len(src.shape) != 3:
        raise ValueError(
            f"{src_path} is {len(src.shape)}-D; this tool handles 3-D "
            "datasets (5-D OME-ZARR fusion pyramids are written by "
            "affine-fusion itself)")
    bscale = parse_csv_ints(args.block_scale, 3)
    print(f"downsampling {src_path} {src.shape} by {steps} -> {outs}")
    if args.dry_run:
        return outs

    prev = src
    # absolute factors continue from the input level's own factors so
    # mipmap transforms stay correct when starting at s>0
    abs_factor = [int(v) for v in
                  (store.get_attribute(src_path, "downsamplingFactors")
                   or [1, 1, 1])]
    abs_factors: list[list[int]] = []  # one per output level, for registration
    for step, out_path in zip(steps, outs):
        abs_factor = [a * f for a, f in zip(abs_factor, step)]
        abs_factors.append(list(abs_factor))
        dims = [max(1, s // f) for s, f in zip(prev.shape, step)]
        if args.skip_existing and store.is_dataset(out_path):
            ex = store.open_dataset(out_path)
            exf = store.get_attribute(out_path, "downsamplingFactors")
            if (list(ex.shape) == dims and exf is not None
                    and [int(v) for v in exf] == [int(v) for v in abs_factor]):
                print(f"  {out_path} {tuple(dims)} already exists with "
                      "matching factors, skipped")
                prev = ex
                continue
        dst = store.create_dataset(out_path, dims, prev.block_size,
                                   prev.dtype.name, delete_existing=True)
        store.set_attribute(out_path, "downsamplingFactors",
                            [int(v) for v in abs_factor])
        compute_block = [b * s for b, s in zip(dst.block_size, bscale)]
        grid = create_grid(dims, compute_block, dst.block_size)

        def read_job(blk, src_ds=prev, f=tuple(step)):
            src_off = [o * x for o, x in zip(blk.offset, f)]
            src_size = [s * x for s, x in zip(blk.size, f)]
            return read_padded(src_ds.read, src_ds.shape, src_off, src_size)

        def write_job(blk, out, dst_ds=dst):
            dst_ds.write(_convert_to_dtype(out, dst_ds.dtype), blk.offset)

        run_downsample(grid, read_job, write_job, tuple(step), device=device,
                       io_threads=args.threads)
        print(f"  wrote {out_path} {tuple(dims)}")
        prev = dst

    _register_bdv_levels(store, src_path, outs, abs_factors)
    return outs


def _register_bdv_levels(store, src_path, outs, abs_factors) -> None:
    """BDV layout (setup{S}/timepoint{T}/s{N}): extend the setup-level
    factor list so viewers can discover the new levels. Level i resolves to
    dataset s{i}, so a factor may only be registered when its output leaf
    IS s{len(list)} at registration time."""
    parts = src_path.split("/")
    if not (len(parts) == 3 and parts[0].startswith("setup")
            and all(p.strip("/").split("/")[0] == parts[0]
                    and len(p.strip("/").split("/")) == 3 for p in outs)):
        return
    setup_group = parts[0]
    existing = store.get_attribute(setup_group, "downsamplingFactors") or []
    existing = [list(map(int, f)) for f in existing]
    if not existing and parts[2] == "s0":
        # fresh single-scale dataset: seed the list with the input level
        existing = [[int(v) for v in
                     (store.get_attribute(src_path, "downsamplingFactors")
                      or [1, 1, 1])]]
    added, skipped = [], []
    for out_path, af in zip(outs, abs_factors):
        leaf = out_path.split("/")[-1]
        if af in existing and leaf == f"s{existing.index(af)}":
            continue  # already registered at the matching index
        if leaf == f"s{len(existing)}":
            existing.append(af)
            added.append(af)
        else:
            skipped.append(out_path)
    if added:
        store.set_attribute(setup_group, "downsamplingFactors", existing)
        store.set_attribute(f"{setup_group}/{parts[1]}", "multiScale", True)
        print(f"  registered factors {added} on {setup_group}")
    for p in skipped:
        print(f"  WARNING: {p} not registered on {setup_group} — its s<N> "
              "index does not continue the existing level list (levels "
              f"must be consecutive s0..s{len(existing) - 1})")
