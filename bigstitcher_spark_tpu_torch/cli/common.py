"""Options shared by the port's commands (argparse counterparts of the JAX
package's click decorator stacks in ``cli/common.py``)."""

from __future__ import annotations

import argparse
import os

from .. import NotYetPorted
from ..io import uris


def add_infrastructure_options(p: argparse.ArgumentParser) -> None:
    """--dryRun and the JAX package's observability and cloud switches
    (accepted so scripts keep working, refused when used)."""
    p.add_argument("--dryRun", dest="dry_run", action="store_true",
                   help="compute but do not persist results")
    p.add_argument("--s3Region", dest="s3_region", default=None,
                   help="AWS region for s3:// roots (not yet ported)")
    p.add_argument("--telemetry-dir", dest="telemetry_dir", default=None,
                   help="telemetry files (not yet ported)")
    p.add_argument("--profile", action="store_true",
                   help="span statistics (not yet ported)")
    p.add_argument("--trace", action="store_true",
                   help="timeline trace (not yet ported)")


def check_infrastructure(args: argparse.Namespace) -> None:
    for name, flag in (("s3_region", "--s3Region"),
                       ("telemetry_dir", "--telemetry-dir"),
                       ("profile", "--profile"), ("trace", "--trace")):
        if getattr(args, name):
            raise NotYetPorted(flag)


def add_xml_option(p: argparse.ArgumentParser) -> None:
    p.add_argument("-x", "--xml", dest="xml", required=True,
                   help="path of the SpimData XML project")


def check_xml(path: str) -> str:
    local = uris.local_path(path)
    if not os.path.exists(local):
        raise FileNotFoundError(f"XML not found: {local}")
    return local


def add_view_selection_options(p: argparse.ArgumentParser) -> None:
    """View subset flags (AbstractSelectableViews.java:38-112)."""
    p.add_argument("--angleId", dest="angle_ids", default=None,
                   help="comma-separated angle ids to process")
    p.add_argument("--channelId", dest="channel_ids", default=None,
                   help="comma-separated channel ids to process")
    p.add_argument("--illuminationId", dest="illumination_ids", default=None,
                   help="comma-separated illumination ids to process")
    p.add_argument("--tileId", dest="tile_ids", default=None,
                   help="comma-separated tile ids to process")
    p.add_argument("--timepointId", dest="timepoint_ids", default=None,
                   help="comma-separated timepoint ids to process")
    p.add_argument("-vi", dest="vi", action="append", default=None,
                   help="explicit view ids 'timepoint,setup' (repeatable)")


def parse_csv_ints(s: str | None, n: int | None = None) -> list[int] | None:
    if s is None:
        return None
    vals = [int(v) for v in s.split(",")]
    if n is not None and len(vals) != n:
        raise ValueError(f"expected {n} comma-separated ints: {s!r}")
    return vals


def select_views_from_args(sd, args: argparse.Namespace):
    from ..utils.viewselect import select_views

    return select_views(
        sd,
        angle_ids=args.angle_ids,
        channel_ids=args.channel_ids,
        illumination_ids=args.illumination_ids,
        tile_ids=args.tile_ids,
        timepoint_ids=args.timepoint_ids,
        vi=args.vi,
    )
