"""View-subset selection from CLI flags (AbstractSelectableViews equivalent,
abstractcmdline/AbstractSelectableViews.java:38-112 + util/Import.java:94-202):
filter the project's views by angle/channel/illumination/tile/timepoint ids or
explicit ``-vi 'tp,setup'`` pairs."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..io.spimdata import SpimData, ViewId
from .geometry import Interval, transformed_interval


def parse_id_list(s: str | None) -> list[int] | None:
    if s is None or s == "":
        return None
    return [int(v) for v in s.split(",") if v.strip() != ""]


def parse_view_ids(items: Sequence[str] | None) -> list[ViewId] | None:
    """Parse ``-vi`` entries of the form 'tp,setup' (Import.java:303-310)."""
    if not items:
        return None
    out = []
    for it in items:
        tp, setup = it.split(",")
        out.append(ViewId(int(tp), int(setup)))
    return out


def select_views(
    sd: SpimData,
    angle_ids: str | None = None,
    channel_ids: str | None = None,
    illumination_ids: str | None = None,
    tile_ids: str | None = None,
    timepoint_ids: str | None = None,
    vi: Sequence[str] | None = None,
) -> list[ViewId]:
    explicit = parse_view_ids(vi)
    if explicit is not None:
        unknown = [v for v in explicit if v.setup not in sd.setups
                   or v.timepoint not in sd.timepoints]
        if unknown:
            raise ValueError(f"unknown view ids: {unknown}")
        views = [v for v in explicit if v not in sd.missing_views]
        if not views:
            raise ValueError(
                f"all requested views are flagged missing: {explicit}"
            )
        return views
    filters = {
        "angle": parse_id_list(angle_ids),
        "channel": parse_id_list(channel_ids),
        "illumination": parse_id_list(illumination_ids),
        "tile": parse_id_list(tile_ids),
    }
    tps = parse_id_list(timepoint_ids)
    out = []
    for v in sd.view_ids():
        if tps is not None and v.timepoint not in tps:
            continue
        setup = sd.setups[v.setup]
        ok = all(
            ids is None or setup.attributes.get(attr, 0) in ids
            for attr, ids in filters.items()
        )
        if ok:
            out.append(v)
    if not out:
        raise ValueError("no views left after filtering")
    return out


def maximal_bounding_box(sd: SpimData, views: list[ViewId],
                         anisotropy: np.ndarray | None = None) -> Interval:
    """Smallest interval containing all transformed views
    (Import.java:39-66 maximal bounding box)."""
    from .geometry import concatenate

    bbox: Interval | None = None
    for v in views:
        m = sd.model(v)
        if anisotropy is not None:
            m = concatenate(anisotropy, m)
        b = transformed_interval(m, Interval.from_shape(sd.view_size(v)))
        bbox = b if bbox is None else bbox.union(b)
    if bbox is None:
        raise ValueError("no views")
    return bbox


def anisotropy_factor_from_voxel_sizes(sd: SpimData, views: list[ViewId]) -> float:
    """Average z/xy calibration ratio (CreateFusionContainer.java:184-211)."""
    ratios = []
    for v in views:
        vs = sd.setups[v.setup].voxel_size
        if vs[0] > 0:
            ratios.append(vs[2] / vs[0])
    return float(np.mean(ratios)) if ratios else 1.0
