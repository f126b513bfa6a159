"""Synthetic registration graphs for the solver: projects with no image data.

Two kinds of input the ``solver`` tool reads, made from a seed with numpy
and written through the port's own XML and interest-point store:

* :func:`make_stitching_grid` — a tile grid whose XML holds pairwise
  stitching results for every 6-neighbour pair (``-s STITCHING``): exact
  shifts between jittered nominal positions and the truth, correlation 0.9,
  and a few links (sharing no tile) with a wrong shift.
* :func:`make_ip_grid` — a tile grid whose true registrations are rigid
  (small rotations about each tile's centre and translations about the
  grid) while the XML holds the grid translations, with bead
  correspondences in every 6-neighbour overlap stored in
  ``interestpoints.n5`` (``-s IP``).

Tile ``t`` of a grid (nx, ny, nz) is setup ``t = x + nx (y + ny z)``; every
view is timepoint 0, illumination, channel and angle 0.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..io.interestpoints import (
    CorrespondingPoint,
    InterestPointStore,
    register_points_in_xml,
)
from ..io.spimdata import (
    AttributeEntity,
    ImageLoader,
    PairwiseStitchingResult,
    SpimData,
    ViewId,
    ViewSetup,
    ViewTransform,
    registration_hash,
)
from .geometry import Interval, invert_affine, translation_affine


def grid_pairs(grid) -> list[tuple[int, int]]:
    """Every 6-neighbour pair (a, b), b the +x, +y or +z neighbour of a."""
    nx, ny, nz = grid
    out = []
    for z in range(nz):
        for y in range(ny):
            for x in range(nx):
                a = x + nx * (y + ny * z)
                if x + 1 < nx:
                    out.append((a, a + 1))
                if y + 1 < ny:
                    out.append((a, a + nx))
                if z + 1 < nz:
                    out.append((a, a + nx * ny))
    return out


def _grid_origin(t: int, grid, step) -> np.ndarray:
    nx, ny, _ = grid
    idx = (t % nx, (t // nx) % ny, t // (nx * ny))
    return np.array([i * s for i, s in zip(idx, step)], np.float64)


def _empty_project(grid, tile, registrations) -> SpimData:
    sd = SpimData()
    sd.image_loader = ImageLoader(format="bdv.n5", path="dataset.n5")
    sd.timepoints = [0]
    for a in ("illumination", "channel", "angle"):
        sd.attributes[a][0] = AttributeEntity(0, "0")
    for t in range(int(np.prod(grid))):
        sd.attributes["tile"][t] = AttributeEntity(t, str(t))
        sd.setups[t] = ViewSetup(
            id=t, name=f"tile{t}", size=tuple(int(v) for v in tile),
            attributes={"illumination": 0, "channel": 0, "tile": t,
                        "angle": 0})
        sd.registrations[ViewId(0, t)] = [
            ViewTransform("Translation to Regular Grid", registrations[t])]
    return sd


def _step(tile, overlap_frac) -> tuple[float, ...]:
    return tuple(float(round(s * (1.0 - overlap_frac))) for s in tile)


def _overlap_box(a0, b0, tile) -> tuple[np.ndarray, np.ndarray]:
    """[lo, hi) of the overlap of two tile boxes at origins a0, b0."""
    t = np.asarray(tile, np.float64)
    return np.maximum(a0, b0), np.minimum(a0 + t, b0 + t)


@dataclass
class StitchingGrid:
    xml_path: str
    true_offsets: dict[int, np.ndarray]
    nominal_offsets: dict[int, np.ndarray]
    bad_pairs: list[tuple[int, int]]        # (setup a, setup b) wrong links
    pairs: list[tuple[int, int]] = field(default_factory=list)


def make_stitching_grid(out_dir: str, grid=(32, 32, 4),
                        tile=(2048, 2048, 512), overlap_frac: float = 0.1,
                        jitter: float = 3.0, n_bad: int = 8,
                        bad_shift: float = 25.0, r: float = 0.9,
                        seed: int = 0) -> StitchingGrid:
    """Write ``dataset.xml`` of a tile grid with stitching results.

    Nominal offsets are the grid positions plus a uniform jitter of
    ±``jitter`` px (tile 0 exact); every 6-neighbour pair stores the exact
    shift ``(truth - nominal)[a] - (truth - nominal)[b]`` over its nominal
    overlap box, with correlation ``r`` and the registration hash. ``n_bad``
    x-links, spread over the grid and sharing no tile, get ``bad_shift`` px
    more along x."""
    rng = np.random.default_rng(seed)
    grid = tuple(int(v) for v in grid)
    step = _step(tile, overlap_frac)
    T = int(np.prod(grid))
    truth = {t: _grid_origin(t, grid, step) for t in range(T)}
    nominal = {t: truth[t] + (rng.uniform(-jitter, jitter, 3) if t else 0.0)
               for t in range(T)}
    sd = _empty_project(grid, tile,
                        {t: translation_affine(nominal[t]) for t in range(T)})
    nx, ny, nz = grid
    bad = []
    for k in range(n_bad):
        x = (nx // 8) + (k % 4) * (nx // 4)
        y = (ny // 4) + (k // 4 % 2) * (ny // 2)
        z = (k // 8 + k % 2) % nz
        a = x + nx * (y + ny * z)
        if x + 1 >= nx or (a, a + 1) in bad:
            raise ValueError(f"grid {grid} too small for {n_bad} wrong links")
        bad.append((a, a + 1))
    if len({t for p in bad for t in p}) != 2 * len(bad):
        raise ValueError(f"grid {grid}: the wrong links would share a tile")
    pairs = grid_pairs(grid)
    for a, b in pairs:
        shift = (truth[a] - nominal[a]) - (truth[b] - nominal[b])
        if (a, b) in bad:
            shift = shift + np.array([bad_shift, 0.0, 0.0])
        lo, hi = _overlap_box(nominal[a], nominal[b], tile)
        va, vb = (ViewId(0, a),), (ViewId(0, b),)
        res = PairwiseStitchingResult(
            va, vb, translation_affine(shift), r,
            hash=registration_hash([sd.model(va[0])], [sd.model(vb[0])]),
            bbox=Interval(tuple(int(v) for v in np.floor(lo)),
                          tuple(int(v) for v in np.ceil(hi) - 1)))
        sd.stitching_results[res.pair_key] = res
    os.makedirs(out_dir, exist_ok=True)
    xml = os.path.join(out_dir, "dataset.xml")
    sd.save(xml)
    return StitchingGrid(xml, truth, nominal, bad, pairs)


def _small_rotation(rng, max_deg: float) -> np.ndarray:
    """A rotation by a uniform angle in ±max_deg about a random axis."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = np.deg2rad(rng.uniform(-max_deg, max_deg))
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * (k @ k)


@dataclass
class IPGrid:
    xml_path: str
    truth: dict[int, np.ndarray]      # true registrations (3x4)
    nominal: dict[int, np.ndarray]    # what the XML holds (grid translations)
    n_links: int
    n_correspondences: int


def make_ip_grid(out_dir: str, grid=(16, 16, 2), tile=(2048, 2048, 512),
                 overlap_frac: float = 0.1, n_per_pair: int = 500,
                 noise: float = 0.1, max_deg: float = 0.2,
                 max_shift: float = 3.0, label: str = "beads",
                 seed: int = 0) -> IPGrid:
    """Write ``dataset.xml`` + ``interestpoints.n5`` of a tile grid with
    bead correspondences.

    True registrations: a rotation by ±``max_deg`` about the tile's centre
    and a translation of ±``max_shift`` px about its grid position (tile 0
    exact); the XML holds the grid translations. Each 6-neighbour pair gets
    ``n_per_pair`` beads drawn uniformly in its overlap box, each seen in
    both views at its true local position plus Gaussian noise of
    ``noise`` px per axis; every bead is one detection in each view and one
    correspondence stored on both sides."""
    rng = np.random.default_rng(seed)
    grid = tuple(int(v) for v in grid)
    step = _step(tile, overlap_frac)
    T = int(np.prod(grid))
    center = np.asarray(tile, np.float64) / 2.0
    nominal, truth = {}, {}
    for t in range(T):
        g = _grid_origin(t, grid, step)
        nominal[t] = translation_affine(g)
        if t == 0:
            truth[t] = nominal[t].copy()
            continue
        r = _small_rotation(rng, max_deg)
        m = np.zeros((3, 4))
        m[:, :3] = r
        m[:, 3] = g + center - r @ center + rng.uniform(-max_shift, max_shift, 3)
        truth[t] = m
    inv = {t: invert_affine(truth[t]) for t in range(T)}
    pts = {t: [] for t in range(T)}
    corrs: dict[int, list[CorrespondingPoint]] = {t: [] for t in range(T)}
    count = {t: 0 for t in range(T)}
    pairs = grid_pairs(grid)
    for a, b in pairs:
        lo, hi = _overlap_box(nominal[a][:, 3], nominal[b][:, 3], tile)
        world = rng.uniform(lo, hi, (n_per_pair, 3))
        for v, other in ((a, b), (b, a)):
            local = world @ inv[v][:, :3].T + inv[v][:, 3]
            pts[v].append(local + rng.normal(0.0, noise, local.shape))
        ia = np.arange(count[a], count[a] + n_per_pair)
        ib = np.arange(count[b], count[b] + n_per_pair)
        va, vb = ViewId(0, a), ViewId(0, b)
        corrs[a] += [CorrespondingPoint(i, vb, label, j)
                     for i, j in zip(ia.tolist(), ib.tolist())]
        corrs[b] += [CorrespondingPoint(j, va, label, i)
                     for i, j in zip(ia.tolist(), ib.tolist())]
        count[a] += n_per_pair
        count[b] += n_per_pair
    sd = _empty_project(grid, tile, nominal)
    os.makedirs(out_dir, exist_ok=True)
    xml = os.path.join(out_dir, "dataset.xml")
    sd.xml_path = xml
    store = InterestPointStore.for_project(sd)
    for t in range(T):
        view = ViewId(0, t)
        grp = store.save_points(view, label, np.concatenate(pts[t]))
        store.save_correspondences(view, label, corrs[t])
        register_points_in_xml(sd, view, label, "synthetic beads", grp)
    sd.save(xml)
    return IPGrid(xml, truth, nominal, len(pairs), n_per_pair * len(pairs))
