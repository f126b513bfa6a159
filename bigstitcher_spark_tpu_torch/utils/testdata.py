"""Synthetic tiled-acquisition generator for tests and benchmarks.

Port of ``bigstitcher_spark_tpu/utils/testdata.py``: the same random
draws in the same order, so one seed gives the same project as the JAX
generator (written through the port's own chunk store). Two helpers the
JAX module lacks append sub-pixel translations or a rotation to a saved
project's registrations (:func:`append_view_transforms`).

The reference tests against a public Janelia example dataset fetched from S3
(TestSparkResave.java:24-38); with zero egress we instead generate an
equivalent fixture: a global bead phantom, cropped into overlapping tiles with
KNOWN ground-truth offsets, written as a bdv.n5 BigStitcher project. The
nominal grid positions stored in the XML are perturbed so stitching /
registration have real error to recover.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..io.chunkstore import ChunkStore, StorageFormat
from ..io.dataset_io import create_bdv_view_datasets
from ..io.spimdata import (
    AttributeEntity,
    ImageLoader,
    SpimData,
    ViewId,
    ViewSetup,
    ViewTransform,
)
from .geometry import translation_affine

NOISE_SIGMA = 8.0   # each tile's Gaussian sensor noise (intensity units)


@dataclass
class SyntheticProject:
    spimdata: SpimData
    xml_path: str
    true_offsets: dict[int, np.ndarray]  # setup id -> true tile offset (xyz float)
    nominal_offsets: dict[int, np.ndarray]
    bead_positions: np.ndarray  # (N,3) in global coords


def make_bead_volume(shape, n_beads=150, sigma=1.8, seed=0, background=100.0,
                     amplitude=3000.0, min_separation=8.0,
                     smooth_field=0.0) -> tuple[np.ndarray, np.ndarray]:
    """Global phantom: Gaussian beads on constant background (float32).

    Beads keep ``min_separation`` px apart (closer blobs merge under the DoG
    and break localization-based assertions). ``smooth_field`` > 0 adds a
    low-frequency random intensity field of that amplitude — dynamic range in
    every region, which intensity matching needs."""
    rng = np.random.default_rng(seed)
    shape = tuple(int(s) for s in shape)
    pos_list: list[np.ndarray] = []
    for _ in range(n_beads * 50):
        if len(pos_list) >= n_beads:
            break
        p = rng.uniform(low=[4, 4, 4], high=[s - 4 for s in shape])
        if pos_list and np.min(
            np.linalg.norm(np.array(pos_list) - p, axis=1)
        ) < min_separation:
            continue
        pos_list.append(p)
    pos = np.array(pos_list)
    vol = np.full(shape, background, dtype=np.float32)
    if smooth_field > 0:
        coarse = rng.uniform(0, 1, (5, 5, 5)).astype(np.float32)
        for d, s in enumerate(shape):
            idx = np.linspace(0, coarse.shape[d] - 1, s)
            lo = np.floor(idx).astype(int)
            hi = np.minimum(lo + 1, coarse.shape[d] - 1)
            f = (idx - lo).astype(np.float32)
            sl_lo = [slice(None)] * 3
            sl_hi = [slice(None)] * 3
            sl_lo[d] = lo
            sl_hi[d] = hi
            shape_f = [1, 1, 1]
            shape_f[d] = s
            coarse = (coarse[tuple(sl_lo)] * (1 - f.reshape(shape_f))
                      + coarse[tuple(sl_hi)] * f.reshape(shape_f))
        vol += smooth_field * coarse
    r = int(np.ceil(3 * sigma))
    ax = np.arange(-r, r + 1, dtype=np.float32)
    gx = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    for p in pos:
        ip = np.round(p).astype(int)
        fr = p - ip
        lo = ip - r
        hi = ip + r + 1
        if np.any(lo < 0) or np.any(hi > np.array(shape)):
            continue
        bx = np.exp(-((ax - fr[0]) ** 2) / (2 * sigma ** 2))
        by = np.exp(-((ax - fr[1]) ** 2) / (2 * sigma ** 2))
        bz = np.exp(-((ax - fr[2]) ** 2) / (2 * sigma ** 2))
        blob = amplitude * bx[:, None, None] * by[None, :, None] * bz[None, None, :]
        vol[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] += blob
    return vol, pos


def make_synthetic_project(
    out_dir: str,
    n_tiles=(2, 1, 1),
    tile_size=(96, 96, 48),
    overlap=24,
    jitter=3.0,
    n_channels=1,
    n_timepoints=1,
    dtype="uint16",
    seed=0,
    block_size=(64, 64, 32),
    n_beads_per_tile=40,
    downsampling_factors=((1, 1, 1),),
    smooth_field=0.0,
    compression="zstd",
    noise_sigma=NOISE_SIGMA,
) -> SyntheticProject:
    """Write ``dataset.xml`` + ``dataset.n5`` under ``out_dir``.
    ``compression`` is the N5 codec of the tile datasets; ``noise_sigma``
    the standard deviation of each tile's Gaussian sensor noise (drawn
    whatever its value, so the rest of the project does not change)."""
    rng = np.random.default_rng(seed + 1)
    n_tiles = tuple(int(v) for v in n_tiles)
    tile_size = tuple(int(v) for v in tile_size)
    step = tuple(ts - overlap for ts in tile_size)
    global_shape = tuple(
        step[d] * (n_tiles[d] - 1) + tile_size[d] + 8 for d in range(3)
    )
    total_tiles = n_tiles[0] * n_tiles[1] * n_tiles[2]
    vol, beads = make_bead_volume(
        global_shape, n_beads=n_beads_per_tile * total_tiles, seed=seed,
        smooth_field=smooth_field,
    )

    os.makedirs(out_dir, exist_ok=True)
    store = ChunkStore.create(os.path.join(out_dir, "dataset.n5"), StorageFormat.N5)

    sd = SpimData()
    sd.image_loader = ImageLoader(format="bdv.n5", path="dataset.n5")
    sd.timepoints = list(range(n_timepoints))
    sd.attributes["illumination"][0] = AttributeEntity(0, "0")
    sd.attributes["angle"][0] = AttributeEntity(0, "0")
    for c in range(n_channels):
        sd.attributes["channel"][c] = AttributeEntity(c, str(c))

    true_offsets: dict[int, np.ndarray] = {}
    nominal_offsets: dict[int, np.ndarray] = {}
    setup_id = 0
    info = np.iinfo(dtype) if np.issubdtype(np.dtype(dtype), np.integer) else None
    for tz in range(n_tiles[2]):
        for ty in range(n_tiles[1]):
            for tx in range(n_tiles[0]):
                tile_id = tx + n_tiles[0] * (ty + n_tiles[1] * tz)
                true_off = np.array(
                    [tx * step[0], ty * step[1], tz * step[2]], dtype=np.float64
                )
                true_off += rng.uniform(0, 4, 3).round()  # integer true offsets
                nominal = np.array(
                    [tx * step[0], ty * step[1], tz * step[2]], dtype=np.float64
                )
                if jitter > 0 and tile_id > 0:
                    nominal = true_off + rng.uniform(-jitter, jitter, 3).round()
                if tile_id not in {e.id for e in sd.attributes["tile"].values()}:
                    sd.attributes["tile"][tile_id] = AttributeEntity(
                        tile_id, str(tile_id),
                        {"location": " ".join(repr(v) for v in nominal)},
                    )
                io = np.round(true_off).astype(int)
                crop = vol[
                    io[0]:io[0] + tile_size[0],
                    io[1]:io[1] + tile_size[1],
                    io[2]:io[2] + tile_size[2],
                ]
                for c in range(n_channels):
                    img = crop * (1.0 + 0.15 * c)
                    noise = rng.normal(0, noise_sigma, img.shape)
                    img = img + noise
                    if info is not None:
                        img = np.clip(img, info.min, info.max).astype(dtype)
                    else:
                        img = img.astype(dtype)
                    vs = ViewSetup(
                        id=setup_id,
                        name=f"tile{tile_id}_ch{c}",
                        size=tile_size,
                        attributes={
                            "illumination": 0, "channel": c,
                            "tile": tile_id, "angle": 0,
                        },
                    )
                    sd.setups[setup_id] = vs
                    true_offsets[setup_id] = io.astype(np.float64)
                    nominal_offsets[setup_id] = nominal.copy()
                    for t in range(n_timepoints):
                        dss = create_bdv_view_datasets(
                            store, setup_id, t, tile_size, block_size, dtype,
                            downsampling_factors=downsampling_factors,
                            compression=compression,
                        )
                        dss[0].write(img, (0, 0, 0))
                        for lvl in range(1, len(downsampling_factors)):
                            f = downsampling_factors[lvl]
                            ds_img = _downsample_avg(img, f)
                            dss[lvl].write(ds_img, (0, 0, 0))
                        sd.registrations[ViewId(t, setup_id)] = [
                            ViewTransform(
                                "Translation to Regular Grid",
                                translation_affine(nominal),
                            ),
                            ViewTransform("calibration", translation_affine((0, 0, 0))),
                        ]
                    setup_id += 1

    xml_path = os.path.join(out_dir, "dataset.xml")
    sd.save(xml_path)
    return SyntheticProject(sd, xml_path, true_offsets, nominal_offsets, beads)


def append_view_transforms(xml_path: str, transforms: dict,
                           name: str = "perturbation") -> SpimData:
    """Preconcatenate ``transforms[setup]`` (3x4, applied after everything
    else) to every view of that setup and save the project in place."""
    sd = SpimData.load(xml_path)
    for v in sd.view_ids():
        t = transforms.get(v.setup)
        if t is not None:
            sd.preconcatenate_transform(
                v, ViewTransform(name, np.asarray(t, np.float64)))
    sd.save(xml_path)
    return sd


def rotation_about_z(degrees: float, center) -> np.ndarray:
    """3x4 rotation by ``degrees`` about the z axis through ``center``."""
    a = np.deg2rad(float(degrees))
    c = np.asarray(center, np.float64)
    m = np.eye(3, 4)
    m[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    m[:, 3] = c - m[:, :3] @ c
    return m


def _downsample_avg(img: np.ndarray, factors) -> np.ndarray:
    out = img.astype(np.float64)
    for d, f in enumerate(factors):
        f = int(f)
        if f == 1:
            continue
        n = (out.shape[d] // f) * f
        sl = [slice(None)] * out.ndim
        sl[d] = slice(0, n)
        out = out[tuple(sl)]
        shape = list(out.shape)
        shape[d] = shape[d] // f
        shape.insert(d + 1, f)
        out = out.reshape(shape).mean(axis=d + 1)
    return out.astype(img.dtype)
