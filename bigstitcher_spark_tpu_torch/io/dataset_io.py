"""BDV-style multiresolution image IO on top of the chunk store.

Port of the ``bdv.n5`` / ``bdv.zarr`` part of
``bigstitcher_spark_tpu/io/dataset_io.py``: the on-disk layout
``setup{S}/timepoint{T}/s{L}`` with ``downsamplingFactors``/``dataType``
attributes on the setup group, default mipmap transforms, and the
halo-padded box reads the fusion drivers stage. HDF5, TIFF and CZI inputs
and split views are not yet ported.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from .. import NotYetPorted
from ..utils.geometry import identity_affine
from .chunkstore import ChunkStore, Dataset
from .spimdata import SpimData, ViewId


def bdv_dataset_path(setup: int, timepoint: int, level: int) -> str:
    return f"setup{setup}/timepoint{timepoint}/s{level}"


def mipmap_transform(factors: Sequence[float]) -> np.ndarray:
    """Level->full-res affine for averaging downsampling by ``factors``:
    scale by f, shift by (f-1)/2 (MipmapTransforms.getMipmapTransformDefault)."""
    m = identity_affine()
    for d in range(3):
        f = float(factors[d])
        m[d, d] = f
        m[d, 3] = (f - 1.0) / 2.0
    return m


def create_bdv_view_datasets(
    store: ChunkStore,
    setup: int,
    timepoint: int,
    shape: Sequence[int],
    block_size: Sequence[int],
    dtype: str,
    downsampling_factors: Sequence[Sequence[int]] = ((1, 1, 1),),
    compression: str = "zstd",
) -> list[Dataset]:
    """Create s0..sN datasets + BDV metadata for one view. ``shape`` xyz."""
    store.set_attribute(f"setup{setup}", "downsamplingFactors",
                        [list(f) for f in downsampling_factors])
    store.set_attribute(f"setup{setup}", "dataType", np.dtype(dtype).name)
    store.set_attribute(f"setup{setup}/timepoint{timepoint}", "multiScale",
                        len(downsampling_factors) > 1)
    store.set_attribute(f"setup{setup}/timepoint{timepoint}", "resolution",
                        [1.0, 1.0, 1.0])
    out = []
    for level, f in enumerate(downsampling_factors):
        lshape = [max(1, int(s) // int(ff)) for s, ff in zip(shape, f)]
        ds = store.create_dataset(
            bdv_dataset_path(setup, timepoint, level),
            lshape, block_size, dtype, compression=compression,
            delete_existing=True,
        )
        store.set_attribute(ds.path, "downsamplingFactors", [int(v) for v in f])
        out.append(ds)
    return out


class ViewLoader:
    """Opens view images of a SpimData project (bdv.n5 / bdv.zarr)."""

    def __init__(self, spimdata: SpimData):
        self.sd = spimdata
        fmt = spimdata.image_loader.format
        if fmt not in ("bdv.n5", "bdv.zarr"):
            raise NotYetPorted(f"image loader format {fmt!r}")
        if spimdata.split_info:
            raise NotYetPorted("split views (split-images)")
        root = spimdata.resolve_loader_path()
        if not os.path.exists(root):
            raise FileNotFoundError(f"image container not found: {root}")
        self.store = ChunkStore.open(root)
        self._cache: dict[tuple, Dataset] = {}
        self._factors_cache: dict[int, list[list[int]]] = {}

    def downsampling_factors(self, setup: int) -> list[list[int]]:
        if setup not in self._factors_cache:
            f = self.store.get_attribute(f"setup{setup}", "downsamplingFactors")
            self._factors_cache[setup] = [
                [int(v) for v in row] for row in (f or [[1, 1, 1]])
            ]
        return self._factors_cache[setup]

    def num_levels(self, setup: int) -> int:
        return len(self.downsampling_factors(setup))

    def open(self, view: ViewId, level: int = 0) -> Dataset:
        key = (view.setup, view.timepoint, level)
        if key not in self._cache:
            self._cache[key] = self.store.open_dataset(
                bdv_dataset_path(view.setup, view.timepoint, level))
        return self._cache[key]

    def mipmap_transform(self, setup: int, level: int) -> np.ndarray:
        return mipmap_transform(self.downsampling_factors(setup)[level])

    def read_block(self, view: ViewId, level: int,
                   offset: Sequence[int], shape: Sequence[int],
                   pad_value: float = 0.0) -> np.ndarray:
        """Read a box, zero-padding parts outside the image (halo over-read)."""
        ds = self.open(view, level)
        full = ds.shape
        lo = [max(0, int(o)) for o in offset]
        hi = [min(int(f), int(o) + int(s)) for f, o, s in zip(full, offset, shape)]
        out = np.full(tuple(int(s) for s in shape), pad_value, dtype=ds.dtype)
        if all(h > l for l, h in zip(lo, hi)):
            data = ds.read(lo, [h - l for l, h in zip(lo, hi)])
            sl = tuple(
                slice(l - int(o), h - int(o)) for l, h, o in zip(lo, hi, offset)
            )
            out[sl] = data
        return out


def best_mipmap_level(
    factors: list[list[int]], target_downsampling: Sequence[float],
    accepted_error: float = 0.02,
) -> int:
    """Pick the coarsest stored level not coarser than ``target_downsampling``
    (replicates the FusionTools.fuseVirtual level pick, ViewUtil.java:425-493:
    largest level whose factors are <= target*(1+acceptedError) per axis)."""
    best = 0
    for lvl, f in enumerate(factors):
        ok = all(
            float(f[d]) <= float(target_downsampling[d]) * (1.0 + accepted_error)
            for d in range(3)
        )
        if ok and np.prod(f) >= np.prod(factors[best]):
            best = lvl
    return best
