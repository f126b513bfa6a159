"""Fusion-container creation & metadata (CreateFusionContainer equivalent).

Port of ``bigstitcher_spark_tpu/io/container.py`` for N5 and OME-ZARR on
the local file system: the same ``Bigstitcher-Spark/*`` attributes, dataset
layouts and NGFF ``multiscales`` metadata, so ``affine-fusion`` of either
package reads the other's containers. HDF5 is not yet ported.

Creates the empty output container (N5 / OME-ZARR / HDF5, optionally as a
BDV-project layout), the multiresolution pyramid datasets, and persists all
fusion parameters as ``Bigstitcher-Spark/*`` root attributes — the persisted
config contract between ``create-fusion-container`` and ``affine-fusion``
(reference: CreateFusionContainer.java:302-320,462-516 ↔
SparkAffineFusion.java:239-309).

Dataset layouts (matching the reference so BigStitcher/BDV can open them):
  * plain N5/HDF5:  ``ch{c}tp{t}/s{level}``
  * BDV project:    ``setup{c}/timepoint{t}/s{level}``
  * OME-ZARR:       5-D ``/{level}`` datasets, logical xyzct (on-disk tczyx),
                    with OME-NGFF v0.4 ``multiscales`` metadata.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from .. import NotYetPorted
from ..utils.geometry import Interval
from .chunkstore import ChunkStore, StorageFormat

ATTR_PREFIX = "Bigstitcher-Spark"


@dataclass
class MultiResolutionLevelInfo:
    """Per-level dataset metadata (mvrecon ``MultiResolutionLevelInfo``)."""

    dataset: str
    dimensions: list[int]
    blockSize: list[int]
    relativeDownsampling: list[int]
    absoluteDownsampling: list[int]
    dataType: str

    def to_json(self) -> dict:
        return dict(
            dataset=self.dataset,
            dimensions=[int(v) for v in self.dimensions],
            blockSize=[int(v) for v in self.blockSize],
            relativeDownsampling=[int(v) for v in self.relativeDownsampling],
            absoluteDownsampling=[int(v) for v in self.absoluteDownsampling],
            dataType=self.dataType,
        )

    @staticmethod
    def from_json(d: dict) -> "MultiResolutionLevelInfo":
        return MultiResolutionLevelInfo(
            d["dataset"], d["dimensions"], d["blockSize"],
            d["relativeDownsampling"], d["absoluteDownsampling"], d["dataType"],
        )


@dataclass
class FusionContainerMeta:
    input_xml: str
    num_timepoints: int
    num_channels: int
    bbox: Interval
    data_type: str
    block_size: list[int]
    fusion_format: str  # "N5" | "OME-ZARR" | "HDF5" | "BDV/N5" | ...
    preserve_anisotropy: bool = False
    anisotropy_factor: float = float("nan")
    min_intensity: float | None = None
    max_intensity: float | None = None
    # [channel + t*numChannels][level]
    mr_infos: list[list[MultiResolutionLevelInfo]] = field(default_factory=list)


def _relative_steps(absolute: list[list[int]]) -> list[list[int]]:
    rel = [list(absolute[0])]
    for i in range(1, len(absolute)):
        rel.append([absolute[i][d] // absolute[i - 1][d] for d in range(3)])
    return rel


def _level_dims(dims: Sequence[int], absolute: Sequence[int]) -> list[int]:
    # successive relative halving => floor division by the absolute factor
    return [max(1, int(d) // int(a)) for d, a in zip(dims, absolute)]


def create_fusion_container(
    out_path: str,
    storage_format: StorageFormat,
    input_xml: str,
    num_timepoints: int,
    num_channels: int,
    bbox: Interval,
    data_type: str = "float32",
    block_size: Sequence[int] = (128, 128, 128),
    downsamplings: list[list[int]] | None = None,
    compression: str = "zstd",
    bdv: bool = False,
    preserve_anisotropy: bool = False,
    anisotropy_factor: float = float("nan"),
    min_intensity: float | None = None,
    max_intensity: float | None = None,
    setup_id_offset: int = 0,
) -> FusionContainerMeta:
    """``setup_id_offset``: first BDV setup id to create — nonzero when
    appending a fusion into an existing BDV project (the next channel/tile
    setup ids, BDVSparkInstantiateViewSetup.java:57-112)."""
    if storage_format == StorageFormat.HDF5:
        raise NotYetPorted("HDF5 fusion containers (-s HDF5)")
    store = ChunkStore.create(out_path, storage_format)
    dims = list(bbox.shape)
    if downsamplings is None:
        downsamplings = [[1, 1, 1]]
    rel = _relative_steps(downsamplings)
    block_size = [int(b) for b in block_size]
    dt = np.dtype(data_type).name

    if storage_format == StorageFormat.ZARR:
        fusion_format = "BDV/OME-ZARR" if bdv else "OME-ZARR"
    else:
        fusion_format = "BDV/N5" if bdv else "N5"

    mr_infos: list[list[MultiResolutionLevelInfo]] = []
    if storage_format == StorageFormat.ZARR:
        # one 5-D multiscale pyramid holds all channels/timepoints
        levels: list[MultiResolutionLevelInfo] = []
        for lvl, absd in enumerate(downsamplings):
            ldims = _level_dims(dims, absd)
            shape5 = ldims + [num_channels, num_timepoints]
            block5 = block_size + [1, 1]
            store.create_dataset(str(lvl), shape5, block5, dt,
                                 compression=compression, delete_existing=True)
            levels.append(MultiResolutionLevelInfo(
                dataset=f"/{lvl}", dimensions=shape5, blockSize=block5,
                relativeDownsampling=rel[lvl], absoluteDownsampling=list(absd),
                dataType=dt,
            ))
        for _ in range(num_channels * num_timepoints):
            mr_infos.append(levels)
        _write_ome_ngff_multiscales(store, downsamplings, anisotropy_factor)
    else:
        for t in range(num_timepoints):
            for c in range(num_channels):
                if bdv:
                    s_id = c + setup_id_offset
                    prefix = f"setup{s_id}/timepoint{t}"
                    store.set_attribute(f"setup{s_id}", "downsamplingFactors",
                                        [list(a) for a in downsamplings])
                    store.set_attribute(f"setup{s_id}", "dataType", dt)
                else:
                    prefix = f"ch{c}tp{t}"
                levels = []
                for lvl, absd in enumerate(downsamplings):
                    ldims = _level_dims(dims, absd)
                    ds = store.create_dataset(
                        f"{prefix}/s{lvl}", ldims, block_size, dt,
                        compression=compression, delete_existing=True,
                    )
                    store.set_attribute(ds.path, "downsamplingFactors",
                                        [int(v) for v in absd])
                    levels.append(MultiResolutionLevelInfo(
                        dataset=f"{prefix}/s{lvl}", dimensions=ldims,
                        blockSize=list(block_size),
                        relativeDownsampling=rel[lvl],
                        absoluteDownsampling=list(absd), dataType=dt,
                    ))
                # reference indexing: mrInfos[c + t*numChannels]
                mr_infos.append(levels)

    meta = FusionContainerMeta(
        input_xml=input_xml, num_timepoints=num_timepoints,
        num_channels=num_channels, bbox=bbox, data_type=dt,
        block_size=block_size, fusion_format=fusion_format,
        preserve_anisotropy=preserve_anisotropy,
        anisotropy_factor=anisotropy_factor,
        min_intensity=min_intensity, max_intensity=max_intensity,
        mr_infos=mr_infos,
    )
    write_container_meta(store, meta)
    return meta


def open_container(path: str) -> ChunkStore:
    """Open a fusion container root (N5 or zarr directory)."""
    if str(path).endswith((".h5", ".hdf5")) or os.path.isfile(path):
        raise NotYetPorted("HDF5 fusion containers")
    return ChunkStore.open(path)


def write_container_meta(store: ChunkStore, meta: FusionContainerMeta) -> None:
    sa = lambda k, v: store.set_attribute("", f"{ATTR_PREFIX}/{k}", v)
    sa("FusionFormat", meta.fusion_format)
    sa("InputXML", meta.input_xml)
    sa("NumTimepoints", meta.num_timepoints)
    sa("NumChannels", meta.num_channels)
    sa("Boundingbox_min", list(meta.bbox.min))
    sa("Boundingbox_max", list(meta.bbox.max))
    sa("PreserveAnisotropy", meta.preserve_anisotropy)
    if meta.preserve_anisotropy and np.isfinite(meta.anisotropy_factor):
        sa("AnisotropyFactor", meta.anisotropy_factor)
    sa("DataType", meta.data_type)
    sa("BlockSize", meta.block_size)
    if meta.min_intensity is not None and meta.max_intensity is not None:
        sa("MinIntensity", meta.min_intensity)
        sa("MaxIntensity", meta.max_intensity)
    sa("MultiResolutionInfos",
       [[li.to_json() for li in levels] for levels in meta.mr_infos])


def read_container_meta(store: ChunkStore) -> FusionContainerMeta:
    ga = lambda k, d=None: store.get_attribute("", f"{ATTR_PREFIX}/{k}", d)
    fusion_format = ga("FusionFormat")
    if fusion_format is None:
        raise ValueError(
            "Could not load 'Bigstitcher-Spark/FusionFormat' metadata — "
            "run create-fusion-container first."
        )
    bbox = Interval(ga("Boundingbox_min"), ga("Boundingbox_max"))
    mr = [
        [MultiResolutionLevelInfo.from_json(li) for li in levels]
        for levels in ga("MultiResolutionInfos", [])
    ]
    return FusionContainerMeta(
        input_xml=ga("InputXML"),
        num_timepoints=int(ga("NumTimepoints")),
        num_channels=int(ga("NumChannels")),
        bbox=bbox,
        data_type=ga("DataType"),
        block_size=[int(v) for v in ga("BlockSize")],
        fusion_format=fusion_format,
        preserve_anisotropy=bool(ga("PreserveAnisotropy", False)),
        anisotropy_factor=float(ga("AnisotropyFactor", float("nan"))),
        min_intensity=ga("MinIntensity"),
        max_intensity=ga("MaxIntensity"),
        mr_infos=mr,
    )


def _write_ome_ngff_multiscales(
    store: ChunkStore, downsamplings: list[list[int]], anisotropy_factor: float,
) -> None:
    """OME-NGFF v0.4 multiscales metadata (CreateFusionContainer.java:368-388).
    Axes listed in on-disk (tczyx) order."""
    aniso = anisotropy_factor if np.isfinite(anisotropy_factor) else 1.0
    res0 = [1.0, 1.0, aniso]  # xyz
    datasets = []
    for lvl, absd in enumerate(downsamplings):
        scale_xyz = [res0[d] * absd[d] for d in range(3)]
        trans_xyz = [0.5 * (absd[d] - 1) * res0[d] for d in range(3)]
        datasets.append({
            "path": str(lvl),
            "coordinateTransformations": [
                {"type": "scale",
                 "scale": [1.0, 1.0] + scale_xyz[::-1]},
                {"type": "translation",
                 "translation": [0.0, 0.0] + trans_xyz[::-1]},
            ],
        })
    store.set_attribute("", "multiscales", [{
        "version": "0.4",
        "name": "/",
        "axes": [
            {"name": "t", "type": "time", "unit": "second"},
            {"name": "c", "type": "channel"},
            {"name": "z", "type": "space", "unit": "micrometer"},
            {"name": "y", "type": "space", "unit": "micrometer"},
            {"name": "x", "type": "space", "unit": "micrometer"},
        ],
        "datasets": datasets,
        "type": "sampling",
    }])
