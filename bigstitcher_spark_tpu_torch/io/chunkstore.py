"""Chunked-array storage: N5 and zarr v2 on the local file system, in numpy.

Port of ``bigstitcher_spark_tpu/io/chunkstore.py`` without tensorstore:
the port reads and writes chunk files itself, so it runs where only numpy
and the standard library are installed. The files are the ones the JAX
package writes (tensorstore's layout), so either package reads the other's:

* N5: ``attributes.json`` per dataset; one file per block at
  ``<dataset>/<i>/<j>/<k>``, a big-endian header (mode, ndim, block dims)
  followed by the encoded big-endian payload, x fastest. Edge blocks hold
  only the voxels inside the dataset.
* zarr v2: ``.zarray`` per dataset, C order on disk (the 5-D OME-ZARR
  ``t,c,z,y,x``); one full-size chunk per file named ``z.y.x`` (reversed
  grid position), edge chunks padded with the fill value.

Codecs: raw, gzip (zlib), bzip2 and xz from the standard library, zstd
through :mod:`.zstd`. blosc, lz4 and HDF5 are not yet ported. All public
APIs use xyz-first logical axis order, as in the JAX package. Attribute
files are plain JSON with N5-style nested key paths.
"""

from __future__ import annotations

import bz2
import enum
import gzip
import itertools
import json
import lzma
import os
import shutil
import struct
import zlib
from typing import Any, Sequence

import numpy as np

from .. import NotYetPorted
from . import uris, zstd


class StorageFormat(str, enum.Enum):
    N5 = "N5"
    ZARR = "ZARR"
    HDF5 = "HDF5"


_N5_DTYPES = {
    "uint8", "uint16", "uint32", "uint64",
    "int8", "int16", "int32", "int64",
    "float32", "float64",
}

_ZARR_DTYPE = {
    "uint8": "|u1", "uint16": "<u2", "uint32": "<u4", "uint64": "<u8",
    "int8": "|i1", "int16": "<i2", "int32": "<i4", "int64": "<i8",
    "float32": "<f4", "float64": "<f8",
}


def _split_level(name: str, level: int | None):
    """``name:level`` carries --compressionLevel inline (e.g. ``zstd:7``)."""
    if ":" in name:
        name, lv = name.split(":", 1)
        if level is None:
            level = int(lv)
    return name, level


def _n5_compression(name: str, level: int | None = None) -> dict:
    """N5 codec metadata, spelled as tensorstore writes it (defaults filled)."""
    name, level = _split_level(name.lower(), level)
    if name == "zstd":
        return {"level": 0 if level is None else int(level), "type": "zstd"}
    if name == "gzip":
        return {"level": -1 if level is None else int(level), "type": "gzip",
                "useZlib": False}
    if name == "raw":
        return {"type": "raw"}
    if name == "bzip2":
        return {"blockSize": 9 if level is None else int(level),
                "type": "bzip2"}
    if name == "xz":
        return {"preset": 6 if level is None else int(level), "type": "xz"}
    if name in ("blosc", "lz4"):
        raise NotYetPorted(f"{name} compression")
    raise ValueError(f"unsupported n5 compression: {name}")


def _zarr_compressor(name: str, level: int | None = None) -> dict | None:
    name, level = _split_level(name.lower(), level)
    if name == "zstd":
        return {"id": "zstd", "level": 3 if level is None else int(level)}
    if name == "gzip":
        return {"id": "zlib", "level": 5 if level is None else int(level)}
    if name == "bzip2":
        return {"id": "bz2", "level": 5 if level is None else int(level)}
    if name == "raw":
        return None
    if name in ("blosc", "lz4", "xz"):
        raise NotYetPorted(f"{name} compression for zarr")
    raise ValueError(f"unsupported zarr compression: {name}")


def _n5_encode(comp: dict, raw: bytes) -> bytes:
    t = comp.get("type", "raw")
    if t == "raw":
        return raw
    if t == "zstd":
        return zstd.compress(raw, comp.get("level", 0))
    if t == "gzip":
        lvl = int(comp.get("level", -1))
        if comp.get("useZlib", False):
            return zlib.compress(raw, lvl)
        return gzip.compress(raw, compresslevel=6 if lvl < 0 else lvl,
                             mtime=0)
    if t == "bzip2":
        return bz2.compress(raw, int(comp.get("blockSize", 9)))
    if t == "xz":
        return lzma.compress(raw, format=lzma.FORMAT_XZ,
                             preset=int(comp.get("preset", 6)))
    raise NotYetPorted(f"N5 {t} codec")


def _n5_decode(comp: dict, data: bytes, nbytes: int) -> bytes:
    t = comp.get("type", "raw")
    if t == "raw":
        return data
    if t == "zstd":
        return zstd.decompress(data, nbytes)
    if t == "gzip":
        return zlib.decompress(data, 47)  # gzip or zlib header, auto-detected
    if t == "bzip2":
        return bz2.decompress(data)
    if t == "xz":
        return lzma.decompress(data)
    raise NotYetPorted(f"N5 {t} codec")


def _zarr_encode(comp: dict | None, raw: bytes) -> bytes:
    if comp is None:
        return raw
    cid = comp.get("id")
    if cid == "zstd":
        return zstd.compress(raw, comp.get("level", 3))
    if cid == "zlib":
        return zlib.compress(raw, int(comp.get("level", 5)))
    if cid == "bz2":
        return bz2.compress(raw, int(comp.get("level", 5)))
    raise NotYetPorted(f"zarr {cid} codec")


def _zarr_decode(comp: dict | None, data: bytes, nbytes: int) -> bytes:
    if comp is None:
        return data
    cid = comp.get("id")
    if cid == "zstd":
        return zstd.decompress(data, nbytes)
    if cid in ("zlib", "gzip"):
        return zlib.decompress(data, 47)
    if cid == "bz2":
        return bz2.decompress(data)
    raise NotYetPorted(f"zarr {cid} codec")


def _write_file(path: str, data: bytes) -> None:
    """Write through a temporary name, so a reader never sees half a chunk."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.{id(data)}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _dump_meta(meta: dict) -> bytes:
    """Dataset metadata as tensorstore writes it: sorted keys, compact."""
    return json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()


class Dataset:
    """A chunked array presented in xyz-first logical order."""

    def __init__(self, store: "ChunkStore", path: str, meta: dict):
        self.store = store
        self.path = path.strip("/")
        self._dir = store._kvpath(self.path)
        if store.format == StorageFormat.N5:
            self.shape = tuple(int(v) for v in meta["dimensions"])
            self.block_size = tuple(int(v) for v in meta["blockSize"])
            self.dtype = np.dtype(meta["dataType"])
            self._disk_dtype = self.dtype.newbyteorder(">")
            self._comp = meta.get("compression", {"type": "raw"})
            self._fill = 0
        else:
            if meta.get("order", "C") != "C" or meta.get("filters"):
                raise NotYetPorted("zarr arrays in F order or with filters")
            self.shape = tuple(int(v) for v in meta["shape"])[::-1]
            self.block_size = tuple(int(v) for v in meta["chunks"])[::-1]
            self._disk_dtype = np.dtype(meta["dtype"])
            self.dtype = self._disk_dtype.newbyteorder("=")
            self._comp = meta.get("compressor")
            self._fill = meta.get("fill_value") or 0
            self._sep = meta.get("dimension_separator", ".")

    # -- chunk files -------------------------------------------------------

    def _chunk_path(self, pos: Sequence[int]) -> str:
        if self.store.format == StorageFormat.N5:
            return os.path.join(self._dir, *(str(int(p)) for p in pos))
        name = self._sep.join(str(int(p)) for p in reversed(pos))
        return os.path.join(self._dir, name)

    def _chunk_extent(self, pos: Sequence[int]) -> tuple[int, ...]:
        return tuple(min(b, s - p * b) for p, b, s in
                     zip(pos, self.block_size, self.shape))

    def _read_chunk(self, pos: Sequence[int]) -> np.ndarray | None:
        """Chunk ``pos`` clipped to the dataset (xyz-first, native byte
        order), or None when no file exists (all fill)."""
        try:
            with open(self._chunk_path(pos), "rb") as f:
                buf = f.read()
        except FileNotFoundError:
            return None
        ext = self._chunk_extent(pos)
        if self.store.format == StorageFormat.N5:
            mode, ndim = struct.unpack(">HH", buf[:4])
            dims = struct.unpack(f">{ndim}I", buf[4:4 + 4 * ndim])
            head = 4 + 4 * ndim + (4 if mode == 1 else 0)
            n = int(np.prod(dims)) * self.dtype.itemsize
            raw = _n5_decode(self._comp, buf[head:], n)
            arr = np.frombuffer(raw, self._disk_dtype, int(np.prod(dims)))
            arr = arr.reshape(dims[::-1]).T
        else:
            n = int(np.prod(self.block_size)) * self.dtype.itemsize
            raw = _zarr_decode(self._comp, buf, n)
            arr = np.frombuffer(raw, self._disk_dtype,
                                int(np.prod(self.block_size)))
            arr = arr.reshape(self.block_size[::-1]).T
        arr = arr[tuple(slice(0, e) for e in ext)]
        return arr.astype(self.dtype, copy=False)

    def _write_chunk(self, pos: Sequence[int], arr: np.ndarray) -> None:
        """Write chunk ``pos`` from ``arr`` (its extent inside the dataset)."""
        if self.store.format == StorageFormat.N5:
            payload = np.ascontiguousarray(arr.T, dtype=self._disk_dtype)
            head = struct.pack(f">HH{arr.ndim}I", 0, arr.ndim, *arr.shape)
            data = head + _n5_encode(self._comp, payload.tobytes())
        else:
            if arr.shape != self.block_size:
                full = np.full(self.block_size, self._fill, self.dtype)
                full[tuple(slice(0, s) for s in arr.shape)] = arr
                arr = full
            payload = np.ascontiguousarray(arr.T, dtype=self._disk_dtype)
            data = _zarr_encode(self._comp, payload.tobytes())
        _write_file(self._chunk_path(pos), data)

    def _chunks_of_box(self, offset, shape):
        self._check_box(offset, shape)
        ranges = [range(int(o) // b, (int(o) + int(s) - 1) // b + 1)
                  for o, s, b in zip(offset, shape, self.block_size)]
        return itertools.product(*ranges)

    def _check_box(self, offset, shape):
        if len(offset) != len(self.shape) or len(shape) != len(self.shape):
            raise ValueError(f"{self.path}: box rank {len(offset)} != "
                             f"dataset rank {len(self.shape)}")
        for o, s, d in zip(offset, shape, self.shape):
            if int(o) < 0 or int(s) <= 0 or int(o) + int(s) > d:
                raise ValueError(f"{self.path}: box {tuple(offset)}+"
                                 f"{tuple(shape)} outside {self.shape}")

    # -- public IO ---------------------------------------------------------

    def read(self, offset: Sequence[int], shape: Sequence[int]) -> np.ndarray:
        """Read a box (xyz-first offset/shape) into a numpy array."""
        shape = tuple(int(s) for s in shape)
        out = np.full(shape, self._fill, self.dtype)
        for pos in self._chunks_of_box(offset, shape):
            chunk = self._read_chunk(pos)
            if chunk is None:
                continue
            c0 = [p * b for p, b in zip(pos, self.block_size)]
            lo = [max(int(o), c) for o, c in zip(offset, c0)]
            hi = [min(int(o) + s, c + e)
                  for o, s, c, e in zip(offset, shape, c0, chunk.shape)]
            out[tuple(slice(l - int(o), h - int(o))
                      for l, h, o in zip(lo, hi, offset))] = \
                chunk[tuple(slice(l - c, h - c)
                            for l, h, c in zip(lo, hi, c0))]
        return out

    def write(self, data: np.ndarray, offset: Sequence[int]) -> None:
        """Write a numpy array (xyz-first) at an xyz-first offset. Chunks the
        box covers fully are replaced; partly covered ones are read,
        updated and rewritten (callers own disjoint chunks)."""
        data = np.asarray(data)
        if data.dtype != self.dtype:
            data = data.astype(self.dtype)
        for pos in self._chunks_of_box(offset, data.shape):
            c0 = [p * b for p, b in zip(pos, self.block_size)]
            ext = self._chunk_extent(pos)
            lo = [max(int(o), c) for o, c in zip(offset, c0)]
            hi = [min(int(o) + s, c + e)
                  for o, s, c, e in zip(offset, data.shape, c0, ext)]
            src = data[tuple(slice(l - int(o), h - int(o))
                             for l, h, o in zip(lo, hi, offset))]
            if all(l == c and h == c + e
                   for l, h, c, e in zip(lo, hi, c0, ext)):
                self._write_chunk(pos, src)
                continue
            chunk = self._read_chunk(pos)
            chunk = (np.full(ext, self._fill, self.dtype) if chunk is None
                     else chunk.copy())
            chunk[tuple(slice(l - c, h - c)
                        for l, h, c in zip(lo, hi, c0))] = src
            self._write_chunk(pos, chunk)

    def read_full(self) -> np.ndarray:
        return self.read((0,) * len(self.shape), self.shape)


class ChunkStore:
    """A root N5 or zarr container on the local file system."""

    def __init__(self, root: str | os.PathLike, fmt: StorageFormat):
        self.root = uris.local_path(root)
        self.format = StorageFormat(fmt)
        if self.format == StorageFormat.HDF5:
            raise NotYetPorted("HDF5 containers")

    # -- raw object IO -----------------------------------------------------

    def _read_obj(self, rel: str) -> bytes | None:
        p = os.path.join(self.root, rel)
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            return f.read()

    def _write_obj(self, rel: str, data: bytes) -> None:
        _write_file(os.path.join(self.root, rel), data)

    # -- creation ----------------------------------------------------------

    @staticmethod
    def create(root: str | os.PathLike, fmt: StorageFormat) -> "ChunkStore":
        store = ChunkStore(root, fmt)
        os.makedirs(store.root, exist_ok=True)
        if store.format == StorageFormat.N5:
            store._merge_json("attributes.json", {"n5": "2.5.1"})
        else:
            store._merge_json(".zgroup", {"zarr_format": 2})
        return store

    @staticmethod
    def open(root: str | os.PathLike) -> "ChunkStore":
        root = uris.local_path(root)
        probe = ChunkStore(root, StorageFormat.N5)
        if probe._read_obj("attributes.json") is not None:
            return probe
        if (probe._read_obj(".zgroup") is not None
                or probe._read_obj(".zattrs") is not None):
            return ChunkStore(root, StorageFormat.ZARR)
        if root.rstrip("/").endswith((".zarr", ".ome.zarr")):
            return ChunkStore(root, StorageFormat.ZARR)
        return probe

    # -- attributes --------------------------------------------------------

    def _attr_rel(self, group: str) -> str:
        name = "attributes.json" if self.format == StorageFormat.N5 else ".zattrs"
        g = group.strip("/")
        return f"{g}/{name}" if g else name

    def _merge_json(self, rel: str, updates: dict) -> None:
        raw = self._read_obj(rel)
        current: dict = json.loads(raw) if raw else {}
        current.update(updates)
        self._write_obj(rel, json.dumps(
            current, indent=0, default=_json_default).encode())

    def get_attributes(self, group: str = "") -> dict:
        raw = self._read_obj(self._attr_rel(group))
        return json.loads(raw) if raw else {}

    def set_attribute(self, group: str, key_path: str, value: Any) -> None:
        """N5-style nested attribute: key path split on '/'."""
        attrs = self.get_attributes(group)
        keys = [k for k in key_path.split("/") if k]
        node = attrs
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
        self._write_obj(self._attr_rel(group), json.dumps(
            attrs, indent=0, default=_json_default).encode())

    def get_attribute(self, group: str, key_path: str, default: Any = None) -> Any:
        node: Any = self.get_attributes(group)
        for k in [k for k in key_path.split("/") if k]:
            if not isinstance(node, dict) or k not in node:
                return default
            node = node[k]
        return node

    # -- datasets ----------------------------------------------------------

    def _kvpath(self, path: str) -> str:
        return os.path.join(self.root, path.strip("/"))

    def create_dataset(
        self,
        path: str,
        shape: Sequence[int],
        block_size: Sequence[int],
        dtype: str | np.dtype,
        compression: str = "zstd",
        delete_existing: bool = False,
        compression_level: int | None = None,
    ) -> Dataset:
        """Create a chunked dataset. ``shape``/``block_size`` xyz-first."""
        dtype = np.dtype(dtype).name
        if dtype not in _N5_DTYPES:
            raise ValueError(f"unsupported dtype {dtype}")
        shape = tuple(int(v) for v in shape)
        block = tuple(min(int(b), int(s)) if int(s) > 0 else int(b)
                      for b, s in zip(block_size, shape))
        p = path.strip("/")
        if self.format == StorageFormat.N5:
            meta = {
                "blockSize": list(block),
                "compression": _n5_compression(compression, compression_level),
                "dataType": dtype,
                "dimensions": list(shape),
            }
            rel = f"{p}/attributes.json"
        else:
            meta = {
                "chunks": list(block[::-1]),
                "compressor": _zarr_compressor(compression, compression_level),
                "dimension_separator": ".",
                "dtype": _ZARR_DTYPE[dtype],
                "fill_value": None,
                "filters": None,
                "order": "C",
                "shape": list(shape[::-1]),
                "zarr_format": 2,
            }
            rel = f"{p}/.zarray"
        if self.is_dataset(p):
            if not delete_existing:
                raise ValueError(f"{path} already exists")
            shutil.rmtree(self._kvpath(p))
        self._write_obj(rel, _dump_meta(meta))
        return Dataset(self, p, meta)

    def open_dataset(self, path: str) -> Dataset:
        p = path.strip("/")
        name = "attributes.json" if self.format == StorageFormat.N5 else ".zarray"
        raw = self._read_obj(f"{p}/{name}" if p else name)
        meta = json.loads(raw) if raw else None
        if not meta or (self.format == StorageFormat.N5
                        and "dimensions" not in meta):
            raise FileNotFoundError(f"no dataset at {self.root}/{p}")
        return Dataset(self, p, meta)

    def is_dataset(self, path: str) -> bool:
        p = path.strip("/")
        if self.format == StorageFormat.N5:
            raw = self._read_obj(f"{p}/attributes.json" if p else "attributes.json")
            return raw is not None and "dimensions" in json.loads(raw)
        return self._read_obj(f"{p}/.zarray" if p else ".zarray") is not None

    def exists(self, path: str) -> bool:
        """Whether a group, dataset or object lies at ``path``."""
        return os.path.exists(self._kvpath(path))

    def list_children(self, path: str = "") -> list[str]:
        """Names of the groups and datasets directly under ``path``."""
        p = self._kvpath(path)
        if not os.path.isdir(p):
            return []
        return sorted(d for d in os.listdir(p)
                      if os.path.isdir(os.path.join(p, d)))

    def remove(self, path: str = "") -> None:
        """Delete ``path`` and everything under it (the whole store for "")."""
        p = self._kvpath(path) if path else self.root
        if os.path.exists(p):
            shutil.rmtree(p)


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")
