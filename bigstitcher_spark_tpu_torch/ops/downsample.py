"""Average downsampling by integer factors: one CUDA kernel (K6) and its
plain-torch twins.

Port of ``bigstitcher_spark_tpu/ops/downsample.py`` and of the batched
downsample of ``models/downsample_driver.py``. ``csrc/downsample.cu`` (K6)
takes a batch of same-shape boxes in their stored type and writes either the
float32 means (:func:`downsample_batch`, :func:`downsample_block`: the JAX
``downsample_block`` and its vmap) or the next pyramid level in the storage
type (:func:`downsample_level`: crop to dims * factors, edge-pad thin axes,
mean, round half to even, clip). The plain versions take strided slices
and sum them in the kernel's order; a wrapper takes its plain version only
because its tensor lies on the CPU, and counts its kernel launches in its
``launches`` attribute.

The means are taken per axis (x, then y, then z), each a left-to-right sum
divided by the factor. For integer inputs and power-of-two factors every
sum and quotient is exact, so both versions equal the JAX package bit for
bit; otherwise float32 rounding order may differ from XLA's.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import _cuda
from .fusion import _IN_CODE, _out_spec, _require, _stream


def _factors(factors: Sequence[int]) -> tuple[int, int, int]:
    f = tuple(int(v) for v in factors)
    if len(f) != 3 or min(f) < 1:
        raise ValueError(f"factors must be three integers >= 1, got {factors}")
    return f


def downsample_block_plain(x: torch.Tensor,
                           factors: Sequence[int]) -> torch.Tensor:
    """Float32 mean of ``x`` (..., X, Y, Z) over windows of ``factors``;
    trailing voxels past ``(X // fx) * fx`` are dropped. The sum of each
    window is its strided slices added left to right, then divided by the
    factor as a device tensor (a Python-scalar divisor may become a
    reciprocal multiplication on the card)."""
    x = x.to(torch.float32)
    for d, f in enumerate(_factors(factors)):
        if f == 1:
            continue
        ax = x.dim() - 3 + d
        n = x.shape[ax] // f
        sl = [slice(None)] * x.dim()
        sl[ax] = slice(0, n * f, f)
        acc = x[tuple(sl)]
        for k in range(1, f):
            sl[ax] = slice(k, n * f, f)
            acc = acc + x[tuple(sl)]
        x = acc / torch.tensor(float(f), dtype=torch.float32, device=x.device)
    return x


def convert_storage(x: torch.Tensor, out_dtype: str) -> torch.Tensor:
    """Round half to even and clip to an integer storage type, or keep
    float32 (the JAX ``convert_storage``, and the downsample drivers' host
    ``np.clip(np.round(x), lo, hi).astype``)."""
    _code, dtype, imax = _out_spec(out_dtype)
    if imax is None:
        return x.to(torch.float32)
    return torch.clamp(torch.round(x), 0.0, imax).to(dtype)


def _crop_or_pad(prev: torch.Tensor, needed: Sequence[int]) -> torch.Tensor:
    """``prev`` cut to ``needed`` voxels per axis, repeating the last voxel
    of an axis thinner than that (the read_padded edge rule)."""
    for d, n in enumerate(needed):
        s = prev.shape[d]
        if n <= s:
            prev = prev.narrow(d, 0, n)
        else:
            idx = torch.clamp(torch.arange(n, device=prev.device), max=s - 1)
            prev = prev.index_select(d, idx)
    return prev


def downsample_level_plain(prev: torch.Tensor, factors: Sequence[int],
                           dims: Sequence[int], out_dtype: str) -> torch.Tensor:
    """One pyramid level of ``dims`` from the previous level in its storage
    type (the JAX ``downsample_level``): crop to ``dims * factors``,
    edge-pad thin axes, float32 mean, convert to ``out_dtype``."""
    f = _factors(factors)
    needed = [int(d) * int(k) for d, k in zip(dims, f)]
    return convert_storage(downsample_block_plain(_crop_or_pad(prev, needed),
                                                  f), out_dtype)


def _launch(x, B, f, dims, out_dtype):
    """K6 on a contiguous (B, X, Y, Z) batch; returns (B, *dims)."""
    code, dtype, _imax = _out_spec(out_dtype)
    X, Y, Z = (int(s) for s in x.shape[-3:])
    out = torch.empty((B, *dims), dtype=dtype, device=x.device)
    lib = _cuda.load("downsample")
    ret = lib.bst_downsample(
        x.data_ptr(), _IN_CODE[x.dtype], B, X, Y, Z, *f, *dims, code,
        out.data_ptr(), _stream(x.device))
    _cuda.check(lib, ret, "downsample")
    return out


def downsample_level(prev: torch.Tensor, factors: Sequence[int],
                     dims: Sequence[int], out_dtype: str) -> torch.Tensor:
    """K6 (``csrc/downsample.cu``) with storage-type output on CUDA, the
    plain version on the CPU. ``prev`` (X, Y, Z) uint8/uint16/int16/float32;
    returns the level (``dims``) in ``out_dtype`` (uint8, uint16 or
    float32)."""
    if prev.device.type == "cpu":
        return downsample_level_plain(prev, factors, dims, out_dtype)
    _require(prev, "prev", prev.device, _IN_CODE)
    if prev.dim() != 3:
        raise ValueError("prev must be 3-D (x, y, z)")
    dims = tuple(int(d) for d in dims)
    if len(dims) != 3 or min(dims) < 1:
        raise ValueError(f"dims must be three positive ints, got {dims}")
    out = _launch(prev, 1, _factors(factors), dims, out_dtype)[0]
    downsample_level.launches += 1
    return out


downsample_level.launches = 0


def downsample_batch(raws: torch.Tensor,
                     factors: Sequence[int]) -> torch.Tensor:
    """K6 with float32 output on CUDA, the plain version on the CPU: the
    mean of each (X, Y, Z) box of ``raws`` (B, X, Y, Z) over windows of
    ``factors`` -> (B, X // fx, Y // fy, Z // fz) float32 (the JAX
    vmap of ``downsample_block``)."""
    if raws.device.type == "cpu":
        return downsample_block_plain(raws, factors)
    _require(raws, "raws", raws.device, _IN_CODE)
    if raws.dim() != 4:
        raise ValueError("raws must be (B, X, Y, Z)")
    f = _factors(factors)
    dims = tuple(int(s) // k for s, k in zip(raws.shape[1:], f))
    if min(dims) < 1:
        raise ValueError(f"box {tuple(raws.shape[1:])} is thinner than "
                         f"factors {f}")
    out = _launch(raws, int(raws.shape[0]), f, dims, "float32")
    downsample_batch.launches += 1
    return out


downsample_batch.launches = 0


def downsample_block(block: torch.Tensor,
                     factors: Sequence[int]) -> torch.Tensor:
    """The JAX ``downsample_block``: one (X, Y, Z) box -> float32 means
    (a batch of one through :func:`downsample_batch`)."""
    return downsample_batch(block[None], factors)[0]


def to_kernel_dtype(a: np.ndarray) -> np.ndarray:
    """A host box in a type K6 reads: native-order uint8, uint16, int16 and
    float32 go as they are, anything else as float32 (the JAX driver also
    ships other types as float32)."""
    a = np.asarray(a)
    if a.dtype in (np.dtype(np.uint8), np.dtype(np.uint16),
                   np.dtype(np.int16), np.dtype(np.float32)):
        return a
    return a.astype(np.float32)


KERNEL_WRAPPERS = {
    "downsample_level": downsample_level,
    "downsample_batch": downsample_batch,
}
