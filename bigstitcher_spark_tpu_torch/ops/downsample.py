"""Average downsampling by integer factors: one CUDA kernel (K6) and its
plain-torch twins.

Port of ``bigstitcher_spark_tpu/ops/downsample.py`` and of the batched
downsample of ``models/downsample_driver.py``. ``csrc/downsample.cu`` (K6)
takes a batch of same-shape boxes in their stored type and writes either the
float32 means (:func:`downsample_batch`, :func:`downsample_block`: the JAX
``downsample_block`` and its vmap) or the next pyramid level in the storage
type (:func:`downsample_level`: crop to dims * factors, edge-pad thin axes,
mean, round half to even, clip). :func:`halfpixel_downsample2x_axis` (the
JAX function of that name) is K6's float32 form with factor 2 on one axis.
The plain versions take strided slices and sum them in the kernel's order;
a wrapper takes its plain version only because its tensor lies on the CPU,
and counts its kernel launches in its ``launches`` attribute.

The means are taken per axis (x, then y, then z), each a left-to-right sum
divided by the factor. For integer inputs and power-of-two factors every
sum and quotient is exact, so both versions equal the JAX package bit for
bit; otherwise float32 rounding order may differ from XLA's.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Sequence

import numpy as np
import torch

from . import _cuda
from .fusion import _IN_CODE, _out_spec, _require, _stream

# K6's launch (csrc/downsample.cu): z outputs a thread on its fast path,
# threads a block, and the largest fx, fy that path takes
DOWNSAMPLE_R = 8
DOWNSAMPLE_THREADS = 256
DOWNSAMPLE_MAX_FAST = 1 << 20
DownsamplePlan = namedtuple("DownsamplePlan",
                            "shape factors dims fast vb vs block grid")


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


def _pow2(v: int) -> int:
    """The largest power of two dividing ``v``, at most 16 (16 for 0)."""
    v = int(v)
    return 16 if v == 0 else min(16, v & -v)


def _cdiv(a: int, b: int) -> int:
    return -(-int(a) // int(b))


def downsample_plan(shape, factors, dims, in_itemsize: int,
                    out_itemsize: int, in_addr: int = 0,
                    out_addr: int = 0) -> DownsamplePlan:
    """K6's launch for a (B, X, Y, Z) batch at ``in_addr`` of
    ``in_itemsize``-byte elements, ``factors`` and output ``dims`` written
    at ``out_addr`` in ``out_itemsize``-byte elements. ``shape``,
    ``factors``, ``dims``: what the kernel is given, a trailing size-1 axis
    with factor 1 re-viewed as (B, 1, X, Y) with factors (1, fx, fy) so that
    a wide axis is fastest (the same memory, the same sums in the same
    order). ``fast``: fz of 1 or 2 and fx, fy at most DOWNSAMPLE_MAX_FAST,
    the kernel's fast path, DOWNSAMPLE_R z outputs a thread (else one,
    the general path). ``vb`` / ``vs``: the vector bytes of its loads and
    stores, the largest power of two (at most 16, at least 4, else 0 for
    element access) dividing the address, the row's bytes and a thread's
    run of inputs / outputs. ``block`` (runs along z, rows along j), at
    most DOWNSAMPLE_THREADS threads; ``grid`` (B OX, j tiles, run tiles),
    each cut to the card's limit (the kernel strides over the rest)."""
    B, X, Y, Z = (int(v) for v in shape)
    fx, fy, fz = _factors(factors)
    OX, OY, OZ = (int(d) for d in dims)
    if min(B, X, Y, Z, OX, OY, OZ) < 1:
        raise ValueError(f"empty downsample: {tuple(shape)} -> {tuple(dims)}")
    if Z == 1 and fz == 1 and OZ == 1:
        X, Y, Z, fx, fy, fz, OX, OY, OZ = 1, X, Y, 1, fx, fy, 1, OX, OY
    if B * OX > 2 ** 31 - 1:
        raise ValueError(f"{B} x {OX} output slices exceed the launch grid")
    fast = fz in (1, 2) and max(fx, fy) <= DOWNSAMPLE_MAX_FAST
    R = DOWNSAMPLE_R if fast else 1
    vb = vs = 0
    if fast:
        vb = min(_pow2(Z * in_itemsize | in_addr), _pow2(R * fz * in_itemsize))
        vs = min(_pow2(OZ * out_itemsize | out_addr), _pow2(R * out_itemsize))
        vb, vs = (vb if vb >= 4 else 0), (vs if vs >= 4 else 0)
    runs = _cdiv(OZ, R)
    tx = min(runs, DOWNSAMPLE_THREADS)
    ty = min(DOWNSAMPLE_THREADS // tx, OY)
    grid = (B * OX, min(_cdiv(OY, ty), 65535), min(_cdiv(runs, tx), 65535))
    return DownsamplePlan((B, X, Y, Z), (fx, fy, fz), (OX, OY, OZ), fast,
                          vb, vs, (tx, ty), grid)


def _launch(x, B, f, dims, out_dtype):
    """K6 on a contiguous (B, X, Y, Z) batch; returns (B, *dims). The
    launch: :func:`downsample_plan`."""
    code, dtype, _imax = _out_spec(out_dtype)
    out = torch.empty((B, *dims), dtype=dtype, device=x.device)
    plan = downsample_plan((B, *x.shape[-3:]), f, dims, x.element_size(),
                           out.element_size(), x.data_ptr(), out.data_ptr())
    lib = _cuda.load("downsample")
    ret = lib.bst_downsample(
        x.data_ptr(), _IN_CODE[x.dtype], *plan.shape, *plan.factors,
        *plan.dims, code, out.data_ptr(), plan.vb, plan.vs, *plan.block,
        *plan.grid, _stream(x.device))
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


def _halfpixel_view(x, axis: int, device):
    """``x`` on its device (an array on ``device``, ``cuda`` unless asked
    otherwise) in a type K6 reads, as (1, before, n, after) with the axis
    normalised; and the output shape."""
    if not isinstance(x, torch.Tensor):
        from ..utils.device import resolve_device

        x = torch.as_tensor(np.asarray(x)).to(resolve_device(device))
    if x.dim() < 1:
        raise ValueError("halfpixel_downsample2x_axis needs at least one axis")
    if x.dtype not in _IN_CODE:  # JAX casts each operand to float32 first
        x = x.to(torch.float32)
    ax = range(x.dim())[axis]
    shape = tuple(int(s) for s in x.shape)
    out = shape[:ax] + (shape[ax] // 2,) + shape[ax + 1:]
    before, after = int(np.prod(shape[:ax])), int(np.prod(shape[ax + 1:]))
    return x.reshape(1, before, shape[ax], after).contiguous(), out


def halfpixel_downsample2x_axis_plain(x, axis: int,
                                      device=None) -> torch.Tensor:
    """The twin of :func:`halfpixel_downsample2x_axis`: K6's plain version
    on the same (1, before, n, after) view."""
    v, out = _halfpixel_view(x, axis, device)
    return downsample_block_plain(v, (1, 2, 1)).reshape(out)


def halfpixel_downsample2x_axis(x, axis: int, device=None) -> torch.Tensor:
    """The JAX ``halfpixel_downsample2x_axis``: out[i] = (in[2i] +
    in[2i+1]) / 2 along ``axis`` in float32, a trailing odd voxel dropped,
    for any ndim >= 1 (a tensor stays on its device; an array goes to
    ``device``, ``cuda`` unless asked otherwise). K6 with factors (1, 2, 1)
    on the view (1, prod(before), n, prod(after)) on CUDA, its twin on the
    CPU. K6 divides the pair sum by 2; a float32 division by 2 and JAX's
    multiplication by 0.5 round the same real number once, so both equal
    JAX's bit for bit. uint8, uint16, int16 and float32 go to K6 as they
    are, other types as float32."""
    v, out = _halfpixel_view(x, axis, device)
    if v.device.type == "cpu" or not int(np.prod(out)):
        return downsample_block_plain(v, (1, 2, 1)).reshape(out)
    return downsample_batch(v, (1, 2, 1)).reshape(out)


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
