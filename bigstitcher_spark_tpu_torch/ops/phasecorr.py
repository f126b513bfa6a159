"""FFT phase-correlation pairwise shift estimation: four CUDA kernels, their
plain-torch twins, and the host-side refinement.

Port of ``bigstitcher_spark_tpu/ops/phasecorr.py``. The device side of the
JAX program ``pcm_peaks`` (and its vmap ``pcm_peaks_batch``) is split into
four hand-written kernels for ``sm_90a``, with a batch dimension written
out instead of ``vmap``:

==========================  ========================  ==========================
wrapper                     kernel (csrc/)            step of ``pcm_peaks``
==========================  ========================  ==========================
:func:`pcm_window`          ``pcm.cu`` (K7)           cast, ``_windowed``
:func:`fft_pow2`            ``fft.cu`` (K8)           ``rfftn`` / ``irfftn`` passes
:func:`pcm_cross_power`     ``pcm.cu`` (K9)           normalised cross-power
:func:`pcm_peaks_topk`      ``pcm.cu`` (K10)          ``_local_maxima`` + top_k
==========================  ========================  ==========================

:func:`pcm_peaks_batch` composes them; :func:`pcm_peaks_plain` composes the
twins. A wrapper takes its plain version only because its tensor lies on
the CPU; on CUDA tensors it launches its kernel or raises. Each wrapper
counts its calls that launch its kernel in its ``launches`` attribute. K8's
twin is ``torch.fft``, a library call the port makes only on the CPU and in
the checks.

The host side (summed-area Pearson scoring of each peak's periodic wraps,
hill-climb, quadratic subpixel; float64 numpy) is the JAX package's, copied
line for line: on identical crops and peaks it gives bitwise equal shifts
and correlations.

Shift convention: the returned ``shift`` s satisfies a[x] ~= b[x + s]; the
correction to apply to view B's translation is ``-s`` (see
models/stitching.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _cuda
from .fusion import _require, _stream

# FFT lengths one K8 block holds in shared memory (8192 complex = 64 KB)
MAX_FFT_LEN = 8192
# K10 keeps at most this many peaks per pair
MAX_PEAKS = 256

_PCM_IN = {torch.uint16: 1, torch.float32: 3}   # fusion_common.cuh InDtype
_FFT_MODE = {"c2c": 0, "r2c": 1, "c2r": 2}
# voxels one K10 candidate block sorts (must match pcm.cu)
_TOPK_TILE = 2048
_F32 = (torch.float32,)
_C64 = (torch.complex64,)
_I32 = (torch.int32,)


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def _check_crop_shape(shape) -> tuple[int, int, int]:
    shape = tuple(int(s) for s in shape)
    if len(shape) != 3 or not all(_is_pow2(s) for s in shape):
        raise ValueError(f"crop shape {shape} must be three powers of two")
    if max(shape) > MAX_FFT_LEN:
        raise ValueError(f"crop shape {shape}: K8 takes FFT lengths up to "
                         f"{MAX_FFT_LEN} per axis")
    if int(np.prod(shape)) >= 2 ** 31:
        raise ValueError(f"crop shape {shape}: K10's flat indices are 31-bit")
    return shape


# ---------------------------------------------------------------------------
# K7: windowing (mean subtraction + separable cosine fade)
# ---------------------------------------------------------------------------


def fade_masks(ext: torch.Tensor, shape, fade_frac: float) -> torch.Tensor:
    """Per-pair, per-axis cosine fade of ``_windowed``: for axis length n
    and extent e, ``0.5 * (1 - cos(pi * clip(d / m, 0, 1)))`` with
    ``m = max(round(e * fade_frac), 1)`` and d the distance into the crop,
    zero at x >= e. ``ext`` (B, 3) int32 -> (B, X + Y + Z) float32 on
    ext's device. K7 and its twin both read this one tensor."""
    e_all = ext.to(torch.float32)
    out = []
    for ax in range(3):
        x = torch.arange(int(shape[ax]), dtype=torch.float32,
                         device=ext.device)[None, :]
        e = e_all[:, ax:ax + 1]
        m = torch.clamp(torch.round(e * fade_frac), min=1.0)
        d = torch.minimum(x + 0.5, e - (x + 0.5))
        ramp = 0.5 * (1.0 - torch.cos(math.pi * torch.clamp(d / m, 0.0, 1.0)))
        out.append(torch.where(x < e, ramp, 0.0))
    return torch.cat(out, dim=1).contiguous()


def _window_count(ext: torch.Tensor) -> torch.Tensor:
    """max(prod(ext), 1) as the JAX program forms it: a float32 product."""
    e = ext.to(torch.float32)
    return torch.clamp(e[:, 0] * e[:, 1] * e[:, 2], min=1.0)


def pcm_window_plain(x: torch.Tensor, ext: torch.Tensor,
                     fade_frac: float = 0.25) -> torch.Tensor:
    """Plain-torch ``_windowed`` over a batch: x (B, X, Y, Z) uint16 or
    float32 zero-padded crops -> float32 ``(x - mean) * win``. The mean is
    the float64 sum over the padded volume rounded to float32, divided by
    max(prod(ext), 1); win is the product of the three fade masks, x
    times y first, then z."""
    B, X, Y, Z = (int(s) for s in x.shape)
    masks = fade_masks(ext, (X, Y, Z), fade_frac)
    mean = (x.to(torch.float64).sum(dim=(1, 2, 3)).to(torch.float32)
            / _window_count(ext))
    mx, my, mz = masks[:, :X], masks[:, X:X + Y], masks[:, X + Y:]
    win = mx[:, :, None, None] * my[:, None, :, None] * mz[:, None, None, :]
    return (x.to(torch.float32) - mean[:, None, None, None]) * win


def pcm_window(x: torch.Tensor, ext: torch.Tensor,
               fade_frac: float = 0.25) -> torch.Tensor:
    """K7 (``csrc/pcm.cu``) on CUDA, the plain version on the CPU.
    x (B, X, Y, Z) uint16 or float32, ext (B, 3) int32 -> float32."""
    if x.device.type == "cpu":
        return pcm_window_plain(x, ext, fade_frac)
    if x.dim() != 4:
        raise ValueError("x must be (B, X, Y, Z)")
    _require(x, "x", x.device, _PCM_IN)
    _require(ext, "ext", x.device, _I32, (int(x.shape[0]), 3))
    masks = fade_masks(ext, x.shape[1:], fade_frac)
    return launch_pcm_window(x, ext, masks)


def launch_pcm_window(x, ext, masks) -> torch.Tensor:
    """K7 alone, on inputs :func:`pcm_window` has checked and on the masks
    it built (chip_smoke times this and the wrapper apart)."""
    B, X, Y, Z = (int(s) for s in x.shape)
    parts = _pcm_parts(X * Y * Z)
    partial = torch.empty((B, parts), dtype=torch.float64, device=x.device)
    out = torch.empty((B, X, Y, Z), dtype=torch.float32, device=x.device)
    lib = _cuda.load("pcm")
    ret = lib.bst_pcm_window(x.data_ptr(), _PCM_IN[x.dtype], B, X, Y, Z,
                             ext.data_ptr(), masks.data_ptr(), parts,
                             partial.data_ptr(), out.data_ptr(),
                             _stream(x.device))
    _cuda.check(lib, ret, "pcm_window")
    pcm_window.launches += 1
    return out


pcm_window.launches = 0


def _pcm_parts(n: int) -> int:
    """Blocks of the per-pair partial reductions of K7 and K9: ~4 values a
    thread, at most 1024 partial results per pair."""
    return max(1, min(1024, -(-n // (256 * 4))))


# ---------------------------------------------------------------------------
# K8: batched power-of-two FFT along one axis
# ---------------------------------------------------------------------------


def _lines(shape, axis: int):
    outer = int(np.prod(shape[:axis], dtype=np.int64))
    inner = int(np.prod(shape[axis + 1:], dtype=np.int64))
    return outer, int(shape[axis]), inner


def fft_pow2_plain(x: torch.Tensor, axis: int, mode: str,
                   inverse: bool = False, scale: float = 1.0,
                   n: int | None = None) -> torch.Tensor:
    """``torch.fft`` of one K8 pass: "c2c" along ``axis`` (unscaled in both
    directions), "r2c" along the last axis (the N/2+1 bins of the forward
    transform), "c2r" along the last axis (``n`` real outputs of the
    unscaled inverse, Hermitian fill; the imaginary parts of the DC and
    Nyquist bins are dropped); the result times ``scale``."""
    if mode == "c2c":
        y = (torch.fft.ifft(x, dim=axis, norm="forward") if inverse
             else torch.fft.fft(x, dim=axis))
    elif mode == "r2c":
        y = torch.fft.rfft(x, dim=-1)
    elif mode == "c2r":
        y = torch.fft.irfft(x, n=n, dim=-1, norm="forward")
    else:
        raise ValueError(f"unknown FFT mode {mode!r}")
    return y if scale == 1.0 else y * scale


_TWIDDLES: dict = {}


def twiddles(N: int, device: torch.device) -> torch.Tensor:
    """exp(-2 pi i m / N) for m < max(N / 2, 1): computed in float64 on the
    device, rounded to complex64; cached per length and device."""
    key = (N, str(device))
    if key not in _TWIDDLES:
        m = torch.arange(max(N // 2, 1), dtype=torch.float64, device=device)
        ang = -2.0 * math.pi * m / N
        _TWIDDLES[key] = torch.complex(torch.cos(ang), torch.sin(ang)).to(
            torch.complex64).contiguous()
    return _TWIDDLES[key]


def fft_pow2(x: torch.Tensor, axis: int, mode: str, inverse: bool = False,
             scale: float = 1.0, n: int | None = None,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """K8 (``csrc/fft.cu``) on CUDA, :func:`fft_pow2_plain` on the CPU.

    One pass of a batched FFT of a power-of-two length N <= 8192 along one
    axis of a contiguous tensor: "c2c" (complex64 in and out, along any
    axis; ``out`` may be ``x``), "r2c" (float32 (..., N) -> complex64
    (..., N/2+1), forward) or "c2r" (complex64 (..., N/2+1) -> float32
    (..., n), inverse). Scaled by ``scale``."""
    if mode not in _FFT_MODE:
        raise ValueError(f"unknown FFT mode {mode!r}")
    axis = axis % x.dim()
    if mode != "c2c" and axis != x.dim() - 1:
        raise ValueError(f"{mode} runs along the last axis")
    N = int(n) if mode == "c2r" else int(x.shape[axis])
    if not _is_pow2(N) or N > MAX_FFT_LEN:
        raise ValueError(f"FFT length {N}: K8 takes powers of two up to "
                         f"{MAX_FFT_LEN}")
    if mode == "c2r" and int(x.shape[-1]) != N // 2 + 1:
        raise ValueError(f"c2r of length {N} takes {N // 2 + 1} bins, got "
                         f"{int(x.shape[-1])}")
    if mode == "r2c" and inverse or mode == "c2r" and not inverse:
        raise ValueError(f"{mode} is {'forward' if mode == 'r2c' else 'inverse'}"
                         " only")
    if x.device.type == "cpu":
        y = fft_pow2_plain(x, axis, mode, inverse, scale, n)
        return out.copy_(y) if out is not None else y
    _require(x, "x", x.device, _F32 if mode == "r2c" else _C64)
    shape = tuple(int(s) for s in x.shape)
    oshape = (shape[:-1] + (N // 2 + 1,) if mode == "r2c" else
              shape[:-1] + (N,) if mode == "c2r" else shape)
    odtype = torch.float32 if mode == "c2r" else torch.complex64
    if out is None:
        out = torch.empty(oshape, dtype=odtype, device=x.device)
    else:
        _require(out, "out", x.device, (odtype,), oshape)
    outer, _, inner = _lines(oshape if mode == "c2r" else shape, axis)
    lib = _cuda.load("fft")
    ret = lib.bst_fft_pow2(x.data_ptr(), out.data_ptr(),
                           twiddles(N, x.device).data_ptr(), _FFT_MODE[mode],
                           N, outer, inner, int(bool(inverse)), float(scale),
                           _stream(x.device))
    _cuda.check(lib, ret, "fft_pow2")
    fft_pow2.launches += 1
    return out


fft_pow2.launches = 0


def rfftn3(x: torch.Tensor) -> torch.Tensor:
    """numpy's ``rfftn`` over the last three axes of (B, X, Y, Z) float32:
    r2c along z, then c2c along y, then along x (three K8 passes)."""
    f = fft_pow2(x, 3, "r2c")
    fft_pow2(f, 2, "c2c", out=f)
    return fft_pow2(f, 1, "c2c", out=f)


def irfftn3(f: torch.Tensor, Z: int) -> torch.Tensor:
    """numpy's ``irfftn`` (norm "backward") over the last three axes, to a
    real last axis of ``Z``: c2c along x, then y, in place in ``f``, then
    c2r along z scaled by 1 / (X Y Z), exact for powers of two."""
    _, X, Y, _ = (int(s) for s in f.shape)
    fft_pow2(f, 1, "c2c", inverse=True, out=f)
    fft_pow2(f, 2, "c2c", inverse=True, out=f)
    return fft_pow2(f, 3, "c2r", inverse=True, scale=1.0 / (X * Y * Z), n=Z)


# ---------------------------------------------------------------------------
# K9: normalised cross-power spectrum
# ---------------------------------------------------------------------------


def pcm_cross_power_plain(fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """Plain ``cross = fa * conj(fb)``, ``mag = |cross|`` (hypot),
    ``norm = cross / max(mag, 1e-30)`` where ``mag > 1e-5 * max(mag)`` over
    each pair, else 0; elementwise in K9's order."""
    ar, ai, br, bi = fa.real, fa.imag, fb.real, fb.imag
    re = ar * br + ai * bi
    im = ai * br - ar * bi
    mag = torch.hypot(re, im)
    mx = mag.amax(dim=tuple(range(1, mag.dim())), keepdim=True)
    keep = mag > mx * 1e-5
    den = torch.clamp(mag, min=1e-30)
    return torch.complex(torch.where(keep, re / den, 0.0),
                         torch.where(keep, im / den, 0.0))


def pcm_cross_power(fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """K9 (``csrc/pcm.cu``) on CUDA, the plain version on the CPU.
    fa, fb (B, X, Y, Zh) complex64 -> norm, the same shape."""
    if fa.device.type == "cpu":
        return pcm_cross_power_plain(fa, fb)
    if fa.dim() != 4:
        raise ValueError("spectra must be (B, X, Y, Zh)")
    _require(fa, "fa", fa.device, _C64)
    _require(fb, "fb", fa.device, _C64, tuple(fa.shape))
    B = int(fa.shape[0])
    m = int(np.prod(fa.shape[1:]))
    parts = _pcm_parts(m)
    partial = torch.empty((B, parts), dtype=torch.float32, device=fa.device)
    out = torch.empty_like(fa)
    lib = _cuda.load("pcm")
    ret = lib.bst_pcm_cross_power(fa.data_ptr(), fb.data_ptr(), B, m, parts,
                                  partial.data_ptr(), out.data_ptr(),
                                  _stream(fa.device))
    _cuda.check(lib, ret, "pcm_cross_power")
    pcm_cross_power.launches += 1
    return out


pcm_cross_power.launches = 0


# ---------------------------------------------------------------------------
# K10: periodic 3x3x3 local maxima + top-n
# ---------------------------------------------------------------------------


def _flat_to_xyz(flat: torch.Tensor, shape) -> torch.Tensor:
    _, Y, Z = shape
    return torch.stack([flat // (Y * Z), (flat // Z) % Y, flat % Z],
                       dim=-1).to(torch.int32)


def pcm_peaks_topk_plain(pcm: torch.Tensor, n_peaks: int) -> torch.Tensor:
    """Plain ``_local_maxima`` (pcm >= its 27 periodic neighbours, by
    separable roll-max) and ``lax.top_k`` of the masked PCM: the ``n_peaks``
    largest values, ties (and the -inf of non-maxima, when fewer maxima
    exist) by ascending flat index. (B, X, Y, Z) -> (B, n_peaks, 3) int32
    (x, y, z) indices."""
    pooled = pcm
    for ax in (1, 2, 3):
        pooled = torch.maximum(pooled, torch.maximum(
            torch.roll(pooled, 1, ax), torch.roll(pooled, -1, ax)))
    masked = torch.where(pcm >= pooled, pcm, -torch.inf).flatten(1)
    _, order = torch.sort(masked, dim=1, descending=True, stable=True)
    return _flat_to_xyz(order[:, :n_peaks], tuple(pcm.shape[1:]))


def pcm_peaks_topk(pcm: torch.Tensor, n_peaks: int) -> torch.Tensor:
    """K10 (``csrc/pcm.cu``, a candidate pass and a merge pass) on CUDA,
    the plain version on the CPU. pcm (B, X, Y, Z) float32 ->
    (B, n_peaks, 3) int32; ``n_peaks`` <= 256."""
    n_peaks = int(n_peaks)
    if not 1 <= n_peaks <= MAX_PEAKS:
        raise ValueError(f"n_peaks {n_peaks}: K10 keeps 1 to {MAX_PEAKS}")
    if pcm.dim() != 4 or n_peaks > int(np.prod(pcm.shape[1:])):
        raise ValueError(f"pcm {tuple(pcm.shape)} must be (B, X, Y, Z) with "
                         f"at least {n_peaks} voxels")
    if pcm.device.type == "cpu":
        return pcm_peaks_topk_plain(pcm, n_peaks)
    _require(pcm, "pcm", pcm.device, _F32)
    B, X, Y, Z = (int(s) for s in pcm.shape)
    tiles = -(-(X * Y * Z) // _TOPK_TILE)
    cand = torch.empty((B, tiles, n_peaks), dtype=torch.int64,
                       device=pcm.device)
    out = torch.empty((B, n_peaks, 3), dtype=torch.int32, device=pcm.device)
    lib = _cuda.load("pcm")
    ret = lib.bst_pcm_peaks_topk(pcm.data_ptr(), B, X, Y, Z, n_peaks, tiles,
                                 cand.data_ptr(), out.data_ptr(),
                                 _stream(pcm.device))
    _cuda.check(lib, ret, "pcm_peaks_topk")
    pcm_peaks_topk.launches += 1
    return out


pcm_peaks_topk.launches = 0


# ---------------------------------------------------------------------------
# pcm_peaks: the composition
# ---------------------------------------------------------------------------


def _check_batch(a, b, ext_a, ext_b):
    if a.dim() != 4 or tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must be "
                         "one (B, X, Y, Z) shape")
    B = int(a.shape[0])
    for name, e in (("ext_a", ext_a), ("ext_b", ext_b)):
        if tuple(e.shape) != (B, 3):
            raise ValueError(f"{name} must be ({B}, 3)")
    return _check_crop_shape(a.shape[1:])


def pcm_peaks_batch(a: torch.Tensor, b: torch.Tensor, ext_a: torch.Tensor,
                    ext_b: torch.Tensor, n_peaks: int = 5,
                    fade_frac: float = 0.25) -> torch.Tensor:
    """Top-``n_peaks`` local maxima of the phase-correlation matrix of each
    pair -> (B, n_peaks, 3) int32 wrapped indices (the JAX
    ``pcm_peaks_batch``). a, b (B, X, Y, Z) uint16 or float32 zero-padded
    crops of power-of-two dims on one device; ext_a, ext_b (B, 3) int32 true
    extents. On CUDA: K7, K8 (three passes each way), K9, K10."""
    X, Y, Z = _check_batch(a, b, ext_a, ext_b)
    fa = rfftn3(pcm_window(a, ext_a, fade_frac))
    fb = rfftn3(pcm_window(b, ext_b, fade_frac))
    norm = pcm_cross_power(fa, fb)
    del fa, fb
    return pcm_peaks_topk(irfftn3(norm, Z), n_peaks)


def pcm_peaks_plain(a: torch.Tensor, b: torch.Tensor, ext_a: torch.Tensor,
                    ext_b: torch.Tensor, n_peaks: int = 5,
                    fade_frac: float = 0.25,
                    return_pcm: bool = False):
    """:func:`pcm_peaks_batch` through the plain twins on any device
    (``torch.fft.rfftn`` / ``irfftn`` for K8); with ``return_pcm`` also
    the PCM."""
    _check_batch(a, b, ext_a, ext_b)
    fa = torch.fft.rfftn(pcm_window_plain(a, ext_a, fade_frac), dim=(1, 2, 3))
    fb = torch.fft.rfftn(pcm_window_plain(b, ext_b, fade_frac), dim=(1, 2, 3))
    pcm = torch.fft.irfftn(pcm_cross_power_plain(fa, fb), s=a.shape[1:],
                           dim=(1, 2, 3)).to(torch.float32)
    peaks = pcm_peaks_topk_plain(pcm, n_peaks)
    return (peaks, pcm) if return_pcm else peaks


def pcm_peaks(a: torch.Tensor, b: torch.Tensor, ext_a, ext_b,
              n_peaks: int = 5, fade_frac: float = 0.25) -> torch.Tensor:
    """One pair (X, Y, Z) -> (n_peaks, 3) int32: a batch of one through
    :func:`pcm_peaks_batch`."""
    dev = a.device
    ea = torch.as_tensor(ext_a, dtype=torch.int32).reshape(1, 3).to(dev)
    eb = torch.as_tensor(ext_b, dtype=torch.int32).reshape(1, 3).to(dev)
    return pcm_peaks_batch(a[None], b[None], ea, eb, n_peaks, fade_frac)[0]


KERNEL_WRAPPERS = {
    "pcm_window": pcm_window,
    "fft_pow2": fft_pow2,
    "pcm_cross_power": pcm_cross_power,
    "pcm_peaks_topk": pcm_peaks_topk,
}


# ---------------------------------------------------------------------------
# host-side refinement (float64, overlap slices only; the JAX package's)
# ---------------------------------------------------------------------------


def _sat(x: np.ndarray) -> np.ndarray:
    """3-D summed-area table with a zero border: S[i,j,k] = sum of
    x[:i,:j,:k]; box sums become 8 corner lookups. Cumsums run on
    contiguous arrays (cumsum into a strided border view is ~5x slower)."""
    c = np.cumsum(np.cumsum(np.cumsum(x, 0, dtype=np.float64), 1), 2)
    S = np.zeros(tuple(s + 1 for s in x.shape), np.float64)
    S[1:, 1:, 1:] = c
    return S


def _box_sum(S: np.ndarray, lo, hi) -> float:
    x0, y0, z0 = int(lo[0]), int(lo[1]), int(lo[2])
    x1, y1, z1 = int(hi[0]), int(hi[1]), int(hi[2])
    return (S[x1, y1, z1] - S[x0, y1, z1] - S[x1, y0, z1] - S[x1, y1, z0]
            + S[x0, y0, z1] + S[x0, y1, z0] + S[x1, y0, z0] - S[x0, y0, z0])


class _PearsonScorer:
    """Pearson r of a[x] vs b[x+s] over the rectangular overlap (the
    reference's per-peak true cross-correlation check), with the window
    sums S_a, S_aa, S_b, S_bb served by summed-area tables — only the
    cross term S_ab costs a pass over the overlap."""

    def __init__(self, a: np.ndarray, b: np.ndarray):
        self.a = a
        self.b = b
        self.ext_a = np.array(a.shape, np.int64)
        self.ext_b = np.array(b.shape, np.int64)
        self.Sa = _sat(a)
        self.Saa = _sat(a * a)
        self.Sb = _sat(b)
        self.Sbb = _sat(b * b)

    def r(self, s, min_overlap) -> float:
        lo = np.maximum(0, -s)
        hi = np.minimum(self.ext_a, self.ext_b - s)
        if np.any(hi - lo < 1):
            return -np.inf
        n = float(np.prod(hi - lo))
        if n < min_overlap:
            return -np.inf
        av = self.a[tuple(slice(int(lo[d]), int(hi[d])) for d in range(3))]
        bv = self.b[tuple(slice(int(lo[d] + s[d]), int(hi[d] + s[d]))
                          for d in range(3))]
        s_ab = float(np.einsum("ijk,ijk->", av, bv, dtype=np.float64,
                               casting="unsafe"))
        s_a = _box_sum(self.Sa, lo, hi)
        s_aa = _box_sum(self.Saa, lo, hi)
        s_b = _box_sum(self.Sb, lo + s, hi + s)
        s_bb = _box_sum(self.Sbb, lo + s, hi + s)
        va = s_aa - s_a * s_a / n
        vb = s_bb - s_b * s_b / n
        den = np.sqrt(max(va, 0.0) * max(vb, 0.0))
        if den <= 1e-12:
            return -1.0
        return float((s_ab - s_a * s_b / n) / den)


def _r_candidate(a, b, ext_a, ext_b, s, min_overlap) -> float:
    """One-shot Pearson r (batch callers use ``_PearsonScorer`` to
    amortize the summed-area tables)."""
    return _PearsonScorer(np.asarray(a, np.float64),
                          np.asarray(b, np.float64)).r(
        np.asarray(s, np.int64), min_overlap)


def refine_peaks(
    crop_a: np.ndarray,       # unpadded crop of group A (any float dtype)
    crop_b: np.ndarray,
    peaks: np.ndarray,        # (n_peaks, 3) wrapped PCM indices
    fft_shape: tuple[int, int, int],
    min_overlap: float = 32.0,
    subpixel: bool = True,
) -> tuple[np.ndarray, float]:
    """Score peak wraps by true correlation, hill-climb (argmax over the 6
    unit neighbors + self per round, 3 rounds), then quadratic subpixel.
    Returns (shift (3,) f64, best r). Candidate r values are memoized: the
    subpixel fit reuses the final round's neighbor evaluations."""
    a = np.asarray(crop_a, np.float64)
    b = np.asarray(crop_b, np.float64)
    N = np.array(fft_shape, np.int64)
    scorer = _PearsonScorer(a, b)
    memo: dict[tuple, float] = {}

    def r_at(s):
        key = tuple(int(v) for v in s)
        if key not in memo:
            memo[key] = scorer.r(np.asarray(s, np.int64), min_overlap)
        return memo[key]

    best_s, best_r = np.zeros(3, np.int64), -np.inf
    for p in np.asarray(peaks, np.int64):
        for wrap in range(8):
            c = np.array([p[d] - (N[d] if (wrap >> d) & 1 else 0)
                          for d in range(3)])
            s = -c  # PCM index c names shift -c (see _windowed convention)
            r = r_at(s)
            if r > best_r:
                best_r, best_s = r, s
    if not np.isfinite(best_r):
        return best_s.astype(np.float64), -1.0

    # hill-climb on the true correlation: the PCM peak can be split across
    # voxels (windowing) so the best integer shift may be a neighbor
    unit = np.concatenate([np.zeros((1, 3), np.int64),
                           np.eye(3, dtype=np.int64),
                           -np.eye(3, dtype=np.int64)], axis=0)
    for _ in range(3):
        cand = best_s[None, :] + unit
        rc = [r_at(s) for s in cand]
        i = int(np.argmax(rc))
        if i == 0:
            break
        best_s, best_r = cand[i], rc[i]

    shift = best_s.astype(np.float64)
    if subpixel:
        for ax in range(3):
            e = np.zeros(3, np.int64)
            e[ax] = 1
            fp, fm = r_at(best_s + e), r_at(best_s - e)
            denom = fm - 2.0 * best_r + fp
            if abs(denom) > 1e-12 and np.isfinite(fp) and np.isfinite(fm):
                shift[ax] += float(np.clip(0.5 * (fm - fp) / denom, -0.5, 0.5))
    return shift, float(best_r)


def stitch_crops(
    a, b, ext_a, ext_b, n_peaks: int = 5, min_overlap: float = 32.0,
    subpixel: bool = True, fade_frac: float = 0.25, device=None,
) -> tuple[np.ndarray, float]:
    """Single-pair convenience: device PCM peaks + host refinement.
    ``a``/``b`` are padded crops (numpy); ``ext_*`` their true extents.
    Runs on ``device`` (default ``cuda``)."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    a, b = np.asarray(a), np.asarray(b)
    ea = tuple(int(v) for v in np.asarray(ext_a))
    eb = tuple(int(v) for v in np.asarray(ext_b))
    peaks = pcm_peaks(torch.from_numpy(np.ascontiguousarray(a)).to(dev),
                      torch.from_numpy(np.ascontiguousarray(b)).to(dev),
                      ea, eb, n_peaks, fade_frac).cpu().numpy()
    crop_a = a[tuple(slice(0, s) for s in ea)]
    crop_b = b[tuple(slice(0, s) for s in eb)]
    return refine_peaks(crop_a, crop_b, peaks, tuple(a.shape),
                        min_overlap=min_overlap, subpixel=subpixel)


def pad_to(crop: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    out = np.zeros(shape, dtype=np.float32)
    sl = tuple(slice(0, s) for s in crop.shape)
    out[sl] = crop
    return out
