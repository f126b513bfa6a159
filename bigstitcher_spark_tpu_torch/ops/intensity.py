"""Intensity correction device programs: the line-fit RANSAC (K23) and the
global coefficient solve.

Port of ``bigstitcher_spark_tpu/ops/intensity.py``. Every view carries a
coarse coefficient grid (default 8x8x8 cells). Between two overlapping
views, co-located intensity samples are collected per cell pair, and a
1-D linear model i_B ~= a * i_A + b is fitted to each cell pair by RANSAC;
the global solve then finds per-cell (scale, offset) maps that minimise the
disagreement over all matched pairs, regularised toward identity.

=========================  =======================  ==========================
wrapper                    kernel (csrc/)           JAX program
=========================  =======================  ==========================
:func:`linefit_ransac`     ``intensity.cu`` (K23)   ``_linefit_ransac_kernel``
the CG of the solve        ``cg.cu`` (K24, K25)     ``ops/solve.py _build_cg_fn``
=========================  =======================  ==========================

The hypotheses (two sample indices each, drawn with replacement over the
padded length, as ``jax.random.randint`` draws them) come from a
``torch.Generator`` (:func:`draw_hypotheses`) and are an input of both
K23 and its twin :func:`linefit_ransac_plain`, so the two see the same
draws. torch cannot reproduce JAX's threefry stream: the tests compare
with the JAX package on draws computed by JAX and fed to the twin.

A wrapper takes its plain version only because its tensors lie on the
CPU; on CUDA tensors it launches its kernel or raises. K23 counts its
launches in ``linefit_ransac.launches``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _cuda
from .fusion import _require, _stream

# K23 keeps one pair's samples in shared memory: 12 bytes a sample
MAX_SAMPLES = 16384
# pairs the plain twin scores at once (each holds an (I, N) error matrix)
_PLAIN_PAIRS = 8


class LineFit(NamedTuple):
    """Per pair p: the refitted line ``a``, ``b`` (float32), the best
    hypothesis' inlier ``count`` and index ``best`` (int32), and every
    hypothesis' inlier ``counts`` (P, I) int32."""

    a: torch.Tensor
    b: torch.Tensor
    count: torch.Tensor
    best: torch.Tensor
    counts: torch.Tensor


def sample_bucket(n_max: int) -> int:
    """The padded sample count of a batch: max(8, next power of two of the
    largest count, at least 2), as the JAX package buckets it."""
    return max(8, 1 << int(np.ceil(np.log2(max(int(n_max), 2)))))


def draw_hypotheses(seed: int, P: int, N: int, iterations: int,
                    device) -> torch.Tensor:
    """(P, iterations, 2) int32 sample indices, uniform with replacement
    over [0, N) (the padding included, as JAX draws them), on ``device``.
    Drawn by a CPU ``torch.Generator`` seeded with ``seed`` whatever the
    device, so a run on the card and one on the CPU score the same
    hypotheses."""
    g = torch.Generator()
    g.manual_seed(int(seed))
    idx = torch.randint(0, int(N), (int(P), int(iterations), 2), generator=g,
                        dtype=torch.int64)
    return idx.to(torch.int32).to(torch.device(device))


def _hypothesis_lines(x, y, hyp):
    """Each hypothesis' slope and intercept, (P, I) float32: a = dy / dx
    (1 where |dx| <= 1e-6), b = y0 - a x0, every op rounded on its own."""
    h = hyp.long()
    x0, x1 = torch.gather(x, 1, h[..., 0]), torch.gather(x, 1, h[..., 1])
    y0, y1 = torch.gather(y, 1, h[..., 0]), torch.gather(y, 1, h[..., 1])
    dx = x1 - x0
    big = dx.abs() > 1e-6
    a = torch.where(big, (y1 - y0) / torch.where(big, dx, 1.0), 1.0)
    b = y0 - a * x0
    return a, b


def _inliers(x, y, valid, a, b, eps):
    """(..., N) inlier mask |y - (a x + b)| < eps of valid samples."""
    err = (y - (a[..., None] * x + b[..., None])).abs()
    return (err < eps) & (valid > 0)


def linefit_ransac_plain(x, y, valid, hyp, epsilon) -> LineFit:
    """Plain-torch ``_linefit_ransac_kernel`` on given hypotheses: score
    every hypothesis (inlier counts), take the first argmax, then the
    float32 weighted least-squares refit on its inliers.

    x, y, valid (P, N) float32; hyp (P, I, 2) int32."""
    P = x.shape[0]
    eps = torch.tensor(float(np.float32(epsilon)), dtype=torch.float32,
                       device=x.device)
    a_h, b_h = _hypothesis_lines(x, y, hyp)
    counts = torch.empty(a_h.shape, dtype=torch.int32, device=x.device)
    for p0 in range(0, P, _PLAIN_PAIRS):
        sl = slice(p0, p0 + _PLAIN_PAIRS)
        inl = _inliers(x[sl, None], y[sl, None], valid[sl, None], a_h[sl],
                       b_h[sl], eps)
        counts[sl] = inl.sum(-1).to(torch.int32)
    best = torch.argmax(counts, dim=1)  # the first maximum
    ab = torch.gather(a_h, 1, best[:, None])[:, 0]
    bb = torch.gather(b_h, 1, best[:, None])[:, 0]
    w = _inliers(x, y, valid, ab, bb, eps).to(torch.float32)
    sw = torch.clamp(w.sum(1), min=1e-6)
    mx = (w * x).sum(1) / sw
    my = (w * y).sum(1) / sw
    dxm = x - mx[:, None]
    cov = (w * dxm * (y - my[:, None])).sum(1)
    var = torch.clamp((w * dxm ** 2).sum(1), min=1e-12)
    a_f = cov / var
    b_f = my - a_f * mx
    return LineFit(a_f, b_f, torch.gather(counts, 1, best[:, None])[:, 0],
                   best.to(torch.int32), counts)


def linefit_ransac(x, y, valid, hyp, epsilon) -> LineFit:
    """K23 (``csrc/intensity.cu``) on CUDA, the plain version on the CPU.

    x, y, valid (P, N) float32 with N <= :data:`MAX_SAMPLES`; hyp (P, I, 2)
    int32 indices in [0, N). Returns a :class:`LineFit`."""
    if x.device.type == "cpu":
        return linefit_ransac_plain(x, y, valid, hyp, epsilon)
    dev = x.device
    P, N = (int(s) for s in x.shape)
    for name, t in (("x", x), ("y", y), ("valid", valid)):
        _require(t, name, dev, (torch.float32,), (P, N))
    if hyp.dim() != 3 or hyp.shape[0] != P or hyp.shape[2] != 2:
        raise ValueError(f"hyp has shape {tuple(hyp.shape)}, expected "
                         f"({P}, I, 2)")
    _require(hyp, "hyp", dev, (torch.int32,))
    if not 1 <= N <= MAX_SAMPLES:
        raise ValueError(f"{N} samples a pair: K23 holds at most "
                         f"{MAX_SAMPLES} in shared memory")
    I = int(hyp.shape[1])
    if P == 0 or I == 0:
        raise ValueError("linefit_ransac needs at least one pair and one "
                         "hypothesis")
    i32 = dict(dtype=torch.int32, device=dev)
    counts = torch.empty((P, I), **i32)
    best = torch.empty(P, **i32)
    count = torch.empty(P, **i32)
    a = torch.empty(P, dtype=torch.float32, device=dev)
    b = torch.empty(P, dtype=torch.float32, device=dev)
    lib = _cuda.load("intensity")
    ret = lib.bst_linefit_ransac(
        x.data_ptr(), y.data_ptr(), valid.data_ptr(), P, N, hyp.data_ptr(),
        I, float(np.float32(epsilon)), counts.data_ptr(), best.data_ptr(),
        count.data_ptr(), a.data_ptr(), b.data_ptr(), _stream(dev))
    _cuda.check(lib, ret, "linefit_ransac")
    linefit_ransac.launches += 1
    return LineFit(a, b, count, best, counts)


linefit_ransac.launches = 0

KERNEL_WRAPPERS = {"linefit_ransac": linefit_ransac}


# --------------------------------------------------------------------------
# pairwise matching
# --------------------------------------------------------------------------


def pack_samples(samples_a, samples_b, device):
    """Pad a list of sample sets to one (P, N) batch on ``device``: x, y,
    valid float32, N = :func:`sample_bucket` of the largest set."""
    P = len(samples_a)
    n = sample_bucket(max(len(s) for s in samples_a))
    x = np.zeros((P, n), np.float32)
    y = np.zeros((P, n), np.float32)
    v = np.zeros((P, n), np.float32)
    for i, (sa, sb) in enumerate(zip(samples_a, samples_b)):
        m = len(sa)
        x[i, :m] = sa
        y[i, :m] = sb
        v[i, :m] = 1.0
    return tuple(torch.from_numpy(a).to(device) for a in (x, y, v))


def finish_cells_ransac(fit: LineFit, samples_a, min_inliers: int = 10
                        ) -> list[tuple[float, float, int] | None]:
    """Fetch K23's fits of ``samples_a``'s sets: (a, b, n) per set, or None
    where the consensus holds fewer than ``min_inliers`` samples or the set
    fewer than 2."""
    a, b, cnt = (t.cpu().numpy() for t in (fit.a, fit.b, fit.count))
    out = []
    for i, s in enumerate(samples_a):
        if cnt[i] >= min_inliers and len(s) >= 2:
            out.append((float(a[i]), float(b[i]), int(cnt[i])))
        else:
            out.append(None)
    return out


def match_cells_ransac(samples_a, samples_b, epsilon: float = 0.1,
                       min_inliers: int = 10, iterations: int = 1000,
                       seed: int = 5, device="cpu"
                       ) -> list[tuple[float, float, int] | None]:
    """RANSAC line fits y ~= a x + b for a list of cell-pair sample sets,
    one K23 launch for the whole list on ``device`` (its twin on the CPU;
    IntensityCorrection.matchRansac role; ``epsilon`` is relative to the
    intensity range)."""
    if not len(samples_a):
        return []
    x, y, v = pack_samples(samples_a, samples_b, device)
    hyp = draw_hypotheses(seed, x.shape[0], x.shape[1], iterations, x.device)
    return finish_cells_ransac(linefit_ransac(x, y, v, hyp, epsilon),
                               samples_a, min_inliers)


def match_cells_histogram(samples_a, samples_b, min_samples: int = 10
                          ) -> list[tuple[float, float, int] | None]:
    """Histogram alignment (IntensityCorrection.matchHistograms role): the
    linear map aligning the two sample distributions by their 10 % and
    90 % quantiles. Host numpy, as in the JAX package."""
    out = []
    for sa, sb in zip(samples_a, samples_b):
        if len(sa) < min_samples:
            out.append(None)
            continue
        qa = np.quantile(sa, [0.1, 0.9])
        qb = np.quantile(sb, [0.1, 0.9])
        if qa[1] - qa[0] < 1e-9:
            out.append(None)
            continue
        a = (qb[1] - qb[0]) / (qa[1] - qa[0])
        b = qb[0] - a * qa[0]
        out.append((float(a), float(b), len(sa)))
    return out


def match_stats(x, y) -> tuple[float, ...]:
    """Sufficient statistics (n, Sx, Sy, Sxx, Syy, Sxy) of a sample pair set."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    return (float(len(x)), float(x.sum()), float(y.sum()),
            float((x * x).sum()), float((y * y).sum()), float((x * y).sum()))


# --------------------------------------------------------------------------
# global solve
# --------------------------------------------------------------------------


def intensity_system(n_cells: int, matches, lam: float = 0.1,
                     smooth_pairs=None, smooth_weight: float = 0.5):
    """The quadratic form's pieces beside the match rows, as the JAX
    package assembles them: ``rows`` (M, 8) float64 ``(ca, cb, n, Sx, Sy,
    Sxx, Syy, Sxy)``; per unknown the identity regulariser ``diag`` and
    ``rhs`` (2C,), each cell's weighted by its own data moments (lam *
    max(Sxx, 1) on the scale, lam * max(n, 1) on the offset); the
    flattened smoothness pairs ``sidx`` (S, 2) over unknowns (scale rows
    tie 2c, offset rows 2c + 1) and their weights ``sw`` (S,), scaled by
    the mean data moments so the term is scale-free."""
    smooth_arr = (np.asarray(smooth_pairs, int).reshape(-1, 2)
                  if smooth_pairs is not None and len(smooth_pairs)
                  else np.zeros((0, 2), int))
    cell_xx = np.full(n_cells, 1e-12)
    cell_n = np.full(n_cells, 1e-12)
    rows = (np.asarray(matches, np.float64).reshape(-1, 8)
            if len(matches) else np.zeros((0, 8)))
    ca_all = rows[:, 0].astype(int)
    cb_all = rows[:, 1].astype(int)
    np.add.at(cell_xx, ca_all, rows[:, 5])
    np.add.at(cell_n, ca_all, rows[:, 2])
    np.add.at(cell_xx, cb_all, rows[:, 6])
    np.add.at(cell_n, cb_all, rows[:, 2])
    lam_eff = max(lam, 1e-6)  # unmatched cells must still solve to identity
    wxx = wn = 0.0
    if len(smooth_arr):
        wxx = smooth_weight * max(float(np.mean(cell_xx[cell_xx > 1e-6]))
                                  if (cell_xx > 1e-6).any() else 1.0, 1.0)
        wn = smooth_weight * max(float(np.mean(cell_n[cell_n > 1e-6]))
                                 if (cell_n > 1e-6).any() else 1.0, 1.0)
    diag = np.zeros(2 * n_cells)
    diag[0::2] = lam_eff * np.maximum(cell_xx, 1.0)
    diag[1::2] = lam_eff * np.maximum(cell_n, 1.0)
    rhs = np.zeros(2 * n_cells)
    rhs[0::2] = diag[0::2]
    if len(smooth_arr):
        sidx = np.concatenate([2 * smooth_arr, 2 * smooth_arr + 1])
        sw = np.concatenate([np.full(len(smooth_arr), wxx),
                             np.full(len(smooth_arr), wn)])
    else:
        sidx = np.zeros((0, 2), int)
        sw = np.zeros(0)
    return rows, diag, rhs, sidx, sw


def _solve_dense(n_cells, rows, diag, rhs, sidx, sw) -> np.ndarray:
    """The dense (2C, 2C) normal equations solved directly (the JAX
    package's numpy reference path)."""
    A = np.diag(diag.copy())
    for (i, j), w in zip(sidx, sw):
        A[i, i] += w
        A[j, j] += w
        A[i, j] -= w
        A[j, i] -= w
    for ca, cb, n, sx, sy, sxx, syy, sxy in rows:
        ia, ib = 2 * int(ca), 2 * int(cb)
        A[ia, ia] += sxx
        A[ia, ia + 1] += sx
        A[ia, ib] -= sxy
        A[ia, ib + 1] -= sx
        A[ia + 1, ia] += sx
        A[ia + 1, ia + 1] += n
        A[ia + 1, ib] -= sy
        A[ia + 1, ib + 1] -= n
        A[ib, ia] -= sxy
        A[ib, ia + 1] -= sy
        A[ib, ib] += syy
        A[ib, ib + 1] += sy
        A[ib + 1, ia] -= sx
        A[ib + 1, ia + 1] -= n
        A[ib + 1, ib] += sy
        A[ib + 1, ib + 1] += n
    return np.linalg.solve(A, rhs).reshape(n_cells, 2)


def solve_intensity_coefficients(
    n_cells: int,
    matches,
    lam: float = 0.1,
    smooth_pairs=None,
    smooth_weight: float = 0.5,
    backend: str | None = None,
    on_device_solution=None,
    device=None,
    devices=None,
) -> np.ndarray:
    """Global least squares over the coefficient graph; (n_cells, 2)
    [scale, offset].

    Unknowns: per cell c a map f_c(i) = s_c i + o_c. Each match (ca, cb,
    n, Sx, Sy, Sxx, Syy, Sxy) contributes the residuals f_ca(x_k) -
    f_cb(y_k) of its samples, through their sufficient statistics
    (:func:`match_stats`); :func:`intensity_system` adds the identity
    regulariser and the smoothness term. ``backend`` (through
    :func:`.solve.resolve_backend`): ``"device"`` runs the float64 CG on
    ``device`` (K24/K25 on the card, their twins on the CPU; default
    ``cuda``), ``"numpy"`` solves the dense system on the host. With no
    match the dense path runs, as in the JAX package. Above
    ``BST_SOLVE_SHARD`` match rows the device CG shards its rows over the
    solve mesh (``devices``, repeats allowed, else every card of the host;
    :func:`.solve.solve_layout`) when it has more than one device.
    ``on_device_solution``: called with the device solution vector (2C,)
    before the host copy (device backend only; the first mesh device's
    when sharded)."""
    from . import solve as S

    rows, diag, rhs, sidx, sw = intensity_system(
        n_cells, matches, lam, smooth_pairs, smooth_weight)
    if S.resolve_backend(backend) == "device" and len(rows):
        mesh = S.solve_mesh(device, devices)
        n_shards = S.solve_layout(len(rows), mesh)
        sol = S.solve_intensity_device(n_cells, rows, diag, rhs, sidx, sw,
                                       mesh[0], n_shards=n_shards,
                                       mesh=mesh).x
        if on_device_solution is not None:
            on_device_solution(sol)
        return sol.cpu().numpy().reshape(n_cells, 2)
    return _solve_dense(n_cells, rows, diag, rhs, sidx, sw)
