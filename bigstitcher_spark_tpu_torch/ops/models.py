"""3-D transformation-model fitting: weighted least squares for translation /
rigid / affine point-correspondence fits, plus regularization by model
interpolation.

Port of ``bigstitcher_spark_tpu/ops/models.py`` (numpy only; the JAX
package's ``xp=jax.numpy`` generality is not carried over). Role of
``mpicbg.models.{TranslationModel3D, RigidModel3D, AffineModel3D,
InterpolatedAffineModel3D}`` used by the reference at
AbstractRegistration.java:110-140 and Solver.java:294-369. All fits map point
sets p -> q (``q ~= M @ [p;1]``), weighted; models are 3x4 row-major affines
(utils.geometry convention), batched over leading dimensions.
"""

from __future__ import annotations

import numpy as np

TRANSLATION = "TRANSLATION"
RIGID = "RIGID"
AFFINE = "AFFINE"
IDENTITY = "IDENTITY"
NONE = "NONE"

MIN_POINTS = {TRANSLATION: 1, RIGID: 3, AFFINE: 4, IDENTITY: 0}


def _prepare(p, q, w):
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    if w is None:
        w = np.ones(p.shape[:-1], dtype=np.float64)
    return p, q, w


def _wmean(x, w):
    return (x * w[..., None]).sum(-2) / w.sum(-1)[..., None]


def fit_translation(p, q, w=None):
    """t = weighted mean(q - p); batched over leading dims."""
    p, q, w = _prepare(p, q, w)
    t = _wmean(q - p, w)
    eye = np.broadcast_to(np.eye(3), p.shape[:-2] + (3, 3))
    return np.concatenate([eye, t[..., :, None]], axis=-1)


def fit_rigid(p, q, w=None):
    """Weighted Kabsch: R = V diag(1,1,det) U^T from the cross-covariance SVD;
    batched over leading dims."""
    p, q, w = _prepare(p, q, w)
    pc = _wmean(p, w)
    qc = _wmean(q, w)
    pp = p - pc[..., None, :]
    qq = q - qc[..., None, :]
    # H = sum_i w_i p_i q_i^T
    h = np.einsum("...n,...ni,...nj->...ij", w, pp, qq)
    u, _, vt = np.linalg.svd(h)
    d = np.linalg.det(np.swapaxes(vt, -1, -2) @ np.swapaxes(u, -1, -2))
    sign = np.stack([np.ones_like(d), np.ones_like(d), d], axis=-1)
    r = np.swapaxes(vt, -1, -2) @ (sign[..., :, None] * np.swapaxes(u, -1, -2))
    t = qc - np.einsum("...ij,...j->...i", r, pc)
    return np.concatenate([r, t[..., :, None]], axis=-1)


def fit_affine(p, q, w=None, eps=1e-12):
    """Weighted linear least squares for the full 3x4 affine (normal
    equations over homogeneous p; batched over leading dims)."""
    p, q, w = _prepare(p, q, w)
    ones = np.ones(p.shape[:-1] + (1,))
    ph = np.concatenate([p, ones], axis=-1)  # (..., N, 4)
    a = np.einsum("...n,...ni,...nj->...ij", w, ph, ph)
    b = np.einsum("...n,...ni,...nk->...ik", w, ph, q)  # (..., 4, 3)
    a = a + eps * np.eye(4)
    sol = np.linalg.solve(a, b)  # (..., 4, 3)
    return np.swapaxes(sol, -1, -2)


def fit_model(kind: str, p, q, w=None):
    if kind == TRANSLATION:
        return fit_translation(p, q, w)
    if kind == RIGID:
        return fit_rigid(p, q, w)
    if kind == AFFINE:
        return fit_affine(p, q, w)
    if kind == IDENTITY:
        p = np.asarray(p)
        eye = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=-1)
        return np.broadcast_to(eye, p.shape[:-2] + (3, 4))
    raise ValueError(f"unknown model {kind!r}")


def fit_interpolated(kind: str, reg_kind: str, lam: float, p, q, w=None):
    """InterpolatedAffineModel3D semantics: fit both models to the same
    matches, then linearly interpolate the affine entries
    (m = (1-λ)·tm + λ·rm; AbstractRegistration.java:134-140)."""
    m = fit_model(kind, p, q, w)
    if reg_kind == NONE or lam == 0.0:
        return m
    r = fit_model(reg_kind, p, q, w)
    return (1.0 - lam) * m + lam * r


def model_error(m, p, q, w=None):
    """Weighted RMS distance ||M(p) - q|| (mpicbg Tile cost)."""
    p = np.asarray(p)
    q = np.asarray(q)
    pred = np.einsum("...ij,...nj->...ni", m[..., :, :3], p) + m[..., None, :, 3]
    d = np.sqrt(((pred - q) ** 2).sum(-1))
    if w is None:
        return d.mean(-1)
    return (d * w).sum(-1) / w.sum(-1)
