"""3-D transformation-model fitting: weighted least squares for translation /
rigid / affine point-correspondence fits, plus regularization by model
interpolation.

Port of ``bigstitcher_spark_tpu/ops/models.py``: the numpy float64 fits
(the solver and RANSAC's final host refit) and, for the JAX package's
``xp=jax.numpy`` fits that RANSAC runs on the device, torch versions
(``torch_fit_*``) that are the plain twins of the fits in
``csrc/fit3d.cuh`` (K21 in float32, K22 in float64). Role of
``mpicbg.models.{TranslationModel3D, RigidModel3D, AffineModel3D,
InterpolatedAffineModel3D}`` used by the reference at
AbstractRegistration.java:110-140 and Solver.java:294-369. All fits map point
sets p -> q (``q ~= M @ [p;1]``), weighted; models are 3x4 row-major affines
(utils.geometry convention), batched over leading dimensions.
"""

from __future__ import annotations

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# torch fits: the plain twins of csrc/fit3d.cuh
# ---------------------------------------------------------------------------

# model codes of csrc/fit3d.cuh
FIT_CODE = {NONE: -1, TRANSLATION: 0, RIGID: 1, AFFINE: 2, IDENTITY: 3}
_JACOBI_TOL = {torch.float32: 1e-6, torch.float64: 1e-15}
_JACOBI_SWEEPS = 30
_RIDGE = 1e-12


def fit_code(kind: str) -> int:
    try:
        return FIT_CODE[kind]
    except KeyError:
        raise ValueError(f"unknown model {kind!r}") from None


def centred_moments(p: torch.Tensor, q: torch.Tensor,
                    w: torch.Tensor | None = None):
    """(pc, qc, A, H) of point sets (..., N, 3) summed over N in order, one
    rounding each: pc = (sum w p) / sum w, A = sum w (p-pc)(p-pc)^T, H =
    sum w (p-pc)(q-qc)^T, as K21 sums its sample (with w = None, where it
    multiplies by no weight). The divisor is a tensor on the points'
    device: on the card PyTorch divides by a Python number as a
    multiplication by its rounded reciprocal, which for N = 3 is not K21's
    division."""
    n = p.shape[-2]

    def wsum(f):
        s = f(0)
        for k in range(1, n):
            s = s + f(k)
        return s

    if w is None:
        sw = torch.tensor(float(n), dtype=p.dtype, device=p.device)
        pc = wsum(lambda k: p[..., k, :]) / sw
        qc = wsum(lambda k: q[..., k, :]) / sw
        wk = lambda k, x: x
    else:
        sw = wsum(lambda k: w[..., k])[..., None]
        pc = wsum(lambda k: w[..., k, None] * p[..., k, :]) / sw
        qc = wsum(lambda k: w[..., k, None] * q[..., k, :]) / sw
        wk = lambda k, x: w[..., k, None, None] * x
    dp = p - pc[..., None, :]
    dq = q - qc[..., None, :]
    a = wsum(lambda k: wk(k, dp[..., k, :, None] * dp[..., k, None, :]))
    h = wsum(lambda k: wk(k, dp[..., k, :, None] * dq[..., k, None, :]))
    return pc, qc, a, h


def _kabsch(h: torch.Tensor) -> torch.Tensor:
    """fit3d.cuh ``kabsch``: R (..., 3, 3) from H by one-sided Jacobi, every
    batch entry stopping after its first sweep without a rotation."""
    tol = _JACOBI_TOL[h.dtype]
    a = [[h[..., i, j] for j in range(3)] for i in range(3)]
    one, zero = torch.ones_like(a[0][0]), torch.zeros_like(a[0][0])
    v = [[one if i == j else zero for j in range(3)] for i in range(3)]
    active = torch.ones_like(a[0][0], dtype=torch.bool)
    for _ in range(_JACOBI_SWEEPS):
        rotated = torch.zeros_like(active)
        for p, q in ((0, 1), (0, 2), (1, 2)):
            alpha = (a[0][p] * a[0][p] + a[1][p] * a[1][p]) + a[2][p] * a[2][p]
            beta = (a[0][q] * a[0][q] + a[1][q] * a[1][q]) + a[2][q] * a[2][q]
            gamma = (a[0][p] * a[0][q] + a[1][p] * a[1][q]) + a[2][p] * a[2][q]
            do = active & (gamma.abs() > tol * torch.sqrt(alpha * beta))
            rotated = rotated | do
            g = torch.where(do, gamma, one)
            zeta = (beta - alpha) / (2.0 * g)
            t = torch.copysign(one, zeta) / (zeta.abs()
                                             + torch.sqrt(1.0 + zeta * zeta))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = c * t
            for m in (a, v):
                for i in range(3):
                    mp, mq = m[i][p], m[i][q]
                    m[i][p] = torch.where(do, c * mp - s * mq, mp)
                    m[i][q] = torch.where(do, s * mp + c * mq, mq)
        active = rotated
        if not bool(active.any()):
            break
    sig = torch.stack([torch.sqrt((a[0][k] * a[0][k] + a[1][k] * a[1][k])
                                  + a[2][k] * a[2][k]) for k in range(3)], -1)
    order = torch.sort(sig, dim=-1, descending=True, stable=True).indices
    am = torch.stack([torch.stack(row, -1) for row in a], -2)
    vm = torch.stack([torch.stack(row, -1) for row in v], -2)
    gidx = order[..., None, :].expand(am.shape)
    ao = torch.gather(am, -1, gidx)
    vs = torch.gather(vm, -1, gidx)
    so = torch.gather(sig, -1, order)
    u = [[None] * 3 for _ in range(3)]
    for k in range(2):
        s = so[..., k]
        for i in range(3):
            u[i][k] = torch.where(s > 0, ao[..., i, k] / torch.where(
                s > 0, s, one), zero)
    u[0][2] = u[1][0] * u[2][1] - u[2][0] * u[1][1]
    u[1][2] = u[2][0] * u[0][1] - u[0][0] * u[2][1]
    u[2][2] = u[0][0] * u[1][1] - u[1][0] * u[0][1]
    vv = [[vs[..., i, k] for k in range(3)] for i in range(3)]
    d = ((vv[0][0] * (vv[1][1] * vv[2][2] - vv[1][2] * vv[2][1])
          - vv[0][1] * (vv[1][0] * vv[2][2] - vv[1][2] * vv[2][0]))
         + vv[0][2] * (vv[1][0] * vv[2][1] - vv[1][1] * vv[2][0]))
    r = [[(vv[i][0] * u[j][0] + vv[i][1] * u[j][1]) + vv[i][2] * (d * u[j][2])
          for j in range(3)] for i in range(3)]
    return torch.stack([torch.stack(row, -1) for row in r], -2)


def _affine_linear(a_in: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """fit3d.cuh ``affine_linear``: L = X^T with (A + 1e-12 I) X = H by
    Gaussian elimination with partial pivoting (the first largest
    |pivot|)."""
    a = [[a_in[..., i, j] + _RIDGE if i == j else a_in[..., i, j]
          for j in range(3)] for i in range(3)]
    b = [[h[..., i, j] for j in range(3)] for i in range(3)]
    for c in range(3):
        piv = torch.full_like(a[0][0], c, dtype=torch.int64)
        best = a[c][c].abs()
        for r in range(c + 1, 3):
            better = a[r][c].abs() > best
            best = torch.where(better, a[r][c].abs(), best)
            piv = torch.where(better, torch.full_like(piv, r), piv)
        for r in range(c + 1, 3):
            sw = piv == r
            for m in (a, b):
                for col in range(3):
                    top = m[c][col]
                    m[c][col] = torch.where(sw, m[r][col], top)
                    m[r][col] = torch.where(sw, top, m[r][col])
        for r in range(c + 1, 3):
            f = a[r][c] / a[c][c]
            for col in range(c + 1, 3):
                a[r][col] = a[r][col] - f * a[c][col]
            for j in range(3):
                b[r][j] = b[r][j] - f * b[c][j]
    x = [[None] * 3 for _ in range(3)]
    for c in (2, 1, 0):
        for j in range(3):
            s = b[c][j]
            for col in range(c + 1, 3):
                s = s - a[c][col] * x[col][j]
            x[c][j] = s / a[c][c]
    return torch.stack([torch.stack([x[j][i] for j in range(3)], -1)
                        for i in range(3)], -2)


def fit_centred(kind: str, pc, qc, a, h) -> torch.Tensor:
    """fit3d.cuh ``fit_centred``: the (..., 3, 4) model of ``kind`` from
    centred moments (:func:`centred_moments`)."""
    code = fit_code(kind)
    shape = pc.shape[:-1]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(*shape, 3, 3)
    if code == FIT_CODE[TRANSLATION]:
        return torch.cat([eye, (qc - pc)[..., None]], -1)
    if code not in (FIT_CODE[RIGID], FIT_CODE[AFFINE]):
        return torch.cat([eye, torch.zeros_like(pc)[..., None]], -1)
    lin = _kabsch(h) if code == FIT_CODE[RIGID] else _affine_linear(a, h)
    t = qc - ((lin[..., 0] * pc[..., 0, None] + lin[..., 1] * pc[..., 1, None])
              + lin[..., 2] * pc[..., 2, None])
    return torch.cat([lin, t[..., None]], -1)


def fit_interpolated_centred(kind: str, reg_kind: str, lam: float,
                             pc, qc, a, h) -> torch.Tensor:
    """fit3d.cuh ``fit_interpolated``: (1 - lam) fit(kind) + lam
    fit(reg_kind), or fit(kind) alone for NONE or lam == 0."""
    m = fit_centred(kind, pc, qc, a, h)
    if reg_kind == NONE or lam == 0.0:
        return m
    return (1.0 - lam) * m + lam * fit_centred(reg_kind, pc, qc, a, h)


def torch_fit_model(kind: str, p, q, w=None):
    """The model of ``kind`` fitted to torch point sets (..., N, 3), weighted,
    batched over leading dims, in their own dtype: t = weighted mean(q) -
    weighted mean(p) (TRANSLATION), weighted Kabsch by one-sided Jacobi
    (RIGID), the centred normal equations + 1e-12 ridge (AFFINE)."""
    return fit_centred(kind, *centred_moments(p, q, w))


def torch_fit_interpolated(kind: str, reg_kind: str, lam: float, p, q,
                           w=None):
    """InterpolatedAffineModel3D semantics on torch point sets."""
    return fit_interpolated_centred(kind, reg_kind, lam,
                                    *centred_moments(p, q, w))
