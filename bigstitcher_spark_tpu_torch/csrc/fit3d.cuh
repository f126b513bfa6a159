// 3-D point-correspondence fits from centred moments, for float (K21's
// hypotheses) and double (K22's consensus refits): the device half of
// ops/models.py (the JAX package's fit_translation / fit_rigid /
// fit_affine / fit_interpolated, ops/models.py:34-106 there). The inputs
// are sw = sum w, the centroids pc, qc, A = sum w (p-pc)(p-pc)^T and
// H = sum w (p-pc)(q-qc)^T; a model is 12 values, 3x4 row-major.
//
//   TRANSLATION  t = qc - pc
//   RIGID        weighted Kabsch from H (one-sided Jacobi, as K12's
//                fit_rigid in solve.cu), t = qc - R pc
//   AFFINE       (A + 1e-12 I) X = H by Gaussian elimination with partial
//                pivoting (the first largest |pivot|), L = X^T, t = qc - L pc
//   IDENTITY     I, 0
//
// The JAX package solves AFFINE's normal equations over homogeneous
// coordinates about the world origin; the centred system is the same least
// squares problem in exact arithmetic and far better conditioned in
// float32. Every float op is rounded on its own (-fmad=false) and the
// plain twins (ops/models.py fit_from_moments) repeat the same operations
// in the same order.
#pragma once

#include <math.h>

namespace bst {

enum FitKind : int { FIT_NONE = -1, FIT_TRANSLATION = 0, FIT_RIGID = 1,
                     FIT_AFFINE = 2, FIT_IDENTITY = 3 };

template <typename T> struct FitConst;
template <> struct FitConst<float> {
  static constexpr float jacobi_tol = 1e-6f;
  static constexpr float ridge = 1e-12f;
};
template <> struct FitConst<double> {
  static constexpr double jacobi_tol = 1e-15;
  static constexpr double ridge = 1e-12;
};
constexpr int kJacobiSweeps = 30;

template <typename T>
__device__ __forceinline__ void fit_identity(T* m) {
#pragma unroll
  for (int i = 0; i < 12; ++i) m[i] = (i % 5 == 0) ? T(1) : T(0);
}

// R (3x3 row-major) by Kabsch from H = U S V^T: one-sided Jacobi on the
// columns of H (H V = U S), singular pairs sorted by descending S, u3 =
// u1 x u2, R = V diag(1, 1, det V) U^T (see K12's fit_rigid).
template <typename T>
__device__ void kabsch(const T h[3][3], T r[3][3]) {
  T a[3][3], v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[i][j] = h[i][j];
      v[i][j] = (i == j) ? T(1) : T(0);
    }
  for (int sweep = 0; sweep < kJacobiSweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int pair = 0; pair < 3; ++pair) {
      const int p = pair == 2 ? 1 : 0, q = pair == 0 ? 1 : 2;
      T alpha = (a[0][p] * a[0][p] + a[1][p] * a[1][p]) + a[2][p] * a[2][p];
      T beta = (a[0][q] * a[0][q] + a[1][q] * a[1][q]) + a[2][q] * a[2][q];
      T gamma = (a[0][p] * a[0][q] + a[1][p] * a[1][q]) + a[2][p] * a[2][q];
      if (!(fabs(gamma) > FitConst<T>::jacobi_tol * sqrt(alpha * beta)))
        continue;
      rotated = true;
      const T zeta = (beta - alpha) / (T(2) * gamma);
      const T t = copysign(T(1), zeta) / (fabs(zeta) + sqrt(T(1) + zeta * zeta));
      const T c = T(1) / sqrt(T(1) + t * t);
      const T s = c * t;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const T ap = a[i][p], aq = a[i][q];
        a[i][p] = c * ap - s * aq;
        a[i][q] = s * ap + c * aq;
        const T vp = v[i][p], vq = v[i][q];
        v[i][p] = c * vp - s * vq;
        v[i][q] = s * vp + c * vq;
      }
    }
    if (!rotated) break;
  }
  T sig[3];
  int ord[3] = {0, 1, 2};
#pragma unroll
  for (int k = 0; k < 3; ++k)
    sig[k] = sqrt((a[0][k] * a[0][k] + a[1][k] * a[1][k]) + a[2][k] * a[2][k]);
  // descending, stable
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && sig[ord[j]] > sig[ord[j - 1]]; --j) {
      const int t = ord[j];
      ord[j] = ord[j - 1];
      ord[j - 1] = t;
    }
  T u[3][3], vs[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < 3; ++i) vs[i][k] = v[i][ord[k]];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const T s = sig[ord[k]];
#pragma unroll
    for (int i = 0; i < 3; ++i) u[i][k] = s > T(0) ? a[i][ord[k]] / s : T(0);
  }
  u[0][2] = u[1][0] * u[2][1] - u[2][0] * u[1][1];
  u[1][2] = u[2][0] * u[0][1] - u[0][0] * u[2][1];
  u[2][2] = u[0][0] * u[1][1] - u[1][0] * u[0][1];
  const T d = (vs[0][0] * (vs[1][1] * vs[2][2] - vs[1][2] * vs[2][1]) -
               vs[0][1] * (vs[1][0] * vs[2][2] - vs[1][2] * vs[2][0])) +
              vs[0][2] * (vs[1][0] * vs[2][1] - vs[1][1] * vs[2][0]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      r[i][j] = (vs[i][0] * u[j][0] + vs[i][1] * u[j][1]) + vs[i][2] * (d * u[j][2]);
}

// (A + ridge I) X = H, X (3x3); L = X^T
template <typename T>
__device__ void affine_linear(const T A[3][3], const T H[3][3], T l[3][3]) {
  T a[3][3], b[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[i][j] = (i == j) ? A[i][j] + FitConst<T>::ridge : A[i][j];
      b[i][j] = H[i][j];
    }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    int p = c;
#pragma unroll
    for (int r = c + 1; r < 3; ++r)
      if (fabs(a[r][c]) > fabs(a[p][c])) p = r;
    if (p != c) {
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        T t = a[c][l]; a[c][l] = a[p][l]; a[p][l] = t;
        t = b[c][l]; b[c][l] = b[p][l]; b[p][l] = t;
      }
    }
#pragma unroll
    for (int r = c + 1; r < 3; ++r) {
      const T f = a[r][c] / a[c][c];
#pragma unroll
      for (int l = c + 1; l < 3; ++l) a[r][l] = a[r][l] - f * a[c][l];
#pragma unroll
      for (int j = 0; j < 3; ++j) b[r][j] = b[r][j] - f * b[c][j];
    }
  }
  T x[3][3];
#pragma unroll
  for (int c = 2; c >= 0; --c) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T s = b[c][j];
#pragma unroll
      for (int l = c + 1; l < 3; ++l) s = s - a[c][l] * x[l][j];
      x[c][j] = s / a[c][c];
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) l[i][j] = x[j][i];
}

template <typename T>
__device__ void fit_centred(int kind, const T pc[3], const T qc[3],
                            const T A[3][3], const T H[3][3], T* m) {
  fit_identity(m);
  if (kind == FIT_TRANSLATION) {
#pragma unroll
    for (int j = 0; j < 3; ++j) m[4 * j + 3] = qc[j] - pc[j];
    return;
  }
  if (kind != FIT_RIGID && kind != FIT_AFFINE) return;
  T l[3][3];
  if (kind == FIT_RIGID)
    kabsch(H, l);
  else
    affine_linear(A, H, l);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) m[4 * i + j] = l[i][j];
    m[4 * i + 3] = qc[i] - ((l[i][0] * pc[0] + l[i][1] * pc[1]) + l[i][2] * pc[2]);
  }
}

// m = (1 - lam) fit(kind) + lam fit(reg) (fit(kind) alone for reg NONE or
// lam == 0)
template <typename T>
__device__ void fit_interpolated(int kind, int reg, T lam, const T pc[3],
                                 const T qc[3], const T A[3][3],
                                 const T H[3][3], T* m) {
  fit_centred(kind, pc, qc, A, H, m);
  if (reg == FIT_NONE || lam == T(0)) return;
  T r[12];
  fit_centred(reg, pc, qc, A, H, r);
#pragma unroll
  for (int i = 0; i < 12; ++i) m[i] = (T(1) - lam) * m[i] + lam * r[i];
}

}  // namespace bst
