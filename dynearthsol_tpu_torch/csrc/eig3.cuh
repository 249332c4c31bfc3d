// Branch-free closed-form symmetric 3x3 eigensolver as __device__ code.
//
// Counterpart of dynearthsol_tpu/ops/eig3.py (eigvals3_c, eigh3_c); the
// plain PyTorch version is ops/eig3.py of this package.  Trigonometric
// Cardano eigenvalues, cross-product eigenvectors, degenerate cases chosen
// by selects.  acos is the A&S 4.4.46 polynomial of the JAX package, not
// acosf: one ulp in the angle moves the eigenvalues by an ulp and flips the
// Mohr-Coulomb branch of an element near the yield surface.  Constants are
// double literals rounded once to T, as JAX rounds a Python float; every
// expression keeps the plain version's operation order and the file is
// compiled without FMA contraction (ops/_build.py).  Only cos differs from
// the plain version, by the ulps of CUDA's libdevice.
#pragma once

#include "rheology2d.cuh"

namespace des {

template <typename T> __device__ __forceinline__ T dcos(T x);
template <> __device__ __forceinline__ float dcos(float x) { return cosf(x); }
template <> __device__ __forceinline__ double dcos(double x) { return cos(x); }

constexpr double EIG_TINY = 1e-30;
constexpr double PI_D = 3.14159265358979323846;

// acos(x) for x in [-1, 1] via sqrt(1-|x|) * poly(|x|) (A&S 4.4.46)
template <typename T> __device__ __forceinline__ T acos_poly(T x) {
  T ax = dabs(x);
  T p = T(-0.0012624911);
  p = p * ax + T(0.0066700901);
  p = p * ax + T(-0.0170881256);
  p = p * ax + T(0.0308918810);
  p = p * ax + T(-0.0501743046);
  p = p * ax + T(0.0889789874);
  p = p * ax + T(-0.2145988016);
  p = p * ax + T(1.5707963050);
  T y = dsqrt(dmax(T(1) - ax, T(0))) * p;
  return x < T(0) ? T(PI_D) - y : y;
}

// Eigenvalues, ascending (dsyevc3, 3x3-C/dsyevc3.c)
template <typename T>
__device__ __forceinline__ void eigvals3(T axx, T ayy, T azz, T axy, T axz,
                                         T ayz, T& l0, T& l1, T& l2) {
  T q = (axx + ayy + azz) / T(3);
  T bxx = axx - q, byy = ayy - q, bzz = azz - q;
  T p2 = (bxx * bxx + byy * byy + bzz * bzz +
          T(2) * (axy * axy + axz * axz + ayz * ayz)) /
         T(6);
  T p = dsqrt(dmax(p2, T(EIG_TINY)));
  // det(B)/2 with B = (A - qI)/p
  T ip = T(1) / p;
  T cxx = bxx * ip, cyy = byy * ip, czz = bzz * ip;
  T cxy = axy * ip, cxz = axz * ip, cyz = ayz * ip;
  T half_det = T(0.5) * (cxx * (cyy * czz - cyz * cyz) -
                         cxy * (cxy * czz - cyz * cxz) +
                         cxz * (cxy * cyz - cyy * cxz));
  T r = dclip(half_det, T(-1), T(1));
  T phi = acos_poly(r) / T(3);
  // l2 >= l1 >= l0 by the cosine ordering
  T L2 = q + T(2) * p * dcos(phi);
  T L0 = q + T(2) * p * dcos(phi + T(2.0 * PI_D / 3.0));
  T L1 = T(3) * q - L0 - L2;
  bool iso = p2 <= T(1e-28) * dmax(q * q, T(1));  // (near-)isotropic
  l0 = iso ? q : L0;
  l1 = iso ? q : L1;
  l2 = iso ? q : L2;
}

template <typename T>
__device__ __forceinline__ void cross3(T ax, T ay, T az, T bx, T by, T bz,
                                       T c[3]) {
  c[0] = ay * bz - az * by;
  c[1] = az * bx - ax * bz;
  c[2] = ax * by - ay * bx;
}

template <typename T>
__device__ __forceinline__ void normalize3(T& x, T& y, T& z) {
  T n2 = x * x + y * y + z * z;
  T inv = T(1) / dsqrt(dmax(n2, T(EIG_TINY)));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// Eigenvector of the most separated eigenvalue lam: the largest-norm cross
// product of two rows of (A - lam I)
template <typename T>
__device__ __forceinline__ void eigvec_for(T axx, T ayy, T azz, T axy, T axz,
                                           T ayz, T lam, T w[3]) {
  T c01[3], c02[3], c12[3];
  cross3(axx - lam, axy, axz, axy, ayy - lam, ayz, c01);
  cross3(axx - lam, axy, axz, axz, ayz, azz - lam, c02);
  cross3(axy, ayy - lam, ayz, axz, ayz, azz - lam, c12);
  T n01 = c01[0] * c01[0] + c01[1] * c01[1] + c01[2] * c01[2];
  T n02 = c02[0] * c02[0] + c02[1] * c02[1] + c02[2] * c02[2];
  T n12 = c12[0] * c12[0] + c12[1] * c12[1] + c12[2] * c12[2];
  bool use01 = (n01 >= n02) && (n01 >= n12);
  bool use02 = !use01 && (n02 >= n12);
  T vx = use01 ? c01[0] : (use02 ? c02[0] : c12[0]);
  T vy = use01 ? c01[1] : (use02 ? c02[1] : c12[1]);
  T vz = use01 ? c01[2] : (use02 ? c02[2] : c12[2]);
  T nmax = dmax(dmax(n01, n02), n12);
  // rank-deficient (degenerate eigenvalue): +x, fixed by the caller's
  // orthogonalization
  if (nmax <= T(EIG_TINY)) {
    vx = T(1);
    vy = T(0);
    vz = T(0);
  }
  normalize3(vx, vy, vz);
  w[0] = vx;
  w[1] = vy;
  w[2] = vz;
}

// Full eigendecomposition: ascending eigenvalues l[3] and an orthonormal
// eigenbasis v[k][comp] (dsyevv3 equivalent, branch-free)
template <typename T>
__device__ __forceinline__ void eigh3(T axx, T ayy, T azz, T axy, T axz,
                                      T ayz, T l[3], T v[3][3]) {
  eigvals3(axx, ayy, azz, axy, axz, ayz, l[0], l[1], l[2]);
  // anchor on the most separated extreme eigenvalue for stability
  bool use_l0 = (l[1] - l[0]) >= (l[2] - l[1]);
  T wa[3];
  eigvec_for(axx, ayy, azz, axy, axz, ayz, use_l0 ? l[0] : l[2], wa);

  // orthonormal complement {u, v} of wa
  T uax = -wa[1], uay = wa[0], uaz = T(0);
  normalize3(uax, uay, uaz);
  T ubx = T(0), uby = -wa[2], ubz = wa[1];
  normalize3(ubx, uby, ubz);
  bool pick = dabs(wa[2]) <= dabs(wa[0]);
  T ux = pick ? uax : ubx, uy = pick ? uay : uby, uz = pick ? uaz : ubz;
  T vv[3];
  cross3(wa[0], wa[1], wa[2], ux, uy, uz, vv);

  // middle eigenvector from the 2x2 projection of A onto span{u, v}
  T au0 = axx * ux + axy * uy + axz * uz;
  T au1 = axy * ux + ayy * uy + ayz * uz;
  T au2 = axz * ux + ayz * uy + azz * uz;
  T av0 = axx * vv[0] + axy * vv[1] + axz * vv[2];
  T av1 = axy * vv[0] + ayy * vv[1] + ayz * vv[2];
  T av2 = axz * vv[0] + ayz * vv[1] + azz * vv[2];
  T muu = ux * au0 + uy * au1 + uz * au2 - l[1];
  T mvv = vv[0] * av0 + vv[1] * av1 + vv[2] * av2 - l[1];
  T muv = ux * av0 + uy * av1 + uz * av2;
  // null vector of [[muu, muv], [muv, mvv]]: use the larger row
  bool row0 = (muu * muu + muv * muv) >= (mvv * mvv + muv * muv);
  T ct = row0 ? -muv : -mvv;
  T st = row0 ? muu : muv;
  T nrm = dsqrt(dmax(ct * ct + st * st, T(EIG_TINY)));
  bool degenerate = (ct * ct + st * st) <= T(EIG_TINY);
  ct = degenerate ? T(1) : ct / nrm;
  st = degenerate ? T(0) : st / nrm;
  T w1[3] = {ct * ux + st * vv[0], ct * uy + st * vv[1], ct * uz + st * vv[2]};
  T wb[3];
  cross3(wa[0], wa[1], wa[2], w1[0], w1[1], w1[2], wb);
  // wa belongs to l0 (if use_l0) else l2; wb to the other end
  for (int a = 0; a < 3; ++a) {
    v[0][a] = use_l0 ? wa[a] : wb[a];
    v[1][a] = w1[a];
    v[2][a] = use_l0 ? wb[a] : wa[a];
  }
}

}  // namespace des
