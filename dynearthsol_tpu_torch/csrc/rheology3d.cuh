// 3D constitutive cores as __device__ functions.
//
// Counterparts of dynearthsol_tpu/ops/rheology.py (elastic3_c, maxwell3_c,
// viscous3_c, elasto_plastic3_c); the plain PyTorch versions are in
// ops/rheology.py of this package.  Reference: rheology.cxx:235-457.
// Tensors are 6 components (xx, yy, zz, xy, xz, yz).  The moduli are the
// run-dtype K and G; every combination of them is formed in T, as the JAX
// package's 3D kernel forms them from its f32 constants.  Operation order
// is the plain version's, compiled without FMA contraction.
#pragma once

#include "eig3.cuh"
#include "rheology2d.cuh"

namespace des {

// squared deviatoric second invariant (pallas3d.py inv2_6)
template <typename T> __device__ __forceinline__ T inv2_6(const T t[6]) {
  T a = (t[0] + t[1] + t[2]) / T(3);
  T d0 = t[0] - a, d1 = t[1] - a, d2 = t[2] - a;
  return T(0.5) * (d0 * d0 + d1 * d1 + d2 * d2) + t[3] * t[3] + t[4] * t[4] +
         t[5] * t[5];
}

// Incremental elasticity (elastic3_c, rheology.cxx:235-261).
template <typename T>
__device__ __forceinline__ void elastic3(T K, T G, const T de[6], const T s[6],
                                         T out[6]) {
  T lam = K - T(2.0 / 3.0) * G;
  T diag = lam * (de[0] + de[1] + de[2]) + T(0);
  for (int i = 0; i < 3; ++i) out[i] = s[i] + T(2) * G * de[i] + diag;
  for (int i = 3; i < 6; ++i) out[i] = s[i] + T(2) * G * de[i];
}

// Maxwell viscoelasticity (maxwell3_c, rheology.cxx:264-281).
template <typename T>
__device__ __forceinline__ void maxwell3(T K, T G, T visc, T dt, T dv,
                                         const T de[6], const T s[6],
                                         T out[6]) {
  T tmp = T(0.5) * dt * G / visc;
  T f1 = T(1) - tmp;
  T f2 = T(1) / (T(1) + tmp);
  T dev = (de[0] + de[1] + de[2]) / T(3);
  T s0 = (s[0] + s[1] + s[2]) / T(3);
  T bdv = K * dv;
  for (int i = 0; i < 3; ++i)
    out[i] = ((s[i] - s0) * f1 + T(2) * G * (de[i] - dev)) * f2 + s0 + bdv;
  for (int i = 3; i < 6; ++i) out[i] = (s[i] * f1 + T(2) * G * de[i]) * f2;
}

// Viscous flow (viscous3_c, rheology.cxx:284-296).
template <typename T>
__device__ __forceinline__ void viscous3(T K, T visc, T total_dv,
                                         const T e[6], T out[6]) {
  T dev = (e[0] + e[1] + e[2]) / T(3);
  for (int i = 0; i < 3; ++i)
    out[i] = T(2) * visc * (e[i] - dev) + K * total_dv;
  for (int i = 3; i < 6; ++i) out[i] = T(2) * visc * e[i];
}

// Mohr-Coulomb return map in principal axes (elasto_plastic3_c,
// rheology.cxx:298-457) with the analytic eigensolver of eig3.cuh.
template <typename T>
__device__ __forceinline__ void elasto_plastic3(T K, T G, T amc, T anphi,
                                                T anpsi, T hardn, T ten_max,
                                                const T de[6], const T s[6],
                                                T out[6], T& depls) {
  T st[6];
  elastic3(K, G, de, s, st);
  T l[3], v[3][3];
  eigh3(st[0], st[1], st[2], st[3], st[4], st[5], l, v);
  const T pmin = l[0], pmid = l[1], pmax = l[2];

  T a1 = K + T(4.0 / 3.0) * G;
  T a2 = K - T(2.0 / 3.0) * G;

  T fs = pmin - pmax * anphi + amc;
  T ft = pmax - ten_max;
  bool no_fail = (fs > T(0)) && (ft < T(0));

  T pa = dsqrt(T(1) + anphi * anphi) + anphi;
  T ps = ten_max * anphi - amc;
  T h = pmax - ten_max + pa * (pmin - ps);
  bool shear_fail = h < T(0);

  T alam_s = fs / (a1 - a2 * anpsi + a1 * anphi * anpsi - a2 * anphi +
                   T(2) * dsqrt(anphi) * hardn);
  T alam_t = ft / a1;
  T alam = shear_fail ? alam_s : alam_t;

  T dpls_shear = dabs(alam) * dsqrt((T(7) + T(4) * anpsi +
                                     T(7) * anpsi * anpsi) / T(18));
  T dpls_tens = dabs(alam) * T(0.6236095644623235);  // sqrt(7/18)
  depls = no_fail ? T(0) : (shear_fail ? dpls_shear : dpls_tens);

  T d_min = shear_fail ? alam * (a1 - a2 * anpsi) : alam * a2;
  T d_mid = shear_fail ? alam * (a2 - a2 * anpsi) : alam * a2;
  T d_max = shear_fail ? alam * (a2 - a1 * anpsi) : alam * a1;
  T pn[3] = {pmin - d_min, pmid - d_mid, pmax - d_max};

  // rotate back: s_ab = sum_k p_k v_k[a] v_k[b]
  const int ia[6] = {0, 1, 2, 0, 0, 1}, ib[6] = {0, 1, 2, 1, 2, 2};
  for (int q = 0; q < 6; ++q) {
    const int a = ia[q], b = ib[q];
    T r = pn[0] * v[0][a] * v[0][b] + pn[1] * v[1][a] * v[1][b] +
          pn[2] * v[2][a] * v[2][b];
    out[q] = no_fail ? st[q] : r;
  }
}

}  // namespace des
