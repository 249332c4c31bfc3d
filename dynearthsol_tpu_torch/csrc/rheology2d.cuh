// 2D constitutive cores and material mixers as __device__ functions.
//
// Counterparts of dynearthsol_tpu/ops/rheology.py (elastic2_c,
// maxwell2_c, viscous2_c, elasto_plastic2d_c) and
// dynearthsol_tpu/ops/pallas_common.py (make_visc_core_local,
// make_plastic_props_local); the plain PyTorch versions are
// ops/rheology.py and ops/fused_common.py of this package.  Reference:
// rheology.cxx:235-674 and matprops.cxx:40-77, 432-530.
//
// Every expression keeps the operation order of the plain version, and the
// file is compiled without FMA contraction (ops/_build.py), so that +, -,
// * and / round exactly as PyTorch rounds them.  Only the transcendental
// functions (exp, log, sin, tan) differ, by the ulps of CUDA's libdevice.
// Shared with the 3D kernel.
#pragma once

namespace des {

constexpr int MAXMAT = 8;

template <typename T> __device__ __forceinline__ T dexp(T x);
template <> __device__ __forceinline__ float dexp(float x) { return expf(x); }
template <> __device__ __forceinline__ double dexp(double x) { return exp(x); }
template <typename T> __device__ __forceinline__ T dlog(T x);
template <> __device__ __forceinline__ float dlog(float x) { return logf(x); }
template <> __device__ __forceinline__ double dlog(double x) { return log(x); }
template <typename T> __device__ __forceinline__ T dsin(T x);
template <> __device__ __forceinline__ float dsin(float x) { return sinf(x); }
template <> __device__ __forceinline__ double dsin(double x) { return sin(x); }
template <typename T> __device__ __forceinline__ T dtan(T x);
template <> __device__ __forceinline__ float dtan(float x) { return tanf(x); }
template <> __device__ __forceinline__ double dtan(double x) { return tan(x); }
template <typename T> __device__ __forceinline__ T dsqrt(T x);
template <> __device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
template <> __device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }

template <typename T> __device__ __forceinline__ T dabs(T x) {
  return x < T(0) ? -x : x;
}
template <typename T> __device__ __forceinline__ T dsign(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}
// jnp/torch minimum and maximum, NaN aside
template <typename T> __device__ __forceinline__ T dmin(T a, T b) {
  return b < a ? b : a;
}
template <typename T> __device__ __forceinline__ T dmax(T a, T b) {
  return b > a ? b : a;
}
// clip(x, lo, hi) = min(max(x, lo), hi)
template <typename T> __device__ __forceinline__ T dclip(T x, T lo, T hi) {
  return dmin(dmax(x, lo), hi);
}

// Per-material constants, formed in float64 on the host exactly as the JAX
// package forms them, rounded once to T (ops/fused_common.py MAT_FIELDS).
template <typename T> struct MatConst {
  T pw, pw1_logc, ea, va, nr, pls0, pls1, span, c0, dc, f0, df, d0, dd,
      hslope;
};
constexpr int NMATFIELD = 15;

// Moduli combinations: formed in T from per-element moduli, or taken in
// their float64-formed rounding for a single material (ops/fused2d.py
// lam_u, a1_u).
template <typename T> struct Moduli {
  T bulkm, shearm, lam, a1, a2;
};

// The material loops below run to MAXMAT, unrolled, and stop at nmat:
// every index is then a constant, so that neither the weights nor the
// plan's per-material constants (a kernel argument) are copied to local
// memory to be indexed.  Plans of more materials run the many-material
// instances, whose mixers (manymat.cuh) walk the materials in groups of
// MAXMAT.

// Dislocation-creep viscosity, harmonic mixture over the materials
// (visc_core_local).
template <typename T>
__device__ __forceinline__ T visc_core(const MatConst<T>* mc, int nmat,
                                       const T* w, T Tm, T s0, T edot,
                                       T log_q, T log_1e6, T vmin, T vmax) {
  T log_edot = dlog(edot);
  T acc = T(0), wsum = T(0);
#pragma unroll
  for (int m = 0; m < MAXMAT; ++m) {
    if (m >= nmat) break;
    T expo = (mc[m].ea + mc[m].va * s0) / (mc[m].nr * Tm);
    T lv = log_q + mc[m].pw * log_edot + mc[m].pw1_logc + expo + log_1e6;
    acc = acc + w[m] * dexp(-lv);
    wsum = wsum + w[m];
  }
  return dclip(wsum / acc, vmin, vmax);
}

// Mohr-Coulomb weakening mixture (plastic_props_local).
template <typename T>
__device__ __forceinline__ void plastic_props(const MatConst<T>* mc, int nmat,
                                              const T* w, T pls, T tension_max,
                                              T deg2rad, T& amc, T& anphi,
                                              T& anpsi, T& hardn, T& ten_max) {
  T c = T(0), f = T(0), d = T(0), h = T(0), wsum = T(0);
#pragma unroll
  for (int m = 0; m < MAXMAT; ++m) {
    if (m >= nmat) break;
    T p = dclip((pls - mc[m].pls0) / mc[m].span, T(0), T(1));
    T c_m = mc[m].c0 + p * mc[m].dc;
    T f_m = mc[m].f0 + p * mc[m].df;
    T d_m = mc[m].d0 + p * mc[m].dd;
    bool in_w = (pls >= mc[m].pls0) && (pls < mc[m].pls1);
    T h_m = in_w ? mc[m].hslope : T(0);
    if (m == 0) {
      c = w[m] * c_m;
      f = w[m] * f_m;
      d = w[m] * d_m;
      h = w[m] * h_m;
      wsum = w[m] + T(0) * c_m;
    } else {
      c = c + w[m] * c_m;
      f = f + w[m] * f_m;
      d = d + w[m] * d_m;
      h = h + w[m] * h_m;
      wsum = wsum + w[m];
    }
  }
  c = c / wsum;
  f = f / wsum;
  d = d / wsum;
  hardn = h / wsum;
  T sphi = dsin(f * deg2rad);
  T spsi = dsin(d * deg2rad);
  anphi = (T(1) + sphi) / (T(1) - sphi);
  anpsi = (T(1) + spsi) / (T(1) - spsi);
  amc = T(2) * c * dsqrt(anphi);
  T tanphi = dtan(f * deg2rad);
  T safe_tan = tanphi == T(0) ? T(1) : tanphi;
  ten_max = f == T(0) ? tension_max : dmin(c / safe_tan, tension_max);
}

// Incremental elasticity (elastic2_c, rheology.cxx:235-261).
template <typename T>
__device__ __forceinline__ void elastic2(const Moduli<T>& k, const T de[3],
                                         const T s[3], T out[3]) {
  T diag = k.lam * (de[0] + de[1]) + T(0);
  out[0] = s[0] + T(2) * k.shearm * de[0] + diag;
  out[1] = s[1] + T(2) * k.shearm * de[1] + diag;
  out[2] = s[2] + T(2) * k.shearm * de[2];
}

// Maxwell viscoelasticity (maxwell2_c, rheology.cxx:264-281).
template <typename T>
__device__ __forceinline__ void maxwell2(const Moduli<T>& k, T visc, T dt,
                                         T dv, const T de[3], const T s[3],
                                         T out[3]) {
  T tmp = T(0.5) * dt * k.shearm / visc;
  T f1 = T(1) - tmp;
  T f2 = T(1) / (T(1) + tmp);
  T dev = (de[0] + de[1]) / T(2);
  T s0 = (s[0] + s[1]) / T(2);
  T bdv = k.bulkm * dv;
  out[0] = ((s[0] - s0) * f1 + T(2) * k.shearm * (de[0] - dev)) * f2 + s0 +
           bdv;
  out[1] = ((s[1] - s0) * f1 + T(2) * k.shearm * (de[1] - dev)) * f2 + s0 +
           bdv;
  out[2] = (s[2] * f1 + T(2) * k.shearm * de[2]) * f2;
}

// Viscous flow (viscous2_c, rheology.cxx:284-296).
template <typename T>
__device__ __forceinline__ void viscous2(const Moduli<T>& k, T visc,
                                         T total_dv, const T e[3], T out[3]) {
  T dev = (e[0] + e[1]) / T(2);
  out[0] = T(2) * visc * (e[0] - dev) + k.bulkm * total_dv;
  out[1] = T(2) * visc * (e[1] - dev) + k.bulkm * total_dv;
  out[2] = T(2) * visc * e[2];
}

// geoFLAC plane-strain Mohr-Coulomb return map (elasto_plastic2d_c,
// rheology.cxx:459-674).
template <typename T>
__device__ __forceinline__ void elasto_plastic2d(
    const Moduli<T>& k, T amc, T anphi, T anpsi, T hardn, T ten_max,
    const T de[3], const T s[3], T syy, T out[3], T& syy_new, T& depls) {
  const T a1 = k.a1, a2 = k.a2;
  T sxx = s[0] + de[1] * a2 + de[0] * a1;
  T szz = s[1] + de[0] * a2 + de[1] * a1;
  T sxz = s[2] + de[2] * T(2) * k.shearm;
  T syy_t = syy + (de[0] + de[1]) * a2;

  T s0 = T(0.5) * (sxx + szz);
  T dd = sxx - szz;
  T rad = T(0.5) * dsqrt(dd * dd + T(4) * sxz * sxz);
  T si = s0 - rad;
  T sii = s0 + rad;
  bool ok = rad > T(1e-15);
  T safe_rad = ok ? rad : T(1);
  T cos2t = ok ? T(0.5) * (szz - sxx) / safe_rad : T(1);
  T sin2t = ok ? -sxz / safe_rad : T(0);

  // sort syy into the (si, sii) pair (rheology.cxx:537-568)
  bool caseA = syy_t > sii;
  bool caseB = syy_t < si;
  T p0 = caseA ? si : (caseB ? syy_t : si);
  T p1 = caseA ? sii : (caseB ? si : syy_t);
  T p2 = caseA ? syy_t : sii;
  int idx_si = caseA ? 0 : (caseB ? 1 : 0);
  int idx_sii = caseA ? 1 : 2;
  int idx_syy = caseA ? 2 : (caseB ? 0 : 1);

  // tensile scenarios (rheology.cxx:587-608)
  bool t1 = p0 >= ten_max;
  bool t2 = !t1 && (p1 >= ten_max);
  bool t3 = !t1 && !t2 && (p2 >= ten_max);
  if (t2) p1 = ten_max;
  if (t2 || t3) p2 = ten_max;

  // shear yield (rheology.cxx:611-631)
  T fs = p0 - p2 * anphi + amc;
  bool elastic_out = !t1 && (fs >= T(0));
  bool shear = !t1 && (fs < T(0));
  T alams = fs / (a1 - a2 * anpsi + a1 * anphi * anpsi - a2 * anphi + hardn);
  T p0s = p0 - alams * (a1 - a2 * anpsi);
  T p1s = p1 - alams * (a2 - a2 * anpsi);
  T p2s = p2 - alams * (a2 - a1 * anpsi);
  depls = shear ? T(0.5) * dabs(alams + alams * anpsi) : T(0);

  // post-shear tensile recheck (rheology.cxx:640-661)
  bool u1 = shear && (p0s >= ten_max);
  bool u2 = shear && !u1 && (p1s >= ten_max);
  bool u3 = shear && !u1 && !u2 && (p2s >= ten_max);
  if (u2) p1s = ten_max;
  if (u2 || u3) p2s = ten_max;

  // rotate principal stresses back (rheology.cxx:665-673); the sorted
  // slots are picked by selects, not by indexing an array, which would
  // live in local memory
  auto pick = [&](int i) { return i == 0 ? p0s : (i == 1 ? p1s : p2s); };
  T pn1 = pick(idx_si), pn2 = pick(idx_sii), pn3 = pick(idx_syy);
  T dc2 = (pn1 - pn2) * cos2t;
  T dss = pn1 + pn2;
  T sxx_r = T(0.5) * (dss + dc2);
  T szz_r = T(0.5) * (dss - dc2);
  T sxz_r = T(0.5) * (pn1 - pn2) * sin2t;

  bool cap = t1 || u1;
  out[0] = cap ? ten_max : (elastic_out ? sxx : sxx_r);
  out[1] = cap ? ten_max : (elastic_out ? szz : szz_r);
  out[2] = cap ? T(0) : (elastic_out ? sxz : sxz_r);
  syy_new = cap ? ten_max : (elastic_out ? syy_t : pn3);
  if (cap && t1) depls = T(0);
}

}  // namespace des
