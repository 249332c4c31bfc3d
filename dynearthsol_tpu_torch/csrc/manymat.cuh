// The material mixers of the many-material instances: plans of more than
// MAXMAT materials, which csrc/fused2d_many.cu and csrc/fused3d_many.cu
// compile (DES_MANY) beside the instances of fused2d.cu and fused3d.cu.
//
// Up to MAXMAT materials the per-material constants are a kernel argument
// and an element's weights a register array, both indexed by constants of
// an unrolled loop (rheology2d.cuh).  Past MAXMAT neither fits: the
// constants are a device table in the run dtype, uploaded once per plan
// (ops/fused2d.py mat_table: material m's MatConst at m * stride, in 3D
// followed by its MixConst), loaded through the read-only cache at the
// same address for every thread of a warp; each weight is read from the
// const pack where a mixture uses it.  for_mats walks the materials in
// groups of MAXMAT, the unrolled loop inside, each accumulator carried
// from group to group: every sum keeps the plain version's left-to-right
// material order, so the kernels round as the plain versions do.
#pragma once

#include "rheology2d.cuh"

namespace des {

// f(m) for m = m0 .. nmat - 1, in order
template <class F>
__device__ __forceinline__ void for_mats(int m0, int nmat, F f) {
#pragma unroll 1
  for (int g = m0; g < nmat; g += MAXMAT) {
#pragma unroll
    for (int q = 0; q < MAXMAT; ++q) {
      if (g + q >= nmat) break;
      f(g + q);
    }
  }
}

// material m's MatConst of the device table
template <typename T> struct MatTable {
  const T* t;
  int stride;
  __device__ __forceinline__ MatConst<T> operator[](int m) const {
    const T* s = t + m * stride;
    return {__ldg(s), __ldg(s + 1), __ldg(s + 2), __ldg(s + 3),
            __ldg(s + 4), __ldg(s + 5), __ldg(s + 6), __ldg(s + 7),
            __ldg(s + 8), __ldg(s + 9), __ldg(s + 10), __ldg(s + 11),
            __ldg(s + 12), __ldg(s + 13), __ldg(s + 14)};
  }
};

// the weights of one element: material m's at p[m * stride], a plane of
// the const pack, which no launch writes
template <typename T> struct Planes {
  const T* p;
  int stride;
  __device__ __forceinline__ T operator[](int m) const {
    return p[m * stride];
  }
};

// rheology2d.cuh visc_core over any number of materials: the same
// operations in the same order.  Kept apart from it: compiled as one
// mixer for both, it moved the registers and spills of the instances up to
// MAXMAT materials, whose -Xptxas -v lines the flagship paths hold.
template <typename T>
__device__ __forceinline__ T visc_core_many(const MatTable<T>& mc, int nmat,
                                            const Planes<T>& w, T Tm, T s0,
                                            T edot, T log_q, T log_1e6,
                                            T vmin, T vmax) {
  T log_edot = dlog(edot);
  T acc = T(0), wsum = T(0);
  for_mats(0, nmat, [&](int m) {
    const MatConst<T> c = mc[m];
    const T wm = w[m];
    T expo = (c.ea + c.va * s0) / (c.nr * Tm);
    T lv = log_q + c.pw * log_edot + c.pw1_logc + expo + log_1e6;
    acc = acc + wm * dexp(-lv);
    wsum = wsum + wm;
  });
  return dclip(wsum / acc, vmin, vmax);
}

// rheology2d.cuh plastic_props over any number of materials: the same
// operations in the same order
template <typename T>
__device__ __forceinline__ void plastic_props_many(
    const MatTable<T>& mc, int nmat, const Planes<T>& w, T pls,
    T tension_max, T deg2rad, T& amc, T& anphi, T& anpsi, T& hardn,
    T& ten_max) {
  T c = T(0), f = T(0), d = T(0), h = T(0), wsum = T(0);
  for_mats(0, nmat, [&](int m) {
    const MatConst<T> k = mc[m];
    const T wm = w[m];
    T p = dclip((pls - k.pls0) / k.span, T(0), T(1));
    T c_m = k.c0 + p * k.dc;
    T f_m = k.f0 + p * k.df;
    T d_m = k.d0 + p * k.dd;
    bool in_w = (pls >= k.pls0) && (pls < k.pls1);
    T h_m = in_w ? k.hslope : T(0);
    if (m == 0) {
      c = wm * c_m;
      f = wm * f_m;
      d = wm * d_m;
      h = wm * h_m;
      wsum = wm + T(0) * c_m;
    } else {
      c = c + wm * c_m;
      f = f + wm * f_m;
      d = d + wm * d_m;
      h = h + wm * h_m;
      wsum = wsum + wm;
    }
  });
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

}  // namespace des
