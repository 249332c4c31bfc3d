// Fused 2D structured time step and per-step dt refresh, for Hopper
// (sm_90a).
//
// Replaces: dynearthsol_tpu/ops/pallas2d.py make_pallas_step -> kernel /
// _core / _tile (pallas_call at pallas2d.py:1431, the per-step tiled step)
// and, with des_dt_refresh_f32, the resident chunk kernel kernel_res
// (pallas_call at pallas2d.py:1330, which runs n steps of _core and
// refreshes dt in-kernel, :1279-1304).  Plain PyTorch version:
// ops/fused2d.py step_planes_plain and dt_refresh_plain.
//
// What bounds it on this card: memory traffic.  A step reads and writes
// the 17 element planes (2 * nxc * nzc each) and 11 nodal planes (nx * nz)
// of the state, f32: at the 512 x 256-cell flagship that is about 25 MB
// each way, a few hundred flops per element and no matrix work, far below
// the card's flop/byte balance.  The TPU kernel kept the planes in VMEM and
// recomputed a stencil halo per tile; a Hopper SM has no such buffer, and
// the element->node->element->node chain of the step needs a grid-wide
// barrier at each hop.  So this first form runs one launch per phase
// (A element, B node, C element, D node, E element, F node, G element,
// H node), one thread per cell (both triangles) or per node, z contiguous
// so that neighbouring threads load neighbouring addresses, and passes
// intermediates through small scratch planes (ework 6 planes, nwork 2).
// At flagship size the planes (~50 MB in and out) mostly stay within the
// 50 MB L2 between phases.  Fewer launches, L2 residency by design and a
// CUDA graph around the chunk are later work.
//
// Node sums reproduce the stencil assembly of pallas2d.py asm_local /
// asm_equal_local / _pad4: each node adds its up-to-four cells' corner
// contributions in the fixed order 00, 10, 11, 01, with the triangle
// parity of ops/structured.py.  No float atomics: min/max partials are
// exact in any order and the force-residual sum is a fixed two-pass tree
// (block partials here, the final pass in dt_refresh), so reruns are
// bit-identical.
//
// Scalars stay on the device: dt, vmax, gdtmin, time, the last L2 partial
// and dt_maxwell are read from / written to `scal`, the refresh and decay
// flags of the step from `flag`.  No host synchronisation inside a chunk.
//
// Built without FMA contraction (-fmad=false, ops/_build.py): every +, -,
// * and / then rounds as in the plain PyTorch version, which is the price
// of an initial volume equal to the step's volume bit for bit (a 1-ulp
// volume difference is multiplied by the bulk modulus every step through
// the maxwell dv = V/V_old - 1).  The kernels are templated on the scalar
// type; this path instantiates float, as the fused-step gate requires.

#include <cuda_runtime.h>

#include <cfloat>

#include "rheology2d.cuh"

using namespace des;

namespace {

constexpr int BLOCK = 256;

// packed slots: ops/fused2d.py E_SLOTS/T_SLOTS, N_SLOTS, CE_SLOTS, CN_SLOTS
enum { E_VOL = 0, E_VOLD, E_SYY, E_PLS, E_DPLS, E_VISC, E_DP, E_EDV,
       E_STRESS, E_STRAIN = E_STRESS + 3, E_SR = E_STRAIN + 3 };
enum { N_CX = 0, N_CZ, N_VX, N_VZ, N_T, N_MASS, N_TMASS, N_HMASS, N_VOLN,
       N_FX, N_FZ };
enum { CE_VALID = 0, CE_RAD, CE_BULK, CE_SHEAR, CE_KAPPA, CE_RHOA, CE_RHOB,
       CE_BUOYA, CE_BUOYB, CE_CPA, CE_CPB, CE_HMA, NCE0 };
enum { CN_TOP = 0, CN_MX, CN_MZ, CN_YM };
// rheology bits (config.py RH_*)
enum { RH_ELASTIC = 1, RH_VISCOUS = 2, RH_MAXWELL = 3, RH_EP = 5,
       RH_EVP = 7 };
constexpr int NFP0 = 23;  // ops/fused2d.py FP_FIELDS

template <typename T> struct StepParams {
  int nx, nz, nxc, nzc, nmat, rheol, uniform, nmd, thermal, gravity_on,
      damping, surf_corr, quasi_static, use_gvs, oceanic, decay_uniform,
      fixed_on, jaumann;
  T surface_T, visc_min, visc_max, tension_max, fac, one_m_fac, two_m_fac,
      ps2, lam_hl, inertial, log_q, log_1e6, deg2rad, tdmax, max_vbc, ps,
      swave_ref, fixed_dt, frac, big, lam_u, a1_u, rhoq_u;
  T ce[NCE0];
  MatConst<T> mat[MAXMAT];
};

// ip/fp are ops/fused2d.py StepPlan.ip (IP_FIELDS) and .fp (FP_FIELDS,
// then CE_SLOTS, then MAT_FIELDS per material); each float64 is rounded to
// T here, once, as JAX rounds a Python float constant.
template <typename T>
StepParams<T> from_host(const int* ip, const double* fp) {
  StepParams<T> p;
  p.nx = ip[0]; p.nz = ip[1]; p.nmat = ip[2]; p.rheol = ip[3];
  p.uniform = ip[4]; p.nmd = ip[5]; p.thermal = ip[6];
  p.gravity_on = ip[7]; p.damping = ip[8]; p.surf_corr = ip[9];
  p.quasi_static = ip[10]; p.use_gvs = ip[11]; p.oceanic = ip[12];
  p.decay_uniform = ip[13]; p.fixed_on = ip[14]; p.jaumann = ip[15];
  p.nxc = p.nx - 1;
  p.nzc = p.nz - 1;
  T* f[NFP0] = {&p.surface_T, &p.visc_min, &p.visc_max, &p.tension_max,
                &p.fac, &p.one_m_fac, &p.two_m_fac, &p.ps2, &p.lam_hl,
                &p.inertial, &p.log_q, &p.log_1e6, &p.deg2rad, &p.tdmax,
                &p.max_vbc, &p.ps, &p.swave_ref, &p.fixed_dt, &p.frac,
                &p.big, &p.lam_u, &p.a1_u, &p.rhoq_u};
  for (int i = 0; i < NFP0; ++i) *f[i] = static_cast<T>(fp[i]);
  for (int i = 0; i < NCE0; ++i) p.ce[i] = static_cast<T>(fp[NFP0 + i]);
  const double* mf = fp + NFP0 + NCE0;
  for (int m = 0; m < p.nmat; ++m) {
    T* v = &p.mat[m].pw;  // MatConst is NMATFIELD consecutive T
    for (int q = 0; q < NMATFIELD; ++q)
      v[q] = static_cast<T>(mf[m * NMATFIELD + q]);
  }
  return p;
}

template <typename T> struct Bufs {
  const T* ein;   // (17, 2, nxc, nzc) state before the step
  const T* nin;   // (11, nx, nz)
  T* eout;        // state after the step
  T* nout;
  const T* cep;   // (12 + nmat, 2, nxc, nzc) or null (single material)
  const T* cnp;   // (4, nx, nz)
  const T* tgt;   // (2, nx, nz) vbc targets
  const T* scal;  // dt, vmax, gdtmin, time, r2, dt_maxwell
  const T* flag;  // refresh, decay of this step
  T* ework;       // (6, 2, nxc, nzc) scratch
  T* nwork;       // (2, nx, nz) scratch
  T* part;        // (4, nb) block partials
  int nb;
};

template <typename T> struct Ctx {
  const StepParams<T>& p;
  const Bufs<T>& b;
  int ES, NS;  // one triangle plane (nxc*nzc), one nodal plane (nx*nz)
  __device__ Ctx(const StepParams<T>& p_, const Bufs<T>& b_)
      : p(p_), b(b_), ES(p_.nxc * p_.nzc), NS(p_.nx * p_.nz) {}
  __device__ T ein(int slot, int e) const { return b.ein[slot * 2 * ES + e]; }
  __device__ T eout(int slot, int e) const { return b.eout[slot * 2 * ES + e]; }
  __device__ void put(int slot, int e, T v) const {
    b.eout[slot * 2 * ES + e] = v;
  }
  __device__ T nin(int slot, int n) const { return b.nin[slot * NS + n]; }
  __device__ T ce(int slot, int e) const {
    return p.uniform ? p.ce[slot] : b.cep[slot * 2 * ES + e];
  }
  __device__ void weights(int e, T* w) const {
    if (p.uniform) {
      w[0] = T(1);
    } else {
      for (int m = 0; m < p.nmat; ++m) w[m] = b.cep[(NCE0 + m) * 2 * ES + e];
    }
  }
  __device__ Moduli<T> moduli(int e) const {
    Moduli<T> k;
    k.bulkm = ce(CE_BULK, e);
    k.shearm = ce(CE_SHEAR, e);
    if (p.uniform) {
      k.lam = p.lam_u;
      k.a1 = p.a1_u;
    } else {
      k.lam = k.bulkm - T(2.0 / 3.0) * k.shearm;
      k.a1 = k.bulkm + T(4.0 / 3.0) * k.shearm;
    }
    k.a2 = k.lam;
    return k;
  }
};

__device__ __forceinline__ bool parity(int i, int j) {
  return ((i + j) & 1) == 0;
}

// corner values of both triangles of cell (i, j) from a nodal plane:
// triangle 0 = (c00, c10, P ? c11 : c01), triangle 1 = (P ? c00 : c10,
// c11, c01)
template <typename T>
__device__ __forceinline__ void corners(const T* g, int nz, int i, int j,
                                        T c[2][3]) {
  const bool P = parity(i, j);
  const int n00 = i * nz + j, n10 = n00 + nz;
  T c00 = g[n00], c10 = g[n10], c01 = g[n00 + 1], c11 = g[n10 + 1];
  c[0][0] = c00; c[0][1] = c10; c[0][2] = P ? c11 : c01;
  c[1][0] = P ? c00 : c10; c[1][1] = c11; c[1][2] = c01;
}

template <typename T> struct Shape {
  T dndx[3], dndz[3];
};

template <typename T>
__device__ __forceinline__ Shape<T> shape_fn(const T* x, const T* z, T vol) {
  Shape<T> s;
  T iv = T(1) / (T(2) * vol);
  s.dndx[0] = iv * (z[1] - z[2]);
  s.dndx[1] = iv * (z[2] - z[0]);
  s.dndx[2] = iv * (z[0] - z[1]);
  s.dndz[0] = iv * (x[2] - x[1]);
  s.dndz[1] = iv * (x[0] - x[2]);
  s.dndz[2] = iv * (x[1] - x[0]);
  return s;
}

template <typename T>
__device__ __forceinline__ T mean3(const T* v) {
  return (v[0] + v[1] + v[2]) / T(3);
}

template <typename T>
__device__ __forceinline__ T volume_of(const T* x, const T* z) {
  return T(0.5) * ((x[1] - x[0]) * (z[2] - z[0]) - (z[1] - z[0]) * (x[2] - x[0]));
}

template <typename T>
__device__ __forceinline__ T min_height(const T* x, const T* z, T vol) {
  T a = x[0] - x[1], b = z[0] - z[1];
  T d01 = a * a + b * b;
  a = x[1] - x[2]; b = z[1] - z[2];
  T d12 = a * a + b * b;
  a = x[0] - x[2]; b = z[0] - z[2];
  T d02 = a * a + b * b;
  T dm = dmax(dmax(d01, d12), d02);
  return T(2) * vol / dsqrt(dm);
}

// velocity gradient of a triangle: (lxx, lzz, lxz)
template <typename T>
__device__ __forceinline__ void strain_rate(const Shape<T>& s, const T* vx,
                                            const T* vz, T sr[3]) {
  sr[0] = vx[0] * s.dndx[0] + vx[1] * s.dndx[1] + vx[2] * s.dndx[2];
  sr[1] = vz[0] * s.dndz[0] + vz[1] * s.dndz[1] + vz[2] * s.dndz[2];
  sr[2] = T(0.5) * (vx[0] * s.dndz[0] + vx[1] * s.dndz[1] + vx[2] * s.dndz[2] +
                    vz[0] * s.dndx[0] + vz[1] * s.dndx[1] + vz[2] * s.dndx[2]);
}

// Node (i, j): sum of its cells' contributions, order 00, 10, 11, 01.
// v(t, c) is the contribution of triangle t of cell c, the same at every
// corner (asm_equal_local).
template <typename T, class F>
__device__ __forceinline__ T asm_equal(F v, int i, int j, int nxc, int nzc) {
  T a00 = T(0), a10 = T(0), a11 = T(0), a01 = T(0);
  if (i < nxc && j < nzc) {
    int c = i * nzc + j;
    a00 = v(0, c) + (parity(i, j) ? v(1, c) : T(0));
  }
  if (i >= 1 && j < nzc) {
    int c = (i - 1) * nzc + j;
    a10 = v(0, c) + (parity(i - 1, j) ? T(0) : v(1, c));
  }
  if (i >= 1 && j >= 1) {
    int c = (i - 1) * nzc + j - 1;
    a11 = (parity(i - 1, j - 1) ? v(0, c) : T(0)) + v(1, c);
  }
  if (i < nxc && j >= 1) {
    int c = i * nzc + j - 1;
    a01 = (parity(i, j - 1) ? T(0) : v(0, c)) + v(1, c);
  }
  return ((a00 + a10) + a11) + a01;
}

// As asm_equal with per-corner contributions: slot planes c0, c1, c2 hold
// the contribution of each triangle's corner 0, 1, 2 (asm_local).
template <typename T>
__device__ __forceinline__ T asm_corner(const T* c0, const T* c1, const T* c2,
                                        int ES, int i, int j, int nxc,
                                        int nzc) {
  T a00 = T(0), a10 = T(0), a11 = T(0), a01 = T(0);
  if (i < nxc && j < nzc) {
    int c = i * nzc + j;
    a00 = c0[c] + (parity(i, j) ? c0[ES + c] : T(0));
  }
  if (i >= 1 && j < nzc) {
    int c = (i - 1) * nzc + j;
    a10 = c1[c] + (parity(i - 1, j) ? T(0) : c0[ES + c]);
  }
  if (i >= 1 && j >= 1) {
    int c = (i - 1) * nzc + j - 1;
    a11 = (parity(i - 1, j - 1) ? c2[c] : T(0)) + c1[ES + c];
  }
  if (i < nxc && j >= 1) {
    int c = i * nzc + j - 1;
    a01 = (parity(i, j - 1) ? T(0) : c2[c]) + c2[ES + c];
  }
  return ((a00 + a10) + a11) + a01;
}

// fixed-order tree reductions over one block
template <typename T, class Op>
__device__ __forceinline__ T block_reduce(T v, T* sh, Op op) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = BLOCK / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] = op(sh[threadIdx.x], sh[threadIdx.x + s]);
    __syncthreads();
  }
  T r = sh[0];
  __syncthreads();
  return r;
}

// ---- A, element: T-diffusion contributions and dvoldt terms
// (pallas2d.py:703-744)
template <typename T>
__global__ void __launch_bounds__(BLOCK) phase_a(StepParams<T> p, Bufs<T> b) {
  Ctx<T> C(p, b);
  int c = blockIdx.x * BLOCK + threadIdx.x;
  if (c >= C.ES) return;
  int i = c / p.nzc, j = c % p.nzc;
  T X[2][3], Z[2][3], VX[2][3], VZ[2][3], TT[2][3];
  corners(b.nin + N_CX * C.NS, p.nz, i, j, X);
  corners(b.nin + N_CZ * C.NS, p.nz, i, j, Z);
  corners(b.nin + N_VX * C.NS, p.nz, i, j, VX);
  corners(b.nin + N_VZ * C.NS, p.nz, i, j, VZ);
  corners(b.nin + N_T * C.NS, p.nz, i, j, TT);
  for (int t = 0; t < 2; ++t) {
    int e = t * C.ES + c;
    T vol = C.ein(E_VOL, e);
    Shape<T> s = shape_fn(X[t], Z[t], vol);
    if (p.thermal) {
      T TinC = mean3(TT[t]) - T(273.0);
      T rho_e = C.ce(CE_RHOA, e) - C.ce(CE_RHOB, e) * TinC;
      T kv = C.ce(CE_KAPPA, e) * vol;
      T source = C.ce(CE_RAD, e) * vol * rho_e / T(3);
      T gtx = s.dndx[0] * TT[t][0] + s.dndx[1] * TT[t][1] + s.dndx[2] * TT[t][2];
      T gtz = s.dndz[0] * TT[t][0] + s.dndz[1] * TT[t][1] + s.dndz[2] * TT[t][2];
      for (int a = 0; a < 3; ++a)
        b.ework[a * 2 * C.ES + e] =
            kv * (s.dndx[a] * gtx + s.dndz[a] * gtz) - source;
    }
    T sr[3];
    strain_rate(s, VX[t], VZ[t], sr);
    b.ework[3 * 2 * C.ES + e] = (sr[0] + sr[1]) * vol;
  }
}

// ---- B, node: temperature and dvoldt (pallas2d.py:730-733, :745)
template <typename T>
__global__ void __launch_bounds__(BLOCK) phase_b(StepParams<T> p, Bufs<T> b) {
  Ctx<T> C(p, b);
  int n = blockIdx.x * BLOCK + threadIdx.x;
  if (n >= C.NS) return;
  int i = n / p.nz, j = n % p.nz;
  const T dt = b.scal[0];
  const T* et = b.ework + 3 * 2 * C.ES;
  T dv = asm_equal<T>([&](int t, int c) { return et[t * C.ES + c]; }, i, j,
                      p.nxc, p.nzc);
  b.nwork[n] = dv / C.nin(N_VOLN, n);
  T Told = C.nin(N_T, n);
  T Tnew = Told;
  if (p.thermal) {
    T tdot = asm_corner(b.ework, b.ework + 2 * C.ES, b.ework + 4 * C.ES, C.ES,
                        i, j, p.nxc, p.nzc);
    Tnew = b.cnp[CN_TOP * C.NS + n] > T(0)
               ? p.surface_T
               : Told - dt * tdot / C.nin(N_TMASS, n);
  }
  b.nout[N_T * C.NS + n] = Tnew;
}

// ---- C, element: edvoldt, strain, constitutive update, dpressure
// (pallas2d.py:746-818)
template <typename T>
__global__ void __launch_bounds__(BLOCK) phase_c(StepParams<T> p, Bufs<T> b) {
  Ctx<T> C(p, b);
  int c = blockIdx.x * BLOCK + threadIdx.x;
  if (c >= C.ES) return;
  int i = c / p.nzc, j = c % p.nzc;
  const T dt = b.scal[0];
  T X[2][3], Z[2][3], VX[2][3], VZ[2][3], TT[2][3], DV[2][3];
  corners(b.nin + N_CX * C.NS, p.nz, i, j, X);
  corners(b.nin + N_CZ * C.NS, p.nz, i, j, Z);
  corners(b.nin + N_VX * C.NS, p.nz, i, j, VX);
  corners(b.nin + N_VZ * C.NS, p.nz, i, j, VZ);
  corners(b.nin + N_T * C.NS, p.nz, i, j, TT);
  corners(b.nwork, p.nz, i, j, DV);
  for (int t = 0; t < 2; ++t) {
    int e = t * C.ES + c;
    T vol = C.ein(E_VOL, e);
    Shape<T> s = shape_fn(X[t], Z[t], vol);
    T sr[3];
    strain_rate(s, VX[t], VZ[t], sr);
    T temp_e = mean3(TT[t]);
    T edv = mean3(DV[t]);
    T adj = (edv - (sr[0] + sr[1])) / T(2);
    T edot[3] = {sr[0] + adj, sr[1] + adj, sr[2]};
    T de[3], strain[3], so[3];
    for (int a = 0; a < 3; ++a) {
      de[a] = edot[a] * dt;
      strain[a] = C.ein(E_STRAIN + a, e) + de[a];
      so[a] = C.ein(E_STRESS + a, e);
    }
    T old_tr = so[0] + so[1];
    // the viscosity of the creep laws and EP's delta_plstrain are
    // recomputed, so their old values are not loaded
    const int rh = p.rheol;
    T syy = C.ein(E_SYY, e), pls = C.ein(E_PLS, e);
    T dpls = rh == RH_EP ? T(0) : C.ein(E_DPLS, e);
    Moduli<T> k = C.moduli(e);
    T w[MAXMAT];
    C.weights(e, w);
    const int nmat = p.uniform ? 1 : p.nmat;
    T visc;
    if (rh == RH_VISCOUS || rh == RH_MAXWELL || rh == RH_EVP) {
      T s0m = (so[0] + so[1]) / T(2);
      T d = sr[0] - sr[1];
      T rII2 = T(0.25) * (d * d) + sr[2] * sr[2];
      T ed = dmax(dsqrt(rII2), T(1e-30));
      visc = visc_core(p.mat, nmat, w, temp_e, s0m, ed, p.log_q, p.log_1e6,
                       p.visc_min, p.visc_max);
    } else {
      visc = C.ein(E_VISC, e);
    }
    T sc[3];
    if (rh == RH_ELASTIC) {
      elastic2(k, de, so, sc);
    } else if (rh == RH_VISCOUS) {
      viscous2(k, visc, strain[0] + strain[1], edot, sc);
    } else if (rh == RH_MAXWELL) {
      T dv = vol / C.ein(E_VOLD, e) - T(1);
      maxwell2(k, visc, dt, dv, de, so, sc);
    } else {  // RH_EP or RH_EVP
      T amc, anphi, anpsi, hardn, ten_max, sp[3], spyy, depls;
      plastic_props(p.mat, nmat, w, pls, p.tension_max, p.deg2rad, amc,
                    anphi, anpsi, hardn, ten_max);
      elasto_plastic2d(k, amc, anphi, anpsi, hardn, ten_max, de, so, syy, sp,
                       spyy, depls);
      bool use_v = false;
      if (rh == RH_EVP) {
        T dv = vol / C.ein(E_VOLD, e) - T(1);
        T sv[3];
        maxwell2(k, visc, dt, dv, de, so, sv);
        T a = sv[0] - sv[1], q = sp[0] - sp[1];
        T svII = T(0.25) * (a * a) + sv[2] * sv[2];
        T spII = T(0.25) * (q * q) + sp[2] * sp[2];
        // min-magnitude selection (rheology.cxx:869-879)
        use_v = svII < spII;
        for (int a2 = 0; a2 < 3; ++a2) sc[a2] = use_v ? sv[a2] : sp[a2];
      } else {
        for (int a2 = 0; a2 < 3; ++a2) sc[a2] = sp[a2];
      }
      if (!use_v) {
        syy = spyy;
        pls = pls + depls;
        dpls = depls;
      }
    }
    T dp = p.nmd ? sc[0] + sc[1] - old_tr : C.ein(E_DP, e);
    for (int a = 0; a < 3; ++a) {
      C.put(E_STRESS + a, e, sc[a]);
      C.put(E_STRAIN + a, e, strain[a]);
      C.put(E_SR + a, e, edot[a]);
    }
    C.put(E_SYY, e, syy);
    C.put(E_PLS, e, pls);
    C.put(E_DPLS, e, dpls);
    C.put(E_VISC, e, visc);
    C.put(E_DP, e, dp);
    C.put(E_EDV, e, edv);
  }
}

// ---- D, node: NMD nodal pressure change (pallas2d.py:819)
template <typename T>
__global__ void __launch_bounds__(BLOCK) phase_d(StepParams<T> p, Bufs<T> b) {
  Ctx<T> C(p, b);
  int n = blockIdx.x * BLOCK + threadIdx.x;
  if (n >= C.NS) return;
  int i = n / p.nz, j = n % p.nz;
  T s = asm_equal<T>(
      [&](int t, int c) {
        int e = t * C.ES + c;
        return C.eout(E_DP, e) * C.ein(E_VOL, e);
      },
      i, j, p.nxc, p.nzc);
  b.nwork[C.NS + n] = s / C.nin(N_VOLN, n);
}

// ---- E, element: NMD correction and force contributions
// (pallas2d.py:820-836)
template <typename T>
__global__ void __launch_bounds__(BLOCK) phase_e(StepParams<T> p, Bufs<T> b) {
  Ctx<T> C(p, b);
  int c = blockIdx.x * BLOCK + threadIdx.x;
  if (c >= C.ES) return;
  int i = c / p.nzc, j = c % p.nzc;
  T X[2][3], Z[2][3], TT[2][3], DP[2][3];
  corners(b.nin + N_CX * C.NS, p.nz, i, j, X);
  corners(b.nin + N_CZ * C.NS, p.nz, i, j, Z);
  corners(b.nin + N_T * C.NS, p.nz, i, j, TT);
  if (p.nmd) corners(b.nwork + C.NS, p.nz, i, j, DP);
  for (int t = 0; t < 2; ++t) {
    int e = t * C.ES + c;
    T vol = C.ein(E_VOL, e);
    Shape<T> s = shape_fn(X[t], Z[t], vol);
    T st[3] = {C.eout(E_STRESS, e), C.eout(E_STRESS + 1, e),
               C.eout(E_STRESS + 2, e)};
    if (p.nmd) {
      T ddp = (mean3(DP[t]) - C.eout(E_DP, e)) / T(2);
      st[0] = st[0] + ddp;
      st[1] = st[1] + ddp;
      C.put(E_STRESS, e, st[0]);
      C.put(E_STRESS + 1, e, st[1]);
    }
    T TinC = mean3(TT[t]) - T(273.0);
    T buoy = p.gravity_on ? C.ce(CE_BUOYA, e) - C.ce(CE_BUOYB, e) * TinC
                          : T(0);
    for (int a = 0; a < 3; ++a) {
      b.ework[a * 2 * C.ES + e] = (st[0] * s.dndx[a] + st[2] * s.dndz[a]) * vol;
      b.ework[(3 + a) * 2 * C.ES + e] =
          (st[2] * s.dndx[a] + st[1] * s.dndz[a] + buoy) * vol;
    }
  }
}

// ---- F, node: force, L2 partial, damping, velocity + vbc, coordinates
// (pallas2d.py:837-950 without the facet tractions :840-894)
template <typename T>
__global__ void __launch_bounds__(BLOCK) phase_f(StepParams<T> p, Bufs<T> b) {
  __shared__ T sh[BLOCK];
  Ctx<T> C(p, b);
  int n = blockIdx.x * BLOCK + threadIdx.x;
  T r2 = T(0);
  if (n < C.NS) {
    int i = n / p.nz, j = n % p.nz;
    const T dt = b.scal[0];
    const int E2 = 2 * C.ES;
    T fx = -asm_corner(b.ework, b.ework + E2, b.ework + 2 * E2, C.ES, i, j,
                       p.nxc, p.nzc);
    T fz = -asm_corner(b.ework + 3 * E2, b.ework + 4 * E2, b.ework + 5 * E2,
                       C.ES, i, j, p.nxc, p.nzc);
    r2 = fx * fx + fz * fz;
    T m = C.nin(N_MASS, n), vx = C.nin(N_VX, n), vz = C.nin(N_VZ, n);
    T fdx = fx, fdz = fz;
    const T tiny = T(1e-13);
    if (p.damping == 1) {
      fdx = fx - (dabs(vx) > tiny ? p.fac * dabs(fx) * dsign(vx) : T(0));
      fdz = fz - (dabs(vz) > tiny ? p.fac * dabs(fz) * dsign(vz) : T(0));
    } else if (p.damping == 2) {
      fdx = fx * p.one_m_fac;
      fdz = fz * p.one_m_fac;
    } else if (p.damping == 3) {
      fdx = ((fx < T(0)) == (vx < T(0))) ? fx * p.one_m_fac : fx * p.two_m_fac;
      fdz = ((fz < T(0)) == (vz < T(0))) ? fz * p.one_m_fac : fz * p.two_m_fac;
    } else if (p.damping == 4) {
      T crit = T(2) * dsqrt(m * b.cnp[CN_YM * C.NS + n]);
      T fCx = p.fac * dabs(fx) * dsign(vx), fVx = crit * vx;
      T fCz = p.fac * dabs(fz) * dsign(vz), fVz = crit * vz;
      fdx = fx - (dabs(vx) > tiny ? (dabs(fCx) < dabs(fVx) ? fVx : fCx) : T(0));
      fdz = fz - (dabs(vz) > tiny ? (dabs(fCz) < dabs(fVz) ? fVz : fCz) : T(0));
    }
    T vxn = vx + dt * fdx / m;
    T vzn = vz + dt * fdz / m;
    if (b.cnp[CN_MX * C.NS + n] > T(0)) vxn = b.tgt[n];
    if (b.cnp[CN_MZ * C.NS + n] > T(0)) vzn = b.tgt[C.NS + n];
    b.nout[N_CX * C.NS + n] = C.nin(N_CX, n) + vxn * dt;
    b.nout[N_CZ * C.NS + n] = C.nin(N_CZ, n) + vzn * dt;
    b.nout[N_VX * C.NS + n] = vxn;
    b.nout[N_VZ * C.NS + n] = vzn;
    b.nout[N_FX * C.NS + n] = fdx;
    b.nout[N_FZ * C.NS + n] = fdz;
  }
  T s = block_reduce(r2, sh, [](T a, T c) { return a + c; });
  if (threadIdx.x == 0) b.part[3 * b.nb + blockIdx.x] = s;
}

// ---- G, element: post-move volume, CFL partials (refresh steps), mass
// contributions, Jaumann rotation, surface correction and plstrain decay
// (pallas2d.py:993-1099)
template <typename T>
__global__ void __launch_bounds__(BLOCK) phase_g(StepParams<T> p, Bufs<T> b) {
  __shared__ T sh[BLOCK];
  Ctx<T> C(p, b);
  int c = blockIdx.x * BLOCK + threadIdx.x;
  const bool refresh = b.flag[0] > T(0);
  const bool decay = b.flag[1] > T(0);
  T hmin = p.big, hsmin = p.big, vmax = T(0);
  if (c < C.ES) {
    int i = c / p.nzc, j = c % p.nzc;
    const T dt = b.scal[0];
    const T gvs = b.scal[1] * p.inertial;
    T X[2][3], Z[2][3], VX[2][3], VZ[2][3], TT[2][3];
    corners(b.nout + N_CX * C.NS, p.nz, i, j, X);
    corners(b.nout + N_CZ * C.NS, p.nz, i, j, Z);
    corners(b.nout + N_VX * C.NS, p.nz, i, j, VX);
    corners(b.nout + N_VZ * C.NS, p.nz, i, j, VZ);
    corners(b.nin + N_T * C.NS, p.nz, i, j, TT);
    const bool zm = j == p.nzc - 1;
    for (int t = 0; t < 2; ++t) {
      int e = t * C.ES + c;
      T vol = C.ein(E_VOL, e);
      T vn = volume_of(X[t], Z[t]);
      T TinC = mean3(TT[t]) - T(273.0);
      T rho_e = C.ce(CE_RHOA, e) - C.ce(CE_RHOB, e) * TinC;
      T shearm = C.ce(CE_SHEAR, e), bulkm = C.ce(CE_BULK, e);
      if (refresh) {
        T vxm = mean3(VX[t]), vzm = mean3(VZ[t]);
        T vmag = dsqrt(vxm * vxm + vzm * vzm);
        T mh = min_height(X[t], Z[t], vn);
        T swave = dsqrt(shearm / rho_e);
        hmin = dmin(hmin, mh);
        hsmin = dmin(hsmin, mh / swave);
        vmax = dmax(vmax, vmag);
      }
      T rho_q;
      if (p.use_gvs) {
        T app = dmin(gvs, dsqrt(shearm / rho_e));
        rho_q = bulkm / (app * app);
      } else {
        rho_q = p.uniform ? p.rhoq_u : bulkm / p.ps2;
      }
      T rho_m = p.quasi_static ? rho_q : rho_e;
      b.ework[e] = rho_m * vn / T(3);
      b.ework[2 * C.ES + e] =
          (C.ce(CE_CPA, e) - C.ce(CE_CPB, e) * TinC) * vn / T(3);
      b.ework[4 * C.ES + e] = C.ce(CE_HMA, e) * vn;

      T st[3], sn[3], ed[3];
      for (int a = 0; a < 3; ++a) {
        st[a] = C.eout(E_STRESS + a, e);
        sn[a] = C.eout(E_STRAIN + a, e);
        ed[a] = C.eout(E_SR + a, e);
      }
      T pls = C.eout(E_PLS, e);
      if (p.jaumann) {  // Jaumann rotation (fields.cxx:832-907)
        Shape<T> s2 = shape_fn(X[t], Z[t], vn);
        T w2 = T(0.5) * ((VZ[t][0] * s2.dndx[0] + VZ[t][1] * s2.dndx[1] +
                          VZ[t][2] * s2.dndx[2]) -
                         (VX[t][0] * s2.dndz[0] + VX[t][1] * s2.dndz[1] +
                          VX[t][2] * s2.dndz[2]));
        T wdt = w2 * dt;
        T r0 = st[0] - T(2) * st[2] * wdt, r1 = st[1] + T(2) * st[2] * wdt,
          r2 = st[2] + (st[0] - st[1]) * wdt;
        st[0] = r0; st[1] = r1; st[2] = r2;
        r0 = sn[0] - T(2) * sn[2] * wdt; r1 = sn[1] + T(2) * sn[2] * wdt;
        r2 = sn[2] + (sn[0] - sn[1]) * wdt;
        sn[0] = r0; sn[1] = r1; sn[2] = r2;
      }
      T vold = vol;
      if (p.surf_corr) {  // correct_surface_element (bc.cxx:1613-1665)
        T rdv = vn / vol;
        T sc = (zm && rdv >= T(1)) ? T(1) / rdv : T(1);
        for (int a = 0; a < 3; ++a) {
          st[a] = st[a] * sc;
          sn[a] = sn[a] * sc;
          ed[a] = ed[a] * sc;
        }
        pls = pls * sc;
        vold = zm ? vn : vol;
        // surface_plstrain_diffusion (bc.cxx:1591-1611)
        bool applies;
        if (p.uniform) {
          applies = p.decay_uniform != 0;
        } else {
          T w[MAXMAT];
          C.weights(e, w);
          T dom = w[0];
          int dom_m = 0;
          for (int m = 1; m < p.nmat; ++m) {
            if (w[m] > dom) dom_m = m;
            dom = dmax(dom, w[m]);
          }
          applies = dom_m != p.oceanic;
        }
        T lam_dt = p.lam_hl * dt;
        pls = pls - ((decay && zm && applies) ? pls * lam_dt : T(0));
      }
      C.put(E_VOL, e, vn);
      C.put(E_VOLD, e, vold);
      for (int a = 0; a < 3; ++a) {
        C.put(E_STRESS + a, e, st[a]);
        C.put(E_STRAIN + a, e, sn[a]);
        C.put(E_SR + a, e, ed[a]);
      }
      C.put(E_PLS, e, pls);
    }
  }
  if (refresh) {  // uniform across the grid
    T r = block_reduce(hmin, sh, [](T a, T q) { return dmin(a, q); });
    if (threadIdx.x == 0) b.part[blockIdx.x] = r;
    r = block_reduce(hsmin, sh, [](T a, T q) { return dmin(a, q); });
    if (threadIdx.x == 0) b.part[b.nb + blockIdx.x] = r;
    r = block_reduce(vmax, sh, [](T a, T q) { return dmax(a, q); });
    if (threadIdx.x == 0) b.part[2 * b.nb + blockIdx.x] = r;
  }
}

// ---- H, node: volume_n, mass, tmass, hmass (pallas2d.py:1035-1038)
template <typename T>
__global__ void __launch_bounds__(BLOCK) phase_h(StepParams<T> p, Bufs<T> b) {
  Ctx<T> C(p, b);
  int n = blockIdx.x * BLOCK + threadIdx.x;
  if (n >= C.NS) return;
  int i = n / p.nz, j = n % p.nz;
  const T* vol = b.eout + E_VOL * 2 * C.ES;
  b.nout[N_VOLN * C.NS + n] = asm_equal<T>(
      [&](int t, int c) { return vol[t * C.ES + c]; }, i, j, p.nxc, p.nzc);
  const int slot[3] = {N_MASS, N_TMASS, N_HMASS};
  for (int q = 0; q < 3; ++q) {
    const T* w = b.ework + q * 2 * C.ES;
    b.nout[slot[q] * C.NS + n] = asm_equal<T>(
        [&](int t, int c) { return w[t * C.ES + c]; }, i, j, p.nxc, p.nzc);
  }
}

// ---- dt_refresh: after each step of a chunk (pallas2d.py:1276-1304 for
// the resident chunk, :1490-1526 for the tiled step, pallas3d.py:1649-1690
// for the 3D step): record dt, finish the partials in a fixed order,
// advance time (tiled) and on refresh steps set dt, vmax and gdtmin.  With
// `every` (the 3D step) vmax and gdtmin are set on every step and only dt
// waits for the refresh cadence.  One block.

// ops/fused_common.py RIP_FIELDS / RFP_FIELDS, shared by the 2D and 3D plans
template <typename T> struct RefreshParams {
  int thermal, use_gvs, quasi_static, fixed_on;
  T big, max_vbc, fixed_dt, tdmax, inertial, swave_ref, ps, frac;
};

template <typename T>
RefreshParams<T> refresh_from_host(const int* ip, const double* fp) {
  RefreshParams<T> p;
  p.thermal = ip[0]; p.use_gvs = ip[1]; p.quasi_static = ip[2];
  p.fixed_on = ip[3];
  T* f[8] = {&p.big, &p.max_vbc, &p.fixed_dt, &p.tdmax, &p.inertial,
             &p.swave_ref, &p.ps, &p.frac};
  for (int i = 0; i < 8; ++i) *f[i] = static_cast<T>(fp[i]);
  return p;
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
    dt_refresh(RefreshParams<T> p, const T* part, int nb, T* scal, T* dthist,
               const T* flag, int k, int tiled, int every) {
  __shared__ T sh[BLOCK];
  T hmin = p.big, hsmin = p.big, vm = T(0), r2 = T(0);
  for (int q = threadIdx.x; q < nb; q += BLOCK) {
    hmin = dmin(hmin, part[q]);
    hsmin = dmin(hsmin, part[nb + q]);
    vm = dmax(vm, part[2 * nb + q]);
    r2 = r2 + part[3 * nb + q];
  }
  hmin = block_reduce(hmin, sh, [](T a, T q) { return dmin(a, q); });
  hsmin = block_reduce(hsmin, sh, [](T a, T q) { return dmin(a, q); });
  vm = block_reduce(vm, sh, [](T a, T q) { return dmax(a, q); });
  r2 = block_reduce(r2, sh, [](T a, T q) { return a + q; });
  if (threadIdx.x != 0) return;
  T dt_old = scal[0];
  dthist[k] = dt_old;
  scal[4] = r2;
  if (tiled) scal[3] = scal[3] + dt_old;
  const bool refresh = flag[0] > T(0);
  if (!refresh && !every) return;
  T vmax = dmax(vm, p.max_vbc);
  T gdtmin = hsmin / T(5);
  scal[1] = vmax;
  scal[2] = gdtmin;
  if (!refresh) return;
  T half = T(0.5) * hmin;
  T dt;
  if (p.fixed_on) {
    dt = p.fixed_dt;
  } else {
    T dt_diff = p.thermal ? half * hmin / p.tdmax : p.big;
    T dt_adv, dt_el;
    if (p.use_gvs) {
      dt_adv = half / vmax;
      dt_el = dmax(p.quasi_static ? half / (vmax * p.inertial)
                                  : half / p.swave_ref,
                   gdtmin);
    } else {
      dt_adv = half / p.max_vbc;
      dt_el = half / (p.quasi_static ? p.ps : p.swave_ref);
    }
    dt = dmin(dmin(dt_el, scal[5]), dmin(dt_adv, dt_diff)) * p.frac;
  }
  scal[0] = dt;
}

template <typename T>
int step(const int* ip, const double* fp, Bufs<T> b, cudaStream_t s) {
  StepParams<T> p = from_host<T>(ip, fp);
  if (!p.uniform && p.nmat > MAXMAT) return int(cudaErrorInvalidValue);
  const int gc = (p.nxc * p.nzc + BLOCK - 1) / BLOCK;
  const int gn = (p.nx * p.nz + BLOCK - 1) / BLOCK;
  if (gc > b.nb || gn > b.nb) return int(cudaErrorInvalidValue);
  cudaError_t e;
#define DES_LAUNCH(K, G)                      \
  K<T><<<G, BLOCK, 0, s>>>(p, b);             \
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  DES_LAUNCH(phase_a, gc)
  DES_LAUNCH(phase_b, gn)
  DES_LAUNCH(phase_c, gc)
  if (p.nmd) { DES_LAUNCH(phase_d, gn) }
  DES_LAUNCH(phase_e, gc)
  DES_LAUNCH(phase_f, gn)
  DES_LAUNCH(phase_g, gc)
  DES_LAUNCH(phase_h, gn)
#undef DES_LAUNCH
  return 0;
}

}  // namespace

extern "C" {

// One fused step.  Returns 0 or the cudaError_t of the first launch that
// failed (launches are checked one by one; faults during the run surface
// at the caller's next synchronisation).
int des_fused2d_step_f32(const int* ip, const double* fp, const float* ein,
                         const float* nin, float* eout, float* nout,
                         const float* cep, const float* cnp, const float* tgt,
                         const float* scal, const float* flag, float* ework,
                         float* nwork, float* part, int nb, void* stream) {
  Bufs<float> b{ein, nin, eout, nout, cep, cnp, tgt, scal, flag, ework,
                nwork, part, nb};
  return step<float>(ip, fp, b, static_cast<cudaStream_t>(stream));
}

// rip/rfp: ops/fused_common.refresh_params of a 2D or 3D step plan
int des_dt_refresh_f32(const int* rip, const double* rfp, const float* part,
                       int nb, float* scal, float* dthist, const float* flag,
                       int k, int tiled, int every, void* stream) {
  RefreshParams<float> p = refresh_from_host<float>(rip, rfp);
  dt_refresh<float><<<1, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      p, part, nb, scal, dthist, flag, k, tiled, every);
  return int(cudaGetLastError());
}

const char* des_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
