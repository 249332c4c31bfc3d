// Fused 2D structured time steps, a whole chunk per launch, and the
// per-step dt refresh, for Hopper (sm_90a).
//
// Replaces: dynearthsol_tpu/ops/pallas2d.py make_pallas_step -> kernel /
// _core / _tile (pallas_call at pallas2d.py:1431, the per-step tiled step)
// and kernel_res (pallas_call at pallas2d.py:1330: n steps of _core with
// the state resident, dt refreshed in-kernel from full-mesh reductions,
// :1279-1304).  Plain PyTorch version: ops/fused2d.py step_planes_plain
// and dt_refresh_plain.
//
// What bounds it on this card: memory traffic.  A step reads and writes
// the 17 element planes (2 * nxc * nzc each) and 11 nodal planes (nx * nz)
// of the state, f32: at the 512 x 256-cell flagship about 41 MB, a few
// hundred flops per element and no matrix work, far below the card's
// flop/byte balance.  The TPU kernel kept the planes in VMEM and recomputed
// a stencil halo per tile; a Hopper SM has no such buffer, and the
// element->node->element->node chain of the step needs a grid-wide barrier
// at each hop.
//
// The design: one persistent cooperative kernel per chunk (step_chunk2d).
// The grid is as many 256-thread blocks as the card holds at once, at most
// one per virtual block; each block walks the virtual blocks vb =
// blockIdx.x, blockIdx.x + gridDim.x, ... of 256 cells (both triangles) or
// nodes of a phase, z contiguous so that neighbouring threads load
// neighbouring addresses, and a grid-wide barrier (cooperative_groups
// grid sync) stands where a kernel boundary stood: A element, B node, C
// element, D node (NMD), E element, F node, G element, then the dt refresh
// and H node.  Intermediates pass through small scratch planes (ework 7
// planes, nwork 2).  ein/eout and nin/nout swap at every step boundary
// inside the kernel; the caller learns from the parity of n which buffer
// holds the result.  A chunk costs the host one launch; the one-step form
// (the tiled runner, vbc targets probed by the host every step) is the
// same kernel with n = 1.  The refresh runs in the last block, which has
// the least work of the H interval.  The 50 MB L2 does not hold a chunk's
// ~58 MB of planes and scratch, so no residency is promised.
//
// Node sums reproduce the stencil assembly of pallas2d.py asm_local /
// asm_equal_local / _pad4: each node adds its up-to-four cells' corner
// contributions in the fixed order 00, 10, 11, 01, with the triangle
// parity of ops/structured.py.  No float atomics: min/max partials are
// exact in any order and the force-residual sum is a fixed two-pass tree
// (one partial per virtual block, the final pass in the refresh), so reruns
// are bit-identical, and a chunk equals its steps launched one by one.
//
// Scalars stay on the device: dt, vmax, gdtmin, time, the last L2 partial
// and dt_maxwell are read from / written to `scal`, the refresh and decay
// flags of each step from `flag`.  Planes and scalars written earlier in
// the same launch are read with plain (coherent) loads after a grid sync,
// never through the non-coherent path: no __restrict__, no __ldg.
//
// Built without FMA contraction (-fmad=false, ops/_build.py): every +, -,
// * and / then rounds as in the plain PyTorch version, which is the price
// of an initial volume equal to the step's volume bit for bit (a 1-ulp
// volume difference is multiplied by the bulk modulus every step through
// the maxwell dv = V/V_old - 1).  The kernels are templated on the scalar
// type; this path instantiates float, as the fused-step gate requires.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>

#include "rheology2d.cuh"

using namespace des;
namespace cg = cooperative_groups;

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
// ework planes (ops/fused2d.py NEWORK): E's force contributions take 0-5;
// A's T-diffusion corners 0-2 and dvoldt term 3; G's mass terms 4-6, so
// that the next step's A writes none of the planes H still reads
enum { W_DV = 3, W_MASS = 4 };
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
// T here, once, as JAX rounds a Python float constant.  The caller has
// refused nmat > MAXMAT.
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
  for (int m = 0; m < p.nmat && m < MAXMAT; ++m) {
    T* v = &p.mat[m].pw;  // MatConst is NMATFIELD consecutive T
    for (int q = 0; q < NMATFIELD; ++q)
      v[q] = static_cast<T>(mf[m * NMATFIELD + q]);
  }
  return p;
}

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

// The same values from a 2D step plan (rounded from the same float64s)
template <typename T>
RefreshParams<T> refresh_of(const StepParams<T>& p) {
  RefreshParams<T> r;
  r.thermal = p.thermal; r.use_gvs = p.use_gvs;
  r.quasi_static = p.quasi_static; r.fixed_on = p.fixed_on;
  r.big = p.big; r.max_vbc = p.max_vbc; r.fixed_dt = p.fixed_dt;
  r.tdmax = p.tdmax; r.inertial = p.inertial; r.swave_ref = p.swave_ref;
  r.ps = p.ps; r.frac = p.frac;
  return r;
}

// The buffers of one step.  The state planes and scal are written in the
// launch that reads them, so none of them is const.
template <typename T> struct Bufs {
  T* ein;          // (17, 2, nxc, nzc) state before the step
  T* nin;          // (11, nx, nz)
  T* eout;         // state after the step
  T* nout;
  const T* cep;    // (12 + nmat, 2, nxc, nzc) or null (single material)
  const T* cnp;    // (4, nx, nz)
  const T* tgt;    // (2, nx, nz) vbc targets
  T* scal;         // dt, vmax, gdtmin, time, r2, dt_maxwell
  const T* flag;   // refresh, decay of this step
  T* dthist;       // dt of each step of the chunk
  T* ework;        // (7, 2, nxc, nzc) scratch
  T* nwork;        // (2, nx, nz) scratch
  T* part;         // (4, nb) partials, one column per virtual block
  int nb;
};

// U: a single material (StepParams::uniform), whose per-element constants
// are plan scalars and whose mixers fold to one material in registers
template <typename T, bool U> struct Ctx {
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
  __device__ T* work(int slot) const { return b.ework + slot * 2 * ES; }
  __device__ T ce(int slot, int e) const {
    return U ? p.ce[slot] : b.cep[slot * 2 * ES + e];
  }
  __device__ int nmat() const { return U ? 1 : p.nmat; }
  __device__ void weights(int e, T* w) const {
    if constexpr (U) {
      w[0] = T(1);
    } else {
      for (int m = 0; m < p.nmat; ++m) w[m] = b.cep[(NCE0 + m) * 2 * ES + e];
    }
  }
  __device__ Moduli<T> moduli(int e) const {
    Moduli<T> k;
    k.bulkm = ce(CE_BULK, e);
    k.shearm = ce(CE_SHEAR, e);
    if constexpr (U) {
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

// the nodes of triangle t of cell (i, j), n00 = i * nz + j: triangle 0 =
// (n00, n10, P ? n11 : n01), triangle 1 = (P ? n00 : n10, n11, n01).  The
// element phases walk a cell's two triangles in a loop that is not
// unrolled, each triangle's corners loaded into registers: no array is
// indexed by the triangle (which would put it in local memory), and half
// the corner values are live at a time.
__device__ __forceinline__ void tri_nodes(int n00, int nz, bool P, int t,
                                          int nd[3]) {
  const int n10 = n00 + nz, n01 = n00 + 1, n11 = n10 + 1;
  if (t == 0) {
    nd[0] = n00; nd[1] = n10; nd[2] = P ? n11 : n01;
  } else {
    nd[0] = P ? n00 : n10; nd[1] = n11; nd[2] = n01;
  }
}

// a nodal plane at a triangle's three nodes
template <typename T>
__device__ __forceinline__ void gather3(const T* g, const int nd[3], T v[3]) {
  v[0] = g[nd[0]]; v[1] = g[nd[1]]; v[2] = g[nd[2]];
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

template <typename T> struct MinOp {
  __device__ T operator()(T a, T q) const { return dmin(a, q); }
};
template <typename T> struct MaxOp {
  __device__ T operator()(T a, T q) const { return dmax(a, q); }
};
template <typename T> struct AddOp {
  __device__ T operator()(T a, T q) const { return a + q; }
};

// ---- The phases.  Each computes one cell c (both triangles) or one node
// n; a thread past the end of the plane skips the work and returns.

// ---- A, element: T-diffusion contributions and dvoldt terms
// (pallas2d.py:703-744)
template <typename T, bool U>
__device__ __forceinline__ void phase_a(const Ctx<T, U>& C, int c) {
  if (c >= C.ES) return;
  const StepParams<T>& p = C.p;
  const T* nin = C.b.nin;
  int i = c / p.nzc, j = c % p.nzc;
  const int n00 = i * p.nz + j;
  const bool P = parity(i, j);
#pragma unroll 1
  for (int t = 0; t < 2; ++t) {
    int nd[3];
    tri_nodes(n00, p.nz, P, t, nd);
    T X[3], Z[3], VX[3], VZ[3], TT[3];
    gather3(nin + N_CX * C.NS, nd, X);
    gather3(nin + N_CZ * C.NS, nd, Z);
    gather3(nin + N_VX * C.NS, nd, VX);
    gather3(nin + N_VZ * C.NS, nd, VZ);
    gather3(nin + N_T * C.NS, nd, TT);
    int e = t * C.ES + c;
    T vol = C.ein(E_VOL, e);
    Shape<T> s = shape_fn(X, Z, vol);
    if (p.thermal) {
      T TinC = mean3(TT) - T(273.0);
      T rho_e = C.ce(CE_RHOA, e) - C.ce(CE_RHOB, e) * TinC;
      T kv = C.ce(CE_KAPPA, e) * vol;
      T source = C.ce(CE_RAD, e) * vol * rho_e / T(3);
      T gtx = s.dndx[0] * TT[0] + s.dndx[1] * TT[1] + s.dndx[2] * TT[2];
      T gtz = s.dndz[0] * TT[0] + s.dndz[1] * TT[1] + s.dndz[2] * TT[2];
      for (int a = 0; a < 3; ++a)
        C.work(a)[e] = kv * (s.dndx[a] * gtx + s.dndz[a] * gtz) - source;
    }
    T sr[3];
    strain_rate(s, VX, VZ, sr);
    C.work(W_DV)[e] = (sr[0] + sr[1]) * vol;
  }
}

// ---- B, node: temperature and dvoldt (pallas2d.py:730-733, :745)
template <typename T, bool U>
__device__ __forceinline__ void phase_b(const Ctx<T, U>& C, int n) {
  if (n >= C.NS) return;
  const StepParams<T>& p = C.p;
  const Bufs<T>& b = C.b;
  int i = n / p.nz, j = n % p.nz;
  const T dt = b.scal[0];
  const T* et = C.work(W_DV);
  T dv = asm_equal<T>([&](int t, int c) { return et[t * C.ES + c]; }, i, j,
                      p.nxc, p.nzc);
  b.nwork[n] = dv / C.nin(N_VOLN, n);
  T Told = C.nin(N_T, n);
  T Tnew = Told;
  if (p.thermal) {
    T tdot = asm_corner<T>(C.work(0), C.work(1), C.work(2), C.ES, i, j,
                           p.nxc, p.nzc);
    Tnew = b.cnp[CN_TOP * C.NS + n] > T(0)
               ? p.surface_T
               : Told - dt * tdot / C.nin(N_TMASS, n);
  }
  b.nout[N_T * C.NS + n] = Tnew;
}

// ---- C, element: edvoldt, strain, constitutive update, dpressure
// (pallas2d.py:746-818)
template <typename T, bool U>
__device__ __forceinline__ void phase_c(const Ctx<T, U>& C, int c) {
  if (c >= C.ES) return;
  const StepParams<T>& p = C.p;
  const Bufs<T>& b = C.b;
  int i = c / p.nzc, j = c % p.nzc;
  const T dt = b.scal[0];
  const int n00 = i * p.nz + j;
  const bool P = parity(i, j);
#pragma unroll 1
  for (int t = 0; t < 2; ++t) {
    int nd[3];
    tri_nodes(n00, p.nz, P, t, nd);
    T X[3], Z[3], VX[3], VZ[3], TT[3], DV[3];
    gather3(b.nin + N_CX * C.NS, nd, X);
    gather3(b.nin + N_CZ * C.NS, nd, Z);
    gather3(b.nin + N_VX * C.NS, nd, VX);
    gather3(b.nin + N_VZ * C.NS, nd, VZ);
    gather3(b.nin + N_T * C.NS, nd, TT);
    gather3(b.nwork, nd, DV);
    int e = t * C.ES + c;
    T vol = C.ein(E_VOL, e);
    Shape<T> s = shape_fn(X, Z, vol);
    T sr[3];
    strain_rate(s, VX, VZ, sr);
    T temp_e = mean3(TT);
    T edv = mean3(DV);
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
    T w[U ? 1 : MAXMAT];
    C.weights(e, w);
    const int nmat = C.nmat();
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
template <typename T, bool U>
__device__ __forceinline__ void phase_d(const Ctx<T, U>& C, int n) {
  if (n >= C.NS) return;
  const StepParams<T>& p = C.p;
  int i = n / p.nz, j = n % p.nz;
  T s = asm_equal<T>(
      [&](int t, int c) {
        int e = t * C.ES + c;
        return C.eout(E_DP, e) * C.ein(E_VOL, e);
      },
      i, j, p.nxc, p.nzc);
  C.b.nwork[C.NS + n] = s / C.nin(N_VOLN, n);
}

// ---- E, element: NMD correction and force contributions
// (pallas2d.py:820-836)
template <typename T, bool U>
__device__ __forceinline__ void phase_e(const Ctx<T, U>& C, int c) {
  if (c >= C.ES) return;
  const StepParams<T>& p = C.p;
  const Bufs<T>& b = C.b;
  int i = c / p.nzc, j = c % p.nzc;
  const int n00 = i * p.nz + j;
  const bool P = parity(i, j);
#pragma unroll 1
  for (int t = 0; t < 2; ++t) {
    int nd[3];
    tri_nodes(n00, p.nz, P, t, nd);
    T X[3], Z[3], TT[3], DP[3];
    gather3(b.nin + N_CX * C.NS, nd, X);
    gather3(b.nin + N_CZ * C.NS, nd, Z);
    gather3(b.nin + N_T * C.NS, nd, TT);
    if (p.nmd) gather3(b.nwork + C.NS, nd, DP);
    int e = t * C.ES + c;
    T vol = C.ein(E_VOL, e);
    Shape<T> s = shape_fn(X, Z, vol);
    T st[3] = {C.eout(E_STRESS, e), C.eout(E_STRESS + 1, e),
               C.eout(E_STRESS + 2, e)};
    if (p.nmd) {
      T ddp = (mean3(DP) - C.eout(E_DP, e)) / T(2);
      st[0] = st[0] + ddp;
      st[1] = st[1] + ddp;
      C.put(E_STRESS, e, st[0]);
      C.put(E_STRESS + 1, e, st[1]);
    }
    T TinC = mean3(TT) - T(273.0);
    T buoy = p.gravity_on ? C.ce(CE_BUOYA, e) - C.ce(CE_BUOYB, e) * TinC
                          : T(0);
    for (int a = 0; a < 3; ++a) {
      C.work(a)[e] = (st[0] * s.dndx[a] + st[2] * s.dndz[a]) * vol;
      C.work(3 + a)[e] = (st[2] * s.dndx[a] + st[1] * s.dndz[a] + buoy) * vol;
    }
  }
}

// ---- F, node: force, damping, velocity + vbc, coordinates
// (pallas2d.py:837-950 without the facet tractions :840-894); returns the
// node's |force|^2 for the L2 partial (0 past the end)
template <typename T, bool U>
__device__ __forceinline__ T phase_f(const Ctx<T, U>& C, int n) {
  if (n >= C.NS) return T(0);
  const StepParams<T>& p = C.p;
  const Bufs<T>& b = C.b;
  int i = n / p.nz, j = n % p.nz;
  const T dt = b.scal[0];
  T fx = -asm_corner<T>(C.work(0), C.work(1), C.work(2), C.ES, i, j, p.nxc,
                        p.nzc);
  T fz = -asm_corner<T>(C.work(3), C.work(4), C.work(5), C.ES, i, j, p.nxc,
                        p.nzc);
  T r2 = fx * fx + fz * fz;
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
  return r2;
}

// CFL metrics of one cell: min height, min height / shear-wave speed,
// max |v| (the neutral elements past the end and off refresh steps)
template <typename T> struct Cfl {
  T hmin, hsmin, vmax;
};

// ---- G, element: post-move volume, CFL metrics (refresh steps), mass
// contributions, Jaumann rotation, surface correction and plstrain decay
// (pallas2d.py:993-1099)
template <typename T, bool U>
__device__ __forceinline__ Cfl<T> phase_g(const Ctx<T, U>& C, int c,
                                          bool refresh, bool decay) {
  const StepParams<T>& p = C.p;
  const Bufs<T>& b = C.b;
  Cfl<T> r{p.big, p.big, T(0)};
  if (c >= C.ES) return r;
  int i = c / p.nzc, j = c % p.nzc;
  const T dt = b.scal[0];
  const T gvs = b.scal[1] * p.inertial;
  const bool zm = j == p.nzc - 1;
  const int n00 = i * p.nz + j;
  const bool P = parity(i, j);
#pragma unroll 1
  for (int t = 0; t < 2; ++t) {
    int nd[3];
    tri_nodes(n00, p.nz, P, t, nd);
    T X[3], Z[3], VX[3], VZ[3], TT[3];
    gather3(b.nout + N_CX * C.NS, nd, X);
    gather3(b.nout + N_CZ * C.NS, nd, Z);
    gather3(b.nout + N_VX * C.NS, nd, VX);
    gather3(b.nout + N_VZ * C.NS, nd, VZ);
    gather3(b.nin + N_T * C.NS, nd, TT);
    int e = t * C.ES + c;
    T vol = C.ein(E_VOL, e);
    T vn = volume_of(X, Z);
    T TinC = mean3(TT) - T(273.0);
    T rho_e = C.ce(CE_RHOA, e) - C.ce(CE_RHOB, e) * TinC;
    T shearm = C.ce(CE_SHEAR, e), bulkm = C.ce(CE_BULK, e);
    if (refresh) {
      T vxm = mean3(VX), vzm = mean3(VZ);
      T vmag = dsqrt(vxm * vxm + vzm * vzm);
      T mh = min_height(X, Z, vn);
      T swave = dsqrt(shearm / rho_e);
      r.hmin = dmin(r.hmin, mh);
      r.hsmin = dmin(r.hsmin, mh / swave);
      r.vmax = dmax(r.vmax, vmag);
    }
    T rho_q;
    if (p.use_gvs) {
      T app = dmin(gvs, dsqrt(shearm / rho_e));
      rho_q = bulkm / (app * app);
    } else {
      rho_q = U ? p.rhoq_u : bulkm / p.ps2;
    }
    T rho_m = p.quasi_static ? rho_q : rho_e;
    C.work(W_MASS)[e] = rho_m * vn / T(3);
    C.work(W_MASS + 1)[e] =
        (C.ce(CE_CPA, e) - C.ce(CE_CPB, e) * TinC) * vn / T(3);
    C.work(W_MASS + 2)[e] = C.ce(CE_HMA, e) * vn;

    T st[3], sn[3], ed[3];
    for (int a = 0; a < 3; ++a) {
      st[a] = C.eout(E_STRESS + a, e);
      sn[a] = C.eout(E_STRAIN + a, e);
      ed[a] = C.eout(E_SR + a, e);
    }
    T pls = C.eout(E_PLS, e);
    if (p.jaumann) {  // Jaumann rotation (fields.cxx:832-907)
      Shape<T> s2 = shape_fn(X, Z, vn);
      T w2 = T(0.5) * ((VZ[0] * s2.dndx[0] + VZ[1] * s2.dndx[1] +
                        VZ[2] * s2.dndx[2]) -
                       (VX[0] * s2.dndz[0] + VX[1] * s2.dndz[1] +
                        VX[2] * s2.dndz[2]));
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
      if constexpr (U) {
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
  return r;
}

// ---- H, node: volume_n, mass, tmass, hmass (pallas2d.py:1035-1038)
template <typename T, bool U>
__device__ __forceinline__ void phase_h(const Ctx<T, U>& C, int n) {
  if (n >= C.NS) return;
  const StepParams<T>& p = C.p;
  int i = n / p.nz, j = n % p.nz;
  const T* vol = C.b.eout + E_VOL * 2 * C.ES;
  C.b.nout[N_VOLN * C.NS + n] = asm_equal<T>(
      [&](int t, int c) { return vol[t * C.ES + c]; }, i, j, p.nxc, p.nzc);
  const int slot[3] = {N_MASS, N_TMASS, N_HMASS};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const T* w = C.work(W_MASS + q);
    C.b.nout[slot[q] * C.NS + n] = asm_equal<T>(
        [&](int t, int c) { return w[t * C.ES + c]; }, i, j, p.nxc, p.nzc);
  }
}

// ---- dt refresh after each step (pallas2d.py:1276-1304 for the resident
// chunk, :1490-1526 for the tiled step, pallas3d.py:1649-1690 for the 3D
// step): record dt, finish the partials in a fixed order, advance time
// (tiled) and on refresh steps set dt, vmax and gdtmin.  With `every` (the
// 3D step) vmax and gdtmin are set on every step and only dt waits for the
// refresh cadence.  Run by one whole block: the last block of the 2D chunk
// kernel, or the one-block dt_refresh launch of the 3D runner.
// sh: 4 * BLOCK values.  The four reductions share one pass of the tree
// of block_reduce (the same pairs, so the same results).
template <typename T>
__device__ __forceinline__ void refresh_body(const RefreshParams<T>& p,
                                             const T* part, int nb, T* scal,
                                             T* dthist, const T* flag, int k,
                                             int tiled, int every, T* sh) {
  T hmin = p.big, hsmin = p.big, vm = T(0), r2 = T(0);
  for (int q = threadIdx.x; q < nb; q += BLOCK) {
    hmin = dmin(hmin, part[q]);
    hsmin = dmin(hsmin, part[nb + q]);
    vm = dmax(vm, part[2 * nb + q]);
    r2 = r2 + part[3 * nb + q];
  }
  T* s0 = sh; T* s1 = sh + BLOCK; T* s2 = sh + 2 * BLOCK; T* s3 = sh + 3 * BLOCK;
  const int x = threadIdx.x;
  s0[x] = hmin; s1[x] = hsmin; s2[x] = vm; s3[x] = r2;
  __syncthreads();
  for (int s = BLOCK / 2; s > 0; s >>= 1) {
    if (x < s) {
      s0[x] = dmin(s0[x], s0[x + s]);
      s1[x] = dmin(s1[x], s1[x + s]);
      s2[x] = dmax(s2[x], s2[x + s]);
      s3[x] = s3[x] + s3[x + s];
    }
    __syncthreads();
  }
  if (x != 0) return;
  hmin = s0[0]; hsmin = s1[0]; vm = s2[0]; r2 = s3[0];
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
__global__ void __launch_bounds__(BLOCK)
    dt_refresh(RefreshParams<T> p, const T* part, int nb, T* scal, T* dthist,
               const T* flag, int k, int tiled, int every) {
  __shared__ T sh[4 * BLOCK];
  refresh_body(p, part, nb, scal, dthist, flag, k, tiled, every, sh);
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// body(i, vb) for the virtual blocks vb = blockIdx.x, blockIdx.x +
// gridDim.x, ... < nvb, i = vb * BLOCK + threadIdx.x.  Every thread of a
// block makes the same iterations, so a body may synchronise the block.
template <class F>
__device__ __forceinline__ void for_vblocks(int nvb, F body) {
  for (int vb = blockIdx.x; vb < nvb; vb += gridDim.x)
    body(vb * BLOCK + threadIdx.x, vb);
}

// ---- The chunk: steps 0..n-1, each with its dt refresh.  flag and dthist
// point at the chunk's first step.  With `stamps`, thread 0 of block 0
// records %globaltimer at the start and after every grid sync (one more
// sync closes the last step); stamp_labels in ops/fused2d.py names the
// intervals.
//
// Why each grid sync stands where it does (what the next interval reads
// that another block wrote, or overwrites that another block may still
// read):
//   after A:  B sums A's dvoldt and T-diffusion planes (ework 0-3) over
//             neighbouring cells.
//   after B:  C gathers B's dvoldt (nwork 0) at neighbouring nodes.
//   after C:  (NMD) D sums C's dpressure over neighbouring cells.
//   after D:  E gathers D's nodal pressure (nwork 1); E also overwrites
//             ework 0-3, which B read (ordered by the sync after B).
//             Without NMD there is no D, and C and E share an interval: E
//             reads only its own cell's C outputs, written by the same
//             thread.
//   after E:  F sums E's force contributions (ework 0-5).
//   after F:  G gathers F's moved coordinates and velocities; G
//             overwrites ework 4-5, which F read.
//   after G:  H sums G's volumes (eout E_VOL) and mass terms (ework 4-6);
//             the refresh finishes F's L2 and G's CFL partials of every
//             block.  Step k+1's A runs in the same interval: it reads the
//             moved mesh (F), T (B) and the volume (G), all before this
//             sync, writes only ework 0-3, which H does not read, and
//             reads nothing H or the refresh writes.
//   after H:  the next B reads H's volume_n and tmass, the refresh's dt
//             (scal[0]), and A's planes.
//
// The register budget is held to 4 blocks per SM (64 registers, some
// spilled), which puts every virtual block of a flagship phase on the card
// at once; on an H100 that is faster than 2 blocks per SM at the 90
// registers the kernel takes uncapped, and than 3 (PERF.md).
template <typename T, bool U>
__global__ void __launch_bounds__(BLOCK, 4)
    step_chunk2d(StepParams<T> p, RefreshParams<T> rp, Bufs<T> b, int n,
                 int tiled, unsigned long long* stamps) {
  __shared__ T sh[4 * BLOCK];  // the refresh's; block_reduce uses BLOCK
  cg::grid_group grid = cg::this_grid();
  const int gc = (p.nxc * p.nzc + BLOCK - 1) / BLOCK;
  const int gn = (p.nx * p.nz + BLOCK - 1) / BLOCK;
  unsigned long long* st =
      blockIdx.x == 0 && threadIdx.x == 0 ? stamps : nullptr;
  if (st) *st++ = globaltimer();
  auto sync = [&]() {
    grid.sync();
    if (st) *st++ = globaltimer();
  };
  // the buffers of step k: in and out swap at every step
  auto step_bufs = [&](int k) {
    Bufs<T> s = b;
    if (k & 1) {
      s.ein = b.eout; s.eout = b.ein;
      s.nin = b.nout; s.nout = b.nin;
    }
    s.flag = b.flag + 2 * k;
    return s;
  };
  {
    const Bufs<T> s = step_bufs(0);
    const Ctx<T, U> C(p, s);
    for_vblocks(gc, [&](int c, int) { phase_a(C, c); });
  }
  sync();
  for (int k = 0; k < n; ++k) {
    const Bufs<T> s = step_bufs(k);
    const Ctx<T, U> C(p, s);
    for_vblocks(gn, [&](int i, int) { phase_b(C, i); });
    sync();
    for_vblocks(gc, [&](int c, int) { phase_c(C, c); });
    if (p.nmd) {
      sync();
      for_vblocks(gn, [&](int i, int) { phase_d(C, i); });
      sync();
    }
    for_vblocks(gc, [&](int c, int) { phase_e(C, c); });
    sync();
    for_vblocks(gn, [&](int i, int vb) {
      T r2 = block_reduce(phase_f(C, i), sh, AddOp<T>());
      if (threadIdx.x == 0) s.part[3 * s.nb + vb] = r2;
    });
    sync();
    const bool refresh = s.flag[0] > T(0);  // uniform across the grid
    const bool decay = s.flag[1] > T(0);
    for_vblocks(gc, [&](int c, int vb) {
      Cfl<T> r = phase_g(C, c, refresh, decay);
      if (refresh) {
        T v = block_reduce(r.hmin, sh, MinOp<T>());
        if (threadIdx.x == 0) s.part[vb] = v;
        v = block_reduce(r.hsmin, sh, MinOp<T>());
        if (threadIdx.x == 0) s.part[s.nb + vb] = v;
        v = block_reduce(r.vmax, sh, MaxOp<T>());
        if (threadIdx.x == 0) s.part[2 * s.nb + vb] = v;
      }
    });
    sync();
    if (blockIdx.x == gridDim.x - 1)
      refresh_body(rp, s.part, s.nb, s.scal, b.dthist, s.flag, k, tiled, 0,
                   sh);
    for_vblocks(gn, [&](int i, int) { phase_h(C, i); });
    if (k + 1 < n) {
      const Bufs<T> s1 = step_bufs(k + 1);
      const Ctx<T, U> C1(p, s1);
      for_vblocks(gc, [&](int c, int) { phase_a(C1, c); });
      sync();
    }
  }
  if (stamps) sync();  // a kernel argument: uniform across the grid
}

// Grid syncs alone, on a grid of the chunk kernel's size: what the
// barriers of a chunk cost without the work between them.
__global__ void __launch_bounds__(BLOCK) grid_barriers(int nsync) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < nsync; ++i) grid.sync();
}

// The chunk kernel's grid: as many blocks as the card holds at once, at
// most one per virtual block.  info (or null): blocks per SM, SMs, grid,
// registers per thread, local (stack) bytes per thread.
template <typename T, bool U>
cudaError_t chunk_grid(int nvb, int* grid, int* info) {
  int dev, sms, bps;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &bps, step_chunk2d<T, U>, BLOCK, 0)) != cudaSuccess)
    return e;
  if (bps < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = nvb < bps * sms ? nvb : bps * sms;
  if (info) {
    cudaFuncAttributes a;
    if ((e = cudaFuncGetAttributes(&a, step_chunk2d<T, U>)) != cudaSuccess)
      return e;
    info[0] = bps; info[1] = sms; info[2] = *grid;
    info[3] = a.numRegs; info[4] = int(a.localSizeBytes);
  }
  return cudaSuccess;
}

template <typename T, bool U>
int launch_chunk(StepParams<T> p, Bufs<T> b, int n, int tiled,
                 unsigned long long* stamps, cudaStream_t s) {
  const int gc = (p.nxc * p.nzc + BLOCK - 1) / BLOCK;
  const int gn = (p.nx * p.nz + BLOCK - 1) / BLOCK;
  if (gc > b.nb || gn > b.nb || n < 1) return int(cudaErrorInvalidValue);
  int grid;
  cudaError_t e = chunk_grid<T, U>(gc > gn ? gc : gn, &grid, nullptr);
  if (e != cudaSuccess) return int(e);
  RefreshParams<T> rp = refresh_of(p);
  void* args[] = {&p, &rp, &b, &n, &tiled, &stamps};
  e = cudaLaunchCooperativeKernel(
      (const void*)step_chunk2d<T, U>, dim3(grid),
      dim3(BLOCK), args, 0, s);
  cudaError_t last = cudaGetLastError();
  return int(e != cudaSuccess ? e : last);
}

}  // namespace

extern "C" {

// Steps 0..n-1 of a chunk in one cooperative launch, each followed by the
// dt refresh (flag and dthist point at the chunk's first step).  After the
// launch the state is in eout/nout if n is odd, in ein/nin if n is even.
// Returns 0 or the cudaError_t of the launch (a refused launch never runs;
// faults during the run surface at the caller's next synchronisation).
int des_fused2d_chunk_f32(const int* ip, const double* fp, float* ein,
                          float* nin, float* eout, float* nout,
                          const float* cep, const float* cnp,
                          const float* tgt, float* scal, const float* flag,
                          float* dthist, float* ework, float* nwork,
                          float* part, int nb, int n, int tiled,
                          unsigned long long* stamps, void* stream) {
  if (!ip[4] && ip[2] > MAXMAT) return int(cudaErrorInvalidValue);
  StepParams<float> p = from_host<float>(ip, fp);
  if (!p.uniform && cep == nullptr) return int(cudaErrorInvalidValue);
  Bufs<float> b{ein, nin, eout, nout, cep, cnp, tgt, scal, flag, dthist,
                ework, nwork, part, nb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.uniform ? launch_chunk<float, true>(p, b, n, tiled, stamps, s)
                   : launch_chunk<float, false>(p, b, n, tiled, stamps, s);
}

// The chunk kernel's grid for nvb virtual blocks; out: blocks per SM, SMs,
// grid, registers per thread, local bytes per thread.
int des_fused2d_chunk_occupancy(int uniform, int nvb, int* out) {
  int grid;
  return int(uniform ? chunk_grid<float, true>(nvb, &grid, out)
                     : chunk_grid<float, false>(nvb, &grid, out));
}

// nsync grid syncs on a cooperative grid of `grid` blocks, nothing else
int des_grid_barriers(int grid, int nsync, void* stream) {
  void* args[] = {&nsync};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)grid_barriers, dim3(grid), dim3(BLOCK),
      args, 0, static_cast<cudaStream_t>(stream));
  cudaError_t last = cudaGetLastError();
  return int(e != cudaSuccess ? e : last);
}

// rip/rfp: ops/fused_common.refresh_params of a 3D step plan
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
