// Fused 3D structured 5-tet time step, for Hopper (sm_90a).
//
// Replaces: dynearthsol_tpu/ops/pallas3d.py make_pallas_step -> kernel /
// _tile (pallas_call at pallas3d.py:1583), one whole 3D step.  Plain
// PyTorch version: ops/fused3d.py step_planes_plain, epilogue and
// finalize_plain.  The per-step scalar update after it is the dt_refresh
// kernel of fused2d.cu, run with every = 1 (vmax and gdtmin each step, dt
// on the 10-step cadence).
//
// Layout (ops/fused3d.py): element planes (slot, tet, i, j, k) and nodal
// planes (slot, i, j, k), k contiguous: cell c = (i*nyc + j)*nzc + k, the
// value of tet t in a slot at slot*5NC + t*NC + c, node (i*ny + j)*nz + k.
// Cell (i, j, k) holds five tets; tet t's corner slot s is the cell corner
// tet_corner(parity, t, s) (structured.tet_tables, corner code a*4 + b*2 +
// d for offsets a, b, d in x, y, z), parity 0 where i + j + k is even.
//
// What bounds it: memory traffic.  A step reads and writes 25 element
// planes (983,040 tets each at the 256 x 48 x 16-cell flagship) and 14
// nodal planes (214,081 nodes) in f32, with a few hundred to a few
// thousand flops per tet (the EVP return map with its eigensolver in phase
// C), below the card's flop/byte balance.  The element->node->element->
// node chain of the step needs a grid-wide barrier at each hop, so it runs
// one launch per phase:
//   A cell  T-diffusion and dvoldt corner partials
//   B node  temperature, dvoldt
//   C tet   the previous step's epilogue (pending), edvoldt, strain,
//           rheology with eig3, dpressure * volume for D
//   D node  NMD nodal pressure (NMD runs only)
//   E cell  NMD correction (in registers), force corner partials
//   F node  force, L2 partial, damping, velocity, coordinates
//   S node  (surface process 1) the top lane's diffusion dh
//   G cell  post-move volumes, CFL partials, mass terms, surface factors
//   H node  volume_n and masses
//
// One pass over the tet state per step.  The step's tensor epilogue (the
// NMD correction of the stored stress, the Jaumann rotation, the surface-
// element scaling; apply_epilogue) would otherwise read and write the 19
// tensor planes twice more (in E and G).  It needs exactly what the next
// step's C has in registers anyway (the moved coordinates and velocities
// are the next step's nodal input, the post-move volume its E_VOL, the
// shape functions the ones C computes), plus the nodal pressure change
// (nwork slot 1, which D of the next step overwrites only after C), the
// old E_DP (read from ein before C writes eout), the step's dt and the
// top-layer surface factors (sfac, written by G).  So the chunk form leaves
// it pending: C applies the previous step's epilogue to the stress, strain
// and plstrain it loads (`pending`), and the finalize kernel applies the
// last step's after a chunk, to the strain rate too.  Planes that no later
// phase or step reads (strain rate, edvoldt, a creep law's viscosity, the
// force, hmass) are stored on the chunk's last step only (`last`).  A
// chunk then gives the State of its complete steps bit for bit.
//
// Phases whose outputs are per-corner sums (A, E) fold a cell's 5 tets
// into 8 corner partials, 8 planes of one value per cell instead of 20
// per-tet slot planes.  They are templated on the cell parity, so that
// corner indices are constants, and no warp runs both paths: a block takes
// 128 cell pairs (k, k+1) along z, one cell of each parity, its first 128
// threads the even cells and the others the odd ones, so the nodes a pair
// shares are loaded within one block.  (A thread holding a whole pair's 12
// nodes, 84 values in A, needed 152 registers, one block per SM, and ran
// slower.)  The rheology (C) runs one thread per tet, which keeps the EVP
// return map's registers to one tet.
//
// G runs per cell too: a cell's 8 corners serve its 5 tets (8 nodal loads
// per field instead of 20), and its blocks, one column of CFL partials
// each, are 256 cells wide, so that dt_refresh (one block) reduces 5 times
// fewer columns than from a block per 256 tets.
//
// Node sums follow ops/fused3d.py (grid3d.asm): for each corner code in
// order, the cell's partial over (tet, slot) in order, each partial and
// each node sum started from zero; which tets of a cell hold a corner code
// comes from a compile-time mask per (parity, code).  No float atomics:
// the min/max partials are exact in any order and the force-residual sum
// is a fixed two-pass tree (block partials here, the final pass in
// dt_refresh).
//
// Material properties (pallas3d.py:825-946): a single material with
// uniform ICs takes them as plan constants (the template switch U);
// otherwise the const pack `cep` holds the radiogenic source and each
// material's raw marker weight per tet, and each phase that reads a
// property mixes it from the weights where it reads it (Props: harmonic
// means of the moduli, arithmetic means of the rest, matprops.cxx:115-144),
// as the TPU kernel recomputes them:
// A (conductivity, density, radiogenic source), C (moduli, the viscosity's
// and the plastic weakening's material loops), E (buoyancy), G (density,
// moduli, heat capacity, the hmass coefficient).  Up to MAXMAT materials
// keep their constants in the kernel argument and a tet's weights in
// registers.  Plans of more materials run the many-material instances of
// A, C, E and G, compiled from this file by fused3d_many.cu (DES_MANY):
// their constants a device table in the run dtype (MAT_FIELDS then
// MIX_FIELDS per material, uploaded once per plan), each weight read from
// the const pack where a mixture uses it (manymat.cuh).  Compiled apart,
// they leave this file's instances as they were, register for register.
// No material count is refused.
//
// Boundary processes (the template switch BND, as X of fused2d.cu's
// step_chunk2d, chosen per plan; the BND = false instances are the flagship
// paths and compile as if BND did not exist):
// - The Winkler and water facet tractions (pallas3d.py:1221-1290,
//   bc.cxx:632-790), which grid3d adds after the residual's partial.  E's
//   bottom-row (k = 0) and top-row (k = nzc - 1) cells compute their two
//   boundary facets (the per-parity (tet, corner codes) groups of
//   ops/fused3d.py grav_facets, in Params3::facets) into per-corner partials
//   of their own (fwork); F adds a boundary node's partials of its up to
//   four cells in corner-code order, after the residual and before
//   damping.  The pressure reads the pre-move coordinates and, for the
//   Winkler density, the owning tet's pre-update temperature and mixture.
// - Surface process 1 (pallas3d.py:1324-1394, surface_dh_3d, bc.cxx:
//   920-1050) runs between the coordinate move and the post-move geometry,
//   and its slopes read the neighbours' moved heights: one more launch, S,
//   over the nx * ny top-lane nodes after F, leaves each top node's dh in
//   nwork slot 0 (free after C; slot 1 still holds the NMD pressure change
//   of the pending epilogue).  G adds dh to the top corners it loads and,
//   per top-row cell, each triangle's deposited volume to its edv plane at
//   the cell's (x0, y0, top) node (diffusion moves z only, the projected
//   area reads x and y); H adds dh to coord_z and dhacc.  Triangle sums
//   go in a fixed order as in ops/fused3d.py surface_process.
//
// Built without FMA contraction (-fmad=false, ops/_build.py): the initial
// volume (ops/shapefn.compute_volume, the same operations) then equals the
// step's volume bit for bit, and every +, -, * and / rounds as in the plain
// version.  Only the transcendental functions (exp, log, sin, tan, cos)
// differ, by the ulps of CUDA's libdevice.

#include <cuda_runtime.h>

#include <cfloat>

#include "rheology3d.cuh"

#ifndef DES_MANY
#define DES_MANY 0
#endif
#if DES_MANY
#include "manymat.cuh"
#endif

using namespace des;

namespace {

constexpr int BLOCK = 256;
// ework planes (of one value per cell): A's corner partials 0-15, E's
// 0-23, C's NMD products dpressure * volume 0-4, G's mass terms 0-14;
// fwork planes (of one value per (x, y) column): E's facet partials,
// (side * 3 + force component) * 4 + corner (a * 2 + b)

// packed slots: ops/fused3d.py E_SLOTS/T_SLOTS, N_SLOTS, CN_SLOTS
enum { E_VOL = 0, E_VOLD, E_PLS, E_DPLS, E_VISC, E_DP, E_EDV, E_STRESS,
       E_STRAIN = E_STRESS + 6, E_SR = E_STRAIN + 6 };
enum { N_CX = 0, N_CY, N_CZ, N_VX, N_VY, N_VZ, N_T, N_MASS, N_TMASS, N_HMASS,
       N_VOLN, N_FX, N_FY, N_FZ, N_DHACC, N_EDVA, N_EDVB };
enum { CN_TOP = 0, CN_MX, CN_MY, CN_MZ };
enum { RH_ELASTIC = 1, RH_VISCOUS = 2, RH_MAXWELL = 3, RH_EP = 5,
       RH_EVP = 7 };
constexpr int NIP0 = 17;  // ops/fused3d.py IP_FIELDS
constexpr int NFP0 = 29;  // ops/fused3d.py FP_FIELDS

// Per-material table values of the mixtures (ops/fused3d.py MIX_FIELDS),
// in the run dtype
template <typename T> struct MixConst {
  T K, G, kappa, rho0, rho0a, phi, cp, biot, ifbm;
};
constexpr int NMIX = 9;

// structured.tet_tables(), 3 bits per (tet, slot) entry, entry t*4 + s:
// even ((0,1,4,2), (1,2,3,7), (1,4,7,5), (2,4,6,7), (1,2,7,4)),
// odd  ((0,1,5,3), (0,2,3,6), (0,4,6,5), (3,5,6,7), (0,3,5,6))
constexpr unsigned long long TET_EVEN = 0x9d1fa2be1ed1508ULL;
constexpr unsigned long long TET_ODD = 0xd58fabba0cd0748ULL;

__host__ __device__ constexpr int tet_corner(int par, int t, int s) {
  return int(((par ? TET_ODD : TET_EVEN) >> (3 * (t * 4 + s))) & 7ULL);
}

// The tets of a cell of parity par that hold corner code q, one bit per
// tet: byte q of tet_masks(par).
constexpr unsigned long long tet_masks(int par) {
  unsigned long long r = 0;
  for (int q = 0; q < 8; ++q)
    for (int t = 0; t < 5; ++t)
      for (int s = 0; s < 4; ++s)
        if (tet_corner(par, t, s) == q) r |= 1ULL << (8 * q + t);
  return r;
}
constexpr unsigned long long MASK_EVEN = tet_masks(0);
constexpr unsigned long long MASK_ODD = tet_masks(1);

__device__ __forceinline__ int tet_mask(int par, int q) {
  return int(((par ? MASK_ODD : MASK_EVEN) >> (8 * q)) & 31ULL);
}

template <typename T> struct Params3 {
  int nx, ny, nz, nxc, nyc, nzc, NC, NS, NT, rheol, nmd, thermal,
      gravity_on, damping, surf_corr, quasi_static, use_gvs, jaumann,
      uniform, nmat;
  T surface_T, visc_min, visc_max, tension_max, fac, one_m_fac, two_m_fac,
      inertial, log_q, log_1e6, deg2rad, ps2, bulkm, shearm, kappa, rhoA,
      rhoB, buoyA, buoyB, cpA, cpB, hmA, g_npe;
  MatConst<T> mat[MAXMAT];
  MixConst<T> mix[MAXMAT];
  // the boundary processes (BND): switches, the facet groups (side: bottom,
  // top; cell parity; group) -> (tet, code0, code1, code2), constants
  int winkler, water, surf_on;
  int facets[2][2][2][4];
  T comp_p, winkler_drho, gravity, zlength, surf_base, surf_diff;
};

// ip/fp are ops/fused3d.py StepPlan3.ip (IP_FIELDS) and .fp (FP_FIELDS,
// then per material its MAT_FIELDS and MIX_FIELDS); each float64 is
// rounded to T once.  The kernel argument holds the first MAXMAT
// materials' constants; the many-material instances read every material's
// from the device table mtab instead (the same values, rounded once on the
// host).
template <typename T>
Params3<T> from_host(const int* ip, const double* fp) {
  Params3<T> p;
  p.nx = ip[0]; p.ny = ip[1]; p.nz = ip[2]; p.rheol = ip[3];
  p.nmd = ip[4]; p.thermal = ip[5]; p.gravity_on = ip[6];
  p.damping = ip[7]; p.surf_corr = ip[8]; p.quasi_static = ip[9];
  p.use_gvs = ip[10]; p.jaumann = ip[11]; p.uniform = ip[12];
  p.nmat = ip[13]; p.winkler = ip[14]; p.water = ip[15]; p.surf_on = ip[16];
  int* fg = &p.facets[0][0][0][0];
  for (int i = 0; i < 32; ++i) fg[i] = ip[NIP0 + i];
  p.nxc = p.nx - 1; p.nyc = p.ny - 1; p.nzc = p.nz - 1;
  p.NT = p.nxc * p.nyc;  // cells of one z layer
  p.NC = p.NT * p.nzc;
  p.NS = p.nx * p.ny * p.nz;
  T* f[NFP0] = {&p.surface_T, &p.visc_min, &p.visc_max, &p.tension_max,
                &p.fac, &p.one_m_fac, &p.two_m_fac, &p.inertial, &p.log_q,
                &p.log_1e6, &p.deg2rad, &p.ps2, &p.bulkm, &p.shearm,
                &p.kappa, &p.rhoA, &p.rhoB, &p.buoyA, &p.buoyB, &p.cpA,
                &p.cpB, &p.hmA, &p.g_npe, &p.comp_p, &p.winkler_drho,
                &p.gravity, &p.zlength, &p.surf_base, &p.surf_diff};
  for (int i = 0; i < NFP0; ++i) *f[i] = static_cast<T>(fp[i]);
  for (int m = 0; m < p.nmat && m < MAXMAT; ++m) {
    const double* mf = fp + NFP0 + m * (NMATFIELD + NMIX);
    T* v = &p.mat[m].pw;  // MatConst is NMATFIELD consecutive T
    for (int q = 0; q < NMATFIELD; ++q) v[q] = static_cast<T>(mf[q]);
    T* x = &p.mix[m].K;   // MixConst is NMIX consecutive T
    for (int q = 0; q < NMIX; ++q) x[q] = static_cast<T>(mf[NMATFIELD + q]);
  }
  return p;
}

template <typename T> struct Bufs3 {
  const T* ein;   // (25, 5, nxc, nyc, nzc) state before the step
  const T* nin;   // (14, nx, ny, nz)
  T* eout;        // state after the step
  T* nout;
  const T* cep;   // (1 + nmat, 5, nxc, nyc, nzc) const pack, or null (U)
  const T* cnp;   // (4, nx, ny, nz)
  const T* tgt;   // (3, nx, ny, nz) vbc targets
  const T* scal;  // dt, vmax, gdtmin, time, r2, dt_maxwell
  T* ework;       // (24, nxc, nyc, nzc) scratch
  T* nwork;       // (2, nx, ny, nz): dvoldt, NMD nodal pressure change
  T* sfac;        // (5, nxc, nyc) surface factors of the top cell layer
  const T* dtp;   // dt of the step whose epilogue ein carries
  T* part;        // (4, nb) block partials
  int nb;
  int pending;    // ein carries the previous step's epilogue
  int last;       // store the planes no later step of the chunk reads
  T* fwork;       // (24, nxc, nyc) facet partials (BND, facets), or null
#if DES_MANY
  const T* mtab;  // (nmat, NMATFIELD + NMIX) per-material constants
#endif
};

// element value of (slot, tet t, cell c)
template <typename T>
__device__ __forceinline__ int eidx(const Params3<T>& p, int slot, int t,
                                    int c) {
  return (slot * 5 + t) * p.NC + c;
}

// node offset of cell corner code q from the cell's corner 0
template <typename T>
__device__ __forceinline__ int corner_off(const Params3<T>& p, int q) {
  return ((q >> 2) & 1) * p.ny * p.nz + ((q >> 1) & 1) * p.nz + (q & 1);
}

template <typename T> struct CellPos {
  int i, j, k, par, n0;  // cell indices, parity, node of corner 0
};

template <typename T>
__device__ __forceinline__ CellPos<T> cell_pos(const Params3<T>& p, int c) {
  CellPos<T> r;
  r.k = c % p.nzc;
  r.j = (c / p.nzc) % p.nyc;
  r.i = c / (p.nzc * p.nyc);
  r.par = (r.i + r.j + r.k) & 1;
  r.n0 = (r.i * p.ny + r.j) * p.nz + r.k;
  return r;
}

// The material properties of tet t of cell c (pallas3d.py CE, W): plan
// constants for a single material (U); else mixed from the raw weights of
// the const pack, each mixture computed where it is read, as
// ops/fused3d.py mixtures orders it: amean = (w0 v0 + w1 v1 + ...) / ws,
// hmean = ws / (w0 / v0 + w1 / v1 + ...), ws the weights' sum (1 where 0).
#if DES_MANY
// The mixtures' table values of a many-material plan: material m's
// MixConst after its MatConst in the device table
template <typename T> struct MixTable {
  const T* t;
  __device__ __forceinline__ MixConst<T> operator[](int m) const {
    const T* s = t + m * (NMATFIELD + NMIX) + NMATFIELD;
    return {__ldg(s), __ldg(s + 1), __ldg(s + 2), __ldg(s + 3),
            __ldg(s + 4), __ldg(s + 5), __ldg(s + 6), __ldg(s + 7),
            __ldg(s + 8)};
  }
};
#endif

template <typename T, bool U> struct Props {
  const Params3<T>& p;
#if DES_MANY
  // more than MAXMAT materials (U false): the tet's weights, planes 5 NC
  // apart in the const pack, and the device table, read by each mixture
  Planes<T> w;
  const T* tab;
  T ws;
  __device__ Props(const Params3<T>& p_, const Bufs3<T>& b, int t, int c)
      : p(p_), w{b.cep + eidx(p_, 1, t, c), 5 * p_.NC}, tab(b.mtab) {
    static_assert(!U, "the many-material instances mix their materials");
    ws = w[0];
    for_mats(1, p.nmat, [&](int m) { ws = ws + w[m]; });
    ws = ws > T(0) ? ws : T(1);
  }
  __device__ MatTable<T> mats() const { return {tab, NMATFIELD + NMIX}; }
  template <class F> __device__ T amean(F f) const {
    const MixTable<T> mix{tab};
    T acc = w[0] * f(mix[0]);
    for_mats(1, p.nmat, [&](int m) { acc = acc + w[m] * f(mix[m]); });
    return acc / ws;
  }
  template <class F> __device__ T hmean(F f) const {
    const MixTable<T> mix{tab};
    T acc = w[0] / f(mix[0]);
    for_mats(1, p.nmat, [&](int m) { acc = acc + w[m] / f(mix[m]); });
    return ws / acc;
  }
#else
  T w[U ? 1 : MAXMAT], ws;
  __device__ Props(const Params3<T>& p_, const Bufs3<T>& b, int t, int c)
      : p(p_) {
    if constexpr (U) {
      w[0] = T(1);
      ws = T(1);
    } else {
      ws = T(0);
#pragma unroll
      for (int m = 0; m < MAXMAT; ++m) {
        w[m] = m < p.nmat ? b.cep[eidx(p, 1 + m, t, c)] : T(0);
        if (m == 0) ws = w[0];
        else if (m < p.nmat) ws = ws + w[m];
      }
      ws = ws > T(0) ? ws : T(1);
    }
  }
  template <class F> __device__ T amean(F f) const {
    T acc = w[0] * f(p.mix[0]);
#pragma unroll
    for (int m = 1; m < MAXMAT; ++m)
      if (m < p.nmat) acc = acc + w[m] * f(p.mix[m]);
    return acc / ws;
  }
  template <class F> __device__ T hmean(F f) const {
    T acc = w[0] / f(p.mix[0]);
#pragma unroll
    for (int m = 1; m < MAXMAT; ++m)
      if (m < p.nmat) acc = acc + w[m] / f(p.mix[m]);
    return ws / acc;
  }
#endif
  __device__ T bulkm() const {
    if constexpr (U) return p.bulkm;
    else return hmean([](const MixConst<T>& q) { return q.K; });
  }
  __device__ T shearm() const {
    if constexpr (U) return p.shearm;
    else return hmean([](const MixConst<T>& q) { return q.G; });
  }
  __device__ T kappa() const {
    if constexpr (U) return p.kappa;
    else return amean([](const MixConst<T>& q) { return q.kappa; });
  }
  __device__ T rhoA() const {
    if constexpr (U) return p.rhoA;
    else return amean([](const MixConst<T>& q) { return q.rho0; });
  }
  __device__ T rhoB() const {
    if constexpr (U) return p.rhoB;
    else return amean([](const MixConst<T>& q) { return q.rho0a; });
  }
  __device__ T phi() const {
    return amean([](const MixConst<T>& q) { return q.phi; });
  }
  __device__ T buoyA() const {
    if constexpr (U) {
      return p.buoyA;
    } else {
      const T f = phi();
      return ((T(1) - f) * rhoA() + T(1000) * f) * p.g_npe;
    }
  }
  __device__ T buoyB() const {
    if constexpr (U) return p.buoyB;
    else return (T(1) - phi()) * rhoB() * p.g_npe;
  }
  __device__ T cpA() const {
    if constexpr (U) return p.cpA;
    else return amean([](const MixConst<T>& q) { return q.cp; }) * rhoA();
  }
  __device__ T cpB() const {
    if constexpr (U) return p.cpB;
    else return amean([](const MixConst<T>& q) { return q.cp; }) * rhoB();
  }
  // 3D bulk_comp = 1/K (geometry.cxx:1098)
  __device__ T hmA() const {
    if constexpr (U) {
      return p.hmA;
    } else {
      const T f = phi();
      const T ab = amean([](const MixConst<T>& q) { return q.biot; });
      return ((ab + f - ab * f) / bulkm() +
              f * hmean([](const MixConst<T>& q) { return q.ifbm; })) /
             T(4);
    }
  }
};

template <typename T> struct Shape3 {
  T dx[4], dy[4], dz[4];
};

// P1 tet gradients (ops/fused3d.py shape_fn)
template <typename T>
__device__ __forceinline__ Shape3<T> shape3(const T* xs, const T* ys,
                                            const T* zs, T vol) {
  Shape3<T> s;
  T iv = T(1) / (T(6) * vol);
  T x01 = xs[0] - xs[1], x02 = xs[0] - xs[2], x03 = xs[0] - xs[3];
  T x12 = xs[1] - xs[2], x13 = xs[1] - xs[3], x23 = xs[2] - xs[3];
  T y01 = ys[0] - ys[1], y02 = ys[0] - ys[2], y03 = ys[0] - ys[3];
  T y12 = ys[1] - ys[2], y13 = ys[1] - ys[3], y23 = ys[2] - ys[3];
  T z01 = zs[0] - zs[1], z02 = zs[0] - zs[2], z03 = zs[0] - zs[3];
  T z12 = zs[1] - zs[2], z13 = zs[1] - zs[3], z23 = zs[2] - zs[3];
  s.dx[0] = iv * (y13 * z12 - y12 * z13);
  s.dx[1] = iv * (y02 * z23 - y23 * z02);
  s.dx[2] = iv * (y13 * z03 - y03 * z13);
  s.dx[3] = iv * (y01 * z02 - y02 * z01);
  s.dy[0] = iv * (z13 * x12 - z12 * x13);
  s.dy[1] = iv * (z02 * x23 - z23 * x02);
  s.dy[2] = iv * (z13 * x03 - z03 * x13);
  s.dy[3] = iv * (z01 * x02 - z02 * x01);
  s.dz[0] = iv * (x13 * y12 - x12 * y13);
  s.dz[1] = iv * (x02 * y23 - x23 * y02);
  s.dz[2] = iv * (x13 * y03 - x03 * y13);
  s.dz[3] = iv * (x01 * y02 - x02 * y01);
  return s;
}

template <typename T>
__device__ __forceinline__ T dot4(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3];
}

template <typename T> __device__ __forceinline__ T mean4(const T* a) {
  return (a[0] + a[1] + a[2] + a[3]) / T(4);
}

// scalar triple product over 6 (ops/shapefn.tet_volume)
template <typename T>
__device__ __forceinline__ T tet_volume(const T* xs, const T* ys,
                                        const T* zs) {
  T d1x = xs[1] - xs[0], d1y = ys[1] - ys[0], d1z = zs[1] - zs[0];
  T d2x = xs[2] - xs[0], d2y = ys[2] - ys[0], d2z = zs[2] - zs[0];
  T d3x = xs[3] - xs[0], d3y = ys[3] - ys[0], d3z = zs[3] - zs[0];
  return (d1x * (d2y * d3z - d2z * d3y) + d1y * (d2z * d3x - d2x * d3z) +
          d1z * (d2x * d3y - d2y * d3x)) /
         T(6);
}

// 3 V / largest facet area (ops/geometry.tet_min_height)
template <typename T>
__device__ __forceinline__ T tri_area(const T* xs, const T* ys, const T* zs,
                                      int i, int j, int k) {
  T ux = xs[j] - xs[i], uy = ys[j] - ys[i], uz = zs[j] - zs[i];
  T vx = xs[k] - xs[i], vy = ys[k] - ys[i], vz = zs[k] - zs[i];
  T cx = uy * vz - uz * vy;
  T cy = uz * vx - ux * vz;
  T cz = ux * vy - uy * vx;
  return T(0.5) * dsqrt(cx * cx + cy * cy + cz * cz);
}

template <typename T>
__device__ __forceinline__ T tet_min_height(const T* xs, const T* ys,
                                            const T* zs, T vol) {
  T maxa = dmax(dmax(tri_area(xs, ys, zs, 0, 1, 2), tri_area(xs, ys, zs, 0, 1, 3)),
                dmax(tri_area(xs, ys, zs, 2, 3, 0), tri_area(xs, ys, zs, 2, 3, 1)));
  return T(3) * vol / maxa;
}

// the four corner values of tet t of a cell from a nodal plane
template <typename T>
__device__ __forceinline__ void tet_gather(const Params3<T>& p, const T* g,
                                           const CellPos<T>& cp, int t,
                                           T out[4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
    out[s] = g[cp.n0 + corner_off(p, tet_corner(cp.par, t, s))];
}

// The cell of a thread of a cell phase (A, E, G): each block takes
// BLOCK / 2 cell pairs (k, k+1) along z, its first half of threads the
// pairs' even cells and its second half their odd cells, so that every
// warp runs one parity's template path and the two cells that share a
// pair's four middle nodes load them in one block.
template <typename T> struct CellOf {
  int c, k, n0, odd;
};

template <typename T>
__device__ __forceinline__ bool cell_of_thread(const Params3<T>& p,
                                               CellOf<T>& r) {
  r.odd = threadIdx.x >= BLOCK / 2;
  const int pr = blockIdx.x * (BLOCK / 2) + threadIdx.x % (BLOCK / 2);
  if (pr >= p.NC / 2) return false;
  const CellPos<T> lo = cell_pos(p, 2 * pr);  // k even
  const int up = r.odd ? 1 - lo.par : lo.par;
  r.c = 2 * pr + up;
  r.k = lo.k + up;
  r.n0 = lo.n0 + up;
  return true;
}

// Node (i, j, k): sum over corner codes q (cell (i-a, j-b, k-d)) of the
// cell's per-code partial part(q, cell), each code in order, from zero.
template <typename T, class F>
__device__ __forceinline__ T node_sum(const Params3<T>& p, int i, int j,
                                      int k, F part) {
  T acc = T(0);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int ci = i - ((q >> 2) & 1), cj = j - ((q >> 1) & 1),
              ck = k - (q & 1);
    if (ci >= 0 && ci < p.nxc && cj >= 0 && cj < p.nyc && ck >= 0 &&
        ck < p.nzc) {
      const int cell = (ci * p.nyc + cj) * p.nzc + ck;
      acc = acc + part(q, cell, (ci + cj + ck) & 1);
    }
  }
  return acc;
}

// The per-code partial of a per-tet value v(t, cell) that lands equally on
// its four corners (ops/fused3d.asm_equal): tets in order, from zero.
template <typename T, class F>
__device__ __forceinline__ T equal_partial(F v, int q, int cell, int par) {
  const int m = tet_mask(par, q);
  T acc = T(0);
#pragma unroll
  for (int t = 0; t < 5; ++t)
    if ((m >> t) & 1) acc = acc + v(t, cell);
  return acc;
}

// fixed-order tree reduction over one block
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

// The CFL partials of one block, for its thread 0: min, min and max over
// the block, exact in any order (shuffles within each warp, then the
// warps' values from shared memory).  Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void cfl_reduce(T& hmin, T& hsmin, T& vmax,
                                           T (*sh)[BLOCK / 32]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    hmin = dmin(hmin, __shfl_xor_sync(0xffffffffu, hmin, o));
    hsmin = dmin(hsmin, __shfl_xor_sync(0xffffffffu, hsmin, o));
    vmax = dmax(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
  }
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sh[0][w] = hmin;
    sh[1][w] = hsmin;
    sh[2][w] = vmax;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 1; q < BLOCK / 32; ++q) {
      hmin = dmin(hmin, sh[0][q]);
      hsmin = dmin(hsmin, sh[1][q]);
      vmax = dmax(vmax, sh[2][q]);
    }
  }
}

// Jaumann rotation of a symmetric tensor (fields.cxx:832-907)
template <typename T>
__device__ __forceinline__ void jaumann(T q[6], T w3t, T w4t, T w5t) {
  T r0 = q[0] - T(2) * q[3] * w3t - T(2) * q[4] * w4t;
  T r1 = q[1] + T(2) * q[3] * w3t - T(2) * q[5] * w5t;
  T r2 = q[2] + T(2) * q[4] * w4t + T(2) * q[5] * w5t;
  T r3 = q[3] + (q[0] - q[1]) * w3t - q[4] * w5t - q[5] * w4t;
  T r4 = q[4] + (q[0] - q[2]) * w4t + q[3] * w5t - q[5] * w3t;
  T r5 = q[5] + (q[1] - q[2]) * w5t + q[3] * w4t + q[4] * w3t;
  q[0] = r0; q[1] = r1; q[2] = r2; q[3] = r3; q[4] = r4; q[5] = r5;
}

// The tensor epilogue of a step (ops/fused3d.py epilogue), deferred by the
// chunk form: phase C of the next step applies it to the stress, strain
// and plstrain it loads, the finalize kernel after a chunk's last step
// (then to the strain rate sr too).  In order: the NMD correction of the
// stress diagonal from the tet's nodal pressure changes dps and its old
// dpressure (pallas3d.py:1176-1205); the Jaumann rotation with the step's
// dt, the moved mesh's velocities and shape functions sh; the surface-
// element scaling of the top cell layer by sc (bc.cxx:1613-1665).
template <typename T>
__device__ __forceinline__ void apply_epilogue(
    const Params3<T>& p, const Shape3<T>& sh, const T* vx, const T* vy,
    const T* vz, T dt, const T* dps, T dp_old, bool top, T sc, T st[6],
    T sn[6], T* sr, T& pls) {
  if (p.nmd) {
    const T ddp = (mean4(dps) - dp_old) / T(3);
#pragma unroll
    for (int a = 0; a < 3; ++a) st[a] = st[a] + ddp;
  }
  if (p.jaumann) {
    const T w3t = T(0.5) * (dot4(vx, sh.dy) - dot4(vy, sh.dx)) * dt;
    const T w4t = T(0.5) * (dot4(vx, sh.dz) - dot4(vz, sh.dx)) * dt;
    const T w5t = T(0.5) * (dot4(vy, sh.dz) - dot4(vz, sh.dy)) * dt;
    jaumann(st, w3t, w4t, w5t);
    jaumann(sn, w3t, w4t, w5t);
  }
  if (p.surf_corr && top) {
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      st[a] = st[a] * sc;
      sn[a] = sn[a] * sc;
      if (sr) sr[a] = sr[a] * sc;
    }
    pls = pls * sc;
  }
}

// the surface factor of tet t of top-layer cell c
template <typename T>
__device__ __forceinline__ int sfac_idx(const Params3<T>& p, int t, int c) {
  return t * p.NT + c / p.nzc;
}

// ---- A, cell: T-diffusion and dvoldt corner partials (pallas3d.py:958-997),
// with a radiogenic source when the material is mixed (U false)
template <int PAR, bool U, typename T>
__device__ __forceinline__ void cell_a(const Params3<T>& p, const Bufs3<T>& b,
                                       int c, const T* X, const T* Y,
                                       const T* Z, const T* VX, const T* VY,
                                       const T* VZ, const T* TT) {
  T tp[8], dp[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) { tp[q] = T(0); dp[q] = T(0); }
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    T x[4], y[4], z[4], vx[4], vy[4], vz[4], ts[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int q = tet_corner(PAR, t, s);
      x[s] = X[q]; y[s] = Y[q]; z[s] = Z[q];
      vx[s] = VX[q]; vy[s] = VY[q]; vz[s] = VZ[q]; ts[s] = TT[q];
    }
    const T vol = b.ein[eidx(p, E_VOL, t, c)];
    Shape3<T> sh = shape3(x, y, z, vol);
    T ev = (dot4(vx, sh.dx) + dot4(vy, sh.dy) + dot4(vz, sh.dz)) * vol;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int q = tet_corner(PAR, t, s);
      dp[q] = dp[q] + ev;
    }
    if (p.thermal) {
      T gx = dot4(sh.dx, ts), gy = dot4(sh.dy, ts), gz = dot4(sh.dz, ts);
      if constexpr (U) {
        T kv = p.kappa * vol;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int q = tet_corner(PAR, t, s);
          tp[q] = tp[q] + kv * (sh.dx[s] * gx + sh.dy[s] * gy + sh.dz[s] * gz);
        }
      } else {
        // radiogenic source (fields.cxx:197-283; pallas3d.py:985-991)
        const Props<T, false> pr(p, b, t, c);
        const T kv = pr.kappa() * vol;
        const T rho = pr.rhoA() - pr.rhoB() * (mean4(ts) - T(273.0));
        const T src = b.cep[eidx(p, 0, t, c)] * vol * rho / T(4);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int q = tet_corner(PAR, t, s);
          tp[q] = tp[q] +
                  (kv * (sh.dx[s] * gx + sh.dy[s] * gy + sh.dz[s] * gz) - src);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (p.thermal) b.ework[q * p.NC + c] = tp[q];
    b.ework[(8 + q) * p.NC + c] = dp[q];
  }
}

template <typename T, bool U>
__global__ void __launch_bounds__(BLOCK) phase_a(Params3<T> p, Bufs3<T> b) {
  CellOf<T> cc;
  if (!cell_of_thread(p, cc)) return;
  T X[8], Y[8], Z[8], VX[8], VY[8], VZ[8], TT[8];
  const T* g = b.nin;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int o = cc.n0 + corner_off(p, q);
    X[q] = g[N_CX * p.NS + o]; Y[q] = g[N_CY * p.NS + o];
    Z[q] = g[N_CZ * p.NS + o]; VX[q] = g[N_VX * p.NS + o];
    VY[q] = g[N_VY * p.NS + o]; VZ[q] = g[N_VZ * p.NS + o];
    TT[q] = p.thermal ? g[N_T * p.NS + o] : T(0);
  }
  if (cc.odd)
    cell_a<1, U>(p, b, cc.c, X, Y, Z, VX, VY, VZ, TT);
  else
    cell_a<0, U>(p, b, cc.c, X, Y, Z, VX, VY, VZ, TT);
}

// ---- B, node: temperature and dvoldt (pallas3d.py:999-1005)
template <typename T>
__global__ void __launch_bounds__(BLOCK) phase_b(Params3<T> p, Bufs3<T> b) {
  int n = blockIdx.x * BLOCK + threadIdx.x;
  if (n >= p.NS) return;
  int k = n % p.nz, j = (n / p.nz) % p.ny, i = n / (p.nz * p.ny);
  const T* w = b.ework;
  const int NC = p.NC;
  T dv = node_sum(p, i, j, k, [&](int q, int cell, int) {
    return w[(8 + q) * NC + cell];
  });
  b.nwork[n] = dv / b.nin[N_VOLN * p.NS + n];
  T Told = b.nin[N_T * p.NS + n];
  T Tnew = Told;
  if (p.thermal) {
    T tdot = node_sum(p, i, j, k, [&](int q, int cell, int) {
      return w[q * NC + cell];
    });
    Tnew = b.cnp[CN_TOP * p.NS + n] > T(0)
               ? p.surface_T
               : Told - b.scal[0] * tdot / b.nin[N_TMASS * p.NS + n];
  }
  b.nout[N_T * p.NS + n] = Tnew;
}

// ---- C, tet: the pending epilogue of the previous step, edvoldt, strain,
// constitutive update, dpressure (pallas3d.py:1046-1169)
template <typename T, bool U>
__global__ void __launch_bounds__(BLOCK) phase_c(Params3<T> p, Bufs3<T> b) {
  int e = blockIdx.x * BLOCK + threadIdx.x;
  if (e >= 5 * p.NC) return;
  const int t = e / p.NC, c = e % p.NC;
  CellPos<T> cp = cell_pos(p, c);
  const T dt = b.scal[0];
  T x[4], y[4], z[4], vx[4], vy[4], vz[4], ts[4], dvs[4];
  tet_gather(p, b.nin + N_CX * p.NS, cp, t, x);
  tet_gather(p, b.nin + N_CY * p.NS, cp, t, y);
  tet_gather(p, b.nin + N_CZ * p.NS, cp, t, z);
  tet_gather(p, b.nin + N_VX * p.NS, cp, t, vx);
  tet_gather(p, b.nin + N_VY * p.NS, cp, t, vy);
  tet_gather(p, b.nin + N_VZ * p.NS, cp, t, vz);
  tet_gather(p, b.nin + N_T * p.NS, cp, t, ts);
  tet_gather(p, b.nwork, cp, t, dvs);
  const T vol = b.ein[eidx(p, E_VOL, t, c)];
  Shape3<T> sh = shape3(x, y, z, vol);
  T so[6], sn[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    so[a] = b.ein[eidx(p, E_STRESS + a, t, c)];
    sn[a] = b.ein[eidx(p, E_STRAIN + a, t, c)];
  }
  T pls = b.ein[eidx(p, E_PLS, t, c)];
  if (b.pending) {
    // the previous step's epilogue: ein's coordinates, velocities and
    // volume are that step's moved mesh, so sh is its shape function
    T dps[4] = {T(0), T(0), T(0), T(0)}, dp_old = T(0);
    if (p.nmd) {
      tet_gather(p, b.nwork + p.NS, cp, t, dps);
      dp_old = b.ein[eidx(p, E_DP, t, c)];
    }
    const bool top = cp.k == p.nzc - 1;
    const T sc = (p.surf_corr && top) ? b.sfac[sfac_idx(p, t, c)] : T(1);
    apply_epilogue(p, sh, vx, vy, vz, *b.dtp, dps, dp_old, top, sc, so, sn,
                   static_cast<T*>(nullptr), pls);
  }
  const T lxx = dot4(vx, sh.dx), lyy = dot4(vy, sh.dy), lzz = dot4(vz, sh.dz);
  const T sr[6] = {lxx, lyy, lzz,
                   T(0.5) * (dot4(vx, sh.dy) + dot4(vy, sh.dx)),
                   T(0.5) * (dot4(vx, sh.dz) + dot4(vz, sh.dx)),
                   T(0.5) * (dot4(vy, sh.dz) + dot4(vz, sh.dy))};
  const T temp_e = mean4(ts);
  const T edv = mean4(dvs);
  const T adj = (edv - (lxx + lyy + lzz)) / T(3);
  T edot[6], de[6], strain[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    edot[a] = a < 3 ? sr[a] + adj : sr[a];
    de[a] = edot[a] * dt;
    strain[a] = sn[a] + de[a];
  }
  // the viscosity of the creep laws and EP's delta_plstrain are
  // recomputed, so their old values are not loaded
  const int rh = p.rheol;
  const bool creep = rh == RH_VISCOUS || rh == RH_MAXWELL || rh == RH_EVP;
  T dpls = rh == RH_EP ? T(0) : b.ein[eidx(p, E_DPLS, t, c)];
  const Props<T, U> pr(p, b, t, c);
  const T K = pr.bulkm(), G = pr.shearm();
  const int nmat = U ? 1 : p.nmat;
  T visc;
  if (creep) {
    T s0m = (so[0] + so[1] + so[2]) / T(3);
    T ed = dmax(dsqrt(inv2_6(sr)), T(1e-30));
#if DES_MANY
    visc = visc_core_many(pr.mats(), nmat, pr.w, temp_e, s0m, ed, p.log_q,
                          p.log_1e6, p.visc_min, p.visc_max);
#else
    visc = visc_core(p.mat, nmat, pr.w, temp_e, s0m, ed, p.log_q, p.log_1e6,
                     p.visc_min, p.visc_max);
#endif
  } else {
    visc = b.ein[eidx(p, E_VISC, t, c)];
  }
  T sc[6];
  if (rh == RH_ELASTIC) {
    elastic3(K, G, de, so, sc);
  } else if (rh == RH_VISCOUS) {
    viscous3(K, visc, strain[0] + strain[1] + strain[2], edot, sc);
  } else if (rh == RH_MAXWELL) {
    T dv = vol / b.ein[eidx(p, E_VOLD, t, c)] - T(1);
    maxwell3(K, G, visc, dt, dv, de, so, sc);
  } else {  // RH_EP or RH_EVP
    T amc, anphi, anpsi, hardn, ten_max, sp[6], depls;
#if DES_MANY
    plastic_props_many(pr.mats(), nmat, pr.w, pls, p.tension_max,
                       p.deg2rad, amc, anphi, anpsi, hardn, ten_max);
#else
    plastic_props(p.mat, nmat, pr.w, pls, p.tension_max, p.deg2rad, amc,
                  anphi, anpsi, hardn, ten_max);
#endif
    elasto_plastic3(K, G, amc, anphi, anpsi, hardn, ten_max, de, so, sp,
                    depls);
    bool use_v = false;
    if (rh == RH_EVP) {
      T dv = vol / b.ein[eidx(p, E_VOLD, t, c)] - T(1);
      T sv[6];
      maxwell3(K, G, visc, dt, dv, de, so, sv);
      // min-magnitude selection (rheology.cxx:869-879)
      use_v = inv2_6(sv) < inv2_6(sp);
#pragma unroll
      for (int a = 0; a < 6; ++a) sc[a] = use_v ? sv[a] : sp[a];
    } else {
#pragma unroll
      for (int a = 0; a < 6; ++a) sc[a] = sp[a];
    }
    if (!use_v) {
      pls = pls + depls;
      dpls = depls;
    }
  }
  const T dp = p.nmd ? sc[0] + sc[1] + sc[2] - (so[0] + so[1] + so[2])
                     : b.ein[eidx(p, E_DP, t, c)];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    b.eout[eidx(p, E_STRESS + a, t, c)] = sc[a];
    b.eout[eidx(p, E_STRAIN + a, t, c)] = strain[a];
  }
  b.eout[eidx(p, E_PLS, t, c)] = pls;
  b.eout[eidx(p, E_DPLS, t, c)] = dpls;
  b.eout[eidx(p, E_DP, t, c)] = dp;
  if (p.nmd) b.ework[e] = dp * vol;  // D's per-tet term
  if (!creep || b.last) b.eout[eidx(p, E_VISC, t, c)] = visc;
  if (b.last) {
#pragma unroll
    for (int a = 0; a < 6; ++a) b.eout[eidx(p, E_SR + a, t, c)] = edot[a];
    b.eout[eidx(p, E_EDV, t, c)] = edv;
  }
}

// ---- D, node: NMD nodal pressure change (pallas3d.py:1171-1175)
template <typename T>
__global__ void __launch_bounds__(BLOCK) phase_d(Params3<T> p, Bufs3<T> b) {
  int n = blockIdx.x * BLOCK + threadIdx.x;
  if (n >= p.NS) return;
  int k = n % p.nz, j = (n / p.nz) % p.ny, i = n / (p.nz * p.ny);
  const int NC = p.NC;
  const T* w = b.ework;  // dpressure * volume per tet, from C
  T s = node_sum(p, i, j, k, [&](int q, int cell, int par) {
    return equal_partial<T>([&](int t, int cl) { return w[t * NC + cl]; },
                            q, cell, par);
  });
  b.nwork[p.NS + n] = s / b.nin[N_VOLN * p.NS + n];
}

// ---- E, cell: NMD correction (in registers: the stored stress keeps its
// epilogue pending) and force corner partials (pallas3d.py:1025-1044,
// :1176-1205)
template <int PAR, bool U, typename T>
__device__ __forceinline__ void cell_e(const Params3<T>& p, const Bufs3<T>& b,
                                       int c, const T* X, const T* Y,
                                       const T* Z, const T* TT, const T* DP) {
  T fp[3][8];
#pragma unroll
  for (int q = 0; q < 8; ++q) fp[0][q] = fp[1][q] = fp[2][q] = T(0);
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    T x[4], y[4], z[4], ts[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int q = tet_corner(PAR, t, s);
      x[s] = X[q]; y[s] = Y[q]; z[s] = Z[q]; ts[s] = TT[q];
    }
    const T vol = b.ein[eidx(p, E_VOL, t, c)];
    Shape3<T> sh = shape3(x, y, z, vol);
    T st[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) st[a] = b.eout[eidx(p, E_STRESS + a, t, c)];
    if (p.nmd) {
      T dps[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) dps[s] = DP[tet_corner(PAR, t, s)];
      T ddp = (mean4(dps) - b.eout[eidx(p, E_DP, t, c)]) / T(3);
#pragma unroll
      for (int a = 0; a < 3; ++a) st[a] = st[a] + ddp;
    }
    T buoy = T(0);
    if (p.gravity_on) {
      const Props<T, U> pr(p, b, t, c);
      buoy = pr.buoyA() - pr.buoyB() * (mean4(ts) - T(273.0));
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int q = tet_corner(PAR, t, s);
      fp[0][q] = fp[0][q] +
                 (st[0] * sh.dx[s] + st[3] * sh.dy[s] + st[4] * sh.dz[s]) * vol;
      fp[1][q] = fp[1][q] +
                 (st[3] * sh.dx[s] + st[1] * sh.dy[s] + st[5] * sh.dz[s]) * vol;
      fp[2][q] = fp[2][q] + (st[4] * sh.dx[s] + st[5] * sh.dy[s] +
                             st[2] * sh.dz[s] + buoy) * vol;
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int q = 0; q < 8; ++q) b.ework[(a * 8 + q) * p.NC + c] = fp[a][q];
}

// ---- E's facet tractions (BND): the two boundary facets of a bottom-row
// (SIDE 0, Winkler) or top-row (SIDE 1, water) cell of parity PAR, from
// the pre-move coordinates (ops/fused3d.py facet_forces).  Each facet adds
// -p n / 3 to its three corners (n its area-weighted normal in the stored
// node order); the cell's partial of each of its four corners on the
// boundary lane sums its facets in group order, from zero, into fwork.
template <int SIDE, int PAR, bool U, typename T>
__device__ __forceinline__ void cell_facets(const Params3<T>& p,
                                            const Bufs3<T>& b, int c,
                                            int n0) {
  const T* g = b.nin;
  const T third = T(1.0 / 3.0);
  T part[3][4];
#pragma unroll
  for (int f = 0; f < 4; ++f) part[0][f] = part[1][f] = part[2][f] = T(0);
#pragma unroll
  for (int gi = 0; gi < 2; ++gi) {
    // the group's tet, then its facet's corner codes (compile-time
    // indices into the kernel parameter, so that it stays in the constant
    // bank)
    const int t = p.facets[SIDE][PAR][gi][0];
    const int cd[3] = {p.facets[SIDE][PAR][gi][1], p.facets[SIDE][PAR][gi][2],
                       p.facets[SIDE][PAR][gi][3]};
    T x[3], y[3], z[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int o = n0 + corner_off(p, cd[m]);
      x[m] = g[N_CX * p.NS + o];
      y[m] = g[N_CY * p.NS + o];
      z[m] = g[N_CZ * p.NS + o];
    }
    const T e1x = x[1] - x[0], e1y = y[1] - y[0], e1z = z[1] - z[0];
    const T e2x = x[2] - x[0], e2y = y[2] - y[0], e2z = z[2] - z[0];
    const T nr[3] = {T(0.5) * (e1y * e2z - e1z * e2y),
                     T(0.5) * (e1z * e2x - e1x * e2z),
                     T(0.5) * (e1x * e2y - e1y * e2x)};
    const T zc = (z[0] + z[1] + z[2]) * third;
    T pres;
    if constexpr (SIDE == 0) {
      // Winkler: the owning tet's density from its pre-update temperature
      T ts[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        ts[q] = g[N_T * p.NS + n0 + corner_off(p, tet_corner(PAR, t, q))];
      const Props<T, U> pr(p, b, t, c);
      const T rho = pr.rhoA() - pr.rhoB() * (mean4(ts) - T(273.0));
      pres = p.comp_p -
             (rho + p.winkler_drho) * p.gravity * (zc + p.zlength);
    } else {
      // water loading below the base level
      pres = zc < p.surf_base
                 ? T(1030.0) * p.gravity * (p.surf_base - zc)
                 : T(0);
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int code = 2 * f + SIDE;  // (a, b) = (f >> 1, f & 1), d = SIDE
      if (code == cd[0] || code == cd[1] || code == cd[2]) {
#pragma unroll
        for (int a = 0; a < 3; ++a)
          part[a][f] = part[a][f] + -pres * nr[a] * third;
      }
    }
  }
  const int col = c / p.nzc;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int f = 0; f < 4; ++f)
      b.fwork[((SIDE * 3 + a) * 4 + f) * p.NT + col] = part[a][f];
}

template <int PAR, bool U, typename T>
__device__ __forceinline__ void cell_e_facets(const Params3<T>& p,
                                              const Bufs3<T>& b,
                                              const CellOf<T>& cc) {
  if (cc.k == 0 && p.winkler) cell_facets<0, PAR, U>(p, b, cc.c, cc.n0);
  if (cc.k == p.nzc - 1 && p.water)
    cell_facets<1, PAR, U>(p, b, cc.c, cc.n0);
}

template <typename T, bool U, bool BND>
__global__ void __launch_bounds__(BLOCK) phase_e(Params3<T> p, Bufs3<T> b) {
  CellOf<T> cc;
  if (!cell_of_thread(p, cc)) return;
  T X[8], Y[8], Z[8], TT[8], DP[8];
  const T* g = b.nin;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int o = cc.n0 + corner_off(p, q);
    X[q] = g[N_CX * p.NS + o]; Y[q] = g[N_CY * p.NS + o];
    Z[q] = g[N_CZ * p.NS + o];
    TT[q] = p.gravity_on ? g[N_T * p.NS + o] : T(0);
    DP[q] = p.nmd ? b.nwork[p.NS + o] : T(0);
  }
  if (cc.odd)
    cell_e<1, U>(p, b, cc.c, X, Y, Z, TT, DP);
  else
    cell_e<0, U>(p, b, cc.c, X, Y, Z, TT, DP);
  if constexpr (BND) {
    if (cc.odd)
      cell_e_facets<1, U>(p, b, cc);
    else
      cell_e_facets<0, U>(p, b, cc);
  }
}

// The facet tractions of boundary lane SIDE at node column (i, j): the
// partials of the node's up to four cells (corner (a, b) of cell (i - a,
// j - b)) in corner-code order, from zero, added to the force f
template <int SIDE, typename T>
__device__ __forceinline__ void lane_tractions(const Params3<T>& p,
                                               const Bufs3<T>& b, int i,
                                               int j, T f[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    T acc = T(0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ci = i - (q >> 1), cj = j - (q & 1);
      if (ci >= 0 && ci < p.nxc && cj >= 0 && cj < p.nyc)
        acc = acc + b.fwork[((SIDE * 3 + a) * 4 + q) * p.NT + ci * p.nyc + cj];
    }
    f[a] = f[a] + acc;
  }
}

// ---- F, node: force, L2 partial, facet tractions (BND), damping,
// velocity + vbc, coordinates (pallas3d.py:1207-1322)
template <typename T, bool BND>
__global__ void __launch_bounds__(BLOCK) phase_f(Params3<T> p, Bufs3<T> b) {
  __shared__ T shm[BLOCK];
  int n = blockIdx.x * BLOCK + threadIdx.x;
  T r2 = T(0);
  if (n < p.NS) {
    int k = n % p.nz, j = (n / p.nz) % p.ny, i = n / (p.nz * p.ny);
    const T dt = b.scal[0];
    const T* w = b.ework;
    const int NC = p.NC;
    T f[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      f[a] = -node_sum(p, i, j, k, [&](int q, int cell, int) {
        return w[(a * 8 + q) * NC + cell];
      });
    r2 = f[0] * f[0] + f[1] * f[1] + f[2] * f[2];
    if constexpr (BND) {
      // after the residual, as grid3d applies them
      if (k == 0 && p.winkler) lane_tractions<0>(p, b, i, j, f);
      if (k == p.nz - 1 && p.water) lane_tractions<1>(p, b, i, j, f);
    }
    const T m = b.nin[N_MASS * p.NS + n];
    const T tiny = T(1e-13);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T v = b.nin[(N_VX + a) * p.NS + n];
      T fd = f[a];
      if (p.damping == 1) {
        fd = f[a] - (dabs(v) > tiny ? p.fac * dabs(f[a]) * dsign(v) : T(0));
      } else if (p.damping == 2) {
        fd = f[a] * p.one_m_fac;
      } else if (p.damping == 3) {
        fd = ((f[a] < T(0)) == (v < T(0))) ? f[a] * p.one_m_fac
                                           : f[a] * p.two_m_fac;
      }
      T vn = b.cnp[(CN_MX + a) * p.NS + n] > T(0) ? b.tgt[a * p.NS + n]
                                                 : v + dt * fd / m;
      b.nout[(N_CX + a) * p.NS + n] = b.nin[(N_CX + a) * p.NS + n] + vn * dt;
      b.nout[(N_VX + a) * p.NS + n] = vn;
      if (b.last) b.nout[(N_FX + a) * p.NS + n] = fd;
    }
  }
  T s = block_reduce(r2, shm, [](T a, T c) { return a + c; });
  if (threadIdx.x == 0) b.part[3 * b.nb + blockIdx.x] = s;
}

// The two triangles of a top cell's quad, split along the parity
// diagonal (ops/fused3d.py TRI_EVEN, TRI_ODD), as the cell's top corners
// f = a * 2 + b: entry (par * 2 + t3) * 3 + m of TRI_F, 2 bits each
constexpr int TRI_F[12] = {0, 3, 1, 0, 2, 3, 0, 2, 1, 1, 2, 3};
constexpr unsigned tri_pack() {
  unsigned r = 0;
  for (int e = 0; e < 12; ++e) r |= unsigned(TRI_F[e]) << (2 * e);
  return r;
}
constexpr unsigned TRI_PACK = tri_pack();

__host__ __device__ constexpr int tri_corner(int par, int t3, int m) {
  return int((TRI_PACK >> (2 * ((par * 2 + t3) * 3 + m))) & 3u);
}

// A top triangle's area projected on the horizontal plane
// (ops/fused3d.py _tri_geom)
template <typename T>
__device__ __forceinline__ T tri_parea(const T* px, const T* py) {
  return T(0.5) * ((px[1] - px[0]) * (py[2] - py[0]) -
                   (py[1] - py[0]) * (px[2] - px[0]));
}

// ---- S, node: surface process 1, the top lane's dh (surface_dh_3d,
// bc.cxx:920-1050; pallas3d.py:1324-1380) from F's moved coordinates:
// each top node sums the slope terms and projected areas of the triangles
// of its up to four cells (a cell's triangles in order, then the cells in
// corner-code order), dh = -kappa dt slope / area on top-mask nodes, into
// nwork slot 0 (G adds it to the corners it loads, H to coord_z and dhacc)
template <typename T>
__global__ void __launch_bounds__(BLOCK) phase_s(Params3<T> p, Bufs3<T> b) {
  const int n2 = blockIdx.x * BLOCK + threadIdx.x;
  if (n2 >= p.nx * p.ny) return;
  const int i = n2 / p.ny, j = n2 % p.ny, n = n2 * p.nz + p.nz - 1;
  const T* g = b.nout;
  T slope = T(0), area = T(0);
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    // the cell of which the node is top corner f
    const int ci = i - (f >> 1), cj = j - (f & 1);
    if (ci < 0 || ci >= p.nxc || cj < 0 || cj >= p.nyc) continue;
    const int par = (ci + cj + p.nzc - 1) & 1;
    const int nb = (ci * p.ny + cj) * p.nz + p.nz - 1;
    T cs = T(0), ca = T(0);
#pragma unroll
    for (int t3 = 0; t3 < 2; ++t3) {
      T px[3], py[3], pz[3];
      int fm[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        fm[m] = tri_corner(par, t3, m);
        const int o = nb + (fm[m] >> 1) * p.ny * p.nz + (fm[m] & 1) * p.nz;
        px[m] = g[N_CX * p.NS + o];
        py[m] = g[N_CY * p.NS + o];
        pz[m] = g[N_CZ * p.NS + o];
      }
      const T parea = tri_parea(px, py);
      const T iv = T(1) / (T(2) * (parea != T(0) ? parea : T(1)));
      const T sdx[3] = {iv * (py[1] - py[2]), iv * (py[2] - py[0]),
                        iv * (py[0] - py[1])};
      const T sdy[3] = {iv * (px[2] - px[1]), iv * (px[0] - px[2]),
                        iv * (px[1] - px[0])};
      const T gx = sdx[0] * pz[0] + sdx[1] * pz[1] + sdx[2] * pz[2];
      const T gy = sdy[0] * pz[0] + sdy[1] * pz[1] + sdy[2] * pz[2];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        if (fm[m] == f) {
          cs = cs + (sdx[m] * gx + sdy[m] * gy) * parea;
          ca = ca + parea;
        }
      }
    }
    slope = slope + cs;
    area = area + ca;
  }
  const T conv = p.surf_diff * b.scal[0] * slope / (area > T(0) ? area : T(1));
  b.nwork[n] = b.cnp[CN_TOP * p.NS + n] > T(0) ? -conv : T(0);
}

// G's surface-process accumulators of a top-row cell of parity PAR: each
// triangle's deposited volume (its corners' dh summed) * area / 3
// (bc.cxx:1745-1760) added to its edv plane at the cell's (x0, y0, top)
// node n (pallas3d.py:1381-1394); X, Y the moved corners, DH the top
// corners' dh
template <int PAR, typename T>
__device__ __forceinline__ void cell_edv(const Params3<T>& p,
                                        const Bufs3<T>& b, int n,
                                        const T* X, const T* Y,
                                        const T* DH) {
#pragma unroll
  for (int t3 = 0; t3 < 2; ++t3) {
    T px[3], py[3], d[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int q = 2 * tri_corner(PAR, t3, m) + 1;
      px[m] = X[q];
      py[m] = Y[q];
      d[m] = DH[q];
    }
    const int o = (t3 ? N_EDVB : N_EDVA) * p.NS + n;
    b.nout[o] = b.nin[o] + (d[0] + d[1] + d[2]) * tri_parea(px, py) / T(3);
  }
}

// ---- G, cell: each of the cell's tets' post-move volume, CFL partials,
// mass terms and surface factor of the epilogue (pallas3d.py:1395-1534)
template <int PAR, bool U, typename T>
__device__ __forceinline__ void cell_g(const Params3<T>& p, const Bufs3<T>& b,
                                       int c, bool top, const T* X,
                                       const T* Y, const T* Z, const T* VX,
                                       const T* VY, const T* VZ, const T* TT,
                                       T& hmin, T& hsmin, T& vmax) {
  T* w = b.ework;
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    T x[4], y[4], z[4], vx[4], vy[4], vz[4], ts[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int q = tet_corner(PAR, t, s);
      x[s] = X[q]; y[s] = Y[q]; z[s] = Z[q];
      vx[s] = VX[q]; vy[s] = VY[q]; vz[s] = VZ[q]; ts[s] = TT[q];
    }
    const Props<T, U> pr(p, b, t, c);
    const T TinC = mean4(ts) - T(273.0);
    const T rho_e = pr.rhoA() - pr.rhoB() * TinC;
    const T shearm = pr.shearm();
    const T vol = b.ein[eidx(p, E_VOL, t, c)];
    const T vn = tet_volume(x, y, z);

    // CFL partials, every step (pallas3d.py:1435-1450)
    const T vxm = mean4(vx), vym = mean4(vy), vzm = mean4(vz);
    const T h = tet_min_height(x, y, z, vn);
    vmax = dmax(vmax, dsqrt(vxm * vxm + vym * vym + vzm * vzm));
    hmin = dmin(hmin, h);
    hsmin = dmin(hsmin, h / dsqrt(shearm / rho_e));

    // (pseudo-)mass matrices (geometry.cxx:1020-1154)
    T rho_q;
    if (p.use_gvs) {
      T app = dmin(b.scal[1] * p.inertial, dsqrt(shearm / rho_e));
      rho_q = pr.bulkm() / (app * app);
    } else {
      rho_q = pr.bulkm() / p.ps2;
    }
    const T rho_m = p.quasi_static ? rho_q : rho_e;
    const int e = t * p.NC + c;
    w[0 * 5 * p.NC + e] = rho_m * vn / T(4);
    w[1 * 5 * p.NC + e] = (pr.cpA() - pr.cpB() * TinC) * vn / T(4);
    if (b.last) w[2 * 5 * p.NC + e] = pr.hmA() * vn;

    // correct_surface_element (bc.cxx:1613-1665): the top layer's factor
    // for the epilogue and its pre-swap volume
    T vold = vol;
    if (p.surf_corr && top) {
      const T rdv = vn / vol;
      b.sfac[sfac_idx(p, t, c)] = rdv >= T(1) ? T(1) / rdv : T(1);
      vold = vn;
    }
    b.eout[eidx(p, E_VOL, t, c)] = vn;
    b.eout[eidx(p, E_VOLD, t, c)] = vold;
  }
}

template <typename T, bool U, bool BND>
__global__ void __launch_bounds__(BLOCK) phase_g(Params3<T> p, Bufs3<T> b) {
  __shared__ T shm[3][BLOCK / 32];
  T hmin = T(FLT_MAX), hsmin = T(FLT_MAX), vmax = T(0);
  CellOf<T> cc;
  if (cell_of_thread(p, cc)) {
    T X[8], Y[8], Z[8], VX[8], VY[8], VZ[8], TT[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int o = cc.n0 + corner_off(p, q);
      X[q] = b.nout[N_CX * p.NS + o]; Y[q] = b.nout[N_CY * p.NS + o];
      Z[q] = b.nout[N_CZ * p.NS + o]; VX[q] = b.nout[N_VX * p.NS + o];
      VY[q] = b.nout[N_VY * p.NS + o]; VZ[q] = b.nout[N_VZ * p.NS + o];
      TT[q] = b.nin[N_T * p.NS + o];
    }
    const bool top = cc.k == p.nzc - 1;
    if constexpr (BND) {
      if (p.surf_on && top) {
        // the top corners after S's diffusion, as H stores them
        T DH[8];
#pragma unroll
        for (int q = 1; q < 8; q += 2) {
          DH[q] = b.nwork[cc.n0 + corner_off(p, q)];
          Z[q] = Z[q] + DH[q];
        }
        if (cc.odd)
          cell_edv<1>(p, b, cc.n0 + 1, X, Y, DH);
        else
          cell_edv<0>(p, b, cc.n0 + 1, X, Y, DH);
      }
    }
    if (cc.odd)
      cell_g<1, U>(p, b, cc.c, top, X, Y, Z, VX, VY, VZ, TT, hmin, hsmin,
                   vmax);
    else
      cell_g<0, U>(p, b, cc.c, top, X, Y, Z, VX, VY, VZ, TT, hmin, hsmin,
                   vmax);
  }
  cfl_reduce(hmin, hsmin, vmax, shm);
  if (threadIdx.x == 0) {
    b.part[blockIdx.x] = hmin;
    b.part[b.nb + blockIdx.x] = hsmin;
    b.part[2 * b.nb + blockIdx.x] = vmax;
  }
}

// ---- H, node: volume_n, mass, tmass, hmass (pallas3d.py:1471-1474); with
// surface process 1 the top lane's dh into coord_z and dhacc
template <typename T, bool BND>
__global__ void __launch_bounds__(BLOCK) phase_h(Params3<T> p, Bufs3<T> b) {
  int n = blockIdx.x * BLOCK + threadIdx.x;
  if (n >= p.NS) return;
  int k = n % p.nz, j = (n / p.nz) % p.ny, i = n / (p.nz * p.ny);
  const int NC = p.NC;
  if constexpr (BND) {
    if (p.surf_on && k == p.nz - 1) {
      const T dh = b.nwork[n];
      b.nout[N_CZ * p.NS + n] = b.nout[N_CZ * p.NS + n] + dh;
      b.nout[N_DHACC * p.NS + n] = b.nin[N_DHACC * p.NS + n] + dh;
    }
  }
  const T* vol = b.eout + E_VOL * 5 * NC;
  b.nout[N_VOLN * p.NS + n] = node_sum(p, i, j, k, [&](int q, int cell, int par) {
    return equal_partial<T>([&](int t, int cl) { return vol[t * NC + cl]; },
                            q, cell, par);
  });
  const int slot[3] = {N_MASS, N_TMASS, N_HMASS};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (a == 2 && !b.last) break;
    const T* w = b.ework + a * 5 * NC;
    b.nout[slot[a] * p.NS + n] = node_sum(p, i, j, k, [&](int q, int cell, int par) {
      return equal_partial<T>([&](int t, int cl) { return w[t * NC + cl]; },
                              q, cell, par);
    });
  }
}

// ---- finalize, tet: the pending epilogue of the step that wrote e / n,
// in place on stress, strain, strain rate and plstrain (after a chunk's
// last step, and after a complete step)
template <typename T>
__global__ void __launch_bounds__(BLOCK)
    finalize(Params3<T> p, T* e, const T* n, const T* nwork, const T* sfac,
             const T* dtp) {
  int id = blockIdx.x * BLOCK + threadIdx.x;
  if (id >= 5 * p.NC) return;
  const int t = id / p.NC, c = id % p.NC;
  CellPos<T> cp = cell_pos(p, c);
  T vx[4] = {}, vy[4] = {}, vz[4] = {};
  Shape3<T> sh = {};
  if (p.jaumann) {
    T x[4], y[4], z[4];
    tet_gather(p, n + N_CX * p.NS, cp, t, x);
    tet_gather(p, n + N_CY * p.NS, cp, t, y);
    tet_gather(p, n + N_CZ * p.NS, cp, t, z);
    tet_gather(p, n + N_VX * p.NS, cp, t, vx);
    tet_gather(p, n + N_VY * p.NS, cp, t, vy);
    tet_gather(p, n + N_VZ * p.NS, cp, t, vz);
    sh = shape3(x, y, z, e[eidx(p, E_VOL, t, c)]);
  }
  // strain rate and plstrain change on the scaled top layer only
  const bool top = cp.k == p.nzc - 1, scaled = p.surf_corr && top;
  T st[6], sn[6], sr[6] = {}, pls = T(0);
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    st[a] = e[eidx(p, E_STRESS + a, t, c)];
    sn[a] = e[eidx(p, E_STRAIN + a, t, c)];
  }
  if (scaled) {
#pragma unroll
    for (int a = 0; a < 6; ++a) sr[a] = e[eidx(p, E_SR + a, t, c)];
    pls = e[eidx(p, E_PLS, t, c)];
  }
  T dps[4] = {T(0), T(0), T(0), T(0)}, dp_old = T(0);
  if (p.nmd) {
    tet_gather(p, nwork + p.NS, cp, t, dps);
    dp_old = e[eidx(p, E_DP, t, c)];
  }
  const T sc = scaled ? sfac[sfac_idx(p, t, c)] : T(1);
  apply_epilogue(p, sh, vx, vy, vz, *dtp, dps, dp_old, top, sc, st, sn, sr,
                 pls);
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    e[eidx(p, E_STRESS + a, t, c)] = st[a];
    e[eidx(p, E_STRAIN + a, t, c)] = sn[a];
  }
  if (scaled) {
#pragma unroll
    for (int a = 0; a < 6; ++a) e[eidx(p, E_SR + a, t, c)] = sr[a];
    e[eidx(p, E_PLS, t, c)] = pls;
  }
}

template <typename T, bool U, bool BND>
int step(const Params3<T>& p, Bufs3<T> b, cudaStream_t s) {
  const int gc = (p.NC / 2 + BLOCK / 2 - 1) / (BLOCK / 2);  // cell phases
  const int gt = (5 * p.NC + BLOCK - 1) / BLOCK;
  const int gn = (p.NS + BLOCK - 1) / BLOCK;
  if (gc > b.nb || gn > b.nb) return int(cudaErrorInvalidValue);
  cudaError_t e;
  // each launch checked at once: a refused launch never runs
  phase_a<T, U><<<gc, BLOCK, 0, s>>>(p, b);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  phase_b<T><<<gn, BLOCK, 0, s>>>(p, b);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  phase_c<T, U><<<gt, BLOCK, 0, s>>>(p, b);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  if (p.nmd) {
    phase_d<T><<<gn, BLOCK, 0, s>>>(p, b);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  phase_e<T, U, BND><<<gc, BLOCK, 0, s>>>(p, b);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  phase_f<T, BND><<<gn, BLOCK, 0, s>>>(p, b);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  if constexpr (BND) {
    if (p.surf_on) {
      phase_s<T><<<(p.nx * p.ny + BLOCK - 1) / BLOCK, BLOCK, 0, s>>>(p, b);
      if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
    }
  }
  phase_g<T, U, BND><<<gc, BLOCK, 0, s>>>(p, b);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  phase_h<T, BND><<<gn, BLOCK, 0, s>>>(p, b);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  return 0;
}

#if DES_MANY
// The many-material instances (more than MAXMAT materials), with the
// shared phases B, D, F, S and H; refused as step_any of fused3d.cu
// refuses, and a plan of MAXMAT materials or fewer, or without its table.
template <typename T>
int step_many(const int* ip, const double* fp, Bufs3<T> b, cudaStream_t s) {
  Params3<T> p = from_host<T>(ip, fp);
  if (p.uniform || p.nmat <= MAXMAT || b.cep == nullptr ||
      b.mtab == nullptr || p.nzc % 2)
    return int(cudaErrorInvalidValue);
  if ((p.winkler || p.water) && b.fwork == nullptr)
    return int(cudaErrorInvalidValue);
  return p.winkler || p.water || p.surf_on ? step<T, false, true>(p, b, s)
                                           : step<T, false, false>(p, b, s);
}

}  // namespace

extern "C" {

// des_fused3d_step_f32's plans of more than MAXMAT materials, with their
// table mtab; arguments as its
int des_fused3d_step_many_f32(const int* ip, const double* fp,
                              const float* ein, const float* nin, float* eout,
                              float* nout, const float* cep,
                              const float* mtab, const float* cnp,
                              const float* tgt, const float* scal,
                              float* ework, float* nwork, float* sfac,
                              const float* dtp, float* part, float* fwork,
                              int nb, int pending, int last, void* stream) {
  Bufs3<float> b{ein,   nin,  eout, nout, cep, cnp,     tgt,  scal,  ework,
                 nwork, sfac, dtp,  part, nb,  pending, last, fwork, mtab};
  return step_many<float>(ip, fp, b, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
#else
// U: a single material with uniform ICs (ops/fused3d.py _uniform_mat),
// whose properties are plan constants; else the const pack's mixtures (of
// more than MAXMAT materials in fused3d_many.cu, which the extern entry
// below calls).  BND: the facet tractions or surface process 1.  Refused:
// an odd nzc (the cell phases take cell pairs along z), a mixed plan
// without its pack, facets without their scratch.
template <typename T>
int step_any(const int* ip, const double* fp, Bufs3<T> b, cudaStream_t s) {
  if (!ip[12] && b.cep == nullptr) return int(cudaErrorInvalidValue);
  Params3<T> p = from_host<T>(ip, fp);
  if (p.nzc % 2) return int(cudaErrorInvalidValue);
  if ((p.winkler || p.water) && b.fwork == nullptr)
    return int(cudaErrorInvalidValue);
  if (p.winkler || p.water || p.surf_on)
    return p.uniform ? step<T, true, true>(p, b, s)
                     : step<T, false, true>(p, b, s);
  return p.uniform ? step<T, true, false>(p, b, s)
                   : step<T, false, false>(p, b, s);
}

template <typename T>
int finalize_step(const int* ip, const double* fp, T* e, const T* n,
                  const T* nwork, const T* sfac, const T* dtp,
                  cudaStream_t s) {
  Params3<T> p = from_host<T>(ip, fp);
  const int gt = (5 * p.NC + BLOCK - 1) / BLOCK;
  finalize<T><<<gt, BLOCK, 0, s>>>(p, e, n, nwork, sfac, dtp);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// fused3d_many.cu
int des_fused3d_step_many_f32(const int* ip, const double* fp,
                              const float* ein, const float* nin, float* eout,
                              float* nout, const float* cep,
                              const float* mtab, const float* cnp,
                              const float* tgt, const float* scal,
                              float* ework, float* nwork, float* sfac,
                              const float* dtp, float* part, float* fwork,
                              int nb, int pending, int last, void* stream);

// One fused 3D step in the chunk form: ein carries the pending epilogue of
// the previous step when `pending` (its dt at dtp), eout is left with this
// step's (nwork slot 1 and sfac hold its inputs); `last` stores the planes
// no later step of the chunk reads; fwork is the facet scratch of a plan
// with facet tractions (else null); mtab the table of a plan of more than
// MAXMAT materials, which the many-material instances run (else null).
// Returns 0 or the cudaError_t of the first launch that failed (faults
// during the run surface at the caller's next synchronisation).
int des_fused3d_step_f32(const int* ip, const double* fp, const float* ein,
                         const float* nin, float* eout, float* nout,
                         const float* cep, const float* mtab,
                         const float* cnp, const float* tgt,
                         const float* scal, float* ework, float* nwork,
                         float* sfac, const float* dtp, float* part,
                         float* fwork, int nb, int pending, int last,
                         void* stream) {
  if (!ip[12] && ip[13] > MAXMAT)
    return des_fused3d_step_many_f32(ip, fp, ein, nin, eout, nout, cep, mtab,
                                     cnp, tgt, scal, ework, nwork, sfac, dtp,
                                     part, fwork, nb, pending, last, stream);
  Bufs3<float> b{ein,   nin,  eout, nout, cep, cnp,     tgt,  scal,  ework,
                 nwork, sfac, dtp,  part, nb,  pending, last, fwork};
  return step_any<float>(ip, fp, b, static_cast<cudaStream_t>(stream));
}

// The pending epilogue of the step that wrote e / n (its dt at dtp),
// applied in place to e: after it e and n are a State's planes.
int des_fused3d_finalize_f32(const int* ip, const double* fp, float* e,
                             const float* n, const float* nwork,
                             const float* sfac, const float* dtp,
                             void* stream) {
  return finalize_step<float>(ip, fp, e, n, nwork, sfac, dtp,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
#endif
