"""The fused 2D structured time step (counterpart of
dynearthsol_tpu/ops/pallas2d.py).

The JAX package fuses the whole dynearthsol.cxx:746-956 step sequence into
one Pallas kernel that tiles x with a recomputed halo, so that every state
plane crosses HBM once per step, and its resident form runs a whole chunk
of steps in one call.  Here the same steps are the CUDA file
csrc/fused2d.cu: one persistent cooperative kernel per chunk
(``fused_chunk``), whose blocks walk the cells or nodes of each phase
(element, node, element, ...) with a grid-wide barrier at every
element->node->element hop, no halo tiles, edges masked by index.  The
tiled runner launches it once per step (n = 1).  ``step_planes_plain`` is
the same step in plain PyTorch on the same plane layout (the whole-mesh
``_core`` of pallas2d.py); the CPU tests hold it against the JAX package
and chip_smoke.py holds the CUDA kernel against it on the card.

Layout.  Element state is packed into ``(NE, 2, nxc, nzc)`` planes (slot,
triangle, cell column, cell row) and nodal state into ``(NN, nx, nz)``,
z contiguous.  Per-chunk constant properties go into a const element pack
(multi-material runs only; single-material runs pass the values as
scalars, as pallas2d.py embeds them) and a const nodal pack (top mask,
vbc masks, ymass).  Velocity BCs are applied as ``where(mask, target, v)``
with targets probed from ``bc.apply_vbcs`` at zero velocity (the 2D BC
types set components independently of the current velocity).

Scalars stay on the device: dt, vmax, gdtmin, time, the last L2 partial
and dt_maxwell live in a small buffer ``scal``; per-step refresh and decay
flags in ``flags``.  After every step the chunk kernel finishes the block
partials of the CFL metrics and the L2 residual in a fixed order and
refreshes dt on the 10-step cadence (``dt_refresh_plain`` is its plain
version), so a chunk runs with no host round trip.

Gating is pallas2d.py's, ported as it is (alignment rules included) so
that the two packages dispatch alike.  This package additionally lacks the
in-kernel gravity-facet tractions and surface process option 1:
``unported_features`` names them and the simulation refuses such configs.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as nnf

from .. import bc as bc_mod
from ..config import RH_ELASTIC, RH_EP, RH_EVP, RH_MAXWELL, RH_VISCOUS, Param
from . import fused_common as FC
from . import matprops as M
from . import rheology as R
from . import surface as SP
from .geometry import _rdiv
from .matprops import CELSIUS0, MIN_STRAIN_RATE
from .structured import parity_2d

# ---- packed-state slot maps ----
# element pack: scalars then 3-component tensors, each (2, nxc, nzc)
E_SLOTS = ("volume", "volume_old", "stressyy", "plstrain", "delta_plstrain",
           "viscosity", "dpressure", "edvoldt")
T_SLOTS = ("stress", "strain", "strain_rate")  # 3 planes each
NE = len(E_SLOTS) + 3 * len(T_SLOTS)

# nodal pack (NN, nx, nz).  pallas2d.py carries two more planes for surface
# process option 1 (dhacc, edv), which this package does not run yet.
N_SLOTS = ("coord_x", "coord_z", "vel_x", "vel_z", "temperature",
           "mass", "tmass", "hmass", "volume_n", "force_x", "force_z")
NN = len(N_SLOTS)

# const element pack (per chunk) + nmat material-weight planes
CE_SLOTS = ("valid", "radiogenic_source", "bulkm", "shearm", "kappa",
            "rhoA", "rhoB",        # rho_e = rhoA - rhoB * T_elem_in_C
            "buoyA", "buoyB",      # buoyancy = (buoyA - buoyB*TinC)
            "cpA", "cpB",          # rho*cp   = cpA  - cpB * TinC
            "hmA")                 # hmass coefficient

# const nodal pack (per chunk)
CN_SLOTS = ("top_mask", "vbc_mask_x", "vbc_mask_z", "ymass")
NCN = len(CN_SLOTS)

# partials (4, NB): min height, min height / shear-wave speed, max |v|,
# sum of |force|^2 -- one column per virtual block of 256 cells or nodes
NPART = 4
BLOCK = 256     # threads per block of csrc/fused2d.cu
MAXMAT = 8      # csrc/rheology2d.cuh MAXMAT
NEWORK = 7      # element scratch planes of csrc/fused2d.cu


def _eslot(name: str) -> int:
    return E_SLOTS.index(name)


def _tslot(name: str) -> int:
    return len(E_SLOTS) + 3 * T_SLOTS.index(name)


def _nslot(name: str) -> int:
    return N_SLOTS.index(name)


# ---------------------------------------------------------------- gates

def pallas_step_applicable(param: Param, ctx) -> bool:
    """Static gate of the fused step (pallas2d.pallas_step_applicable)."""
    ctrl = param.control
    rheol = param.mat.rheol_type
    if not (ctx.sgrid is not None and ctx.ndims == 2
            and not ctrl.has_hydraulic_diffusion
            and not ctrl.has_PT
            and rheol in (RH_ELASTIC, RH_VISCOUS, RH_MAXWELL, RH_EP,
                          RH_EVP)
            and (rheol not in (RH_EP, RH_EVP)
                 or param.mat.is_plane_strain)):
        return False
    if ctrl.surface_process_option not in (0, 1):
        return False
    if param.sim.float_dtype != "float32":
        return False
    if param.sim.is_outputting_averaged_fields:
        return False
    if not ctrl.has_moving_mesh:
        return False
    if ctrl.damping_option not in (0, 1, 2, 3, 4):
        return False
    if ctx.sbc.n_neu > 0 or param.bc.has_elastic_foundation:
        return False
    if ctx.sbc.n_grav > 0 and not _grav_facets_canonical(ctx):
        return False
    nx, nz = ctx.sgrid
    nxc, nzc = nx - 1, nz - 1
    if nzc % 128 != 0:
        return False
    if _pick_tc(nxc) is None:
        return False
    return True


def _grav_facets_canonical(ctx) -> bool:
    """Whether the gravity-traction facet tables are the full bottom/top
    rows that pallas2d._grav_facets_structured accepts."""
    nx, nz = ctx.sgrid
    nxc, nzc = nx - 1, nz - 1
    fn, fe, kind = ctx.sbc.facet_nodes, ctx.sbc.facet_elem, ctx.sbc.kind
    if not set(np.unique(kind)).issubset({0, 1}):
        return False
    for kval, lane in ((0, 0), (1, nz - 1)):
        rows = np.where(kind == kval)[0]
        if rows.size == 0:
            continue
        cols = fn[rows] // nz
        if not ((fn[rows] % nz) == lane).all():
            return False
        if rows.size != nxc \
                or sorted(cols.min(axis=1).tolist()) != list(range(nxc)):
            return False
        left_first = cols[:, 0] < cols[:, 1]
        if not (left_first.all() or (~left_first).all()):
            return False
        erow = (fe[rows] // 2) % nzc
        if np.unique(fe[rows] % 2).size != 1 \
                or not (erow == (0 if kval == 0 else nzc - 1)).all():
            return False
    return True


def _pick_tc(nxc: int):
    force = os.environ.get("DES_PALLAS_TC")
    if force and nxc % int(force) == 0:
        return int(force)
    for tc in (64, 32, 16, 8):
        if nxc % tc == 0:
            return tc
    return None


# the TPU's VMEM budget for the resident block, kept so that both packages
# choose the resident chunk for the same configs
_RESIDENT_VMEM_BUDGET = 80 * 1024 * 1024


def _nzp(nz: int) -> int:
    return ((nz + 127) // 128) * 128


def resident_applicable(param: Param, ctx) -> bool:
    """Static gate of the resident chunk runner
    (pallas2d.resident_applicable): the fused-step gate plus chunk-constant
    vbc targets and the TPU's whole-mesh VMEM budget."""
    if os.environ.get("DES_NO_RESIDENT"):
        return False
    if not pallas_step_applicable(param, ctx):
        return False
    if param.control.use_global_velocity_scaling:
        return False  # per-step vmax feedback into the mass matrix
    spec = ctx.vbc
    tx0, tx1, _, _, tz0, tz1 = spec.types
    if tx0 not in (0, 1, 2, 3, 4, 6) or tx1 not in (0, 1, 2, 3, 4, 6):
        return False
    if tz0 not in (0, 1, 2, 3, 4) or tz1 not in (0, 1, 2, 3, 4):
        return False
    for arr in (spec.ratio_x0, spec.ratio_x1, spec.period_ratio_x0,
                spec.period_ratio_x1):
        # a profile is chunk-constant iff its interpolated ratio is the
        # same everywhere (the defaults are all-ones vectors)
        if torch.unique(arr).numel() > 1:
            return False
    if spec.bottom_shear_zone_thickness > 0:
        return False
    if tz1 != 0 and np.isfinite(spec.vbc_val_z1_loading_period):
        return False

    nx, nz = ctx.sgrid
    nxc, nzc = nx - 1, nz - 1
    if nxc % 8 != 0:
        return False
    NW = nxc + 16
    NZP = _nzp(nz)
    nmat = param.mat.nmat
    uniform = (nmat == 1 and param.ic.temperature_option in (0, 1, 90))
    nce = 0 if uniform else (len(CE_SLOTS) + nmat) * 2 * NW * nzc
    cells = (NE * 2 * NW * nzc + nce)
    nodes = (13 + NCN + 2) * NW * NZP   # pallas2d.py's NN is 13
    if 4 * (cells + nodes) > _RESIDENT_VMEM_BUDGET:
        return False
    return True


def unported_features(param: Param, ctx) -> list:
    """Features that pass the gates above but that this package's fused
    step does not compute yet (pallas2d.py:840-894 and :952-991)."""
    out = []
    if ctx.sbc.n_grav > 0:
        out.append("in-kernel gravity-facet tractions (Winkler / water "
                   "loading)")
    if param.control.surface_process_option == 1:
        out.append("surface process option 1")
    if param.mat.nmat > MAXMAT:
        out.append(f"more than {MAXMAT} materials")
    return out


# ------------------------------------------------------ static step plan

@dataclass
class StepPlan:
    """Everything static about the fused step of one (param, mesh): sizes,
    switches and constants as Python values (float64, rounded to the run
    dtype where they enter the arithmetic, exactly as pallas2d.py rounds
    them), the cell parity, and the same values packed for the CUDA
    kernel (``ip`` int32, ``fp`` float64 host arrays)."""

    nx: int
    nz: int
    dtype: torch.dtype
    rheol: int
    nmat: int
    uniform: bool
    ce_const: dict
    mc: list
    sw: dict          # integer switches
    k: dict           # float constants
    par: torch.Tensor  # (nxc, nzc) bool cell parity
    ip: np.ndarray
    fp: np.ndarray

    @property
    def nxc(self) -> int:
        return self.nx - 1

    @property
    def nzc(self) -> int:
        return self.nz - 1

    def nblocks(self) -> int:
        """Columns of the partials buffer: the larger count of virtual
        blocks of the element and the node phases."""
        ncell, nnode = self.nxc * self.nzc, self.nx * self.nz
        return max(-(-ncell // BLOCK), -(-nnode // BLOCK))


# ip slots (csrc/fused2d.cu StepParams::from_host)
IP_FIELDS = ("nx", "nz", "nmat", "rheol", "uniform", "nmd", "thermal",
             "gravity_on", "damping", "surf_corr", "quasi_static", "use_gvs",
             "oceanic", "decay_uniform", "fixed_on", "jaumann")
# fp slots before the 12 CE constants and the per-material blocks
FP_FIELDS = ("surface_T", "visc_min", "visc_max", "tension_max", "fac",
             "one_m_fac", "two_m_fac", "ps2", "lam_hl", "inertial",
             "log_q", "log_1e6", "deg2rad", "tdmax", "max_vbc", "ps",
             "swave_ref", "fixed_dt", "frac", "big", "lam_u", "a1_u",
             "rhoq_u")


def make_plan(param: Param, ctx, device) -> StepPlan:
    """Build the StepPlan (cf. the closure constants of
    pallas2d.make_pallas_step)."""
    ctrl, mat = param.control, param.mat
    nx, nz = ctx.sgrid
    dtype = torch.float32 if param.sim.float_dtype == "float32" \
        else torch.float64
    tabn = ctx.mat.host()
    nmat = int(tabn["rho0"].shape[0])
    npe = 3.0
    max_vbc = float(ctx.max_vbc_val)
    uniform = nmat == 1 and param.ic.temperature_option in (0, 1, 90)
    ce_const = {}
    if uniform:
        # one material: the mixing means are the material's values
        # whatever the marker weights (matprops.cxx:115-144)
        phi = float(tabn["porosity"][0])
        rho0 = float(tabn["rho0"][0])
        alpha = float(tabn["alpha"][0])
        g = float(ctrl.gravity)
        K = float(tabn["bulk_modulus"][0])
        G = float(tabn["shear_modulus"][0])
        cp = float(tabn["heat_capacity"][0])
        ab = float(tabn["biot_coeff"][0])
        bf = 1.0 / float(tabn["fluid_bulk_modulus"][0])
        ce_const = {
            "valid": 1.0, "radiogenic_source": 0.0,
            "bulkm": K, "shearm": G, "kappa": float(tabn["therm_cond"][0]),
            "rhoA": rho0, "rhoB": rho0 * alpha,
            "buoyA": ((1 - phi) * rho0 + 1000.0 * phi) * g / npe,
            "buoyB": (1 - phi) * rho0 * alpha * g / npe,
            "cpA": cp * rho0, "cpB": cp * rho0 * alpha,
            "hmA": ((ab + phi - ab * phi) / (K + G / 3.0) + phi * bf) / npe,
        }
    sw = {
        "nx": nx, "nz": nz, "nmat": nmat, "rheol": mat.rheol_type,
        "uniform": int(uniform), "nmd": int(ctrl.is_using_mixed_stress),
        "thermal": int(ctrl.has_thermal_diffusion),
        "gravity_on": int(ctrl.gravity != 0),
        "damping": ctrl.damping_option,
        "surf_corr": int(ctrl.has_surface_correction),
        "quasi_static": int(ctrl.is_quasi_static),
        "use_gvs": int(ctrl.use_global_velocity_scaling),
        "oceanic": mat.mattype_oceanic_crust,
        "decay_uniform": int(mat.mattype_oceanic_crust != 0),
        "fixed_on": int(ctrl.fixed_dt != 0.0),
        "jaumann": int(bool(mat.rheol_type & RH_ELASTIC)),
        "qcsi": param.mesh.quality_check_step_interval,
    }
    ps = max_vbc * ctrl.inertial_scaling
    k = {
        "surface_T": float(param.bc.surface_temperature),
        "visc_min": float(tabn["visc_min"]),
        "visc_max": float(tabn["visc_max"]),
        "tension_max": float(tabn["tension_max"]),
        "fac": ctrl.damping_factor,
        "one_m_fac": 1.0 - ctrl.damping_factor,
        "two_m_fac": 2.0 - ctrl.damping_factor,
        "ps2": ps * ps, "lam_hl": SP.LN2 / SP.PLSTRAIN_HALF_LIFE,
        "inertial": float(ctrl.inertial_scaling),
        "gravity": float(ctrl.gravity),
        "log_q": FC.LOG_QUARTER, "log_1e6": FC.LOG_1E6,
        "deg2rad": FC.DEG2RAD,
        "tdmax": float(tabn["therm_diff_max"]), "max_vbc": max_vbc,
        "ps": ps,
        "swave_ref": float(np.sqrt(mat.bulk_modulus[mat.mattype_ref]
                                   / mat.rho0[mat.mattype_ref])),
        "fixed_dt": float(ctrl.fixed_dt), "frac": float(ctrl.dt_fraction),
        "big": float(torch.finfo(dtype).max),
    }
    # single-material moduli combinations are formed in float64 before
    # they meet the f32 arithmetic, as the Python floats of pallas2d.py
    # are; the CUDA kernel takes them precomputed
    K, G = ce_const.get("bulkm", 0.0), ce_const.get("shearm", 0.0)
    k.update(lam_u=K - 2.0 / 3.0 * G, a1_u=K + 4.0 / 3.0 * G,
             rhoq_u=K / (ps * ps))
    mc = FC.mat_consts(tabn)
    ip = np.array([sw[f] for f in IP_FIELDS], dtype=np.int32)
    fp = np.array([k[f] for f in FP_FIELDS]
                  + [ce_const.get(f, 0.0) for f in CE_SLOTS]
                  + [c[f] for c in mc for f in FC.MAT_FIELDS],
                  dtype=np.float64)
    par = torch.as_tensor(parity_2d(nx, nz), device=device)
    return StepPlan(nx=nx, nz=nz, dtype=dtype,
                    rheol=mat.rheol_type, nmat=nmat, uniform=uniform,
                    ce_const=ce_const, mc=mc, sw=sw, k=k, par=par,
                    ip=ip, fp=fp)


# ------------------------------------------- packing (chunk boundaries)

def state_to_planes(s, nx: int, nz: int):
    """State -> (epack (NE, 2, nxc, nzc), npack (NN, nx, nz)), contiguous."""
    nxc, nzc = nx - 1, nz - 1
    planes = [getattr(s, f).reshape(nxc, nzc, 2).permute(2, 0, 1)
              for f in E_SLOTS]
    for f in T_SLOTS:
        t = getattr(s, f).reshape(nxc, nzc, 2, 3).permute(3, 2, 0, 1)
        planes.extend([t[0], t[1], t[2]])
    epack = torch.stack(planes).contiguous()
    nodal = [s.coord[:, 0], s.coord[:, 1], s.vel[:, 0], s.vel[:, 1],
             s.temperature, s.mass, s.tmass, s.hmass, s.volume_n,
             s.force[:, 0], s.force[:, 1]]
    npack = torch.stack([a.reshape(nx, nz) for a in nodal]).contiguous()
    return epack, npack


def planes_to_state(s, epack, npack, nx: int, nz: int, **scalars):
    """Packed planes (+ new scalars) -> State; other fields pass through."""
    nxc, nzc = nx - 1, nz - 1
    nelem = nxc * nzc * 2

    def p2e(p):
        return p.permute(1, 2, 0).reshape(nelem)

    upd = {f: p2e(epack[_eslot(f)]) for f in E_SLOTS}
    for f in T_SLOTS:
        k = _tslot(f)
        upd[f] = epack[k:k + 3].permute(2, 3, 1, 0).reshape(nelem, 3)

    def p2n(nm):
        return npack[_nslot(nm)].reshape(nx * nz)

    upd["coord"] = torch.stack([p2n("coord_x"), p2n("coord_z")], dim=1)
    upd["vel"] = torch.stack([p2n("vel_x"), p2n("vel_z")], dim=1)
    upd["force"] = torch.stack([p2n("force_x"), p2n("force_z")], dim=1)
    for nm in ("temperature", "mass", "tmass", "hmass", "volume_n"):
        upd[nm] = p2n(nm)
    return s.replace(**upd, **scalars)


# ------------------------------------------------ stencils on the planes

def gather_planes(g, par):
    """Nodal plane (nx, nz) -> 3 corner-slot planes, each (2, nxc, nzc):
    triangle 0 is (c00, c10, c11|c01), triangle 1 (c00|c10, c11, c01),
    the alternative chosen by the cell parity (ops/structured.py)."""
    c00, c10 = g[:-1, :-1], g[1:, :-1]
    c01, c11 = g[:-1, 1:], g[1:, 1:]
    return (torch.stack([c00, torch.where(par, c00, c10)]),
            torch.stack([c10, c11]),
            torch.stack([torch.where(par, c11, c01), c01]))


def _pad4(a00, a10, a11, a01):
    """Per-cell corner sums -> nodal plane, adding in the fixed order
    00, 10, 11, 01 (pallas2d.py _pad4)."""
    out = nnf.pad(a00, (0, 1, 0, 1))
    out = out + nnf.pad(a10, (0, 1, 1, 0))
    out = out + nnf.pad(a11, (1, 0, 1, 0))
    return out + nnf.pad(a01, (1, 0, 0, 1))


def asm_planes(c0, c1, c2, par):
    """Transpose of gather_planes: corner-slot contributions (each
    (2, nxc, nzc)) -> nodal sums (nx, nz)."""
    z = torch.zeros((), dtype=c0.dtype, device=c0.device)
    a00 = c0[0] + torch.where(par, c0[1], z)
    a10 = c1[0] + torch.where(par, z, c0[1])
    a11 = torch.where(par, c2[0], z) + c1[1]
    a01 = torch.where(par, z, c2[0]) + c2[1]
    return _pad4(a00, a10, a11, a01)


def asm_equal_planes(v, par):
    """asm_planes with the same value at all three corners."""
    z = torch.zeros((), dtype=v.dtype, device=v.device)
    a00 = v[0] + torch.where(par, v[1], z)
    a10 = v[0] + torch.where(par, z, v[1])
    a11 = torch.where(par, v[0], z) + v[1]
    a01 = torch.where(par, z, v[0]) + v[1]
    return _pad4(a00, a10, a11, a01)


def shape_fn(xs, zs, vol):
    iv = 1.0 / (2.0 * vol)
    dndx = (iv * (zs[1] - zs[2]), iv * (zs[2] - zs[0]),
            iv * (zs[0] - zs[1]))
    dndz = (iv * (xs[2] - xs[1]), iv * (xs[0] - xs[2]),
            iv * (xs[1] - xs[0]))
    return dndx, dndz


def volume_of(xs, zs):
    """Triangle area; the same operations as ops/shapefn.compute_volume."""
    return 0.5 * ((xs[1] - xs[0]) * (zs[2] - zs[0])
                  - (zs[1] - zs[0]) * (xs[2] - xs[0]))


def min_height(xs, zs, vol):
    def sq(a):
        return a * a

    d01 = sq(xs[0] - xs[1]) + sq(zs[0] - zs[1])
    d12 = sq(xs[1] - xs[2]) + sq(zs[1] - zs[2])
    d02 = sq(xs[0] - xs[2]) + sq(zs[0] - zs[2])
    dmax = torch.maximum(torch.maximum(d01, d12), d02)
    return 2.0 * vol / torch.sqrt(dmax)


# ------------------------------------------------- the step, plain torch

def _div(a, b):
    """a / b rounded once.  Single-material properties are Python
    floats, and PyTorch computes ``float / tensor`` as
    ``reciprocal(b) * a``."""
    if isinstance(a, float):
        return torch.div(torch.full_like(b, a), b)
    return a / b


def step_planes_plain(P: StepPlan, ein, nin, cep, cnp, tgt, dt, gvs,
                      refresh, decay):
    """One whole time step on the packed planes, in plain PyTorch: the
    whole-mesh ``_core`` of pallas2d.py (dynearthsol.cxx:746-956 minus the
    gravity-facet tractions and surface processes).

    ``dt``/``gvs`` are 0-d tensors, ``refresh``/``decay`` 0-d bools.
    Returns (epack, npack, red) with red = (min height, min height /
    shear-wave speed, max |v|, sum |force|^2); the first three are the
    CFL metrics of the moved mesh and matter only on refresh steps."""
    sw, k = P.sw, P.k
    rheol = P.rheol
    par = P.par
    npe = 3.0
    dtype = ein.dtype

    def E(nm):
        return ein[_eslot(nm)]

    def TEN(nm):
        i = _tslot(nm)
        return ein[i], ein[i + 1], ein[i + 2]

    def N(nm):
        return nin[_nslot(nm)]

    if P.uniform:
        def CE(nm):
            return P.ce_const[nm]

        w = [1.0]
    else:
        def CE(nm):
            return cep[CE_SLOTS.index(nm)]

        w = [cep[len(CE_SLOTS) + m] for m in range(P.nmat)]

    def zero_like(a):
        return torch.zeros_like(a)

    vol = E("volume")
    xs = gather_planes(N("coord_x"), par)
    zs = gather_planes(N("coord_z"), par)
    vxs = gather_planes(N("vel_x"), par)
    vzs = gather_planes(N("vel_z"), par)
    ts = gather_planes(N("temperature"), par)

    dndx, dndz = shape_fn(xs, zs, vol)
    temp_e = (ts[0] + ts[1] + ts[2]) / npe
    TinC = temp_e - CELSIUS0
    bulkm = CE("bulkm")
    shearm = CE("shearm")
    rho_e = CE("rhoA") - CE("rhoB") * TinC

    # temperature diffusion (fields.cxx:197-283)
    temperature_new = N("temperature")
    if sw["thermal"]:
        kv = CE("kappa") * vol
        source = CE("radiogenic_source") * vol * rho_e / npe
        gtx = dndx[0] * ts[0] + dndx[1] * ts[1] + dndx[2] * ts[2]
        gtz = dndz[0] * ts[0] + dndz[1] * ts[1] + dndz[2] * ts[2]
        contrib = tuple(kv * (dndx[i] * gtx + dndz[i] * gtz) - source
                        for i in range(3))
        tdot = asm_planes(*contrib, par)
        temperature_new = torch.where(
            cnp[0] > 0, torch.full_like(tdot, k["surface_T"]),
            N("temperature") - dt * tdot / N("tmass"))

    # strain rate (fields.cxx:408-483)
    lxx = vxs[0] * dndx[0] + vxs[1] * dndx[1] + vxs[2] * dndx[2]
    lzz = vzs[0] * dndz[0] + vzs[1] * dndz[1] + vzs[2] * dndz[2]
    lxz = 0.5 * (vxs[0] * dndz[0] + vxs[1] * dndz[1] + vxs[2] * dndz[2]
                 + vzs[0] * dndx[0] + vzs[1] * dndx[1]
                 + vzs[2] * dndx[2])
    sr = (lxx, lzz, lxz)

    # dvoldt / edvoldt anti-locking (geometry.cxx:202-276)
    dvoldt = asm_equal_planes((lxx + lzz) * vol, par) / N("volume_n")
    dvs = gather_planes(dvoldt, par)
    edvoldt = (dvs[0] + dvs[1] + dvs[2]) / npe

    adj = (edvoldt - (lxx + lzz)) / 2.0
    edot = (lxx + adj, lzz + adj, lxz)
    de = (edot[0] * dt, edot[1] * dt, edot[2] * dt)
    strain_old = TEN("strain")
    strain = tuple(strain_old[i] + de[i] for i in range(3))

    # constitutive update (rheology.cxx:676-991)
    stress_old = TEN("stress")
    old_tr = stress_old[0] + stress_old[1]
    stressyy = E("stressyy")
    plstrain = E("plstrain")
    delta_plstrain = E("delta_plstrain")
    viscosity = E("viscosity")

    def creep_visc():
        s0 = (stress_old[0] + stress_old[1]) / 2.0
        d = sr[0] - sr[1]
        rII2 = 0.25 * (d * d) + sr[2] * sr[2]
        ed = torch.clamp(torch.sqrt(rII2), min=MIN_STRAIN_RATE)
        return FC.visc_core_local(P.mc, w, temp_e, s0, ed, k["visc_min"],
                                  k["visc_max"])

    def plastic():
        return FC.plastic_props_local(P.mc, w, plstrain, k["tension_max"])

    def second_inv2(t):
        d = t[0] - t[1]
        return 0.25 * (d * d) + t[2] * t[2]

    if rheol == RH_ELASTIC:
        stress_c = R.elastic2_c(bulkm, shearm, de, stress_old)
    elif rheol == RH_VISCOUS:
        viscosity = creep_visc()
        stress_c = R.viscous2_c(bulkm, viscosity, strain[0] + strain[1],
                                edot)
    elif rheol == RH_MAXWELL:
        viscosity = creep_visc()
        dv = vol / E("volume_old") - 1.0
        stress_c = R.maxwell2_c(bulkm, shearm, viscosity, dt, dv, de,
                                stress_old)
    elif rheol == RH_EP:
        amc, anphi, anpsi, hardn, ten_max = plastic()
        stress_c, stressyy, depls, _ = R.elasto_plastic2d_c(
            bulkm, shearm, amc, anphi, anpsi, hardn, ten_max,
            de, stress_old, E("stressyy"))
        plstrain = plstrain + depls
        delta_plstrain = depls
    elif rheol == RH_EVP:
        viscosity = creep_visc()
        dv = vol / E("volume_old") - 1.0
        sv = R.maxwell2_c(bulkm, shearm, viscosity, dt, dv, de, stress_old)
        amc, anphi, anpsi, hardn, ten_max = plastic()
        sp, spyy, depls, _ = R.elasto_plastic2d_c(
            bulkm, shearm, amc, anphi, anpsi, hardn, ten_max,
            de, stress_old, E("stressyy"))
        # min-magnitude selection (rheology.cxx:869-879)
        use_v = second_inv2(sv) < second_inv2(sp)
        stress_c = tuple(torch.where(use_v, p, q) for p, q in zip(sv, sp))
        stressyy = torch.where(use_v, E("stressyy"), spyy)
        plstrain = torch.where(use_v, plstrain, plstrain + depls)
        delta_plstrain = torch.where(use_v, delta_plstrain, depls)
    else:
        raise ValueError(f"fused step: unsupported rheology {rheol}")

    dpressure = E("dpressure")
    if sw["nmd"]:
        # nodal-mixed-discretization pressure smoothing
        # (geometry.cxx:279-331)
        dpressure = stress_c[0] + stress_c[1] - old_tr
        dp_nd = asm_equal_planes(dpressure * vol, par) / N("volume_n")
        dps = gather_planes(dp_nd, par)
        ddp = ((dps[0] + dps[1] + dps[2]) / npe - dpressure) / 2.0
        stress_c = (stress_c[0] + ddp, stress_c[1] + ddp, stress_c[2])

    # force assembly (fields.cxx:612-703)
    buoy = CE("buoyA") - CE("buoyB") * TinC if sw["gravity_on"] \
        else zero_like(vol)
    fx = tuple((stress_c[0] * dndx[i] + stress_c[2] * dndz[i]) * vol
               for i in range(3))
    fz = tuple((stress_c[2] * dndx[i] + stress_c[1] * dndz[i] + buoy) * vol
               for i in range(3))
    force_x = -asm_planes(*fx, par)
    force_z = -asm_planes(*fz, par)
    r2 = (force_x * force_x + force_z * force_z).sum()

    # damping + velocity + vbcs (fields.cxx:486-582,730-747; bc.cxx)
    mass_n = N("mass")
    vx, vz = N("vel_x"), N("vel_z")
    fdx, fdz = force_x, force_z
    damp = sw["damping"]
    if damp == 1:
        fac = k["fac"]
        fdx = force_x - torch.where(
            torch.abs(vx) > 1e-13,
            fac * torch.abs(force_x) * torch.sign(vx), zero_like(vx))
        fdz = force_z - torch.where(
            torch.abs(vz) > 1e-13,
            fac * torch.abs(force_z) * torch.sign(vz), zero_like(vz))
    elif damp == 2:
        fdx = force_x * k["one_m_fac"]
        fdz = force_z * k["one_m_fac"]
    elif damp == 3:
        fdx = torch.where((force_x < 0) == (vx < 0),
                          force_x * k["one_m_fac"],
                          force_x * k["two_m_fac"])
        fdz = torch.where((force_z < 0) == (vz < 0),
                          force_z * k["one_m_fac"],
                          force_z * k["two_m_fac"])
    elif damp == 4:
        crit = 2.0 * torch.sqrt(mass_n * cnp[3])

        def d4(f, v):
            fC = k["fac"] * torch.abs(f) * torch.sign(v)
            fV = crit * v
            pick = torch.where(torch.abs(fC) < torch.abs(fV), fV, fC)
            return f - torch.where(torch.abs(v) > 1e-13, pick,
                                   zero_like(v))

        fdx, fdz = d4(force_x, vx), d4(force_z, vz)

    vel_x = vx + dt * fdx / mass_n
    vel_z = vz + dt * fdz / mass_n
    vel_x = torch.where(cnp[1] > 0, tgt[0], vel_x)
    vel_z = torch.where(cnp[2] > 0, tgt[1], vel_z)

    # coordinate update + post-move geometry (dynearthsol.cxx:431-473)
    coord_x = N("coord_x") + vel_x * dt
    coord_z = N("coord_z") + vel_z * dt
    xs2 = gather_planes(coord_x, par)
    zs2 = gather_planes(coord_z, par)
    vxs2 = gather_planes(vel_x, par)
    vzs2 = gather_planes(vel_z, par)
    volume_new = volume_of(xs2, zs2)

    # CFL metrics (geometry.cxx:756-923), used on dt-refresh steps only
    vx_m = (vxs2[0] + vxs2[1] + vxs2[2]) / npe
    vz_m = (vzs2[0] + vzs2[1] + vzs2[2]) / npe
    vmag = torch.sqrt(vx_m * vx_m + vz_m * vz_m)
    minh = min_height(xs2, zs2, volume_new)
    swave = torch.sqrt(_div(shearm, rho_e))
    big = torch.full((), k["big"], dtype=dtype, device=ein.device)
    red = torch.stack([
        torch.where(refresh, minh.min(), big),
        torch.where(refresh, (minh / swave).min(), big),
        torch.where(refresh, vmag.max(), torch.zeros_like(big)),
        r2])

    # (pseudo-)mass matrices (geometry.cxx:1020-1154)
    if sw["use_gvs"]:
        apparent = torch.minimum(gvs, torch.sqrt(_div(shearm, rho_e)))
        rho_q = _div(bulkm, apparent * apparent)
    else:
        rho_q = bulkm / k["ps2"] + zero_like(vol)
    rho_m = rho_q if sw["quasi_static"] else rho_e
    volume_n = asm_equal_planes(volume_new, par)
    mass_new = asm_equal_planes(rho_m * volume_new / npe, par)
    tmass_new = asm_equal_planes(
        (CE("cpA") - CE("cpB") * TinC) * volume_new / npe, par)
    hmass_new = asm_equal_planes(CE("hmA") * volume_new + zero_like(vol),
                                 par)

    # Jaumann rotation (fields.cxx:832-907) with post-move geometry
    stress3, strain3 = stress_c, strain
    if sw["jaumann"]:
        dndx2, dndz2 = shape_fn(xs2, zs2, volume_new)
        w2 = 0.5 * ((vzs2[0] * dndx2[0] + vzs2[1] * dndx2[1]
                     + vzs2[2] * dndx2[2])
                    - (vxs2[0] * dndz2[0] + vxs2[1] * dndz2[1]
                       + vxs2[2] * dndz2[2]))
        wdt = w2 * dt

        def rot(tt):
            return (tt[0] - 2.0 * tt[2] * wdt,
                    tt[1] + 2.0 * tt[2] * wdt,
                    tt[2] + (tt[0] - tt[1]) * wdt)

        stress3 = rot(stress_c)
        strain3 = rot(strain)

    # correct_surface_element (bc.cxx:1613-1665): every element touching
    # a top node (the z row nzc-1) is rescaled by 1/rdv when it grew, and
    # its pre-swap volume overwritten (pallas2d.py:1059-1078)
    volume_old_out = vol
    if sw["surf_corr"]:
        zmask = torch.zeros_like(vol, dtype=torch.bool)
        zmask[:, :, -1] = True
        rdv = volume_new / vol
        sc = torch.where(zmask & (rdv >= 1.0), 1.0 / rdv,
                         torch.ones_like(rdv))
        stress3 = tuple(x * sc for x in stress3)
        strain3 = tuple(x * sc for x in strain3)
        edot = tuple(x * sc for x in edot)
        plstrain = plstrain * sc
        volume_old_out = torch.where(zmask, volume_new, vol)
        # surface_plstrain_diffusion (bc.cxx:1591-1611): decay at the
        # quality-check cadence, skipped for oceanic-crust elements
        if P.uniform:
            applies = bool(sw["decay_uniform"])
        else:
            dom, dom_m = w[0], torch.zeros_like(vol, dtype=torch.int32)
            for m in range(1, P.nmat):
                dom_m = torch.where(w[m] > dom, m, dom_m)
                dom = torch.maximum(dom, w[m])
            applies = dom_m != sw["oceanic"]
        lam_dt = torch.full_like(dt, k["lam_hl"]) * dt
        dec_on = decay & zmask & applies
        plstrain = plstrain - torch.where(dec_on, plstrain * lam_dt,
                                          zero_like(plstrain))

    e_out = {"volume": volume_new, "volume_old": volume_old_out,
             "stressyy": stressyy, "plstrain": plstrain,
             "delta_plstrain": delta_plstrain, "viscosity": viscosity,
             "dpressure": dpressure, "edvoldt": edvoldt,
             "stress": stress3, "strain": strain3, "strain_rate": edot}
    eplanes = [e_out[nm] for nm in E_SLOTS]
    for nm in T_SLOTS:
        eplanes.extend(e_out[nm])
    n_out = {"coord_x": coord_x, "coord_z": coord_z, "vel_x": vel_x,
             "vel_z": vel_z, "temperature": temperature_new,
             "mass": mass_new, "tmass": tmass_new, "hmass": hmass_new,
             "volume_n": volume_n, "force_x": fdx, "force_z": fdz}
    shape_e = vol.shape
    eout = torch.stack([p.expand(shape_e) for p in eplanes])
    nout = torch.stack([n_out[nm] for nm in N_SLOTS])
    return eout, nout, red


# ------------------------------------------ per-chunk constants and probes

def const_packs(P: StepPlan, ctx, s):
    """Per-chunk constant planes (pallas2d._const_packs): the element pack
    (None for a single material, whose values are StepPlan constants) and
    the nodal pack (top mask, vbc masks, ymass)."""
    nx, nz, nxc, nzc = P.nx, P.nz, P.nxc, P.nzc
    tab = ctx.mat
    npe = 3.0
    emw = s.emw.reshape(nxc, nzc, 2, s.emw.shape[1]).permute(2, 0, 1, 3)
    bulkm = M.bulkm(tab, emw)
    shearm = M.shearm(tab, emw)
    cep = None
    if not P.uniform:
        g = P.k["gravity"]
        wsum = emw.sum(dim=-1)
        phi = M.phi_porosity(tab, emw)
        cp_e = M.cp(tab, emw)
        # rho(T) = rhoA - rhoB*(T-273C): matprops.cxx:565-587
        rhoA = (emw * tab.rho0).sum(dim=-1) / wsum
        rhoB = (emw * tab.rho0 * tab.alpha).sum(dim=-1) / wsum
        ab = M.alpha_biot(tab, emw)
        bf = M.beta_fluid(tab, emw)
        bulk_comp = 1.0 / (bulkm + shearm / 3.0)
        planes = [torch.ones_like(rhoA),
                  s.radiogenic_source.reshape(nxc, nzc, 2).permute(2, 0, 1),
                  bulkm, shearm, M.therm_cond(tab, emw), rhoA, rhoB,
                  ((1.0 - phi) * rhoA + 1000.0 * phi) * g / npe,
                  (1.0 - phi) * rhoB * g / npe,
                  cp_e * rhoA, cp_e * rhoB,
                  ((ab + phi - ab * phi) * bulk_comp + phi * bf) / npe]
        planes += [emw[..., m] for m in range(P.nmat)]
        cep = torch.stack([p.expand(2, nxc, nzc) for p in planes])

    top = ctx.top_mask.to(P.dtype).reshape(nx, nz)
    zeros = torch.zeros_like(s.coord)
    a = bc_mod.apply_vbcs(ctx.vbc, zeros, s.coord, s.time)
    b = bc_mod.apply_vbcs(ctx.vbc, torch.ones_like(s.coord), s.coord,
                          s.time)
    mask = (a == b).to(P.dtype)  # constrained components
    # ymass: constant through the chunk (9KG/(3K+G)/npe assembled)
    ym = 9.0 * bulkm * shearm / (3.0 * bulkm + shearm) / npe
    ymass = asm_equal_planes(ym, P.par)
    cnp = torch.stack([top, mask[:, 0].reshape(nx, nz),
                       mask[:, 1].reshape(nx, nz), ymass]).contiguous()
    return cep, cnp


def vbc_targets(ctx, npack, time):
    """Velocity-BC target planes (2, nx, nz): bc.apply_vbcs probed with
    zero velocity at the given coordinates and time (pallas2d.py:1466)."""
    nx, nz = npack.shape[1:]
    coord = torch.stack([npack[_nslot("coord_x")].reshape(-1),
                         npack[_nslot("coord_z")].reshape(-1)], dim=1)
    tgt = bc_mod.apply_vbcs(ctx.vbc, torch.zeros_like(coord), coord, time)
    return tgt.t().reshape(2, nx, nz).contiguous()


# ------------------------------------------------------- chunk buffers

@dataclass
class ChunkBuffers:
    """Device buffers of one chunk.  ``ein``/``nin`` hold the state before
    a step and ``eout``/``nout`` after it; they swap after every step."""

    ein: torch.Tensor
    nin: torch.Tensor
    eout: torch.Tensor
    nout: torch.Tensor
    cep: torch.Tensor | None
    cnp: torch.Tensor
    tgt: torch.Tensor
    scal: torch.Tensor     # dt, vmax, gdtmin, time, last L2 partial,
    #                        dt_maxwell
    flags: torch.Tensor    # (n, 2): refresh, decay
    dthist: torch.Tensor   # (n,)
    part: torch.Tensor     # (NPART, nblocks)
    ework: torch.Tensor    # (NEWORK, 2, nxc, nzc) element scratch (CUDA)
    nwork: torch.Tensor    # (2, nx, nz) node scratch (CUDA)

    def swap(self):
        self.ein, self.eout = self.eout, self.ein
        self.nin, self.nout = self.nout, self.nin


def dt_maxwell(P: StepPlan, ctx, emw):
    """Maxwell time-step limit, constant through a chunk (shearm depends
    on the material weights only)."""
    return _rdiv(0.5 * P.k["visc_min"],
                 1e-40 + M.shearm(ctx.mat, emw)).min()


def make_buffers(P: StepPlan, ctx, s, n: int, tiled: bool) -> ChunkBuffers:
    dev, dtype = s.coord.device, P.dtype
    ein, nin = state_to_planes(s, P.nx, P.nz)
    cep, cnp = const_packs(P, ctx, s)
    ks = s.steps + 1 + torch.arange(n, device=dev)
    refresh = ks % 10 == 0
    if tiled and P.sw["use_gvs"]:
        refresh = torch.ones_like(refresh)
    decay = ks % P.sw["qcsi"] == 0
    flags = torch.stack([refresh, decay], dim=1).to(dtype).contiguous()
    scal = torch.stack([s.dt, s.max_global_vel_mag, s.global_dt_min,
                        s.time, torch.zeros_like(s.dt),
                        dt_maxwell(P, ctx, s.emw)]).to(dtype)
    nb = P.nblocks()
    part = torch.zeros((NPART, nb), dtype=dtype, device=dev)
    part[:2] = P.k["big"]   # neutral elements of min, min, max, sum
    cuda = dev.type == "cuda"
    return ChunkBuffers(
        ein=ein, nin=nin, eout=torch.empty_like(ein),
        nout=torch.empty_like(nin), cep=cep, cnp=cnp,
        tgt=(torch.zeros((2, P.nx, P.nz), dtype=dtype, device=dev)
             if tiled else vbc_targets(ctx, nin, s.time)),
        scal=scal, flags=flags,
        dthist=torch.zeros(n, dtype=dtype, device=dev), part=part,
        ework=torch.empty((NEWORK, 2, P.nxc, P.nzc) if cuda else (0,),
                          dtype=dtype, device=dev),
        nwork=torch.empty((2, P.nx, P.nz) if cuda else (0,), dtype=dtype,
                          device=dev))


# ------------------------------------------------ kernel wrappers

def stamp_labels(P: StepPlan, n: int) -> list:
    """Names of the intervals between the stamps of an n-step chunk (the
    grid syncs of csrc/fused2d.cu step_chunk2d): A of the first step, then
    per step B, C, D, E, F, G (without NMD: B, C+E, F, G) and H with the
    dt refresh, which shares its interval with the next step's A ("H+A")
    on every step but the last."""
    per = ["B", "C", "D", "E", "F", "G"] if P.sw["nmd"] \
        else ["B", "C+E", "F", "G"]
    out = ["A"]
    for k in range(n):
        out += per + ["H+A" if k + 1 < n else "H"]
    return out


def _cuda_args_ok(P: StepPlan, b: ChunkBuffers, n: int, k: int, stamps):
    if P.dtype != torch.float32:
        raise TypeError("the CUDA fused step is built for float32 only")
    dev = b.ein.device
    ep, npl = (2, P.nxc, P.nzc), (P.nx, P.nz)
    shapes = {"ein": (NE, *ep), "eout": (NE, *ep), "nin": (NN, *npl),
              "nout": (NN, *npl), "cnp": (NCN, *npl), "tgt": (2, *npl),
              "scal": (6,), "flags": (b.flags.shape[0], 2),
              "dthist": (b.dthist.shape[0],), "part": (NPART, P.nblocks()),
              "ework": (NEWORK, *ep), "nwork": (2, *npl)}
    if not P.uniform:
        shapes["cep"] = (len(CE_SLOTS) + P.nmat, *ep)
    for name, shape in shapes.items():
        t = getattr(b, name)
        if t is None or not (t.device == dev and t.dtype == torch.float32
                             and t.is_contiguous()):
            raise TypeError(f"{name}: need a contiguous float32 tensor on "
                            f"{dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the step "
                             f"plan needs {shape}")
    if n < 1 or k < 0 or k + n > min(b.flags.shape[0], b.dthist.shape[0]):
        raise ValueError(f"steps {k}..{k + n - 1} are not steps of the "
                         "chunk buffers")
    if stamps is not None and not (
            stamps.device == dev and stamps.dtype == torch.int64
            and stamps.is_contiguous()
            and stamps.numel() > len(stamp_labels(P, n))):
        raise TypeError("stamps: need a contiguous int64 tensor of "
                        "len(stamp_labels(P, n)) + 1 entries on the card")


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def fused_chunk(P: StepPlan, b: ChunkBuffers, n: int, tiled: bool,
                k: int = 0, stamps=None):
    """Steps k .. k+n-1 of the chunk in ``b``, each followed by its dt
    refresh (time advanced step by step when ``tiled``), with the buffers
    swapped after every step: ``b.ein``/``b.nin`` then hold the state after
    the last step and ``b.eout``/``b.nout`` the state before it.  On CUDA
    tensors one cooperative launch of the chunk kernel of csrc/fused2d.cu
    (counted in ``fused_chunk.launches``), or raises; ``stamps``, None or
    an int64 tensor of len(stamp_labels(P, n)) + 1 entries, receives the
    card's clock (ns) at the start and after every grid barrier.  On CPU
    tensors chunk_plain."""
    if b.ein.is_cuda:
        from . import _build

        _cuda_args_ok(P, b, n, k, stamps)
        lib = _build.load()
        rc = lib.des_fused2d_chunk_f32(
            P.ip.ctypes.data, P.fp.ctypes.data,
            _ptr(b.ein), _ptr(b.nin), _ptr(b.eout), _ptr(b.nout),
            _ptr(b.cep), _ptr(b.cnp), _ptr(b.tgt), _ptr(b.scal),
            _ptr(b.flags[k]), _ptr(b.dthist[k:]), _ptr(b.ework),
            _ptr(b.nwork), _ptr(b.part), b.part.shape[1], n, int(tiled),
            _ptr(stamps), _stream())
        if rc != 0:
            raise RuntimeError(f"fused2d chunk launch failed: "
                               f"{_build.err(rc)}")
        fused_chunk.launches += 1
        if n % 2:  # the kernel swaps in and out n times
            b.swap()
        return
    if b.ein.device.type != "cpu":
        raise TypeError(f"no fused step for device {b.ein.device}")
    chunk_plain(P, b, n, tiled, k)


fused_chunk.launches = 0


def chunk_plain(P: StepPlan, b: ChunkBuffers, n: int, tiled: bool,
                k: int = 0):
    """The plain version of fused_chunk, on any device: for each step
    fused_step_plain, dt_refresh_plain and a swap."""
    for j in range(k, k + n):
        fused_step_plain(P, b, j)
        dt_refresh_plain(P, b.part, b.scal, b.dthist, b.flags, j, tiled)
        b.swap()


def fused_step_plain(P: StepPlan, b: ChunkBuffers, k: int):
    """step_planes_plain on the chunk buffers, step k: ``b.ein``/``b.nin``
    -> ``b.eout``/``b.nout`` (the full-mesh partials go to column 0 of
    ``b.part``), on any device; calls counted in ``.calls``."""
    fused_step_plain.calls += 1
    eout, nout, red = step_planes_plain(
        P, b.ein, b.nin, b.cep, b.cnp, b.tgt, b.scal[0],
        b.scal[1] * P.k["inertial"], b.flags[k, 0] > 0, b.flags[k, 1] > 0)
    b.eout.copy_(eout)
    b.nout.copy_(nout)
    b.part[:, 0] = red


fused_step_plain.calls = 0


def chunk_occupancy(P: StepPlan) -> dict:
    """The chunk kernel's launch shape on the current card: blocks per SM,
    SMs, grid, registers and local (stack) bytes per thread."""
    from . import _build

    out = (ctypes.c_int * 5)()
    rc = _build.load().des_fused2d_chunk_occupancy(int(P.uniform),
                                                   P.nblocks(), out)
    if rc != 0:
        raise RuntimeError(f"fused2d occupancy query failed: "
                           f"{_build.err(rc)}")
    return dict(zip(("blocks_per_sm", "sms", "grid", "registers",
                     "local_bytes"), out))


def grid_barriers(grid: int, nsync: int):
    """nsync grid-wide barriers and no work, in one cooperative launch of
    ``grid`` blocks on the current stream: what a chunk's barriers cost on
    their own (a measurement of the card; no step of the model)."""
    from . import _build

    rc = _build.load().des_grid_barriers(grid, nsync, _stream())
    if rc != 0:
        raise RuntimeError(f"barrier launch failed: {_build.err(rc)}")


def dt_refresh_plain(P, part, scal, dthist, flags, k: int, tiled: bool,
                     every: bool = False):
    """Plain version of the dt refresh, in place on ``scal`` and
    ``dthist``: record dt, finish the partials of step k, advance time
    (tiled runner) and, on refresh steps, set dt, vmax and gdtmin
    (pallas2d.py:1279-1304 and :1490-1526).  With ``every`` (the 3D step,
    pallas3d.py:1649-1690) vmax and gdtmin are set on every step and only
    dt waits for the refresh cadence.  ``P`` is a 2D or 3D step plan;
    calls counted in ``.calls``."""
    dt_refresh_plain.calls += 1
    sw, kk = P.sw, P.k

    def c(v):
        return torch.full((), v, dtype=scal.dtype, device=scal.device)

    dt_old = scal[0].clone()
    dthist[k] = dt_old
    scal[4] = part[3].sum()
    if tiled:
        scal[3] = scal[3] + dt_old
    minh = part[0].min()
    vmax = torch.maximum(part[2].max(), c(kk["max_vbc"]))
    gdtmin = part[1].min() / c(5.0)
    half_h = 0.5 * minh
    if sw["fixed_on"]:
        dt_new = c(kk["fixed_dt"])
    else:
        dt_diff = (half_h * minh / c(kk["tdmax"]) if sw["thermal"]
                   else c(kk["big"]))
        if sw["use_gvs"]:
            dt_adv = half_h / vmax
            dt_el = torch.maximum(
                half_h / (vmax * kk["inertial"]) if sw["quasi_static"]
                else half_h / c(kk["swave_ref"]), gdtmin)
        else:
            dt_adv = half_h / c(kk["max_vbc"])
            dt_el = half_h / c(kk["ps"] if sw["quasi_static"]
                               else kk["swave_ref"])
        dt_new = torch.minimum(torch.minimum(dt_el, scal[5]),
                               torch.minimum(dt_adv, dt_diff)) \
            * kk["frac"]
    refresh = flags[k, 0] > 0
    scal[0] = torch.where(refresh, dt_new, scal[0])
    if every:
        scal[1] = vmax
        scal[2] = gdtmin
    else:
        scal[1] = torch.where(refresh, vmax, scal[1])
        scal[2] = torch.where(refresh, gdtmin, scal[2])


dt_refresh_plain.calls = 0


def dt_refresh(P, b, k: int, tiled: bool, every: bool = False):
    """The per-step scalar update after step k (see dt_refresh_plain) for
    the chunk buffers of the 3D step, whose runner calls it with
    ``every``; the 2D chunk kernel refreshes dt inside its launch.  On
    CUDA tensors it launches the one-block dt_refresh kernel of
    csrc/fused2d.cu (counted in ``dt_refresh.launches``)."""
    if b.scal.is_cuda:
        from . import _build

        for name in ("part", "scal", "dthist", "flags"):
            t = getattr(b, name)
            if not (t.is_cuda and t.dtype == torch.float32
                    and t.is_contiguous()):
                raise TypeError(f"{name}: need a contiguous float32 CUDA "
                                "tensor")
        lib = _build.load()
        rc = lib.des_dt_refresh_f32(
            P.rip.ctypes.data, P.rfp.ctypes.data, _ptr(b.part),
            b.part.shape[1], _ptr(b.scal), _ptr(b.dthist), _ptr(b.flags[k]),
            k, int(tiled), int(every), _stream())
        if rc != 0:
            raise RuntimeError(f"dt_refresh launch failed: {_build.err(rc)}")
        dt_refresh.launches += 1
        return
    if b.scal.device.type != "cpu":
        raise TypeError(f"no dt_refresh for device {b.scal.device}")
    dt_refresh_plain(P, b.part, b.scal, b.dthist, b.flags, k, tiled, every)


dt_refresh.launches = 0


# ---------------------------------------------------------- chunk runners

def run_chunk(P: StepPlan, ctx, s, n: int, resident: bool,
              plain: bool = False):
    """Advance ``s`` by n fused steps.  Resident (pallas2d.py:1371-1413):
    vbc targets probed once per chunk, the chunk in one launch, time =
    s.time + sum(dt history).  Tiled (pallas2d.py:1457-1532): targets
    probed every step from the pre-move coordinates at time + dt, one
    launch per step, time accumulated step by step.  ``plain`` runs the
    plain version on the state's device instead of the kernel (the
    reference the CUDA kernel is checked against)."""
    tiled = not resident
    b = make_buffers(P, ctx, s, n, tiled)
    run = chunk_plain if plain else fused_chunk
    if resident:
        run(P, b, n, False)
    else:
        for k in range(n):
            b.tgt = vbc_targets(ctx, b.nin, b.scal[3] + b.scal[0])
            run(P, b, 1, True, k)
    time = b.scal[3].clone() if tiled else s.time + b.dthist.sum()
    nnode2 = torch.full((), float(P.nx * P.nz * 2), dtype=P.dtype,
                        device=b.scal.device)
    return planes_to_state(
        s, b.ein, b.nin, P.nx, P.nz, time=time, dt=b.scal[0].clone(),
        steps=s.steps + n, max_global_vel_mag=b.scal[1].clone(),
        global_dt_min=b.scal[2].clone(),
        l2_residual=torch.sqrt(b.scal[4] / nnode2))


def make_chunk_runner(param: Param, ctx, n: int):
    """run(ctx, state) -> state after n fused steps, tiled form (the
    counterpart of pallas2d.make_chunk_runner)."""
    P = make_plan(param, ctx, ctx.conn.device)
    return lambda c, s: run_chunk(P, c, s, n, resident=False)


def make_resident_chunk_runner(param: Param, ctx, n: int):
    """run(ctx, state) -> state after n fused steps, resident form (the
    counterpart of pallas2d.make_resident_chunk_runner)."""
    P = make_plan(param, ctx, ctx.conn.device)
    return lambda c, s: run_chunk(P, c, s, n, resident=True)
