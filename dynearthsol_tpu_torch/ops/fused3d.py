"""The fused 3D structured time step (counterpart of
dynearthsol_tpu/ops/pallas3d.py).

The JAX package fuses the whole dynearthsol.cxx:746-956 step sequence on
the 5-tet structured grid into one Pallas kernel that tiles y with a
recomputed halo.  Here the same step is the CUDA file csrc/fused3d.cu: one
launch per phase (every element->node->element hop needs a grid-wide
barrier), no halo tiles, edges masked by index.  ``step_planes_plain`` is
the same step in plain PyTorch on the same plane layout; the CPU tests hold
it against the JAX package and chip_smoke.py holds the CUDA kernel against
it on the card.

Layout.  Element state is packed into ``(NE, 5, nxc, nyc, nzc)`` planes
(slot, tet, cell x, cell y, cell z), nodal state into ``(NN, nx, ny, nz)``,
z contiguous in both: the order of the node id (i*ny + j)*nz + k and of the
element id ((i*nyc + j)*nzc + k)*5 + t.  Cell (i, j, k) holds five tets
whose corners come from ``structured.tet_tables`` by the parity of
i + j + k.  A const nodal pack holds the top mask and the vbc component
masks.  Velocity BCs are ``where(mask, target, v)`` with targets probed from
``bc.apply_vbcs`` at zero velocity, every step, from the pre-move
coordinates at time + dt (pallas3d.py:1619-1637).

Node sums follow grid3d.asm: for each corner code, a per-cell partial over
(tet, slot) in order, then the eight codes in order.  The CUDA kernel adds
in the same order with no atomics.

A chunk runs in a chunk form (``run_chunk``): each step leaves its tensor
epilogue (``epilogue``) pending on the planes for the next step to apply,
and one finalize applies the last; the result equals that many complete
steps (``fused3d_step``) bit for bit.

Scalars stay on the device as in 2D (ops/fused2d.py ``scal``, ``flags``).
Unlike the 2D step, the 3D step sets vmax and gdtmin from the CFL partials
of EVERY step and only dt waits for the 10-step cadence
(pallas3d.py:1649-1690); ``dt_refresh`` runs with ``every=True``.

Material properties.  A single material with uniform ICs
(``_uniform_mat``) takes its properties as plan constants.  Otherwise a
const element pack (``const_epack``, pallas3d._const_epack) holds the
radiogenic source and the raw marker weight of each material, and the
step mixes the properties from the weights where it uses them
(matprops.cxx:115-144, pallas3d.py:825-946): harmonic means of the moduli,
arithmetic means of the rest, and the viscosity's and the plastic
weakening's material loops.

Boundary processes (the template switch BND of csrc/fused3d.cu).  The
Winkler and water facet tractions (apply_stress_bcs, bc.cxx:632-790;
pallas3d.py:1221-1290) come from the canonical facet tables that
``grav_facets`` decodes into per-parity (tet, corner-code) groups; they
are added to the assembled force after the residual's partial.  Surface process option 1
(surface_dh_3d, bc.cxx:920-1050; pallas3d.py:1324-1394) diffuses the top
lane between the coordinate move and the post-move geometry; its ``dhacc``
and per-facet ``edv`` accumulators ride three more nodal planes, placed by
``surf_maps``.

Gating is pallas3d.py's together with grid3d.grid_step_applicable, ported
as it is so that both packages dispatch alike.  ``unported_features``
refuses only more materials than the kernel's MAXMAT.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import bc as bc_mod
from ..config import RH_ELASTIC, RH_EP, RH_EVP, RH_MAXWELL, RH_VISCOUS, Param
from ..state import state_from_numpy, state_to_numpy
from . import fused2d
from . import fused_common as FC
from . import rheology as R
from .geometry import tet_min_height
from .matprops import CELSIUS0, MIN_STRAIN_RATE
from .shapefn import tet_volume
from .structured import parity_3d, tet_tables
from .tensor import inv2_6

# ---- packed-state slot maps ----
# element pack: scalars then 6-component tensors, each (5, nxc, nyc, nzc)
E_SLOTS = ("volume", "volume_old", "plstrain", "delta_plstrain",
           "viscosity", "dpressure", "edvoldt")
T_SLOTS = ("stress", "strain", "strain_rate")  # 6 planes each
NE = len(E_SLOTS) + 6 * len(T_SLOTS)            # 25

# nodal pack (NN, nx, ny, nz); with surface process option 1 three more
# planes (pallas3d.py:74-79): the height accumulator dhacc and edvacc_surf
# of each top cell's two triangles at the cell's (x0, y0, top) node
# (surf_maps), so NN_SURF planes
N_SLOTS = ("coord_x", "coord_y", "coord_z", "vel_x", "vel_y", "vel_z",
           "temperature", "mass", "tmass", "hmass", "volume_n",
           "force_x", "force_y", "force_z")
NN = len(N_SLOTS)                               # 14
SURF_SLOTS = ("dhacc", "edv_a", "edv_b")
NN_SURF = NN + len(SURF_SLOTS)                  # 17

# const nodal pack (per chunk)
CN_SLOTS = ("top_mask", "vbc_mask_x", "vbc_mask_y", "vbc_mask_z")
NCN = len(CN_SLOTS)

NPART = 4          # min height, min height / swave, max |v|, sum |f|^2
BLOCK = 256        # threads (tets, cells or nodes) per block of
#                    csrc/fused3d.cu
NEWORK = 24        # element scratch planes of one cell each (csrc)
NNWORK = 2         # node scratch planes
NFWORK = 24        # facet scratch planes of one (x, y) column each (csrc):
#                    side (bottom, top), force component, top/bottom corner
MAXMAT = fused2d.MAXMAT  # csrc/rheology2d.cuh MAXMAT

# per-material table values the mixtures take (csrc/fused3d.cu MixConst),
# after the material's MAT_FIELDS: moduli, conductivity, rho0, rho0 * alpha,
# porosity, heat capacity, Biot coefficient, 1 / fluid bulk modulus
MIX_FIELDS = ("bulk_modulus", "shear_modulus", "therm_cond", "rho0",
              "rho0_alpha", "porosity", "heat_capacity", "biot_coeff",
              "inv_fluid_bulk_modulus")

EVEN_T, ODD_T = tet_tables()

# the pallas3d.py y halo (exact chained-stencil depth incl. the NMD hop)
_H = 4


def _eslot(name: str) -> int:
    return E_SLOTS.index(name)


def _tslot(name: str) -> int:
    return len(E_SLOTS) + 6 * T_SLOTS.index(name)


def _nslot(name: str) -> int:
    return (N_SLOTS + SURF_SLOTS).index(name)


# ---------------------------------------------------------------- gates

def _uniform_mat(param: Param) -> bool:
    """Single material + uniform ICs (pallas3d._uniform_mat)."""
    return (len(param.mat.rho0) == 1
            and param.ic.temperature_option in (0, 1, 90))


def _nce(param: Param) -> int:
    return 0 if _uniform_mat(param) else 1 + len(param.mat.rho0)


def _pick_ty(nyc: int, nzc: int, nxc: int, nce: int = 0, halo: int = _H):
    """pallas3d._pick_ty: the largest y tile whose VMEM slabs fit the TPU
    kernel's budget.  This package has no tiles; the rule stays in the gate
    so that a config dispatches to the same path in both packages (a config
    the TPU kernel cannot tile runs on grid3d there, and is refused here
    with that name)."""
    ne_in = NE - 7   # pallas3d.py NE_IN: the element pack minus outputs
    for ty in (64, 32, 16, 12, 8, 6, 4):
        if nyc % ty:
            continue
        slab = (ne_in + NE + nce) * (ty + 2 * halo) * 5 * nzc * nxc * 4
        if slab <= 63 * 1024 * 1024:
            return ty
    return None


def _surf_on(param: Param, ctx) -> bool:
    return (param.control.surface_process_option == 1
            and int(ctx.surf.etop) > 0)


# the two triangles of a top cell's quad, split along the parity diagonal
# of the 5-tet decomposition (structured.tet_tables), as the corner codes
# a*4 + b*2 + 1 of the cell's top corners, in the order of pallas3d.py:
# 1342-1343 (counter-clockwise seen from above, +z outward)
TRI_EVEN = ((1, 7, 3), (1, 5, 7))
TRI_ODD = ((1, 5, 3), (3, 5, 7))


def surf_maps(ctx):
    """pallas3d._surf_maps: for each top facet, its triangle slot (0 or 1,
    the triangle of TRI_EVEN / TRI_ODD with the facet's corner set) and the
    node that carries its edvacc_surf, the owning cell's (x0, y0, top)
    node; (tri, nid) int32 arrays.  Raises ValueError when a top facet is
    not such a triangle."""
    nx, ny, nz = ctx.sgrid
    nzc = nz - 1
    fn = np.asarray(ctx.surf.facet_nodes)
    k_n = fn % nz
    j_n = (fn // nz) % ny
    i_n = fn // (nz * ny)
    if not (k_n == nz - 1).all():
        raise ValueError("top facets off the top lane")
    i0 = i_n.min(axis=1)
    j0 = j_n.min(axis=1)
    a = i_n - i0[:, None]
    b = j_n - j0[:, None]
    par = (i0 + j0 + nzc - 1) % 2
    # the corner set (a, b) of a facet as the bits a * 2 + b (three
    # distinct corners set three bits), against each parity's two triangles
    ok = ((a == 0) | (a == 1)) & ((b == 0) | (b == 1))
    bits = (1 << (a * 2 + b)).sum(axis=1, where=ok)
    want = np.array([[sum(1 << (q >> 1) for q in t) for t in tris]
                     for tris in (TRI_EVEN, TRI_ODD)])[par]
    if not (ok.all() and ((bits == want[:, 0])
                          | (bits == want[:, 1])).all()):
        raise ValueError("top facet is not a parity-diagonal triangle "
                         "of the 5-tet decomposition")
    tri = np.where(bits == want[:, 0], 0, 1).astype(np.int32)
    nid = ((i0 * ny + j0) * nz + (nz - 1)).astype(np.int32)
    return tri, nid


def grav_facets(ctx):
    """pallas3d._grav_facets_structured_3d: the gravity-traction facet
    tables (ctx.sbc) of the structured 5-tet grid decoded into
    {"winkler", "water", "bottom", "top"}, where bottom/top map the cell
    parity (0 where i + j + k is even) to its two (tet, (code0, code1,
    code2)) groups, sorted, with the corner codes a*4 + b*2 + d in the
    stored facet-node order (so that the cross product gives the outward
    normal of the generic path).  None without gravity facets; raises
    ValueError when the tables are not the full bottom and top rows: each
    parity's two groups must each cover every cell of that parity in the
    row once."""
    if int(ctx.sbc.n_grav) == 0:
        return None
    nx, ny, nz = ctx.sgrid
    nxc, nyc, nzc = nx - 1, ny - 1, nz - 1
    fn, fe, kind = ctx.sbc.facet_nodes, ctx.sbc.facet_elem, ctx.sbc.kind
    if not set(np.unique(kind)).issubset({0, 1}):
        raise ValueError("sidewall lithostatic facets")
    spec = {"winkler": False, "water": False, "bottom": None, "top": None}
    for kval, name in ((0, "bottom"), (1, "top")):
        rows = np.where(kind == kval)[0]
        if rows.size == 0:
            continue
        if rows.size != 2 * nxc * nyc:
            raise ValueError(f"{name} facet coverage incomplete")
        f = fn[rows]
        k_n = f % nz
        j_n = (f // nz) % ny
        i_n = f // (nz * ny)
        krow = 0 if kval == 0 else nzc - 1
        if not (k_n == (0 if kval == 0 else nz - 1)).all():
            raise ValueError(f"{name} facets off the boundary lane")
        e = fe[rows]
        t_id = e % 5
        cell = e // 5
        kz = cell % nzc
        jy = (cell // nzc) % nyc
        ix = cell // (nzc * nyc)
        if not (kz == krow).all():
            raise ValueError(f"{name} facet elements off the boundary row")
        a = i_n - ix[:, None]
        b = j_n - jy[:, None]
        d = k_n - kz[:, None]
        if not (((a == 0) | (a == 1)) & ((b == 0) | (b == 1))
                & ((d == 0) | (d == 1))).all():
            raise ValueError(f"{name} facet nodes outside the owner cell")
        key = np.concatenate([t_id[:, None], a * 4 + b * 2 + d], axis=1)
        parv = (ix + jy + kz) % 2
        col = ix * nyc + jy
        out = {}
        for pv in (0, 1):
            n_pv = int(((np.arange(nxc)[:, None] + np.arange(nyc)
                         + krow) % 2 == pv).sum())
            m = parv == pv
            keys, inv = np.unique(key[m], axis=0, return_inverse=True)
            inv = inv.reshape(-1)
            if keys.shape[0] != 2 or any(
                    np.unique(col[m][inv == g]).size != n_pv
                    or (inv == g).sum() != n_pv for g in range(2)):
                raise ValueError(f"{name} facet groups not canonical")
            out[pv] = [(int(k[0]), tuple(int(c) for c in k[1:]))
                       for k in keys]
        spec[name] = out
        spec["winkler" if kval == 0 else "water"] = True
    return spec


def _decodes(fn, *args) -> bool:
    try:
        fn(*args)
    except ValueError:
        return False
    return True


def grid_step_applicable(param: Param, ctx) -> bool:
    """grid3d.grid_step_applicable (this package has no sharded axis)."""
    ctrl = param.control
    return (ctx.sgrid is not None and len(ctx.sgrid) == 3
            and ctx.ndims == 3
            and not ctrl.has_hydraulic_diffusion
            and not ctrl.has_PT
            and param.mat.rheol_type in (RH_ELASTIC, RH_VISCOUS, RH_MAXWELL,
                                         RH_EP, RH_EVP))


def pallas3d_step_applicable(param: Param, ctx) -> bool:
    """Static gate of the fused 3D step (pallas3d.pallas3d_step_applicable
    folded with grid3d.grid_step_applicable)."""
    if not grid_step_applicable(param, ctx):
        return False
    ctrl = param.control
    if ctrl.surface_process_option not in (0, 1) and ctx.surf.etop > 0:
        return False
    if _surf_on(param, ctx) and not _decodes(surf_maps, ctx):
        return False
    if param.sim.float_dtype != "float32":
        return False
    if param.sim.is_outputting_averaged_fields:
        return False
    if not ctrl.has_moving_mesh:
        return False
    if ctrl.damping_option not in (0, 1, 2, 3):
        return False
    if ctx.sbc.n_neu > 0 or param.bc.has_elastic_foundation:
        return False
    if not _decodes(grav_facets, ctx):
        return False
    nx, ny, nz = ctx.sgrid
    nxc, nyc, nzc = nx - 1, ny - 1, nz - 1
    if nxc % 128 != 0 or nzc % 8 != 0:
        return False
    halo = _H + 1 if _surf_on(param, ctx) else _H
    if _pick_ty(nyc, nzc, nxc, _nce(param), halo=halo) is None:
        return False
    return True


def unported_features(param: Param, ctx) -> list:
    """Features that pass the gate above but that this package's fused 3D
    step does not compute."""
    if len(param.mat.rho0) > MAXMAT:
        return [f"more than {MAXMAT} materials"]
    return []


# ------------------------------------------------------ static step plan

# ip slots (csrc/fused3d.cu Params3::from_host), then the facet groups of
# grav_facets (facet_table)
IP_FIELDS = ("nx", "ny", "nz", "rheol", "nmd", "thermal", "gravity_on",
             "damping", "surf_corr", "quasi_static", "use_gvs", "jaumann",
             "uniform", "nmat", "winkler", "water", "surf_on")
# fp slots, then per material its MAT_FIELDS and MIX_FIELDS
FP_FIELDS = ("surface_T", "visc_min", "visc_max", "tension_max", "fac",
             "one_m_fac", "two_m_fac", "inertial", "log_q", "log_1e6",
             "deg2rad", "ps2", "bulkm", "shearm", "kappa", "rhoA", "rhoB",
             "buoyA", "buoyB", "cpA", "cpB", "hmA", "g_npe", "comp_p",
             "winkler_drho", "gravity", "zlength", "surf_base", "surf_diff")


def facet_table(grav) -> np.ndarray:
    """The facet groups of a grav_facets spec as the kernel reads them:
    (side: bottom, top; cell parity; group) -> (tet, code0, code1, code2),
    zeros for a side without facets, (2, 2, 2, 4) int32."""
    tab = np.zeros((2, 2, 2, 4), dtype=np.int32)
    for side, name in enumerate(("bottom", "top")):
        if grav is not None and grav[name] is not None:
            for pv in (0, 1):
                for g, (t, codes) in enumerate(grav[name][pv]):
                    tab[side, pv, g] = (t, *codes)
    return tab


@dataclass
class StepPlan3:
    """Everything static about the fused 3D step of one (param, mesh):
    sizes, switches and float64 constants, each rounded once to the run
    dtype where it enters the arithmetic (as pallas3d.py rounds its
    ``_c`` constants), the cell parity, and the same values packed for the
    CUDA kernel (``ip``, ``fp``) and for dt_refresh (``rip``, ``rfp``).
    ``uniform``: one material with uniform ICs, whose properties are the
    constants of ``k``; otherwise ``mix`` holds every material's table
    values for the mixtures (MIX_FIELDS) and ``mc`` its MAT_FIELDS.
    ``grav``: the facet groups (grav_facets) where the tractions run;
    ``smaps``: the edvacc_surf placement (surf_maps, as tensors on the
    plan's device) where surface process 1 runs."""

    nx: int
    ny: int
    nz: int
    dtype: torch.dtype
    rheol: int
    uniform: bool
    nmat: int
    sw: dict
    k: dict
    mc: list
    mix: list
    par: torch.Tensor  # (nxc, nyc, nzc) bool
    grav: dict | None
    smaps: tuple | None
    ip: np.ndarray
    fp: np.ndarray
    rip: np.ndarray
    rfp: np.ndarray

    @property
    def ncell(self) -> int:
        return (self.nx - 1) * (self.ny - 1) * (self.nz - 1)

    @property
    def nnode(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def cells(self) -> tuple:
        return (self.nx - 1, self.ny - 1, self.nz - 1)

    @property
    def nn(self) -> int:
        """Planes of the nodal pack."""
        return NN_SURF if self.sw["surf_on"] else NN

    @property
    def facets(self) -> bool:
        return bool(self.sw["winkler"] or self.sw["water"])

    def nblocks(self) -> int:
        """Columns of the partials buffer: the larger block count of the
        launches that write them, phase G (per cell) and F (per node)."""
        return max(-(-self.ncell // BLOCK), -(-self.nnode // BLOCK))


def make_plan(param: Param, ctx, device,
              compensation_pressure: float = 0.0) -> StepPlan3:
    """Build the StepPlan3 (cf. the closure constants of
    pallas3d.make_pallas_step); ``compensation_pressure`` is the Winkler
    reference pressure."""
    ctrl, mat = param.control, param.mat
    nx, ny, nz = ctx.sgrid
    dtype = torch.float32 if param.sim.float_dtype == "float32" \
        else torch.float64
    tabn = ctx.mat.host()
    npe = 4.0
    max_vbc = float(ctx.max_vbc_val)
    ps = max_vbc * ctrl.inertial_scaling
    phi = float(tabn["porosity"][0])
    rho0 = float(tabn["rho0"][0])
    alpha = float(tabn["alpha"][0])
    g = float(ctrl.gravity)
    K = float(tabn["bulk_modulus"][0])
    G = float(tabn["shear_modulus"][0])
    cp = float(tabn["heat_capacity"][0])
    ab = float(tabn["biot_coeff"][0])
    bf = 1.0 / float(tabn["fluid_bulk_modulus"][0])
    visc_min = float(tabn["visc_min"])
    uniform = _uniform_mat(param)
    nmat = int(tabn["rho0"].shape[0])
    sw = {
        "nx": nx, "ny": ny, "nz": nz, "rheol": mat.rheol_type,
        "uniform": int(uniform), "nmat": nmat,
        "nmd": int(ctrl.is_using_mixed_stress),
        "thermal": int(ctrl.has_thermal_diffusion),
        "gravity_on": int(ctrl.gravity != 0),
        "damping": ctrl.damping_option,
        "surf_corr": int(ctrl.has_surface_correction),
        "quasi_static": int(ctrl.is_quasi_static),
        "use_gvs": int(ctrl.use_global_velocity_scaling),
        "fixed_on": int(ctrl.fixed_dt != 0.0),
        "jaumann": int(bool(mat.rheol_type & RH_ELASTIC)),
        "surf_on": int(_surf_on(param, ctx)),
    }
    # the tractions need gravity, as apply_stress_bcs (bc.cxx:632-790) and
    # grid3d, the oracle, apply them
    grav = grav_facets(ctx) if ctrl.gravity != 0 else None
    for f in ("winkler", "water"):
        sw[f] = int(grav is not None and grav[f])
    k = {
        "surface_T": float(param.bc.surface_temperature),
        "visc_min": visc_min, "visc_max": float(tabn["visc_max"]),
        "tension_max": float(tabn["tension_max"]),
        "fac": ctrl.damping_factor,
        "one_m_fac": 1.0 - ctrl.damping_factor,
        "two_m_fac": 2.0 - ctrl.damping_factor,
        "inertial": float(ctrl.inertial_scaling),
        "log_q": FC.LOG_QUARTER, "log_1e6": FC.LOG_1E6,
        "deg2rad": FC.DEG2RAD, "ps": ps, "ps2": ps * ps,
        "tdmax": float(tabn["therm_diff_max"]), "max_vbc": max_vbc,
        "swave_ref": float(np.sqrt(mat.bulk_modulus[mat.mattype_ref]
                                   / mat.rho0[mat.mattype_ref])),
        "fixed_dt": float(ctrl.fixed_dt), "frac": float(ctrl.dt_fraction),
        "big": float(torch.finfo(dtype).max),
        "dt_maxwell": 0.5 * visc_min / (1e-40 + G),
        # one material: the mixing means are the material's values
        # whatever the marker weights (matprops.cxx:115-144)
        "bulkm": K, "shearm": G, "kappa": float(tabn["therm_cond"][0]),
        "rhoA": rho0, "rhoB": rho0 * alpha,
        "buoyA": ((1 - phi) * rho0 + 1000.0 * phi) * g / npe,
        "buoyB": (1 - phi) * rho0 * alpha * g / npe,
        "cpA": cp * rho0, "cpB": cp * rho0 * alpha,
        # hmass coefficient: 3D bulk_comp = 1/K (geometry.cxx:1098)
        "hmA": ((ab + phi - ab * phi) / K + phi * bf) / npe,
        "g_npe": g / npe,
        "comp_p": float(compensation_pressure),
        "winkler_drho": float(param.bc.winkler_delta_rho),
        "gravity": g, "zlength": float(param.mesh.zlength),
        "surf_base": float(ctrl.surf_base_level),
        "surf_diff": float(ctrl.surface_diffusivity),
    }
    mc = FC.mat_consts(tabn)
    # the tables in the run dtype, products and quotients formed in it as
    # pallas3d.py forms them in numpy (rho0 * alpha, 1 / fluid bulk modulus)
    tv = {**tabn, "rho0_alpha": tabn["rho0"] * tabn["alpha"],
          "inv_fluid_bulk_modulus": 1.0 / tabn["fluid_bulk_modulus"]}
    mix = [{f: float(tv[f][m]) for f in MIX_FIELDS} for m in range(nmat)]
    ip = np.concatenate([np.array([sw[f] for f in IP_FIELDS],
                                  dtype=np.int32),
                         facet_table(grav).reshape(-1)])
    fp = np.array([k[f] for f in FP_FIELDS]
                  + [v for m in range(nmat)
                     for v in [mc[m][f] for f in FC.MAT_FIELDS]
                     + [mix[m][f] for f in MIX_FIELDS]], dtype=np.float64)
    rip, rfp = FC.refresh_params(sw, k)
    par = torch.as_tensor(parity_3d(nx, ny, nz), device=device)
    smaps = None
    if sw["surf_on"]:
        tri, nid = surf_maps(ctx)
        smaps = (torch.as_tensor(tri, device=device),
                 torch.as_tensor(nid, device=device).long())
    return StepPlan3(nx=nx, ny=ny, nz=nz, dtype=dtype, rheol=mat.rheol_type,
                     uniform=uniform, nmat=nmat, sw=sw, k=k, mc=mc, mix=mix,
                     par=par, grav=grav, smaps=smaps, ip=ip, fp=fp,
                     rip=rip, rfp=rfp)


# ------------------------------------------- packing (chunk boundaries)

def state_to_planes(s, nx: int, ny: int, nz: int, smaps=None):
    """State -> (epack (NE, 5, nxc, nyc, nzc), npack (NN, nx, ny, nz));
    with ``smaps`` (StepPlan3.smaps) the NN_SURF planes, dhacc and each
    top facet's edvacc_surf at its node of its triangle slot's plane
    (pallas3d.state_to_pgrid)."""
    cells = (nx - 1, ny - 1, nz - 1)
    planes = [getattr(s, f).reshape(*cells, 5).permute(3, 0, 1, 2)
              for f in E_SLOTS]
    for f in T_SLOTS:
        t = getattr(s, f).reshape(*cells, 5, 6).permute(4, 3, 0, 1, 2)
        planes.extend(t[i] for i in range(6))
    epack = torch.stack(planes).contiguous()
    nodal = [s.coord[:, 0], s.coord[:, 1], s.coord[:, 2], s.vel[:, 0],
             s.vel[:, 1], s.vel[:, 2], s.temperature, s.mass, s.tmass,
             s.hmass, s.volume_n, s.force[:, 0], s.force[:, 1],
             s.force[:, 2]]
    if smaps is not None:
        tri, nid = smaps
        edv = torch.zeros((2, nx * ny * nz), dtype=s.coord.dtype,
                          device=s.coord.device)
        edv[tri.long(), nid] = s.edvacc_surf
        nodal += [s.dhacc, edv[0], edv[1]]
    npack = torch.stack([a.reshape(nx, ny, nz) for a in nodal]).contiguous()
    return epack, npack


def planes_to_state(s, epack, npack, nx: int, ny: int, nz: int,
                    smaps=None, **scalars):
    """Packed planes (+ new scalars) -> State; other fields pass through
    (dhacc and edvacc_surf too, unless ``smaps`` says where they are, as
    state_to_planes put them)."""
    nelem = (nx - 1) * (ny - 1) * (nz - 1) * 5

    def p2e(p):
        return p.permute(1, 2, 3, 0).reshape(nelem)

    upd = {f: p2e(epack[_eslot(f)]) for f in E_SLOTS}
    for f in T_SLOTS:
        k = _tslot(f)
        upd[f] = epack[k:k + 6].permute(2, 3, 4, 1, 0).reshape(nelem, 6)

    def p2n(nm):
        return npack[_nslot(nm)].reshape(nx * ny * nz)

    for v, names in (("coord", ("coord_x", "coord_y", "coord_z")),
                     ("vel", ("vel_x", "vel_y", "vel_z")),
                     ("force", ("force_x", "force_y", "force_z"))):
        upd[v] = torch.stack([p2n(n) for n in names], dim=1)
    for nm in ("temperature", "mass", "tmass", "hmass", "volume_n"):
        upd[nm] = p2n(nm)
    if smaps is not None:
        tri, nid = smaps
        upd["dhacc"] = p2n("dhacc")
        edv = npack[_nslot("edv_a"):_nslot("edv_b") + 1].reshape(2, -1)
        upd["edvacc_surf"] = edv[tri.long(), nid]
    return s.replace(**upd, **scalars)


# ------------------------------------------------ stencils on the planes

def _corner_views(g):
    """Nodal plane (nx, ny, nz) -> the 8 cell-corner views (nxc, nyc, nzc),
    corner code a*4 + b*2 + d for offsets (a, b, d) in x/y/z."""
    nxc, nyc, nzc = (n - 1 for n in g.shape)
    return [g[a:a + nxc, b:b + nyc, d:d + nzc]
            for a in (0, 1) for b in (0, 1) for d in (0, 1)]


def gather_tets(g, par):
    """Nodal plane -> 4 corner-slot planes, each (5, nxc, nyc, nzc)."""
    c = _corner_views(g)
    return tuple(torch.stack([torch.where(par, c[EVEN_T[t][s]],
                                          c[ODD_T[t][s]])
                              for t in range(5)])
                 for s in range(4))


def _scatter_codes(per_code):
    """Add the 8 per-code cell planes into the node grid, code by code
    (grid3d._scatter)."""
    nxc, nyc, nzc = per_code[0].shape
    out = torch.zeros((nxc + 1, nyc + 1, nzc + 1), dtype=per_code[0].dtype,
                      device=per_code[0].device)
    for code, v in enumerate(per_code):
        a, b, d = code >> 2 & 1, code >> 1 & 1, code & 1
        out[a:a + nxc, b:b + nyc, d:d + nzc] += v
    return out


def cell_partials(cs, par):
    """Per-cell corner partials of slot contributions cs (4 planes of
    (5, nxc, nyc, nzc)): for each corner code, the sum over (tet, slot)
    in order of the contributions that land on it (grid3d.asm)."""
    zero = torch.zeros_like(cs[0][0])
    out = []
    for code in range(8):
        acc_e, acc_o = zero, zero
        for t in range(5):
            for s in range(4):
                if EVEN_T[t][s] == code:
                    acc_e = acc_e + cs[s][t]
                if ODD_T[t][s] == code:
                    acc_o = acc_o + cs[s][t]
        out.append(torch.where(par, acc_e, acc_o))
    return out


def asm(cs, par):
    """Transpose of gather_tets: slot contributions -> nodal sums."""
    return _scatter_codes(cell_partials(cs, par))


def asm_equal(v, par):
    """asm() with the same per-tet value at all four corners."""
    zero = torch.zeros_like(v[0])
    out = []
    for code in range(8):
        acc_e, acc_o = zero, zero
        for t in range(5):
            if code in EVEN_T[t]:
                acc_e = acc_e + v[t]
            if code in ODD_T[t]:
                acc_o = acc_o + v[t]
        out.append(torch.where(par, acc_e, acc_o))
    return _scatter_codes(out)


def shape_fn(xs, ys, zs, vol):
    """P1 tet gradients (fields.cxx:11-54; pallas3d.py:741-759)."""
    iv = 1.0 / (6.0 * vol)

    def d(a, i, j):
        return a[i] - a[j]

    x01, x02, x03 = d(xs, 0, 1), d(xs, 0, 2), d(xs, 0, 3)
    x12, x13, x23 = d(xs, 1, 2), d(xs, 1, 3), d(xs, 2, 3)
    y01, y02, y03 = d(ys, 0, 1), d(ys, 0, 2), d(ys, 0, 3)
    y12, y13, y23 = d(ys, 1, 2), d(ys, 1, 3), d(ys, 2, 3)
    z01, z02, z03 = d(zs, 0, 1), d(zs, 0, 2), d(zs, 0, 3)
    z12, z13, z23 = d(zs, 1, 2), d(zs, 1, 3), d(zs, 2, 3)
    dndx = (iv * (y13 * z12 - y12 * z13), iv * (y02 * z23 - y23 * z02),
            iv * (y13 * z03 - y03 * z13), iv * (y01 * z02 - y02 * z01))
    dndy = (iv * (z13 * x12 - z12 * x13), iv * (z02 * x23 - z23 * x02),
            iv * (z13 * x03 - z03 * x13), iv * (z01 * x02 - z02 * x01))
    dndz = (iv * (x13 * y12 - x12 * y13), iv * (x02 * y23 - x23 * y02),
            iv * (x13 * y03 - x03 * y13), iv * (x01 * y02 - x02 * y01))
    return dndx, dndy, dndz


def _row_views(g, krow: int):
    """Nodal plane (nx, ny, nz) -> the 8 corner views (nxc, nyc) of the
    cells of z row ``krow``, corner code a*4 + b*2 + d."""
    nxc, nyc = g.shape[0] - 1, g.shape[1] - 1
    return [g[a:a + nxc, b:b + nyc, krow + d]
            for a in (0, 1) for b in (0, 1) for d in (0, 1)]


def _lane_sum(parts):
    """Per-cell partials of a cell row's 4 bottom or top corners (a, b)
    -> their node lane (nx, ny): corner by corner in order, from zero (the
    kernel's node_sum over one lane)."""
    nxc, nyc = parts[0].shape
    out = torch.zeros((nxc + 1, nyc + 1), dtype=parts[0].dtype,
                      device=parts[0].device)
    for f, v in enumerate(parts):
        out[f >> 1:(f >> 1) + nxc, f & 1:(f & 1) + nyc] += v
    return out


def facet_forces(P: StepPlan3, nin, rho_of, c):
    """The gravity-facet tractions (apply_stress_bcs, bc.cxx:632-790;
    pallas3d.py:1221-1290) from the pre-move coordinates: the Winkler
    pressure compensation_pressure - (rho + delta_rho) g (z_c + zlength)
    on the bottom facets, rho that of the owning tet from the pre-update
    temperature (``rho_of(t, krow, TinC)``), and the water pressure
    1030 g (base - z_c) below the base level on the top facets; each facet
    adds -p n / 3 to its three nodes, n its area-weighted normal in the
    stored node order.  In csrc/fused3d.cu's order: each boundary cell's
    two facet groups in order into per-corner partials from zero, then a
    node's up to four cells in corner-code order (_lane_sum).  Returns
    {node lane k: (3, nx, ny) force additions}."""
    k, g, third = P.k, P.grav, c(1.0 / 3.0)
    gconst = c(k["gravity"])
    out = {}
    for side, name, flag in ((0, "bottom", "winkler"), (1, "top", "water")):
        if not P.sw[flag]:
            continue
        krow = 0 if side == 0 else P.nz - 2
        X, Y, Z, TT = (_row_views(nin[_nslot(n)], krow) for n in
                       ("coord_x", "coord_y", "coord_z", "temperature"))
        parts = {}
        for pv, corners in ((0, EVEN_T), (1, ODD_T)):
            acc = [[torch.zeros_like(X[0]) for _ in range(4)]
                   for _ in range(3)]
            for t, codes in g[name][pv]:
                c0, c1, c2 = codes
                e1 = [V[c1] - V[c0] for V in (X, Y, Z)]
                e2 = [V[c2] - V[c0] for V in (X, Y, Z)]
                nr = (0.5 * (e1[1] * e2[2] - e1[2] * e2[1]),
                      0.5 * (e1[2] * e2[0] - e1[0] * e2[2]),
                      0.5 * (e1[0] * e2[1] - e1[1] * e2[0]))
                zc = (Z[c0] + Z[c1] + Z[c2]) * third
                if side == 0:
                    ts = [TT[q] for q in corners[t]]
                    TinC = (ts[0] + ts[1] + ts[2] + ts[3]) / 4.0 - CELSIUS0
                    pres = c(k["comp_p"]) - (
                        rho_of(t, krow, TinC) + c(k["winkler_drho"])) \
                        * gconst * (zc + c(k["zlength"]))
                else:
                    base = c(k["surf_base"])
                    pres = torch.where(zc < base,
                                       c(1030.0) * gconst * (base - zc),
                                       c(0.0))
                cf = [-pres * n * third for n in nr]
                for f in range(4):
                    if 2 * f + side in codes:
                        for q in range(3):
                            acc[q][f] = acc[q][f] + cf[q]
            parts[pv] = acc
        par = P.par[:, :, krow]
        out[0 if side == 0 else -1] = torch.stack([_lane_sum(
            [torch.where(par, parts[0][q][f], parts[1][q][f])
             for f in range(4)]) for q in range(3)])
    return out


def _tri_geom(px, py, pz=None):
    """A top triangle's area projected on the horizontal plane and, given
    its heights, each corner's slope term (sdx_j gx + sdy_j gy) * area of
    the facet FEM (surface_dh_3d, bc.cxx:920-1050; pallas3d.py:1355-1368)."""
    parea = 0.5 * ((px[1] - px[0]) * (py[2] - py[0])
                   - (py[1] - py[0]) * (px[2] - px[0]))
    if pz is None:
        return parea, None
    iv = 1.0 / (2.0 * torch.where(parea != 0, parea, torch.ones_like(parea)))
    sdx = (iv * (py[1] - py[2]), iv * (py[2] - py[0]), iv * (py[0] - py[1]))
    sdy = (iv * (px[2] - px[1]), iv * (px[0] - px[2]), iv * (px[1] - px[0]))
    gx = sdx[0] * pz[0] + sdx[1] * pz[1] + sdx[2] * pz[2]
    gy = sdy[0] * pz[0] + sdy[1] * pz[1] + sdy[2] * pz[2]
    return parea, [(sdx[j] * gx + sdy[j] * gy) * parea for j in range(3)]


def surface_process(P: StepPlan3, coord, top_mask, dt, dhacc, edv, c):
    """Surface process option 1 on the moved coordinates (surface_dh_3d
    and the accumulators of bc.cxx:1745-1760; pallas3d.py:1324-1394): dh =
    -kappa dt (sum of slope terms) / (sum of projected areas) over each top
    node's triangles, on top-mask nodes, added to z and dhacc; each top
    cell's triangle t adds (its corners' dh summed) * area / 3 to edv[t] at
    the cell's (x0, y0, top) node.  The sums in csrc/fused3d.cu's order: a
    cell's triangles in order into per-corner partials from zero, then a
    node's up to four cells in corner-code order.  Returns (coord_z,
    dhacc, (edv_a, edv_b))."""
    x, y, z = (g[:, :, -1] for g in coord)
    nxc, nyc = x.shape[0] - 1, x.shape[1] - 1
    par = P.par[:, :, -1]

    def corner(v, f):
        return v[f >> 1:(f >> 1) + nxc, f & 1:(f & 1) + nyc]

    zero = torch.zeros_like(corner(x, 0))
    slope = {pv: [zero] * 4 for pv in (0, 1)}
    area = {pv: [zero] * 4 for pv in (0, 1)}
    pareas = {0: [], 1: []}
    for pv, tris in ((0, TRI_EVEN), (1, TRI_ODD)):
        for tri in tris:
            fs = [q >> 1 for q in tri]
            parea, sl = _tri_geom(*([corner(v, f) for f in fs]
                                    for v in (x, y, z)))
            pareas[pv].append(parea)
            for f in range(4):
                if f in fs:
                    slope[pv][f] = slope[pv][f] + sl[fs.index(f)]
                    area[pv][f] = area[pv][f] + parea
    ts, td = (_lane_sum([torch.where(par, a[0][f], a[1][f])
                         for f in range(4)]) for a in (slope, area))
    conv = c(P.k["surf_diff"]) * dt * ts / torch.where(td > 0, td, c(1.0))
    dh = torch.where(top_mask[:, :, -1] > 0, -conv, c(0.0))
    coord_z, dhacc = coord[2].clone(), dhacc.clone()
    coord_z[:, :, -1] = z + dh
    dhacc[:, :, -1] = dhacc[:, :, -1] + dh
    edv_out = []
    for t3 in range(2):
        dv = []
        for pv, tris in ((0, TRI_EVEN), (1, TRI_ODD)):
            d = [corner(dh, q >> 1) for q in tris[t3]]
            dv.append((d[0] + d[1] + d[2]) * pareas[pv][t3] / 3.0)
        e = edv[t3].clone()
        e[:nxc, :nyc, -1] = e[:nxc, :nyc, -1] + torch.where(par, *dv)
        edv_out.append(e)
    return coord_z, dhacc, tuple(edv_out)


def _dot4(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3]


def _mean4(a):
    return (a[0] + a[1] + a[2] + a[3]) / 4.0


# ------------------------------------------------- the step, plain torch

def epilogue(P: StepPlan3, nin, vol, dt, dp_old, dp_nd, sfac, stress,
             strain, pls, sr=None):
    """The tensor epilogue of a step, which the chunk form defers to the
    next step's rheology phase (csrc/fused3d.cu ``apply_epilogue``), in
    the order the complete step applies it:

    1. the NMD correction of the stress diagonal, ddp = (mean of the nodal
       pressure change ``dp_nd`` over the tet's corners - the element's
       ``dp_old``) / 3 (pallas3d.py:1176-1205);
    2. the Jaumann rotation of stress and strain (fields.cxx:832-907) with
       the step's ``dt``, the velocities and the shape functions of the
       moved mesh (``nin``, volume ``vol``);
    3. correct_surface_element (bc.cxx:1613-1665): stress, strain, strain
       rate and plstrain of the top cell layer times ``sfac`` (1/rdv where
       the element grew, else 1); rotate-then-scale equals the reference's
       scale-then-rotate.  3D has no surface plstrain decay.

    Returns (stress, strain, pls, sr)."""
    sw, par = P.sw, P.par
    if sw["nmd"]:
        ddp = (_mean4(gather_tets(dp_nd, par)) - dp_old) / 3.0
        stress = (stress[0] + ddp, stress[1] + ddp,
                  stress[2] + ddp) + tuple(stress[3:])
    if sw["jaumann"]:
        xs, ys, zs, vxs, vys, vzs = (
            gather_tets(nin[_nslot(n)], par)
            for n in ("coord_x", "coord_y", "coord_z", "vel_x", "vel_y",
                      "vel_z"))
        dndx, dndy, dndz = shape_fn(xs, ys, zs, vol)
        w3t = 0.5 * (_dot4(vxs, dndy) - _dot4(vys, dndx)) * dt
        w4t = 0.5 * (_dot4(vxs, dndz) - _dot4(vzs, dndx)) * dt
        w5t = 0.5 * (_dot4(vys, dndz) - _dot4(vzs, dndy)) * dt

        def rot(q):
            return (q[0] - 2.0 * q[3] * w3t - 2.0 * q[4] * w4t,
                    q[1] + 2.0 * q[3] * w3t - 2.0 * q[5] * w5t,
                    q[2] + 2.0 * q[4] * w4t + 2.0 * q[5] * w5t,
                    q[3] + (q[0] - q[1]) * w3t - q[4] * w5t - q[5] * w4t,
                    q[4] + (q[0] - q[2]) * w4t + q[3] * w5t - q[5] * w3t,
                    q[5] + (q[1] - q[2]) * w5t + q[3] * w4t + q[4] * w3t)

        stress, strain = rot(stress), rot(strain)
    if sw["surf_corr"]:
        def scale(x):
            return torch.cat([x[..., :-1], (x[..., -1] * sfac)[..., None]],
                             dim=-1)

        stress = tuple(scale(x) for x in stress)
        strain = tuple(scale(x) for x in strain)
        pls = scale(pls)
        if sr is not None:
            sr = tuple(scale(x) for x in sr)
    return stress, strain, pls, sr


def mixtures(P: StepPlan3, cep, c):
    """The element properties of a multi-material plan from the weight
    planes of the const pack (pallas3d.py:886-946, matprops.cxx:115-144):
    the harmonic means of the moduli, arithmetic means of the rest, each
    from the raw weights and their sum; (props, weights).  ``c`` rounds a
    constant to the run dtype."""
    w = [cep[1 + m] for m in range(P.nmat)]
    ws = w[0]
    for wm in w[1:]:
        ws = ws + wm
    ws = torch.where(ws > 0, ws, c(1.0))

    def amean(f):
        acc = w[0] * c(P.mix[0][f])
        for m in range(1, P.nmat):
            acc = acc + w[m] * c(P.mix[m][f])
        return acc / ws

    def hmean(f):
        acc = w[0] / c(P.mix[0][f])
        for m in range(1, P.nmat):
            acc = acc + w[m] / c(P.mix[m][f])
        return ws / acc

    bulkm = hmean("bulk_modulus")
    rhoA, rhoB = amean("rho0"), amean("rho0_alpha")
    phi, cp, ab = amean("porosity"), amean("heat_capacity"), \
        amean("biot_coeff")
    g_npe = c(P.k["g_npe"])
    props = {
        "radiogenic_source": cep[0], "bulkm": bulkm,
        "shearm": hmean("shear_modulus"), "kappa": amean("therm_cond"),
        "rhoA": rhoA, "rhoB": rhoB,
        "buoyA": ((1.0 - phi) * rhoA + 1000.0 * phi) * g_npe,
        "buoyB": (1.0 - phi) * rhoB * g_npe,
        "cpA": cp * rhoA, "cpB": cp * rhoB,
        # 3D bulk_comp = 1/K (geometry.cxx:1098)
        "hmA": ((ab + phi - ab * phi) / bulkm
                + phi * hmean("inv_fluid_bulk_modulus")) / c(4.0)}
    return props, w


def step_planes_plain(P: StepPlan3, ein, nin, cnp, tgt, dt, gvs,
                      ties=None, pending=None, cep=None):
    """One time step on the packed planes, in plain PyTorch, in the chunk
    form of csrc/fused3d.cu: the physics of pallas3d.py:793-1567 on the
    whole mesh (dynearthsol.cxx:746-956 with the gravity-facet tractions
    and surface process 1 where the plan runs them), with the tensor
    epilogue (``epilogue``) left
    pending on the stress, strain, strain-rate and plstrain planes it
    returns.  ``cep`` is the const pack of a multi-material plan
    (const_epack), whose properties it mixes (``mixtures``).

    ``pending`` is None, or (dt, dp_nd, sfac) of the previous step when
    ``ein`` carries that step's pending epilogue: it is applied to the old
    stress, strain and plstrain before the step uses them.  ``dt``/``gvs``
    are 0-d tensors.  Returns (epack, npack, red, dp_nd, sfac) with red =
    (min height, min height / shear-wave speed, max |v|, sum |force|^2),
    the CFL metrics of the moved mesh and the residual, and dp_nd / sfac
    this step's nodal pressure change (NMD) and top-layer surface factors
    (5, nxc, nyc) (surface correction), else None.  Under EVP a list passed
    as ``ties`` receives the (5, nxc, nyc, nzc) masks of the elements whose
    min-select is an exact tie that matters (the two trial stresses
    unequal), with both trial invariants 0 and with two equal nonzero
    ones, then the two invariants themselves (2, 5, nxc, nyc, nzc)."""
    sw, k = P.sw, P.k
    rheol = P.rheol
    par = P.par
    dtype, dev = ein.dtype, ein.device

    def c(v):
        """A constant rounded once to the run dtype (pallas3d ``_c``)."""
        return torch.full((), v, dtype=dtype, device=dev)

    def E(nm):
        return ein[_eslot(nm)]

    def TEN(nm):
        i = _tslot(nm)
        return tuple(ein[i + q] for q in range(6))

    def N(nm):
        return nin[_nslot(nm)]

    if P.uniform:
        w = [1.0]

        def CE(nm):
            return c(k[nm])
    else:
        props, w = mixtures(P, cep, c)

        def CE(nm):
            return props[nm]

    bulkm, shearm = CE("bulkm"), CE("shearm")
    vol = E("volume")
    xs, ys, zs = (gather_tets(N(n), par)
                  for n in ("coord_x", "coord_y", "coord_z"))
    vxs, vys, vzs = (gather_tets(N(n), par)
                     for n in ("vel_x", "vel_y", "vel_z"))
    ts = gather_tets(N("temperature"), par)
    dndx, dndy, dndz = shape_fn(xs, ys, zs, vol)
    lxx, lyy, lzz = _dot4(vxs, dndx), _dot4(vys, dndy), _dot4(vzs, dndz)

    # ---- phase 1: dvoldt numerator + temperature diffusion
    # (geometry.cxx:202-276, fields.cxx:197-283)
    dvoldt = asm_equal((lxx + lyy + lzz) * vol, par) / N("volume_n")
    temperature_new = N("temperature")
    if sw["thermal"]:
        gx, gy, gz = _dot4(dndx, ts), _dot4(dndy, ts), _dot4(dndz, ts)
        kv = CE("kappa") * vol
        contrib = tuple(kv * (dndx[i] * gx + dndy[i] * gy + dndz[i] * gz)
                        for i in range(4))
        if not P.uniform:
            # radiogenic source (fields.cxx:197-283; pallas3d.py:985-991)
            rho_e1 = CE("rhoA") - CE("rhoB") * (_mean4(ts) - CELSIUS0)
            source = CE("radiogenic_source") * vol * rho_e1 / c(4.0)
            contrib = tuple(x - source for x in contrib)
        tdot = asm(contrib, par)
        temperature_new = torch.where(
            cnp[0] > 0, c(k["surface_T"]),
            N("temperature") - dt * tdot / N("tmass"))

    # ---- phase 2a: strain rate, edvoldt, constitutive update
    temp_e = _mean4(ts)
    TinC = temp_e - CELSIUS0
    lxy = 0.5 * (_dot4(vxs, dndy) + _dot4(vys, dndx))
    lxz = 0.5 * (_dot4(vxs, dndz) + _dot4(vzs, dndx))
    lyz = 0.5 * (_dot4(vys, dndz) + _dot4(vzs, dndy))
    sr = (lxx, lyy, lzz, lxy, lxz, lyz)
    edvoldt = _mean4(gather_tets(dvoldt, par))
    adj = (edvoldt - (lxx + lyy + lzz)) / 3.0
    edot = (lxx + adj, lyy + adj, lzz + adj, lxy, lxz, lyz)
    de = tuple(e * dt for e in edot)
    stress_old, strain_old = TEN("stress"), TEN("strain")
    plstrain = E("plstrain")
    if pending is not None:
        stress_old, strain_old, plstrain, _ = epilogue(
            P, nin, vol, pending[0], E("dpressure"), pending[1], pending[2],
            stress_old, strain_old, plstrain)
    strain = tuple(strain_old[i] + de[i] for i in range(6))

    delta_plstrain = E("delta_plstrain")
    viscosity = E("viscosity")

    def creep_visc():
        s0 = (stress_old[0] + stress_old[1] + stress_old[2]) / 3.0
        ed = torch.clamp(torch.sqrt(inv2_6(sr)), min=MIN_STRAIN_RATE)
        return FC.visc_core_local(P.mc, w, temp_e, s0, ed,
                                  k["visc_min"], k["visc_max"])

    def plastic():
        return FC.plastic_props_local(P.mc, w, plstrain, k["tension_max"])

    if rheol == RH_ELASTIC:
        stress_c = R.elastic3_c(bulkm, shearm, de, stress_old)
    elif rheol == RH_VISCOUS:
        viscosity = creep_visc()
        stress_c = R.viscous3_c(bulkm, viscosity,
                                strain[0] + strain[1] + strain[2], edot)
    elif rheol == RH_MAXWELL:
        viscosity = creep_visc()
        dv = vol / E("volume_old") - 1.0
        stress_c = R.maxwell3_c(bulkm, shearm, viscosity, dt, dv, de,
                                stress_old)
    elif rheol == RH_EP:
        amc, anphi, anpsi, hardn, ten_max = plastic()
        stress_c, depls, _ = R.elasto_plastic3_c(
            bulkm, shearm, amc, anphi, anpsi, hardn, ten_max, de,
            stress_old)
        plstrain = plstrain + depls
        delta_plstrain = depls
    elif rheol == RH_EVP:
        viscosity = creep_visc()
        dv = vol / E("volume_old") - 1.0
        sv = R.maxwell3_c(bulkm, shearm, viscosity, dt, dv, de, stress_old)
        amc, anphi, anpsi, hardn, ten_max = plastic()
        sp, depls, _ = R.elasto_plastic3_c(
            bulkm, shearm, amc, anphi, anpsi, hardn, ten_max, de,
            stress_old)
        # min-magnitude selection (rheology.cxx:869-879)
        iv, ip = inv2_6(sv), inv2_6(sp)
        use_v = iv < ip
        if ties is not None:
            # x < x decides the select while the branches differ: there an
            # ulp elsewhere may pick the other branch.  Both invariants 0
            # first, then an equal nonzero pair (the trial deviators
            # agree, at visc_max, while the pressures do not)
            differ = torch.stack([p != q for p, q in zip(sv, sp)]).any(0)
            zero = (iv == 0) & (ip == 0)
            ties.append(zero & differ)
            ties.append((iv == ip) & ~zero & differ)
            ties.append(torch.stack([iv, ip]))
        stress_c = tuple(torch.where(use_v, p, q) for p, q in zip(sv, sp))
        plstrain = torch.where(use_v, plstrain, plstrain + depls)
        delta_plstrain = torch.where(use_v, delta_plstrain, depls)
    else:
        raise ValueError(f"fused 3D step: unsupported rheology {rheol}")

    # ---- NMD nodal pressure smoothing (pallas3d.py:1171-1228): the force
    # takes the corrected stress, the stored stress waits for epilogue()
    dpressure = E("dpressure")
    s, dp_nd = stress_c, None
    if sw["nmd"]:
        old_tr = stress_old[0] + stress_old[1] + stress_old[2]
        dpressure = stress_c[0] + stress_c[1] + stress_c[2] - old_tr
        dp_nd = asm_equal(dpressure * vol, par) / N("volume_n")
        ddp = (_mean4(gather_tets(dp_nd, par)) - dpressure) / 3.0
        s = (s[0] + ddp, s[1] + ddp, s[2] + ddp) + s[3:]

    # ---- phase 2b: force assembly with buoyancy (fields.cxx:612-703)
    if sw["gravity_on"]:
        buoy = CE("buoyA") - CE("buoyB") * TinC
    else:
        buoy = torch.zeros_like(vol)
    fxc = tuple((s[0] * dndx[i] + s[3] * dndy[i] + s[4] * dndz[i]) * vol
                for i in range(4))
    fyc = tuple((s[3] * dndx[i] + s[1] * dndy[i] + s[5] * dndz[i]) * vol
                for i in range(4))
    fzc = tuple((s[4] * dndx[i] + s[5] * dndy[i] + s[2] * dndz[i] + buoy)
                * vol for i in range(4))
    force = [-asm(fc, par) for fc in (fxc, fyc, fzc)]
    r2 = (force[0] * force[0] + force[1] * force[1]
          + force[2] * force[2]).sum()
    # the gravity-facet tractions, after the residual as in grid3d
    if P.facets:
        def rho_of(t, krow, TinC):
            a, b = CE("rhoA"), CE("rhoB")
            if not P.uniform:
                a, b = a[t, ..., krow], b[t, ..., krow]
            return a - b * TinC

        for lane, add in facet_forces(P, nin, rho_of, c).items():
            for q in range(3):
                force[q][..., lane] = force[q][..., lane] + add[q]

    # ---- phase 3: damping, velocity, vbcs, coordinates
    # (fields.cxx:486-582,730-747; bc.cxx)
    mass_n = N("mass")
    vel = [N("vel_x"), N("vel_y"), N("vel_z")]
    damp = sw["damping"]
    fd = []
    for f, v in zip(force, vel):
        if damp == 1:
            f = f - torch.where(torch.abs(v) > 1e-13,
                                k["fac"] * torch.abs(f) * torch.sign(v),
                                torch.zeros_like(v))
        elif damp == 2:
            f = f * k["one_m_fac"]
        elif damp == 3:
            f = torch.where((f < 0) == (v < 0), f * k["one_m_fac"],
                            f * k["two_m_fac"])
        fd.append(f)
    vel_new = [torch.where(cnp[1 + q] > 0, tgt[q], vel[q] + dt * fd[q]
                           / mass_n) for q in range(3)]
    coord_new = [N(n) + vel_new[q] * dt
                 for q, n in enumerate(("coord_x", "coord_y", "coord_z"))]
    surf = {}
    if sw["surf_on"]:
        coord_new[2], surf["dhacc"], (surf["edv_a"], surf["edv_b"]) = \
            surface_process(P, coord_new, cnp[0], dt, N("dhacc"),
                            (N("edv_a"), N("edv_b")), c)

    # ---- phase 4: post-move geometry, CFL partials, masses, the surface
    # factors of epilogue() (pallas3d.py:1395-1534)
    xs2, ys2, zs2 = (gather_tets(g, par) for g in coord_new)
    vxs2, vys2, vzs2 = (gather_tets(v, par) for v in vel_new)
    rho_e = CE("rhoA") - CE("rhoB") * TinC
    volume_new = tet_volume(xs2, ys2, zs2)
    vx_m, vy_m, vz_m = _mean4(vxs2), _mean4(vys2), _mean4(vzs2)
    vmag = torch.sqrt(vx_m * vx_m + vy_m * vy_m + vz_m * vz_m)
    minh = tet_min_height(xs2, ys2, zs2, volume_new)
    swave = torch.sqrt(shearm / rho_e)
    red = torch.stack([minh.min(), (minh / swave).min(), vmag.max(), r2])

    if sw["use_gvs"]:
        apparent = torch.minimum(gvs, torch.sqrt(shearm / rho_e))
        rho_q = bulkm / (apparent * apparent)
    else:
        rho_q = bulkm / c(k["ps2"])
    rho_m = rho_q if sw["quasi_static"] else rho_e
    volume_n = asm_equal(volume_new, par)
    mass_new = asm_equal(rho_m * volume_new / 4.0, par)
    tmass_new = asm_equal(
        (CE("cpA") - CE("cpB") * TinC) * volume_new / 4.0, par)
    hmass_new = asm_equal(CE("hmA") * volume_new, par)

    # correct_surface_element (bc.cxx:1613-1665): the top cell layer's
    # factor 1/rdv where the element grew (applied by epilogue()), and its
    # pre-swap volume overwritten
    volume_old_out, sfac = vol, None
    if sw["surf_corr"]:
        rdv = volume_new[..., -1] / vol[..., -1]
        sfac = torch.where(rdv >= 1.0, 1.0 / rdv, torch.ones_like(rdv))
        volume_old_out = torch.cat([vol[..., :-1], volume_new[..., -1:]],
                                   dim=-1)

    e_out = {"volume": volume_new, "volume_old": volume_old_out,
             "plstrain": plstrain, "delta_plstrain": delta_plstrain,
             "viscosity": viscosity, "dpressure": dpressure,
             "edvoldt": edvoldt, "stress": stress_c, "strain": strain,
             "strain_rate": edot}
    eplanes = [e_out[nm] for nm in E_SLOTS]
    for nm in T_SLOTS:
        eplanes.extend(e_out[nm])
    n_out = {"coord_x": coord_new[0], "coord_y": coord_new[1],
             "coord_z": coord_new[2], "vel_x": vel_new[0],
             "vel_y": vel_new[1], "vel_z": vel_new[2],
             "temperature": temperature_new, "mass": mass_new,
             "tmass": tmass_new, "hmass": hmass_new, "volume_n": volume_n,
             "force_x": fd[0], "force_y": fd[1], "force_z": fd[2], **surf}
    eout = torch.stack([p.expand(vol.shape) for p in eplanes])
    nout = torch.stack([n_out[nm] for nm in N_SLOTS + tuple(surf)])
    return eout, nout, red, dp_nd, sfac


# ------------------------------------------ per-chunk constants and probes

def const_epack(P: StepPlan3, s):
    """Per-chunk constant element planes of a multi-material plan
    (pallas3d._const_epack): the radiogenic source, then the raw marker
    weight of each material, (1 + nmat, 5, nxc, nyc, nzc); None for a
    uniform plan."""
    if P.uniform:
        return None
    cells = P.cells
    planes = [s.radiogenic_source.reshape(*cells, 5).permute(3, 0, 1, 2)]
    emw = s.emw.reshape(*cells, 5, P.nmat).permute(3, 0, 1, 2, 4)
    planes += [emw[..., m] for m in range(P.nmat)]
    return torch.stack(planes).to(P.dtype).contiguous()


def const_npack(P: StepPlan3, ctx, s):
    """Per-chunk constant nodal planes (pallas3d._const_npack): the top
    mask and the vbc component masks, (NCN, nx, ny, nz)."""
    shape = (P.nx, P.ny, P.nz)
    top = ctx.top_mask.to(P.dtype).reshape(shape)
    a = bc_mod.apply_vbcs(ctx.vbc, torch.zeros_like(s.coord), s.coord,
                          s.time)
    b = bc_mod.apply_vbcs(ctx.vbc, torch.ones_like(s.coord), s.coord,
                          s.time)
    mask = (a == b).to(P.dtype)  # constrained components
    return torch.stack([top] + [mask[:, q].reshape(shape)
                                for q in range(3)]).contiguous()


def vbc_targets(ctx, npack, time):
    """Velocity-BC target planes (3, nx, ny, nz): bc.apply_vbcs probed with
    zero velocity at the given coordinates and time
    (pallas3d.py:1619-1637)."""
    shape = npack.shape[1:]
    coord = torch.stack([npack[_nslot(n)].reshape(-1)
                         for n in ("coord_x", "coord_y", "coord_z")], dim=1)
    tgt = bc_mod.apply_vbcs(ctx.vbc, torch.zeros_like(coord), coord, time)
    return tgt.t().reshape(3, *shape).contiguous()


# ------------------------------------------------------- chunk buffers

@dataclass
class ChunkBuffers3:
    """Device buffers of one chunk.  ``ein``/``nin`` hold the state before
    a step and ``eout``/``nout`` after it; the runner swaps them.  The
    scalar and flag buffers follow ops/fused2d.ChunkBuffers.  Inside a
    chunk the tensor planes carry the pending epilogue of the step that
    wrote them (``epilogue``), whose nodal pressure change is ``nwork[1]``
    and whose top-layer surface factors are ``sfac``."""

    ein: torch.Tensor
    nin: torch.Tensor
    eout: torch.Tensor
    nout: torch.Tensor
    cep: torch.Tensor | None  # const_epack (multi-material plans)
    cnp: torch.Tensor
    tgt: torch.Tensor
    scal: torch.Tensor     # dt, vmax, gdtmin, time, last L2 partial,
    #                        dt_maxwell
    flags: torch.Tensor    # (n, 1): refresh
    dthist: torch.Tensor   # (n,)
    part: torch.Tensor     # (NPART, nblocks)
    ework: torch.Tensor    # (NEWORK, nxc, nyc, nzc) element scratch (CUDA)
    nwork: torch.Tensor    # (NNWORK, nx, ny, nz) node scratch: dvoldt (on
    #                        the top lane, after C, surface process 1's dh),
    #                        and the NMD nodal pressure change
    sfac: torch.Tensor     # (5, nxc, nyc) surface factors of the top layer
    fwork: torch.Tensor    # (NFWORK, nxc, nyc) facet tractions' corner
    #                        partials (CUDA, plans with facets)

    def swap(self):
        self.ein, self.eout = self.eout, self.ein
        self.nin, self.nout = self.nout, self.nin


def make_buffers(P: StepPlan3, ctx, s, n: int) -> ChunkBuffers3:
    dev, dtype = s.coord.device, P.dtype
    ein, nin = state_to_planes(s, P.nx, P.ny, P.nz, P.smaps)
    # surface process 1 writes its accumulators on the top lane only, so
    # both buffers start with the other values
    nout = torch.empty_like(nin)
    nout[NN:] = nin[NN:]
    ks = s.steps + 1 + torch.arange(n, device=dev)
    refresh = (ks % 10 == 0) | bool(P.sw["use_gvs"])
    flags = refresh.to(dtype).reshape(n, 1).contiguous()
    # the Maxwell limit, constant through a chunk: the material's, or the
    # least over the elements' mixed shear moduli (pallas3d.py:1660-1669)
    dtm = (torch.full_like(s.dt, P.k["dt_maxwell"]) if P.uniform
           else fused2d.dt_maxwell(P, ctx, s.emw))
    scal = torch.stack([s.dt, s.max_global_vel_mag, s.global_dt_min,
                        s.time, torch.zeros_like(s.dt), dtm]).to(dtype)
    part = torch.zeros((NPART, P.nblocks()), dtype=dtype, device=dev)
    part[:2] = P.k["big"]   # neutral elements of min, min, max, sum
    cuda = dev.type == "cuda"
    return ChunkBuffers3(
        ein=ein, nin=nin, eout=torch.empty_like(ein), nout=nout,
        cep=const_epack(P, s),
        cnp=const_npack(P, ctx, s),
        tgt=torch.zeros((3, P.nx, P.ny, P.nz), dtype=dtype, device=dev),
        scal=scal, flags=flags,
        dthist=torch.zeros(n, dtype=dtype, device=dev), part=part,
        ework=torch.empty((NEWORK, *P.cells) if cuda else (0,),
                          dtype=dtype, device=dev),
        nwork=torch.empty((NNWORK, P.nx, P.ny, P.nz), dtype=dtype,
                          device=dev),
        sfac=torch.empty((5, P.nx - 1, P.ny - 1), dtype=dtype, device=dev),
        fwork=torch.empty((NFWORK, *P.cells[:2]) if cuda and P.facets
                          else (0,), dtype=dtype, device=dev))


def last_only_slots(P: StepPlan3):
    """(element slots, nodal slots) that no later phase or step of a chunk
    reads, which the chunk form stores on its last step only: strain rate,
    edvoldt and the viscosity a creep law recomputes; hmass and the
    force."""
    e = [_eslot("edvoldt")] + [_tslot("strain_rate") + q for q in range(6)]
    if P.rheol in (RH_VISCOUS, RH_MAXWELL, RH_EVP):
        e.append(_eslot("viscosity"))
    n = [_nslot(f) for f in ("hmass", "force_x", "force_y", "force_z")]
    return e, n


# ------------------------------------------------ kernel wrappers

def _cuda_args_ok(P: StepPlan3, b: ChunkBuffers3):
    if P.dtype != torch.float32:
        raise TypeError("the CUDA fused 3D step is built for float32 only")
    for name in ("ein", "nin", "eout", "nout", "cnp", "tgt", "scal",
                 "dthist", "part", "ework", "nwork", "sfac"):
        t = getattr(b, name)
        if not (t.is_cuda and t.dtype == torch.float32
                and t.is_contiguous()):
            raise TypeError(f"{name}: need a contiguous float32 CUDA "
                            "tensor")
    if not P.uniform and (
            b.cep is None or not (b.cep.is_cuda
                                  and b.cep.dtype == torch.float32
                                  and b.cep.is_contiguous())
            or tuple(b.cep.shape) != (1 + P.nmat, 5, *P.cells)):
        raise TypeError("cep: need the plan's contiguous float32 const "
                        "pack on the card (const_epack)")
    if P.facets and not (b.fwork.is_cuda and b.fwork.dtype == torch.float32
                         and b.fwork.is_contiguous()
                         and tuple(b.fwork.shape) == (NFWORK, *P.cells[:2])):
        raise TypeError("fwork: need the plan's contiguous float32 facet "
                        "scratch on the card")
    if tuple(b.ein.shape) != (NE, 5, *P.cells) \
            or tuple(b.nin.shape) != (P.nn, P.nx, P.ny, P.nz) \
            or tuple(b.ework.shape) != (NEWORK, *P.cells) \
            or tuple(b.nwork.shape) != (NNWORK, P.nx, P.ny, P.nz) \
            or tuple(b.sfac.shape) != (5, *P.cells[:2]) \
            or tuple(b.part.shape) != (NPART, P.nblocks()):
        raise ValueError("plane shapes do not match the step plan")
    if P.cells[2] % 2:
        # the cell phases take the cells (k, k + 1) in pairs
        raise ValueError("the CUDA fused 3D step needs an even nzc")


def _launch_step(P: StepPlan3, b: ChunkBuffers3, pending: bool, last: bool,
                 dt_prev):
    from . import _build

    _cuda_args_ok(P, b)
    p = fused2d._ptr
    rc = _build.load().des_fused3d_step_f32(
        P.ip.ctypes.data, P.fp.ctypes.data, p(b.ein), p(b.nin), p(b.eout),
        p(b.nout), p(b.cep), p(b.cnp), p(b.tgt), p(b.scal), p(b.ework),
        p(b.nwork),
        p(b.sfac), p(dt_prev), p(b.part), p(b.fwork if P.facets else None),
        b.part.shape[1], int(pending), int(last), fused2d._stream())
    if rc != 0:
        raise RuntimeError(f"fused3d step launch failed: {_build.err(rc)}")
    fused3d_step.launches += 1


def fused3d_step(P: StepPlan3, b: ChunkBuffers3):
    """One complete fused 3D time step: ``b.ein``/``b.nin`` (a State's
    planes, no pending epilogue) -> ``b.eout``/``b.nout`` (the same), with
    block partials in ``b.part``: the chunk-form step on its own, then its
    epilogue (fused3d_chunk_step, fused3d_finalize: on CUDA tensors the
    kernels, on CPU tensors their plain versions)."""
    fused3d_chunk_step(P, b, 0, 1)
    fused3d_finalize(P, b, b.eout, b.nout, b.scal[0])


def fused3d_step_plain(P: StepPlan3, b: ChunkBuffers3):
    """The plain version of fused3d_step on the chunk buffers, on any
    device, with the same inputs and outputs (the full-mesh partials go to
    column 0 of ``b.part``)."""
    chunk_step_plain(P, b, 0, 1)
    finalize_plain(P, b, b.eout, b.nout, b.scal[0])


def fused3d_chunk_step(P: StepPlan3, b: ChunkBuffers3, k: int, n: int):
    """Step k of an n-step chunk in the chunk form (the entry run_chunk
    uses): ``b.ein`` carries the pending epilogue of step k - 1 (k > 0,
    with that step's dt from ``b.dthist[k - 1]``) and ``b.eout`` is left
    with step k's; the planes of last_only_slots are stored on step n - 1
    only.  On CUDA tensors it launches csrc/fused3d.cu (counted in
    ``fused3d_step.launches``); on CPU tensors it runs chunk_step_plain."""
    if b.ein.is_cuda:
        _launch_step(P, b, k > 0, k == n - 1,
                     b.dthist[k - 1] if k else b.scal[0])
        return
    if b.ein.device.type != "cpu":
        raise TypeError(f"no fused 3D step for device {b.ein.device}")
    chunk_step_plain(P, b, k, n)


def chunk_step_plain(P: StepPlan3, b: ChunkBuffers3, k: int, n: int):
    """The plain version of fused3d_chunk_step, on any device (counted in
    ``chunk_step_plain.calls``, so that a run on the card can show it never
    took it)."""
    chunk_step_plain.calls += 1
    pending = (b.dthist[k - 1], b.nwork[1], b.sfac) if k else None
    eout, nout, red, dp_nd, sfac = step_planes_plain(
        P, b.ein, b.nin, b.cnp, b.tgt, b.scal[0],
        b.scal[1] * P.k["inertial"], pending=pending, cep=b.cep)
    if k == n - 1:
        b.eout.copy_(eout)
        b.nout.copy_(nout)
    else:
        skip_e, skip_n = last_only_slots(P)
        ke = [i for i in range(NE) if i not in skip_e]
        kn = [i for i in range(P.nn) if i not in skip_n]
        b.eout[ke] = eout[ke]
        b.nout[kn] = nout[kn]
    if dp_nd is not None:
        b.nwork[1] = dp_nd
    if sfac is not None:
        b.sfac.copy_(sfac)
    b.part[:, 0] = red


def fused3d_finalize(P: StepPlan3, b: ChunkBuffers3, e, n, dt):
    """Apply the pending epilogue of the step that wrote the planes ``e``
    / ``n`` (its dt the 0-d tensor ``dt``) to ``e`` in place, stress,
    strain, strain rate and plstrain: after it the planes are a State's.
    On CUDA tensors it launches the finalize kernel of csrc/fused3d.cu
    (counted in ``fused3d_finalize.launches``); on CPU tensors it runs
    finalize_plain."""
    if e.is_cuda:
        from . import _build

        _cuda_args_ok(P, b)
        if not any(e.data_ptr() == t.data_ptr() for t in (b.ein, b.eout)) \
                or not any(n.data_ptr() == t.data_ptr()
                           for t in (b.nin, b.nout)):
            raise ValueError("finalize takes planes of the chunk buffers")
        p = fused2d._ptr
        rc = _build.load().des_fused3d_finalize_f32(
            P.ip.ctypes.data, P.fp.ctypes.data, p(e), p(n), p(b.nwork),
            p(b.sfac), p(dt), fused2d._stream())
        if rc != 0:
            raise RuntimeError(
                f"fused3d finalize launch failed: {_build.err(rc)}")
        fused3d_finalize.launches += 1
        return
    if e.device.type != "cpu":
        raise TypeError(f"no fused 3D finalize for device {e.device}")
    finalize_plain(P, b, e, n, dt)


def finalize_plain(P: StepPlan3, b: ChunkBuffers3, e, n, dt):
    """The plain version of fused3d_finalize, on any device (counted in
    ``finalize_plain.calls``)."""
    finalize_plain.calls += 1
    st, sn, sr = (_tslot(f) for f in T_SLOTS)
    pl = _eslot("plstrain")
    stress, strain, pls, rate = epilogue(
        P, n, e[_eslot("volume")], dt, e[_eslot("dpressure")], b.nwork[1],
        b.sfac, tuple(e[st:st + 6]), tuple(e[sn:sn + 6]), e[pl],
        tuple(e[sr:sr + 6]))
    e[st:st + 6] = torch.stack(stress)
    e[sn:sn + 6] = torch.stack(strain)
    e[sr:sr + 6] = torch.stack(rate)
    e[pl] = pls


def _plain_ties(P: StepPlan3, ctx, s):
    """The ``ties`` list of step_planes_plain for one step from State s
    (empty off EVP), each entry by element id in its last dimension."""
    b = make_buffers(P, ctx, s, 1)
    b.tgt = vbc_targets(ctx, b.nin, b.scal[3] + b.scal[0])
    ties = []
    step_planes_plain(P, b.ein, b.nin, b.cnp, b.tgt, b.scal[0],
                      b.scal[1] * P.k["inertial"], ties, cep=b.cep)
    return [t.movedim(-4, -1).reshape(*t.shape[:-4], -1) for t in ties]


def evp_ties(P: StepPlan3, ctx, s):
    """The elements, by id, whose EVP min-select after one step from State
    s is an exact tie with both trial invariants 0 and the trial stresses
    unequal (all False off EVP): both invariants are exactly 0 in any
    correct step, which must resolve them alike."""
    ties = _plain_ties(P, ctx, s)
    return ties[0] if ties else torch.zeros(
        5 * P.ncell, dtype=torch.bool, device=s.coord.device)


def evp_tie_reach(P: StepPlan3, ctx, s):
    """What the ties of equal nonzero trial invariants of one step from
    State s can change, and how near a tie they are: (element mask, node
    mask, gap).  A tie element's branch moves its nodes' forces and NMD
    pressure change, which every element on those nodes takes into its
    stress, and so into its own nodes' forces.  ``gap`` is the max over
    the ties of |iv - ip| / e, with iv and ip taken in float64 from the
    same inputs and constants and e the larger of the run dtype's own
    errors in them: below 1, the step rounds the invariants by more than
    they differ, so which is the smaller is a matter of rounding and two
    correct steps may pick either branch (0 without such ties)."""
    lo = _plain_ties(P, ctx, s)
    conn = ctx.conn.to(s.coord.device)
    nodes = torch.zeros(ctx.nnode, dtype=torch.bool, device=conn.device)
    if not lo:
        return nodes[conn].any(1), nodes, 0.0
    hi = _plain_ties(replace(P, dtype=torch.float64), ctx, state_from_numpy(
        state_to_numpy(s), s.coord.device, torch.float64))
    tie = lo[1]
    nodes[conn[tie].reshape(-1)] = True
    elems = nodes[conn].any(1)
    reach = torch.zeros_like(nodes)
    reach[conn[elems].reshape(-1)] = True
    # (iv, ip) at the ties, in the run dtype and in float64
    a, b = lo[2][:, tie].double(), hi[2][:, tie]
    d, err = (b[0] - b[1]).abs(), (a - b).abs().max(0).values
    gap = float(torch.where(d == 0, 0.0, d / err).max()) \
        if bool(tie.any()) else 0.0
    return elems, reach, gap


fused3d_step.launches = 0
fused3d_finalize.launches = 0
chunk_step_plain.calls = 0
finalize_plain.calls = 0


# ---------------------------------------------------------- chunk runner

def run_chunk(P: StepPlan3, ctx, s, n: int, plain: bool = False):
    """Advance ``s`` by n fused 3D steps (pallas3d.make_chunk_runner) in
    the chunk form: each step leaves its tensor epilogue pending for the
    next (fused3d_chunk_step) and one finalize after the last step applies
    the last one, so the State returned is the State of n complete steps,
    bit for bit.  vbc targets probed every step from the pre-move
    coordinates at time + dt, time accumulated step by step, vmax and
    gdtmin set every step and dt on the refresh cadence.  ``plain`` runs
    the plain versions on the state's device instead of the wrappers (the
    reference the CUDA kernels are checked against)."""
    b = make_buffers(P, ctx, s, n)
    for k in range(n):
        b.tgt = vbc_targets(ctx, b.nin, b.scal[3] + b.scal[0])
        if plain:
            chunk_step_plain(P, b, k, n)
            fused2d.dt_refresh_plain(P, b.part, b.scal, b.dthist, b.flags,
                                     k, tiled=True, every=True)
        else:
            fused3d_chunk_step(P, b, k, n)
            fused2d.dt_refresh(P, b, k, tiled=True, every=True)
        b.swap()
    (finalize_plain if plain else fused3d_finalize)(
        P, b, b.ein, b.nin, b.dthist[n - 1])
    # l2_residual: pallas3d.py:1654 divides by nx*ny*nz*3
    nnode3 = torch.full((), float(P.nnode * 3), dtype=P.dtype,
                        device=b.scal.device)
    return planes_to_state(
        s, b.ein, b.nin, P.nx, P.ny, P.nz, P.smaps, time=b.scal[3].clone(),
        dt=b.scal[0].clone(), steps=s.steps + n,
        max_global_vel_mag=b.scal[1].clone(),
        global_dt_min=b.scal[2].clone(),
        l2_residual=torch.sqrt(b.scal[4] / nnode3))


def make_chunk_runner(param: Param, ctx, compensation_pressure: float,
                      n: int):
    """run(ctx, state) -> state after n fused 3D steps (the counterpart of
    pallas3d.make_chunk_runner, with its arguments): ``compensation_pressure``
    is the Winkler reference pressure of the bottom facet tractions."""
    P = make_plan(param, ctx, ctx.conn.device, compensation_pressure)
    return lambda c, s: run_chunk(P, c, s, n)
