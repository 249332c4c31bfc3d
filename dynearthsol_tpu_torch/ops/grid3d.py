"""Structured-grid 3D step on planes (counterpart of
dynearthsol_tpu/ops/grid3d.py).

The step of the raster 5-tet box (mesh/generate.regular_grid_3d: node id =
(i*ny + j)*nz + k, five tets per cell, their decomposition mirrored with
the parity of i + j + k) where the fused 3D step's gate refuses it: in
float64, with averaged output, Neumann tractions or the elastic
foundation, surface process 102, or a box that fails the kernel's tile
conditions.  It is the JAX package's ``make_grid_step``, operation for
operation and in the same order, in PyTorch:

  element scalar   -> (5, nzc, nyc, nxc) planes, x-minor
  element tensor   -> (6, 5, nzc, nyc, nxc)
  emw              -> (5, nzc, nyc, nxc, nmat)
  nodal fields     -> unchanged (nnode, ...)

Element-node transfers are shifted slices of the (nz, ny, nx) node grid
with a parity select between the two tet tables (structured.tet_tables):
a gather is eight views and a select, an assembly eight in-place slice
additions in corner order, with no index scatter and no atomics.  The
physics is the componentwise cores of ops/rheology.py and ops/matprops.py;
the boundary tractions, damping, velocity BCs and the surface processes
are the nodal functions the column steps call.  A chunk runner converts
the state to planes once, steps n times and converts back.

This is plain PyTorch: the JAX module is XLA code outside any Pallas
kernel.  A divisor that is a Python number is made a 0-d tensor first (on
the card PyTorch divides by a Python number as a product with its
reciprocal).  Reference per-step kernel order: dynearthsol.cxx:746-956.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import bc as bc_mod
from ..config import (RH_ELASTIC, RH_EP, RH_EVP, RH_MAXWELL, RH_VISCOUS,
                      Param)
from . import fields as F
from . import matprops as M
from . import rheology as R
from . import surface as SP
from .geometry import tet_min_height
from .matprops import MIN_STRAIN_RATE
from .structured import tet_tables

E_SCALARS = ("volume", "volume_old", "stressyy", "old_mean_stress",
             "plstrain", "delta_plstrain", "viscosity", "dpressure",
             "edvoldt", "radiogenic_source", "dyn_fric_coeff",
             "state_variable", "delta_plstrain_avg")
E_TENSORS = ("stress", "strain", "strain_rate", "stress_avg", "strain_avg0")
NPE = 4


def state_to_grid(s, nx: int, ny: int, nz: int):
    """The element fields of a State as x-minor planes."""
    nxc, nyc, nzc = nx - 1, ny - 1, nz - 1

    def e2p(a):   # (nelem,) -> (5, nzc, nyc, nxc)
        return a.reshape(nxc, nyc, nzc, 5).permute(3, 2, 1, 0).contiguous()

    def t2p(a):   # (nelem, 6) -> (6, 5, nzc, nyc, nxc)
        return a.reshape(nxc, nyc, nzc, 5, a.shape[1]) \
            .permute(4, 3, 2, 1, 0).contiguous()

    upd = {f: e2p(getattr(s, f)) for f in E_SCALARS}
    upd.update({f: t2p(getattr(s, f)) for f in E_TENSORS})
    upd["emw"] = s.emw.reshape(nxc, nyc, nzc, 5, s.emw.shape[1]) \
        .permute(3, 2, 1, 0, 4).contiguous()
    return s.replace(**upd)


def grid_to_state(g, nx: int, ny: int, nz: int):
    """Inverse of state_to_grid."""
    nxc, nyc, nzc = nx - 1, ny - 1, nz - 1
    nelem = nxc * nyc * nzc * 5

    def p2e(p):
        return p.permute(3, 2, 1, 0).reshape(nelem)

    def p2t(p):
        return p.permute(4, 3, 2, 1, 0).reshape(nelem, p.shape[0])

    upd = {f: p2e(getattr(g, f)) for f in E_SCALARS}
    upd.update({f: p2t(getattr(g, f)) for f in E_TENSORS})
    upd["emw"] = g.emw.permute(3, 2, 1, 0, 4).reshape(nelem,
                                                      g.emw.shape[4])
    return g.replace(**upd)


def grid_step_applicable(param: Param, ctx) -> bool:
    """grid3d.grid_step_applicable (this package has no sharded axis).
    The fused 3D step's gate (ops/fused3d.py) starts from it."""
    ctrl = param.control
    return (ctx.sgrid is not None and len(ctx.sgrid) == 3
            and ctx.ndims == 3
            and not ctrl.has_hydraulic_diffusion
            and not ctrl.has_PT
            and param.mat.rheol_type in (RH_ELASTIC, RH_VISCOUS, RH_MAXWELL,
                                         RH_EP, RH_EVP))


def unported_features(param: Param, ctx) -> list:
    """What passes the gate above but this step does not compute: nothing
    (the simulation asks every step module)."""
    return []


def make_grid_step(param: Param, ctx, compensation_pressure: float = 0.0):
    """Build step(ctx, gstate) -> gstate on plane-layout State (3D
    structured 5-tet), mirroring grid3d.make_grid_step."""
    ctrl = param.control
    mat = param.mat
    nx, ny, nz = ctx.sgrid
    nxc, nyc, nzc = nx - 1, ny - 1, nz - 1
    nnode = nx * ny * nz
    dev = ctx.conn.device
    dtype = torch.float64 if param.sim.float_dtype == "float64" \
        else torch.float32
    rheol = mat.rheol_type
    max_vbc_val = ctx.max_vbc_val
    pseudo_speed = max_vbc_val * ctrl.inertial_scaling
    surface = ctrl.surface_process_option != 0 and ctx.surf.etop > 0
    even_t, odd_t = tet_tables()
    k = np.arange(nzc)[:, None, None]
    j = np.arange(nyc)[None, :, None]
    i = np.arange(nxc)[None, None, :]
    P = torch.as_tensor((i + j + k) % 2 == 0, device=dev)
    # the z-cell row under the top nodes (every tet of it touches one)
    toprow = torch.zeros((5, nzc, nyc, nxc), dtype=torch.bool, device=dev)
    toprow[:, -1] = True

    def const(v):
        return torch.tensor(float(v), dtype=dtype, device=dev)

    npe = const(NPE)
    three = const(3.0)
    five = const(5.0)
    six = const(6.0)
    big = const(torch.finfo(dtype).max)
    c_therm_diff_max = const(ctx.mat.therm_diff_max)
    c_max_vbc = const(max_vbc_val)
    c_pseudo = const(pseudo_speed)
    c_pseudo2 = const(pseudo_speed * pseudo_speed)
    c_swave_ref = const(math.sqrt(mat.bulk_modulus[mat.mattype_ref]
                                  / mat.rho0[mat.mattype_ref]))
    c_half_visc_min = const(0.5 * ctx.mat.visc_min)
    surface_T = const(param.bc.surface_temperature)
    sbc = ctx.sbc.on(dev)
    st = (SP.surf_tables(ctx.surf, ctx.nnode, dtype, dev) if surface
          else None)

    def _views(g):
        """The 8 shifted cell-corner views of an x-minor node grid
        (nz, ny, nx); corner code = a*4 + b*2 + d for x/y/z offsets."""
        return [g[d:d + nzc, b:b + nyc, a:a + nxc]
                for a in (0, 1) for b in (0, 1) for d in (0, 1)]

    def gather(nodal):
        """(nnode,) -> 4 slot planes, each (5, nzc, nyc, nxc)."""
        c = _views(nodal.reshape(nx, ny, nz).permute(2, 1, 0))
        return tuple(torch.stack([torch.where(P, c[even_t[t][s]],
                                              c[odd_t[t][s]])
                                  for t in range(5)])
                     for s in range(NPE))

    def _scatter(per_corner):
        """Add the 8 per-corner cell planes into the node grid, in corner
        order."""
        out = torch.zeros((nz, ny, nx), dtype=per_corner[0].dtype,
                          device=dev)
        code = 0
        for a in (0, 1):
            for b in (0, 1):
                for d in (0, 1):
                    out[d:d + nzc, b:b + nyc, a:a + nxc] += per_corner[code]
                    code += 1
        return out.permute(2, 1, 0).reshape(nnode)

    def asm(*cs):
        """Transpose of gather: 4 slot planes -> nodal sums (nnode,)."""
        per_corner = []
        zero = torch.zeros((nzc, nyc, nxc), dtype=cs[0].dtype, device=dev)
        for code in range(8):
            acc_e = zero
            acc_o = zero
            for t in range(5):
                for s in range(NPE):
                    if even_t[t][s] == code:
                        acc_e = acc_e + cs[s][t]
                    if odd_t[t][s] == code:
                        acc_o = acc_o + cs[s][t]
            per_corner.append(torch.where(P, acc_e, acc_o))
        return _scatter(per_corner)

    def asm_equal(v):
        """asm() when all 4 slots carry the same per-element value."""
        per_corner = []
        zero = torch.zeros((nzc, nyc, nxc), dtype=v.dtype, device=dev)
        for code in range(8):
            acc_e = zero
            acc_o = zero
            for t in range(5):
                if code in even_t[t]:
                    acc_e = acc_e + v[t]
                if code in odd_t[t]:
                    acc_o = acc_o + v[t]
            per_corner.append(torch.where(P, acc_e, acc_o))
        return _scatter(per_corner)

    def corner_sum(cols):
        return cols[0] + cols[1] + cols[2] + cols[3]

    def dot4(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3]

    def volume_of(xs, ys, zs):
        """Tet volume (geometry.cxx:135-200)."""
        d1 = (xs[1] - xs[0], ys[1] - ys[0], zs[1] - zs[0])
        d2 = (xs[2] - xs[0], ys[2] - ys[0], zs[2] - zs[0])
        d3 = (xs[3] - xs[0], ys[3] - ys[0], zs[3] - zs[0])
        return (d1[0] * (d2[1] * d3[2] - d2[2] * d3[1])
                + d1[1] * (d2[2] * d3[0] - d2[0] * d3[2])
                + d1[2] * (d2[0] * d3[1] - d2[1] * d3[0])) / six

    def shape_fn(xs, ys, zs, vol):
        """P1 tet gradients (fields.cxx:11-54)."""
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

    def compute_dt_planes(xs, ys, zs, vol, vxs, vys, vzs, shearm, rho_e):
        """CFL dt (geometry.cxx:756-923) on planes."""
        vxm = corner_sum(vxs) / npe
        vym = corner_sum(vys) / npe
        vzm = corner_sum(vzs) / npe
        vmag = torch.sqrt(vxm * vxm + vym * vym + vzm * vzm)
        vmax = torch.maximum(vmag.max(), c_max_vbc)
        if ctrl.fixed_dt != 0.0:
            fdt = const(ctrl.fixed_dt)
            return fdt, vmax, fdt
        minh = tet_min_height(xs, ys, zs, vol)
        minl = minh.min()
        dt_maxwell = (c_half_visc_min / (1e-40 + shearm)).min()
        dt_diffusion = (0.5 * minh * minh / c_therm_diff_max).min() \
            if ctrl.has_thermal_diffusion else big
        swave = torch.sqrt(shearm / rho_e)
        gdtmin = (minl / swave / five).min()
        if ctrl.use_global_velocity_scaling:
            dt_advection = 0.5 * minl / vmax
            if ctrl.is_quasi_static:
                dt_elastic = 0.5 * minl / (vmax * ctrl.inertial_scaling)
            else:
                dt_elastic = 0.5 * minl / c_swave_ref
            dt_elastic = torch.maximum(dt_elastic, gdtmin)
        else:
            dt_advection = 0.5 * minl / c_max_vbc
            if ctrl.is_quasi_static:
                dt_elastic = 0.5 * minl / c_pseudo
            else:
                dt_elastic = 0.5 * minl / c_swave_ref
        dt = torch.minimum(torch.minimum(dt_elastic, dt_maxwell),
                           torch.minimum(dt_advection, dt_diffusion)) \
            * ctrl.dt_fraction
        return dt, vmax, gdtmin

    def inv2(t):
        a = (t[0] + t[1] + t[2]) / three
        return (0.5 * ((t[0] - a) * (t[0] - a) + (t[1] - a) * (t[1] - a)
                       + (t[2] - a) * (t[2] - a))
                + t[3] * t[3] + t[4] * t[4] + t[5] * t[5])

    def update_stress_planes(tab, s, de, edot, sr, bulkm, shearm, temp_e,
                             dt):
        """Constitutive switch (rheology.cxx:676-991), 3D componentwise."""
        stress = tuple(s.stress[i] for i in range(6))
        old_tr = stress[0] + stress[1] + stress[2]
        plstrain, delta_plstrain = s.plstrain, s.delta_plstrain
        viscosity = s.viscosity

        def creep_visc():
            s0 = (stress[0] + stress[1] + stress[2]) / three
            edot_inv = torch.clamp(torch.sqrt(inv2(sr)), min=MIN_STRAIN_RATE)
            return M.visc_core(tab, s.emw, temp_e, s0, edot_inv)

        if rheol == RH_ELASTIC:
            stress = R.elastic3_c(bulkm, shearm, de, stress)
        elif rheol == RH_VISCOUS:
            viscosity = creep_visc()
            strain_new = tuple(s.strain[i] + de[i] for i in range(6))
            total_dv = strain_new[0] + strain_new[1] + strain_new[2]
            stress = R.viscous3_c(bulkm, viscosity, total_dv, edot)
        elif rheol == RH_MAXWELL:
            viscosity = creep_visc()
            dv = s.volume / s.volume_old - 1.0
            stress = R.maxwell3_c(bulkm, shearm, viscosity, dt, dv, de,
                                  stress)
        elif rheol == RH_EP:
            stress, depls, _ = R.elasto_plastic3_c(
                bulkm, shearm, *M.plastic_props(tab, s.emw, s.plstrain),
                de, stress)
            plstrain = s.plstrain + depls
            delta_plstrain = depls
        elif rheol == RH_EVP:
            viscosity = creep_visc()
            dv = s.volume / s.volume_old - 1.0
            sv = R.maxwell3_c(bulkm, shearm, viscosity, dt, dv, de, stress)
            sp, depls, _ = R.elasto_plastic3_c(
                bulkm, shearm, *M.plastic_props(tab, s.emw, s.plstrain),
                de, stress)
            # min-magnitude selection (rheology.cxx:869-879)
            use_v = inv2(sv) < inv2(sp)
            stress = tuple(torch.where(use_v, a, b) for a, b in zip(sv, sp))
            plstrain = torch.where(use_v, s.plstrain, s.plstrain + depls)
            delta_plstrain = torch.where(use_v, s.delta_plstrain, depls)
        else:  # pragma: no cover - gated
            raise ValueError(f"grid3d: unsupported rheology {rheol}")
        if ctrl.is_using_mixed_stress:
            dpressure = stress[0] + stress[1] + stress[2] - old_tr
        else:
            dpressure = s.dpressure
        return stress, plstrain, delta_plstrain, viscosity, dpressure

    def step(ctx, s):
        tab = ctx.mat
        dt = s.dt
        steps = s.steps + 1
        time = s.time + s.dt

        xs = gather(s.coord[:, 0])
        ys = gather(s.coord[:, 1])
        zs = gather(s.coord[:, 2])
        vxs = gather(s.vel[:, 0])
        vys = gather(s.vel[:, 1])
        vzs = gather(s.vel[:, 2])
        ts = gather(s.temperature)

        vol = s.volume
        dndx, dndy, dndz = shape_fn(xs, ys, zs, vol)
        temp_e = corner_sum(ts) / npe
        bulkm = M.bulkm(tab, s.emw)
        shearm = M.shearm(tab, s.emw)
        rho_e = M.rho_from_T(tab, s.emw, temp_e)

        temperature = s.temperature
        if ctrl.has_thermal_diffusion:
            kappa = M.therm_cond(tab, s.emw)
            source = s.radiogenic_source * vol * rho_e / npe
            kv = kappa * vol
            gx, gy, gz = dot4(dndx, ts), dot4(dndy, ts), dot4(dndz, ts)
            tdot = asm(*(kv * (dndx[c] * gx + dndy[c] * gy + dndz[c] * gz)
                         - source for c in range(NPE)))
            temperature = torch.where(
                ctx.top_mask, surface_T,
                s.temperature - s.dt * tdot / s.tmass)

        # strain rate (fields.cxx:408-483)
        lxx, lyy, lzz = dot4(vxs, dndx), dot4(vys, dndy), dot4(vzs, dndz)
        lxy = 0.5 * (dot4(vxs, dndy) + dot4(vys, dndx))
        lxz = 0.5 * (dot4(vxs, dndz) + dot4(vzs, dndx))
        lyz = 0.5 * (dot4(vys, dndz) + dot4(vzs, dndy))
        sr = (lxx, lyy, lzz, lxy, lxz, lyz)

        # dvoldt/edvoldt anti-locking (geometry.cxx:202-276)
        etmp = (lxx + lyy + lzz) * vol
        dvoldt = asm_equal(etmp) / s.volume_n
        edvoldt = corner_sum(gather(dvoldt)) / npe

        adj = (edvoldt - (lxx + lyy + lzz)) / three
        edot = (lxx + adj, lyy + adj, lzz + adj, lxy, lxz, lyz)
        de = tuple(edot[i] * dt for i in range(6))
        strain = torch.stack([s.strain[i] + de[i] for i in range(6)])
        strain_rate = torch.stack(edot)

        (stress_c, plstrain, delta_plstrain, viscosity,
         dpressure) = update_stress_planes(
            tab, s.replace(edvoldt=edvoldt), de, edot, sr, bulkm, shearm,
            temp_e, dt)

        if ctrl.is_using_mixed_stress:
            # NMD pressure smoothing (geometry.cxx:279-331)
            dp_nd = asm_equal(dpressure * vol) / s.volume_n
            ddp = (corner_sum(gather(dp_nd)) / npe - dpressure) / three
            stress_c = (stress_c[0] + ddp, stress_c[1] + ddp,
                        stress_c[2] + ddp) + stress_c[3:]
        stress = torch.stack(stress_c)

        # force assembly (fields.cxx:612-703)
        phi_e = M.phi_porosity(tab, s.emw)
        if ctrl.gravity != 0:
            buoy = (rho_e * (1.0 - phi_e) + 1000.0 * phi_e) \
                * ctrl.gravity / npe
        else:
            buoy = torch.zeros_like(vol)
        sc = stress_c
        fx = tuple((sc[0] * dndx[c] + sc[3] * dndy[c] + sc[4] * dndz[c])
                   * vol for c in range(NPE))
        fy = tuple((sc[3] * dndx[c] + sc[1] * dndy[c] + sc[5] * dndz[c])
                   * vol for c in range(NPE))
        fz = tuple((sc[4] * dndx[c] + sc[5] * dndy[c] + sc[2] * dndz[c]
                    + buoy) * vol for c in range(NPE))
        force = torch.stack([-asm(*fx), -asm(*fy), -asm(*fz)], dim=1)
        l2_res = F.residual_l2(force)

        if ctrl.gravity != 0:
            # the facet tractions read element densities in element order
            rho_flat = rho_e.permute(3, 2, 1, 0).reshape(-1)
            force = bc_mod.apply_stress_bcs(
                param, sbc, s.coord, force, rho_flat, compensation_pressure,
                s.coord0)
        force = bc_mod.apply_stress_bcs_neumann(sbc, s.coord, force)
        force = F.apply_damping(force, s.vel, s.mass, s.ymass,
                                ctrl.damping_option, ctrl.damping_factor)
        vel = F.update_velocity(s.vel, force, s.mass, s.dt)
        vel = bc_mod.apply_vbcs(ctx.vbc, vel, s.coord, time)

        # update_mesh (dynearthsol.cxx:431-473)
        vxs2 = gather(vel[:, 0])
        vys2 = gather(vel[:, 1])
        vzs2 = gather(vel[:, 2])
        dhacc, edvacc_surf = s.dhacc, s.edvacc_surf
        if ctrl.has_moving_mesh:
            coord = F.update_coordinate(s.coord, vel, s.dt)
            if surface:
                # in-step surface processes (bc.cxx:1667-1831); the top
                # plane moved, so the coordinates are gathered again
                coord, dhacc, edvacc_surf, _ = SP.apply_surface_processes(
                    param, st, coord, s.dt, dhacc, edvacc_surf)
                xs2 = gather(coord[:, 0])
                ys2 = gather(coord[:, 1])
                zs2 = gather(coord[:, 2])
            else:
                xs2 = tuple(xs[i] + vxs2[i] * s.dt for i in range(NPE))
                ys2 = tuple(ys[i] + vys2[i] * s.dt for i in range(NPE))
                zs2 = tuple(zs[i] + vzs2[i] * s.dt for i in range(NPE))
            volume_old = vol
            volume = volume_of(xs2, ys2, zs2)
            # correct_surface_element (bc.cxx:1613-1665), even with
            # surface_process_option 0: the top z-cell row is rescaled by
            # 1/rdv where it grew and its pre-swap volume overwritten,
            # before the (linear) Jaumann rotation below
            if ctrl.has_surface_correction:
                rdv = volume / vol
                tscale = torch.where(toprow & (rdv >= 1.0), 1.0 / rdv,
                                     torch.ones_like(rdv))
                stress = stress * tscale
                strain = strain * tscale
                strain_rate = strain_rate * tscale
                plstrain = plstrain * tscale
                volume_old = torch.where(toprow, volume, vol)
        else:
            coord, volume_old, volume = s.coord, s.volume_old, vol
            xs2, ys2, zs2 = xs, ys, zs

        dt_new, vmax, gdtmin = compute_dt_planes(
            xs2, ys2, zs2, volume, vxs2, vys2, vzs2, shearm, rho_e)
        if ctrl.use_global_velocity_scaling:
            dt_out = dt_new
        else:
            dt_out = torch.where(steps % 10 == 0, dt_new, s.dt)

        if ctrl.has_moving_mesh:
            # (pseudo-)mass matrices (geometry.cxx:1020-1154)
            if ctrl.use_global_velocity_scaling:
                apparent = torch.minimum(s.max_global_vel_mag
                                         * ctrl.inertial_scaling,
                                         torch.sqrt(shearm / rho_e))
                rho_q = bulkm / (apparent * apparent)
            else:
                rho_q = bulkm / c_pseudo2
            rho_m = rho_q if ctrl.is_quasi_static else rho_e
            bulk_comp = 1.0 / bulkm       # 3D (geometry.cxx:1098)
            ab_e = M.alpha_biot(tab, s.emw)
            bf_e = M.beta_fluid(tab, s.emw)
            cp_e = M.cp(tab, s.emw)
            hm_coeff = ab_e + phi_e - ab_e * phi_e
            m = rho_m * volume / npe
            tm = rho_e * cp_e * volume / npe
            hm = (hm_coeff * bulk_comp + phi_e * bf_e) * volume / npe
            ym = 9.0 * bulkm * shearm / (3.0 * bulkm + shearm) / npe
            volume_n = asm_equal(volume)
            mass = asm_equal(m)
            tmass = asm_equal(tm)
            hmass = asm_equal(hm)
            ymass = asm_equal(ym)
        else:
            volume_n, mass, tmass, hmass, ymass = (
                s.volume_n, s.mass, s.tmass, s.hmass, s.ymass)

        # Jaumann rotation with post-move geometry (dynearthsol.cxx:853-855)
        if rheol & RH_ELASTIC:
            dndx2, dndy2, dndz2 = shape_fn(xs2, ys2, zs2, volume)
            w3t = 0.5 * (dot4(vxs2, dndy2) - dot4(vys2, dndx2)) * s.dt
            w4t = 0.5 * (dot4(vxs2, dndz2) - dot4(vzs2, dndx2)) * s.dt
            w5t = 0.5 * (dot4(vys2, dndz2) - dot4(vzs2, dndy2)) * s.dt

            def rot(t):
                return torch.stack([
                    t[0] - 2.0 * t[3] * w3t - 2.0 * t[4] * w4t,
                    t[1] + 2.0 * t[3] * w3t - 2.0 * t[5] * w5t,
                    t[2] + 2.0 * t[4] * w4t + 2.0 * t[5] * w5t,
                    t[3] + (t[0] - t[1]) * w3t - t[4] * w5t - t[5] * w4t,
                    t[4] + (t[0] - t[2]) * w4t + t[3] * w5t - t[5] * w3t,
                    t[5] + (t[1] - t[2]) * w5t + t[3] * w4t + t[4] * w3t])

            stress = rot(stress)
            strain = rot(strain)

        # averaged-output accumulators (output.cxx:300-340)
        upd_avg = {}
        if param.sim.is_outputting_averaged_fields:
            interval = param.mesh.quality_check_step_interval
            reset = (steps % interval) == 1
            upd_avg = dict(
                stress_avg=torch.where(reset, stress,
                                       s.stress_avg + stress),
                delta_plstrain_avg=torch.where(
                    reset, delta_plstrain,
                    s.delta_plstrain_avg + delta_plstrain),
                coord_avg0=torch.where(reset, coord, s.coord_avg0),
                strain_avg0=torch.where(reset, strain, s.strain_avg0),
                time_avg0=torch.where(reset, time, s.time_avg0))

        return s.replace(
            coord=coord, vel=vel, temperature=temperature,
            dhacc=dhacc, edvacc_surf=edvacc_surf,
            volume=volume, volume_old=volume_old, volume_n=volume_n,
            mass=mass, tmass=tmass, hmass=hmass, ymass=ymass, force=force,
            stress=stress, strain=strain, strain_rate=strain_rate,
            plstrain=plstrain, delta_plstrain=delta_plstrain,
            viscosity=viscosity, dpressure=dpressure, edvoldt=edvoldt,
            time=time, dt=dt_out, steps=steps, max_global_vel_mag=vmax,
            global_dt_min=gdtmin, l2_residual=l2_res, **upd_avg)

    return step


def make_chunk_runner(param: Param, ctx, compensation_pressure: float,
                      n: int):
    """run(ctx, state) -> state after n grid3d steps: the state goes to
    planes once, steps n times in a Python loop and comes back, as the
    JAX package's grid chunk (simulation.py:1390-1405)."""
    step = make_grid_step(param, ctx, compensation_pressure)
    dims = tuple(ctx.sgrid)

    def run_chunk(sctx, state):
        g = state_to_grid(state, *dims)
        for _ in range(n):
            g = step(sctx, g)
        return grid_to_state(g, *dims)

    return run_chunk
