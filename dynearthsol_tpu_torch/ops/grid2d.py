"""Structured-grid 2D step on planes (counterpart of
dynearthsol_tpu/ops/grid2d.py).

The step of the raster triangle grid (mesh/generate.regular_grid_2d: node
id = i*nz + j, two triangles per cell whose diagonal alternates with the
cell parity) where the fused 2D steps' gates refuse it: in float64, with
averaged output, Neumann tractions or the elastic foundation, surface
process 102, or a grid that fails the resident or tiled layout
conditions.  It is the JAX package's ``make_grid_step``, operation for
operation and in the same order, in PyTorch:

  element scalar   -> (2, nxc, nzc) planes [tri-in-cell, cell-i, cell-j]
  element tensor   -> (3, 2, nxc, nzc)
  emw              -> (2, nxc, nzc, nmat)
  nodal fields     -> unchanged (nnode, ...)

Element-node transfers are shifted slices of the (nx, nz) node grid: a
gather is four views and a parity select, an assembly four in-place slice
additions, with no index scatter and no atomics.  The boundary tractions,
damping, velocity BCs and the surface processes (options 1 and 102) are
the nodal functions the column steps call.  A chunk runner converts the
state to planes once, steps n times and converts back.

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
from .matprops import MIN_STRAIN_RATE

E_SCALARS = ("volume", "volume_old", "stressyy", "old_mean_stress",
             "plstrain", "delta_plstrain", "viscosity", "dpressure",
             "edvoldt", "radiogenic_source", "dyn_fric_coeff",
             "state_variable", "delta_plstrain_avg")
E_TENSORS = ("stress", "strain", "strain_rate", "stress_avg", "strain_avg0")
NPE = 3


def state_to_grid(s, nx: int, nz: int):
    """The element fields of a State as planes."""
    nxc, nzc = nx - 1, nz - 1

    def e2p(a):   # (nelem,) -> (2, nxc, nzc)
        return a.reshape(nxc, nzc, 2).permute(2, 0, 1).contiguous()

    def t2p(a):   # (nelem, k) -> (k, 2, nxc, nzc)
        return a.reshape(nxc, nzc, 2, a.shape[1]) \
            .permute(3, 2, 0, 1).contiguous()

    upd = {f: e2p(getattr(s, f)) for f in E_SCALARS}
    upd.update({f: t2p(getattr(s, f)) for f in E_TENSORS})
    upd["emw"] = s.emw.reshape(nxc, nzc, 2, s.emw.shape[1]) \
        .permute(2, 0, 1, 3).contiguous()
    return s.replace(**upd)


def grid_to_state(g, nx: int, nz: int):
    """Inverse of state_to_grid."""
    nxc, nzc = nx - 1, nz - 1
    nelem = nxc * nzc * 2

    def p2e(p):
        return p.permute(1, 2, 0).reshape(nelem)

    def p2t(p):
        return p.permute(2, 3, 1, 0).reshape(nelem, p.shape[0])

    upd = {f: p2e(getattr(g, f)) for f in E_SCALARS}
    upd.update({f: p2t(getattr(g, f)) for f in E_TENSORS})
    upd["emw"] = g.emw.permute(1, 2, 0, 3).reshape(nelem, g.emw.shape[3])
    return g.replace(**upd)


def grid_step_applicable(param: Param, ctx) -> bool:
    """grid2d.grid_step_applicable (this package has no axisymmetric or
    sharded mode): the structured plane step covers the model's feature
    set."""
    ctrl = param.control
    rheol = param.mat.rheol_type
    return (ctx.sgrid is not None and len(ctx.sgrid) == 2
            and ctx.ndims == 2
            and not ctrl.has_hydraulic_diffusion
            and not ctrl.has_PT
            and rheol in (RH_ELASTIC, RH_VISCOUS, RH_MAXWELL, RH_EP, RH_EVP)
            and (rheol not in (RH_EP, RH_EVP) or param.mat.is_plane_strain))


def unported_features(param: Param, ctx) -> list:
    """What passes the gate above but this step does not compute: nothing
    (the simulation asks every step module)."""
    return []


def make_grid_step(param: Param, ctx, compensation_pressure: float = 0.0):
    """Build step(ctx, gstate) -> gstate on plane-layout State (2D
    structured), mirroring grid2d.make_grid_step."""
    ctrl = param.control
    mat = param.mat
    nx, nz = ctx.sgrid
    nxc, nzc = nx - 1, nz - 1
    nnode = nx * nz
    dev = ctx.conn.device
    dtype = torch.float64 if param.sim.float_dtype == "float64" \
        else torch.float32
    rheol = mat.rheol_type
    max_vbc_val = ctx.max_vbc_val
    pseudo_speed = max_vbc_val * ctrl.inertial_scaling
    surface = ctrl.surface_process_option != 0 and ctx.surf.etop > 0
    i = np.arange(nxc)[:, None]
    j = np.arange(nzc)[None, :]
    P = torch.as_tensor((i + j) % 2 == 0, device=dev)      # (nxc, nzc)
    # the z-cell row under the top nodes (both triangles touch one)
    toprow = torch.zeros((2, nxc, nzc), dtype=torch.bool, device=dev)
    toprow[:, :, -1] = True

    def const(v):
        return torch.tensor(float(v), dtype=dtype, device=dev)

    npe = const(NPE)
    two = const(2.0)
    five = const(5.0)
    big = const(torch.finfo(dtype).max)
    c_therm_diff_max = const(ctx.mat.therm_diff_max)
    c_max_vbc = const(max_vbc_val)
    c_pseudo = const(pseudo_speed)
    c_pseudo2 = const(pseudo_speed * pseudo_speed)
    c_swave_ref = const(math.sqrt(mat.bulk_modulus[mat.mattype_ref]
                                  / mat.rho0[mat.mattype_ref]))
    c_half_visc_min = const(0.5 * ctx.mat.visc_min)
    c_three = const(3.0)
    surface_T = const(param.bc.surface_temperature)
    sbc = ctx.sbc.on(dev)
    st = (SP.surf_tables(ctx.surf, ctx.nnode, dtype, dev) if surface
          else None)
    decay_lam = SP.LN2 / SP.PLSTRAIN_HALF_LIFE
    qcsi = param.mesh.quality_check_step_interval

    # ---- element<->node stencil transfers ----
    def gather(nodal):
        """(nnode,) -> 3 slot planes, each (2, nxc, nzc)."""
        g = nodal.reshape(nx, nz)
        c00 = g[:-1, :-1]
        c10 = g[1:, :-1]
        c01 = g[:-1, 1:]
        c11 = g[1:, 1:]
        s0 = torch.stack([c00, torch.where(P, c00, c10)])
        s1 = torch.stack([c10, c11])
        s2 = torch.stack([torch.where(P, c11, c01), c01])
        return s0, s1, s2

    def _scatter(a00, a10, a11, a01):
        out = torch.zeros((nx, nz), dtype=a00.dtype, device=dev)
        out[:-1, :-1] += a00
        out[1:, :-1] += a10
        out[1:, 1:] += a11
        out[:-1, 1:] += a01
        return out.reshape(nnode)

    def asm(c0, c1, c2):
        """Transpose of gather: 3 slot planes -> nodal sums (nnode,).
        Slot -> cell corner: tri0 s0->c00, s1->c10, s2->(P? c11 : c01);
        tri1 s0->(P? c00 : c10), s1->c11, s2->c01."""
        zero = torch.zeros((), dtype=c0.dtype, device=dev)
        return _scatter(c0[0] + torch.where(P, c0[1], zero),
                        c1[0] + torch.where(P, zero, c0[1]),
                        torch.where(P, c2[0], zero) + c1[1],
                        torch.where(P, zero, c2[0]) + c2[1])

    def asm_equal(v):
        """asm() when all 3 slots carry the same per-element value."""
        zero = torch.zeros((), dtype=v.dtype, device=dev)
        return _scatter(v[0] + torch.where(P, v[1], zero),
                        v[0] + torch.where(P, zero, v[1]),
                        torch.where(P, v[0], zero) + v[1],
                        torch.where(P, zero, v[0]) + v[1])

    def dot3(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    def shape_fn(xs, zs, vol):
        """P1 gradients from coordinate slot planes (fields.cxx:11-54)."""
        iv = 1.0 / (2.0 * vol)
        dndx = (iv * (zs[1] - zs[2]), iv * (zs[2] - zs[0]),
                iv * (zs[0] - zs[1]))
        dndz = (iv * (xs[2] - xs[1]), iv * (xs[0] - xs[2]),
                iv * (xs[1] - xs[0]))
        return dndx, dndz

    def volume_of(xs, zs):
        """Triangle area from slot planes (geometry.cxx:135-200)."""
        return 0.5 * ((xs[1] - xs[0]) * (zs[2] - zs[0])
                      - (zs[1] - zs[0]) * (xs[2] - xs[0]))

    def min_height(xs, zs, vol):
        """2 * A / longest edge (geometry.cxx:830-852)."""
        d01 = (xs[0] - xs[1]) ** 2 + (zs[0] - zs[1]) ** 2
        d12 = (xs[1] - xs[2]) ** 2 + (zs[1] - zs[2]) ** 2
        d02 = (xs[0] - xs[2]) ** 2 + (zs[0] - zs[2]) ** 2
        dmax = torch.maximum(torch.maximum(d01, d12), d02)
        return 2.0 * vol / torch.sqrt(dmax)

    def compute_dt_planes(xs, zs, vol, vxs, vzs, shearm, rho_e):
        """CFL dt (geometry.cxx:756-923) on planes."""
        vx_m = (vxs[0] + vxs[1] + vxs[2]) / npe
        vz_m = (vzs[0] + vzs[1] + vzs[2]) / npe
        vmag = torch.sqrt(vx_m * vx_m + vz_m * vz_m)
        vmax = torch.maximum(vmag.max(), c_max_vbc)
        if ctrl.fixed_dt != 0.0:
            fdt = const(ctrl.fixed_dt)
            return fdt, vmax, fdt
        minh = min_height(xs, zs, vol)
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
        # the hydraulic limit is big (the gate excludes the diffusion)
        dt = torch.minimum(torch.minimum(torch.minimum(dt_elastic,
                                                       dt_maxwell),
                                         torch.minimum(dt_advection,
                                                       dt_diffusion)),
                           big) * ctrl.dt_fraction
        return dt, vmax, gdtmin

    def update_stress_planes(tab, s, de, edot, srp, bulkm, shearm, temp_e,
                             dt):
        """Constitutive switch on planes (rheology.cxx:676-991)."""
        stress = (s.stress[0], s.stress[1], s.stress[2])
        old_tr = stress[0] + stress[1]
        stressyy = s.stressyy
        plstrain, delta_plstrain = s.plstrain, s.delta_plstrain
        viscosity = s.viscosity

        def creep_visc():
            s0 = (stress[0] + stress[1]) / two
            rII2 = (0.25 * (srp[0] - srp[1]) ** 2 + srp[2] ** 2)
            ed = torch.clamp(torch.sqrt(rII2), min=MIN_STRAIN_RATE)
            return M.visc_core(tab, s.emw, temp_e, s0, ed)

        if rheol == RH_ELASTIC:
            stress = R.elastic2_c(bulkm, shearm, de, stress)
        elif rheol == RH_VISCOUS:
            viscosity = creep_visc()
            strain_new = (s.strain[0] + de[0], s.strain[1] + de[1],
                          s.strain[2] + de[2])
            total_dv = strain_new[0] + strain_new[1]
            stress = R.viscous2_c(bulkm, viscosity, total_dv, edot)
        elif rheol == RH_MAXWELL:
            viscosity = creep_visc()
            dv = s.volume / s.volume_old - 1.0
            stress = R.maxwell2_c(bulkm, shearm, viscosity, dt, dv, de,
                                  stress)
        elif rheol == RH_EP:
            stress, stressyy, depls, _ = R.elasto_plastic2d_c(
                bulkm, shearm, *M.plastic_props(tab, s.emw, s.plstrain),
                de, stress, s.stressyy)
            plstrain = s.plstrain + depls
            delta_plstrain = depls
        elif rheol == RH_EVP:
            viscosity = creep_visc()
            dv = s.volume / s.volume_old - 1.0
            sv = R.maxwell2_c(bulkm, shearm, viscosity, dt, dv, de, stress)
            svII = 0.25 * (sv[0] - sv[1]) ** 2 + sv[2] ** 2
            sp, spyy, depls, _ = R.elasto_plastic2d_c(
                bulkm, shearm, *M.plastic_props(tab, s.emw, s.plstrain),
                de, stress, s.stressyy)
            spII = 0.25 * (sp[0] - sp[1]) ** 2 + sp[2] ** 2
            use_v = svII < spII
            stress = tuple(torch.where(use_v, a, b) for a, b in zip(sv, sp))
            stressyy = torch.where(use_v, s.stressyy, spyy)
            plstrain = torch.where(use_v, s.plstrain, s.plstrain + depls)
            delta_plstrain = torch.where(use_v, s.delta_plstrain, depls)
        else:  # pragma: no cover - gated by grid_step_applicable
            raise ValueError(f"grid2d: unsupported rheology {rheol}")
        if ctrl.is_using_mixed_stress:
            dpressure = stress[0] + stress[1] - old_tr
        else:
            dpressure = s.dpressure
        return (stress, stressyy, plstrain, delta_plstrain, viscosity,
                dpressure)

    def step(ctx, s):
        tab = ctx.mat
        dt = s.dt
        steps = s.steps + 1
        time = s.time + s.dt

        # corner slot planes (one stencil gather per nodal field)
        xs = gather(s.coord[:, 0])
        zs = gather(s.coord[:, 1])
        vxs = gather(s.vel[:, 0])
        vzs = gather(s.vel[:, 1])
        ts = gather(s.temperature)

        vol = s.volume
        dndx, dndz = shape_fn(xs, zs, vol)
        temp_e = (ts[0] + ts[1] + ts[2]) / npe
        bulkm = M.bulkm(tab, s.emw)
        shearm = M.shearm(tab, s.emw)
        rho_e = M.rho_from_T(tab, s.emw, temp_e)

        temperature = s.temperature
        if ctrl.has_thermal_diffusion:
            kappa = M.therm_cond(tab, s.emw)
            source = s.radiogenic_source * vol * rho_e / npe
            kv = kappa * vol
            gtx, gtz = dot3(dndx, ts), dot3(dndz, ts)
            tdot = asm(*(kv * (dndx[c] * gtx + dndz[c] * gtz) - source
                         for c in range(NPE)))
            temperature = torch.where(
                ctx.top_mask, surface_T,
                s.temperature - s.dt * tdot / s.tmass)

        # strain rate (fields.cxx:408-483)
        lxx = dot3(vxs, dndx)
        lzz = dot3(vzs, dndz)
        lxz = 0.5 * (vxs[0] * dndz[0] + vxs[1] * dndz[1] + vxs[2] * dndz[2]
                     + vzs[0] * dndx[0] + vzs[1] * dndx[1]
                     + vzs[2] * dndx[2])
        sr = (lxx, lzz, lxz)

        # anti-mesh-locking dvoldt/edvoldt (geometry.cxx:202-276)
        etmp = (lxx + lzz) * vol
        dvoldt = asm_equal(etmp) / s.volume_n
        dvs = gather(dvoldt)
        edvoldt = (dvs[0] + dvs[1] + dvs[2]) / npe

        # strain-rate anti-locking fix (rheology.cxx:755-763)
        adj = (edvoldt - (lxx + lzz)) / two
        edot = (lxx + adj, lzz + adj, lxz)
        de = (edot[0] * dt, edot[1] * dt, edot[2] * dt)
        strain = torch.stack([s.strain[0] + de[0], s.strain[1] + de[1],
                              s.strain[2] + de[2]])
        strain_rate = torch.stack(edot)

        (stress_c, stressyy, plstrain, delta_plstrain, viscosity,
         dpressure) = update_stress_planes(
            tab, s.replace(edvoldt=edvoldt), de, edot, sr, bulkm, shearm,
            temp_e, dt)

        if ctrl.is_using_mixed_stress:
            # NMD pressure smoothing (geometry.cxx:279-331)
            dp_nd = asm_equal(dpressure * vol) / s.volume_n
            dps = gather(dp_nd)
            ddp = ((dps[0] + dps[1] + dps[2]) / npe - dpressure) / two
            stress_c = (stress_c[0] + ddp, stress_c[1] + ddp, stress_c[2])
        stress = torch.stack(stress_c)

        # force assembly (fields.cxx:612-703)
        phi_e = M.phi_porosity(tab, s.emw)
        if ctrl.gravity != 0:
            buoy = (rho_e * (1.0 - phi_e) + 1000.0 * phi_e) \
                * ctrl.gravity / npe
        else:
            buoy = torch.zeros_like(vol)
        fx = tuple((stress_c[0] * dndx[c] + stress_c[2] * dndz[c]) * vol
                   for c in range(NPE))
        fz = tuple((stress_c[2] * dndx[c] + stress_c[1] * dndz[c] + buoy)
                   * vol for c in range(NPE))
        force = torch.stack([-asm(*fx), -asm(*fz)], dim=1)
        l2_res = F.residual_l2(force)

        if ctrl.gravity != 0:
            # the facet tractions read element densities in element order
            rho_flat = rho_e.permute(1, 2, 0).reshape(-1)
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
        vzs2 = gather(vel[:, 1])
        dhacc, edvacc_surf = s.dhacc, s.edvacc_surf
        if ctrl.has_moving_mesh:
            coord = F.update_coordinate(s.coord, vel, s.dt)
            if surface:
                # in-step surface processes (bc.cxx:1667-1831); the top
                # row moved, so the coordinates are gathered again
                coord, dhacc, edvacc_surf, _ = SP.apply_surface_processes(
                    param, st, coord, s.dt, dhacc, edvacc_surf)
                xs2 = gather(coord[:, 0])
                zs2 = gather(coord[:, 1])
            else:
                xs2 = tuple(xs[i] + vxs2[i] * s.dt for i in range(NPE))
                zs2 = tuple(zs[i] + vzs2[i] * s.dt for i in range(NPE))
            volume_old = vol
            volume = volume_of(xs2, zs2)
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
                # surface_plstrain_diffusion (bc.cxx:1591-1611, 2D only):
                # exponential decay at the quality-check cadence, skipped
                # for oceanic-crust-dominated elements
                dominant = torch.argmax(s.emw, dim=-1)
                dec = torch.where(
                    toprow & (dominant != mat.mattype_oceanic_crust)
                    & (steps % qcsi == 0),
                    plstrain * decay_lam * s.dt, torch.zeros_like(plstrain))
                plstrain = plstrain - dec
        else:
            coord, volume_old, volume = s.coord, s.volume_old, vol
            xs2, zs2 = xs, zs

        # CFL dt, refreshed every 10 steps (dynearthsol.cxx:861-871)
        dt_new, vmax, gdtmin = compute_dt_planes(
            xs2, zs2, volume, vxs2, vzs2, shearm, rho_e)
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
            bulk_comp = 1.0 / (bulkm + shearm / c_three)
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
            dndx2, dndz2 = shape_fn(xs2, zs2, volume)
            w2 = 0.5 * (dot3(vzs2, dndx2) - dot3(vxs2, dndz2))
            wdt = w2 * s.dt

            def rot(t):
                return torch.stack([t[0] - 2.0 * t[2] * wdt,
                                    t[1] + 2.0 * t[2] * wdt,
                                    t[2] + (t[0] - t[1]) * wdt])

            stress = rot(stress)
            strain = rot(strain)

        # averaged-output accumulators (output.cxx:300-340)
        upd_avg = {}
        if param.sim.is_outputting_averaged_fields:
            reset = (steps % qcsi) == 1
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
            stress=stress, stressyy=stressyy, strain=strain,
            strain_rate=strain_rate, plstrain=plstrain,
            delta_plstrain=delta_plstrain, viscosity=viscosity,
            dpressure=dpressure, edvoldt=edvoldt, time=time, dt=dt_out,
            steps=steps, max_global_vel_mag=vmax, global_dt_min=gdtmin,
            l2_residual=l2_res, **upd_avg)

    return step


def make_chunk_runner(param: Param, ctx, compensation_pressure: float,
                      n: int):
    """run(ctx, state) -> state after n grid2d steps: the state goes to
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
