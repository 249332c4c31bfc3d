"""Connectivity-driven 3D step in column layout (counterpart of
dynearthsol_tpu/ops/flat3d.py).

The 3D sibling of ops/flat2d.py, on any tetrahedral mesh: the step of
unstructured meshes (every 3D run after a remesh, a run on
``meshing_elem_shape 0`` or on the reference's own mesh) and of structured
meshes whose feature set falls off the fused 3D step's gate (hydraulic
diffusion, rate-and-state friction, the pseudo-transient loop).  Reference
kernel order: dynearthsol.cxx:746-956.

The step is the JAX package's ``make_flat_step`` of flat3d, operation for
operation and in the same order, on flat columns:

  element scalar   -> (nelem,)
  element tensor   -> (6, nelem), components (xx, yy, zz, xy, xz, yz)
  corner values    -> ``cgather`` of a packed nodal array, read back as
                      (nelem,) columns per field and corner
  assembly         -> ``asm_pack`` / ``asm_gather`` of packed corner
                      columns, each node's sum in node_sum's order

The gathers and assemblies go through the three kernels of ops/band2d.py
at npe = 4 (csrc/band2d.cu on the card, their plain versions on the CPU):
per step the packed gather (8 fields, or 10 with hydraulic diffusion in
two calls of 8 and 2, since a call takes at most ``band2d.KMAX``), the
thermal + dvoldt assembly with its re-gather, the mixed-stress hop, the
force assembly, the post-move gather and the mass assembly; with the
pseudo-transient loop one more gather per step and per iteration two
gathers, an assembly with its re-gather and two assemblies.  Everything
between them is plain PyTorch column arithmetic; a divisor that is a
Python number is made a 0-d tensor first (on the card PyTorch divides by a
Python number as a product with its reciprocal).

Scalars stay 0-d tensors on the device; a chunk runs with no host round
trip but for the pseudo-transient loop, whose condition is read on the
host once per iteration after the first (``step.stats``).  In its generic
mode the step is the JAX package's generic step in 3D; its pieces
(``step.pieces``) make the isostasy and body-force pre-relaxations in 3D.
"""

from __future__ import annotations

import math
from dataclasses import replace
from types import SimpleNamespace

import torch

from .. import bc as bc_mod
from ..config import (RH_ELASTIC, RH_EP, RH_EP_RSF, RH_EVP, RH_EVP_RSF,
                      RH_MAXWELL, RH_VISCOUS, Param)
from . import band2d
from . import fields as F
from . import matprops as M
from . import rheology as R
from . import surface as SP
from .assembly import node_sum
from .flat2d import flat_to_state, state_to_flat
from .matprops import MIN_STRAIN_RATE

NPE = 4


def flat3d_step_applicable(param: Param, ctx) -> bool:
    """Static gate (flat3d.flat3d_step_applicable; this package has no
    sharded step).  It applies to structured meshes too: the dispatcher
    checks the fused path first."""
    return (ctx.ndims == 3
            and param.mat.rheol_type in (RH_ELASTIC, RH_VISCOUS,
                                         RH_MAXWELL, RH_EP, RH_EVP,
                                         RH_EP_RSF, RH_EVP_RSF))


def generic_applicable(param: Param, ctx) -> bool:
    """Whether this module computes the JAX package's generic step for the
    config: in 3D, every rheology of the flat gate.  The JAX package
    reaches its generic step in 3D only under ``DES_NO_FLAT``;
    ``make_flat_step(..., generic=True)`` computes it as the column step
    with the generic step's own choices where the two differ, as
    ops/flat2d.py does in 2D (the pseudo-mass's velocity scale, the
    fluid-filled density of the hydraulic mass and facet loads, and the
    pore-pressure update after the force assembly).  The 3D generic step
    has no principal-axes branch and no surface plastic-strain decay."""
    return flat3d_step_applicable(param, ctx)


def unported_features(param: Param, ctx) -> list:
    """What passes the gate above but this step does not compute: nothing
    (the simulation asks every step module)."""
    return []


def make_flat_step(param: Param, ctx, compensation_pressure: float = 0.0,
                   plain: bool = False, generic: bool = False):
    """Build step(ctx, fstate) -> fstate on flat column state (3D, any
    tetrahedral mesh), mirroring flat3d.make_flat_step, or with
    ``generic`` the JAX package's generic step (simulation.make_step_fn)
    in 3D where the two differ (see ``generic_applicable``).  ``plain``
    runs the plain versions of the gathers and assemblies on the state's
    device instead of the wrappers (the reference the CUDA kernels are
    checked against on the card).  ``step.stats`` counts the
    pseudo-transient loop's iterations and host reads; ``step.pieces``
    holds the step's pieces, as in ops/flat2d.py."""
    ctrl = param.control
    mat = param.mat
    if ctx.band is None:
        raise ValueError("the flat step needs the gather tables "
                         "(band2d.build_tables) in ctx.band")
    bt = ctx.band
    dev = bt.conn_cm.device
    dtype = torch.float64 if param.sim.float_dtype == "float64" \
        else torch.float32
    max_vbc_val = ctx.max_vbc_val
    rheol = mat.rheol_type
    is_rsf = rheol in (RH_EP_RSF, RH_EVP_RSF)
    rheol_ep = rheol in (RH_EP, RH_EP_RSF)
    rheol_evp = rheol in (RH_EVP, RH_EVP_RSF)
    hydraulic = ctrl.has_hydraulic_diffusion
    # the pore-pressure rate rides the force assembly (flat3d); the
    # generic step and the pseudo-transient loop recompute it after
    pp_in_force = hydraulic and not (generic or ctrl.has_PT)
    surface = ctrl.surface_process_option != 0 and ctx.surf.etop > 0
    pseudo_speed = max_vbc_val * ctrl.inertial_scaling

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
    top_elem = torch.as_tensor(ctx.surf.top_elem_mask, device=dev)
    surface_T = const(param.bc.surface_temperature)
    sbc = ctx.sbc.on(dev)
    st = (SP.surf_tables(ctx.surf, ctx.nnode, dtype, dev) if surface
          else None)
    gamma_w = 1000.0 * ctrl.gravity     # fields.cxx:330 hard-codes water
    c_gamma_w = const(gamma_w)
    # the pseudo-transient loop relaxes with zeroed vbc values
    # (PT_jump, bc.cxx:305-317)
    vbc0 = replace(ctx.vbc, values=(0.0,) * 6, values_lateral=(0.0,) * 4)
    pt_tol = float(torch.tensor(ctrl.PT_relative_tolerance, dtype=dtype))
    stats = {"pt_iterations": 0, "host_syncs": 0}

    eng_gather, eng_scatter, eng_scatter_gather = (
        (band2d.gather_corners, band2d.scatter_corners,
         band2d.scatter_gather_corners) if plain
        else (band2d.cgather, band2d.asm_pack, band2d.asm_gather))

    def cgather(cols):
        """Nodal columns [(nnode, w), ...] -> (k, 4, nelem) [field][corner]
        element columns, in calls of at most band2d.KMAX fields."""
        pack = torch.cat(cols, dim=1)
        k = pack.shape[1]
        if k <= band2d.KMAX:
            return eng_gather(pack.contiguous(), bt)
        return torch.cat([eng_gather(pack[:, j:j + band2d.KMAX]
                                     .contiguous(), bt)
                          for j in range(0, k, band2d.KMAX)])

    def _pack(slot_cols):
        """[corner][field] columns -> the (k, 4, nelem) element pack."""
        k = len(slot_cols[0])
        return torch.stack([slot_cols[c][j] for j in range(k)
                            for c in range(NPE)]).view(k, NPE, bt.nelem)

    def asm_pack(slot_cols):
        """[corner][field] columns -> (nnode, k) sums, node_sum order."""
        return eng_scatter(_pack(slot_cols), bt)

    def asm_gather(slot_cols, kg):
        """Assembly + corner re-gather of the first ``kg`` nodal sums:
        ((nnode, k) sums, (kg, 4, nelem) columns): the transfer hops
        (dvoldt, NMD pressure smoothing)."""
        return eng_scatter_gather(_pack(slot_cols), bt, kg)

    def corner_sum(cols):
        return cols[0] + cols[1] + cols[2] + cols[3]

    def dot4(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3]

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

    def volume_of(xs, ys, zs):
        d1 = (xs[1] - xs[0], ys[1] - ys[0], zs[1] - zs[0])
        d2 = (xs[2] - xs[0], ys[2] - ys[0], zs[2] - zs[0])
        d3 = (xs[3] - xs[0], ys[3] - ys[0], zs[3] - zs[0])
        return (d1[0] * (d2[1] * d3[2] - d2[2] * d3[1])
                + d1[1] * (d2[2] * d3[0] - d2[0] * d3[2])
                + d1[2] * (d2[0] * d3[1] - d2[1] * d3[0])) / six

    def min_height(xs, ys, zs, vol):
        """3 * V / largest facet area (geometry.cxx:830-852)."""
        def tri_area(i, j, k):
            ux, uy, uz = xs[j] - xs[i], ys[j] - ys[i], zs[j] - zs[i]
            vx, vy, vz = xs[k] - xs[i], ys[k] - ys[i], zs[k] - zs[i]
            cx = uy * vz - uz * vy
            cy = uz * vx - ux * vz
            cz = ux * vy - uy * vx
            return 0.5 * torch.sqrt(cx * cx + cy * cy + cz * cz)

        maxa = torch.maximum(
            torch.maximum(tri_area(0, 1, 2), tri_area(0, 1, 3)),
            torch.maximum(tri_area(2, 3, 0), tri_area(2, 3, 1)))
        return 3.0 * vol / maxa

    def strain_rate_cols(vxs, vys, vzs, dndx, dndy, dndz):
        """(lxx, lyy, lzz, lxy, lxz, lyz) of fields.cxx:408-483."""
        return (dot4(vxs, dndx), dot4(vys, dndy), dot4(vzs, dndz),
                0.5 * (dot4(vxs, dndy) + dot4(vys, dndx)),
                0.5 * (dot4(vxs, dndz) + dot4(vzs, dndx)),
                0.5 * (dot4(vys, dndz) + dot4(vzs, dndy)))

    def force_cols(sc, dndx, dndy, dndz, buoy, vol):
        """Each corner's internal-force contribution (fields.cxx:612-703)."""
        return [((sc[0] * dndx[c] + sc[3] * dndy[c] + sc[4] * dndz[c])
                 * vol,
                 (sc[3] * dndx[c] + sc[1] * dndy[c] + sc[5] * dndz[c])
                 * vol,
                 (sc[4] * dndx[c] + sc[5] * dndy[c] + sc[2] * dndz[c]
                  + buoy) * vol) for c in range(NPE)]

    def mass_cols(volume, bulkm, shearm, rho_e, phi_e, tab, emw,
                  max_global_vel_mag, fluid_density=False):
        """Each element's (volume, mass, tmass, hmass, ymass) shares
        (geometry.cxx:1020-1154; bulk_comp = 1 / K in 3D,
        geometry.cxx:1098); ``fluid_density``: a dynamic run's mass is
        that of the fluid-filled rock (the generic step's, with hydraulic
        diffusion)."""
        if ctrl.use_global_velocity_scaling:
            apparent = torch.minimum(max_global_vel_mag
                                     * ctrl.inertial_scaling,
                                     torch.sqrt(shearm / rho_e))
            rho_q = bulkm / (apparent * apparent)
        else:
            rho_q = bulkm / c_pseudo2
        rho_m = rho_q if ctrl.is_quasi_static else rho_e
        if fluid_density and not ctrl.is_quasi_static:
            rho_m = rho_e * (1.0 - phi_e) + 1000.0 * phi_e
        bulk_comp = 1.0 / bulkm
        ab_e = M.alpha_biot(tab, emw)
        bf_e = M.beta_fluid(tab, emw)
        cp_e = M.cp(tab, emw)
        hm_coeff = ab_e + phi_e - ab_e * phi_e
        m = rho_m * volume / npe
        tm = rho_e * cp_e * volume / npe
        hm = (hm_coeff * bulk_comp + phi_e * bf_e) * volume / npe
        ym = 9.0 * bulkm * shearm / (3.0 * bulkm + shearm) / npe
        return [(volume, m, tm, hm, ym)] * NPE

    def compute_dt_cols(xs, ys, zs, vol, vxs, vys, vzs, shearm, rho_e,
                        hydro_diff_max):
        """CFL dt (geometry.cxx:756-923); mirrors flat3d.compute_dt_cols,
        with the hydraulic diffusion limit when enabled."""
        vx_m = corner_sum(vxs) / npe
        vy_m = corner_sum(vys) / npe
        vz_m = corner_sum(vzs) / npe
        vmag = torch.sqrt(vx_m * vx_m + vy_m * vy_m + vz_m * vz_m)
        vmax = torch.maximum(vmag.max(), c_max_vbc)
        if ctrl.fixed_dt != 0.0:
            fdt = const(ctrl.fixed_dt)
            return fdt, vmax, fdt
        minh = min_height(xs, ys, zs, vol)
        minl = minh.min()
        dt_maxwell = (c_half_visc_min / (1e-40 + shearm)).min()
        dt_diffusion = (0.5 * minh * minh / c_therm_diff_max).min() \
            if ctrl.has_thermal_diffusion else big
        if hydraulic:
            dt_hydro = torch.where(hydro_diff_max > 0,
                                   (0.5 * minh * minh).min()
                                   / hydro_diff_max, big)
        else:
            dt_hydro = big
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
        dt = torch.minimum(
            torch.minimum(torch.minimum(dt_elastic, dt_maxwell),
                          torch.minimum(dt_advection, dt_diffusion)),
            dt_hydro)
        return dt * ctrl.dt_fraction, vmax, gdtmin

    def inv2(t):
        a = (t[0] + t[1] + t[2]) / three
        return (0.5 * ((t[0] - a) * (t[0] - a) + (t[1] - a) * (t[1] - a)
                       + (t[2] - a) * (t[2] - a))
                + t[3] * t[3] + t[4] * t[4] + t[5] * t[5])

    def update_stress_cols(tab, s, de, edot, sr, bulkm, shearm, temp_e, dt,
                           dpp=None, vmean=None):
        """Constitutive switch (rheology.cxx:676-991) on columns; mirrors
        flat3d.update_stress_cols: the Biot effective-stress increment
        ``dpp`` (rheology.cxx:696-755) and the rate-and-state variants
        (rheology.cxx:151-194, matprops.cxx:532-552), with ``vmean`` the
        element-mean pre-update velocity columns."""
        stress = tuple(s.stress[i] for i in range(6))
        old_tr = stress[0] + stress[1] + stress[2]
        plstrain, delta_plstrain = s.plstrain, s.delta_plstrain
        viscosity = s.viscosity
        dyn_fric_coeff = s.dyn_fric_coeff
        state_variable = s.state_variable

        if is_rsf:
            slip = R.slip_rate3_c(stress, vmean)
            (amc_r, anphi_r, anpsi_r, hardn_r, ten_max_r,
             dyn_fric_coeff, state_variable) = M.plastic_props_rsf(
                tab, s.emw, s.plstrain, slip, s.state_variable, dt,
                mat.state_var_model)

        def creep_visc():
            s0 = (stress[0] + stress[1] + stress[2]) / three
            ed = torch.clamp(torch.sqrt(inv2(sr)), min=MIN_STRAIN_RATE)
            return M.visc_core(tab, s.emw, temp_e, s0, ed)

        def mc_props():
            if is_rsf:
                return amc_r, anphi_r, anpsi_r, hardn_r, ten_max_r
            return M.plastic_props(tab, s.emw, s.plstrain)

        if rheol == RH_ELASTIC:
            stress = R.elastic3_c(bulkm, shearm, de, stress, dpp)
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
        elif rheol_ep:
            stress, depls, _ = R.elasto_plastic3_c(
                bulkm, shearm, *mc_props(), de, stress, dpp)
            plstrain = s.plstrain + depls
            delta_plstrain = depls
        elif rheol_evp:
            viscosity = creep_visc()
            dv = s.volume / s.volume_old - 1.0
            sv = R.maxwell3_c(bulkm, shearm, viscosity, dt, dv, de, stress)
            sp, depls, _ = R.elasto_plastic3_c(
                bulkm, shearm, *mc_props(), de, stress, dpp)
            # min-magnitude selection (rheology.cxx:869-879)
            use_v = inv2(sv) < inv2(sp)
            stress = tuple(torch.where(use_v, a, b) for a, b in zip(sv, sp))
            plstrain = torch.where(use_v, s.plstrain, s.plstrain + depls)
            delta_plstrain = torch.where(use_v, s.delta_plstrain, depls)
        else:  # pragma: no cover - gated
            raise ValueError(f"flat3d: unsupported rheology {rheol}")
        if ctrl.is_using_mixed_stress:
            dpressure = stress[0] + stress[1] + stress[2] - old_tr
        else:
            dpressure = s.dpressure
        return (stress, plstrain, delta_plstrain, viscosity, dpressure,
                dyn_fric_coeff, state_variable)

    def boundary_forces(force, coord, coord0, rho_e, phi_e,
                        fluid=generic and hydraulic, neumann=True):
        """Facet tractions and the elastic foundation (only with gravity),
        then the Neumann tractions (flat3d.py:469-473).  The generic step
        loads them with the fluid-filled rock's density under hydraulic
        diffusion (simulation.py:323-326): ``fluid``.  The isostasy
        pre-relaxation adds no Neumann tractions."""
        if ctrl.gravity != 0:
            rho_eff = rho_e
            if fluid:
                rho_eff = rho_e * (1.0 - phi_e) + 1000.0 * phi_e
            force = bc_mod.apply_stress_bcs(param, sbc, coord, force,
                                            rho_eff, compensation_pressure,
                                            coord0)
        if neumann:
            force = bc_mod.apply_stress_bcs_neumann(sbc, coord, force)
        return force

    def _anti_lock(sr, edv):
        """The strain rate with the anti-mesh-locking volumetric part
        (rheology.cxx:755-763)."""
        adj = (edv - (sr[0] + sr[1] + sr[2])) / three
        return (sr[0] + adj, sr[1] + adj, sr[2] + adj) + tuple(sr[3:])

    def corners(g, j0):
        """The three coordinate-like fields from field j0 of a gathered
        pack, as [component][corner] columns."""
        return [tuple(g[j0 + d, c] for c in range(NPE)) for d in range(3)]

    def pt_loop(ctx, s, sc, l2_res, time, bulkm, shearm, rho_e, phi_e,
                buoy, temp_e_pt, fluid=generic and hydraulic):
        """The pseudo-transient inner relaxation (dynearthsol.cxx:779-840)
        in columns: the step's kernel sequence with zeroed vbc values,
        surface processes skipped, hydraulic diffusion suspended and no
        NMD smoothing (the reference iteration is update_stress ->
        update_force only, :787-800), until the residual's relative change
        drops below PT_relative_tolerance or PT_max_iter iterations have
        run.  It is also the body-force pre-relaxation's loop
        (dynearthsol.cxx:526-571), which loads the facets with the rock's
        own density (``fluid`` False)."""
        tab = ctx.mat
        res_old = l2_res
        rel = None      # 1.0 before the first iteration, known here
        k = 0
        while k < ctrl.PT_max_iter:
            if rel is None:
                if not 1.0 >= pt_tol:
                    break
            else:
                stats["host_syncs"] += 1
                if not bool(rel >= ctrl.PT_relative_tolerance):
                    break
            velp = bc_mod.apply_vbcs(vbc0, sc.vel, sc.coord, time)
            if ctrl.has_moving_mesh:
                coordp = F.update_coordinate(sc.coord, velp, sc.dt)
                volp_old = sc.volume
            else:
                coordp = sc.coord
            gp = cgather([coordp, velp])
            (xsp, ysp, zsp), (vxp, vyp, vzp) = corners(gp, 0), \
                corners(gp, 3)
            if ctrl.has_moving_mesh:
                volp = volume_of(xsp, ysp, zsp)
                mpk = asm_pack(mass_cols(volp, bulkm, shearm, rho_e, phi_e,
                                         tab, s.emw, sc.max_global_vel_mag))
                sc = sc.replace(
                    coord=coordp, volume=volp, volume_old=volp_old,
                    volume_n=mpk[:, 0], mass=mpk[:, 1], tmass=mpk[:, 2],
                    hmass=mpk[:, 3], ymass=mpk[:, 4])
            else:
                volp = sc.volume
            vnp = cgather([sc.volume_n[:, None]])
            dndxp, dndyp, dndzp = shape_fn(xsp, ysp, zsp, volp)
            srp = strain_rate_cols(vxp, vyp, vzp, dndxp, dndyp, dndzp)
            divp = srp[0] + srp[1] + srp[2]
            _, gdvp = asm_gather([(divp * volp,)] * NPE, kg=1)
            edvp = corner_sum([gdvp[0, c] / vnp[0, c]
                               for c in range(NPE)]) / npe
            edotp = _anti_lock(srp, edvp)
            dep = tuple(edotp[i] * sc.dt for i in range(6))
            strainp = torch.stack([sc.strain[i] + dep[i]
                                   for i in range(6)])
            vmeanp = ((corner_sum(vxp) / npe, corner_sum(vyp) / npe,
                       corner_sum(vzp) / npe) if is_rsf else None)
            sc1 = sc.replace(vel=velp, edvoldt=edvp)
            (stp, plsp, dplsp, viscp, dprp, dfcp, svp) = update_stress_cols(
                tab, sc1, dep, edotp, srp, bulkm, shearm, temp_e_pt, sc.dt,
                None, vmeanp)
            forcep = -asm_pack(force_cols(stp, dndxp, dndyp, dndzp, buoy,
                                          volp))
            resp = F.residual_l2(forcep)
            forcep = boundary_forces(forcep, sc.coord, sc.coord0, rho_e,
                                     phi_e, fluid)
            forcep = F.apply_damping(forcep, velp, sc.mass, sc.ymass,
                                     ctrl.damping_option,
                                     ctrl.damping_factor)
            velq = F.update_velocity(velp, forcep, sc.mass, sc.dt)
            rel = torch.abs((resp - res_old)
                            / torch.where(res_old != 0, res_old,
                                          torch.ones_like(res_old)))
            res_old = resp
            sc = sc1.replace(
                vel=velq, force=forcep, stress=torch.stack(stp),
                strain=strainp, strain_rate=torch.stack(edotp),
                plstrain=plsp, delta_plstrain=dplsp, viscosity=viscp,
                dpressure=dprp, l2_residual=resp, dyn_fric_coeff=dfcp,
                state_variable=svp)
            k += 1
        stats["pt_iterations"] += k
        return sc

    def step(ctx, s):
        tab = ctx.mat
        dt = s.dt
        steps = s.steps + 1
        time = s.time + s.dt

        # the packed corner gather (coord, vel, T [, pp, dpp], volume_n);
        # volume_n rides along so that the dvoldt/NMD transfer hops can
        # divide their re-gathered nodal sums per corner
        cols = [s.coord, s.vel, s.temperature[:, None]]
        if hydraulic:
            cols += [s.ppressure[:, None], s.dppressure[:, None]]
        cols.append(s.volume_n[:, None])
        slots = cgather(cols)                    # [field][corner]
        (xs, ys, zs), (vxs, vys, vzs) = corners(slots, 0), corners(slots, 3)
        ts = tuple(slots[6, c] for c in range(NPE))
        vns = tuple(slots[-1, c] for c in range(NPE))

        vol = s.volume
        dndx, dndy, dndz = shape_fn(xs, ys, zs, vol)
        temp_e = corner_sum(ts) / npe
        bulkm = M.bulkm(tab, s.emw)
        shearm = M.shearm(tab, s.emw)
        rho_e = M.rho_from_T(tab, s.emw, temp_e)

        sr = strain_rate_cols(vxs, vys, vzs, dndx, dndy, dndz)
        div = sr[0] + sr[1] + sr[2]

        # thermal diffusion + dvoldt share ONE assembly (k = 2 or 1)
        etmp = div * vol
        if ctrl.has_thermal_diffusion:
            kappa = M.therm_cond(tab, s.emw)
            source = s.radiogenic_source * vol * rho_e / npe
            kv = kappa * vol
            gx, gy, gz = dot4(dndx, ts), dot4(dndy, ts), dot4(dndz, ts)
            both, gdv = asm_gather([
                (etmp, kv * (dndx[c] * gx + dndy[c] * gy + dndz[c] * gz)
                 - source) for c in range(NPE)], kg=1)
            tdot = both[:, 1]
            temperature = torch.where(
                ctx.top_mask, surface_T,
                s.temperature - s.dt * tdot / s.tmass)
        else:
            _, gdv = asm_gather([(etmp,)] * NPE, kg=1)
            temperature = s.temperature

        # the transfer hop: dividing by corner volume_n equals gathering
        # dv_sum / volume_n bit for bit
        edvoldt = corner_sum([gdv[0, c] / vns[c] for c in range(NPE)]) / npe

        edot = _anti_lock(sr, edvoldt)
        de = tuple(edot[i] * dt for i in range(6))
        strain = torch.stack([s.strain[i] + de[i] for i in range(6)])
        strain_rate = torch.stack(edot)

        # Biot effective-stress increment + pre-update mean stress
        old_mean_stress = s.old_mean_stress
        dpp = None
        if hydraulic:
            old_mean_stress = (s.stress[0] + s.stress[1] + s.stress[2]) \
                / three
            alpha_b = M.alpha_biot(tab, s.emw)
            dpp = alpha_b * corner_sum([slots[8, c] for c in range(NPE)]) \
                / npe
        vmean = ((corner_sum(vxs) / npe, corner_sum(vys) / npe,
                  corner_sum(vzs) / npe) if is_rsf else None)

        (stress_c, plstrain, delta_plstrain, viscosity, dpressure,
         dyn_fric_coeff, state_variable) = update_stress_cols(
            tab, s.replace(edvoldt=edvoldt), de, edot, sr, bulkm, shearm,
            temp_e, dt, dpp, vmean)

        if ctrl.is_using_mixed_stress:
            # NMD pressure smoothing (geometry.cxx:279-331)
            _, gdp = asm_gather([(dpressure * vol,)] * NPE, kg=1)
            ddp = (corner_sum([gdp[0, c] / vns[c] for c in range(NPE)])
                   / npe - dpressure) / three
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
        fcols = force_cols(stress_c, dndx, dndy, dndz, buoy, vol)
        if pp_in_force:
            # the pore-pressure contributions ride the force assembly
            # (k = 4); fields.cxx:297-406, bulk_comp = 1 / K in 3D
            mean_change = (stress_c[0] + stress_c[1] + stress_c[2]) \
                / three - old_mean_stress
            matrix_comp = 1.0 / (bulkm + 4.0 * shearm / three)
            bulk_comp2 = 1.0 / bulkm
            perm_e = M.perm(tab, s.emw)
            mu_e = M.mu_fluid(tab, s.emw)
            beta_f = M.beta_fluid(tab, s.emw)
            hc = perm_e * gamma_w / mu_e
            kv_h = hc * vol
            diff_e = hc / (phi_e * beta_f + alpha_b * matrix_comp) \
                / c_gamma_w
            hydro_diff_max = torch.clamp(diff_e.max(), min=1e-38)
            pe_src = alpha_b * mean_change * bulk_comp2 * vol / npe / dt
            heads = tuple(slots[7, c] / c_gamma_w + zs[c]
                          for c in range(NPE))
            ghx, ghy, ghz = dot4(dndx, heads), dot4(dndy, heads), \
                dot4(dndz, heads)
            fpack = asm_pack([
                fcols[c] + (kv_h * (dndx[c] * ghx + dndy[c] * ghy
                                    + dndz[c] * ghz) + pe_src,)
                for c in range(NPE)])
            pp_tdot = fpack[:, 3]
            force = -fpack[:, :3]
        else:
            hydro_diff_max = s.hydro_diff_max
            force = -asm_pack(fcols)
        l2_res = F.residual_l2(force)

        force = boundary_forces(force, s.coord, s.coord0, rho_e, phi_e)
        force = F.apply_damping(force, s.vel, s.mass, s.ymass,
                                ctrl.damping_option, ctrl.damping_factor)
        vel = F.update_velocity(s.vel, force, s.mass, s.dt)

        if ctrl.has_PT:
            sc0 = s.replace(
                vel=vel, stress=stress, strain=strain,
                strain_rate=strain_rate, plstrain=plstrain,
                delta_plstrain=delta_plstrain, viscosity=viscosity,
                dpressure=dpressure, dyn_fric_coeff=dyn_fric_coeff,
                state_variable=state_variable, edvoldt=edvoldt,
                temperature=temperature, l2_residual=l2_res)
            # loop-invariant: the post-diffusion element temperature
            temp_e_pt = corner_sum(cgather([temperature[:, None]])[0]) / npe
            s_pt = pt_loop(ctx, s, sc0, l2_res, time, bulkm, shearm, rho_e,
                           phi_e, buoy, temp_e_pt)
            (stress, strain, strain_rate, plstrain, delta_plstrain,
             viscosity, dpressure, dyn_fric_coeff, state_variable, vel,
             force, l2_res, edvoldt) = (
                s_pt.stress, s_pt.strain, s_pt.strain_rate, s_pt.plstrain,
                s_pt.delta_plstrain, s_pt.viscosity, s_pt.dpressure,
                s_pt.dyn_fric_coeff, s_pt.state_variable, s_pt.vel,
                s_pt.force, s_pt.l2_residual, s_pt.edvoldt)
            s = s.replace(
                coord=s_pt.coord, volume=s_pt.volume,
                volume_old=s_pt.volume_old, volume_n=s_pt.volume_n,
                mass=s_pt.mass, tmass=s_pt.tmass, hmass=s_pt.hmass,
                ymass=s_pt.ymass)
            vol = s.volume

        # pore-pressure update after the velocity, before the vbcs
        ppressure, dppressure = s.ppressure, s.dppressure
        if hydraulic:
            if not pp_in_force:
                # from the updated (relaxed) stress, with the step's first
                # shape-function gradients (as the JAX package)
                dnd = torch.stack([torch.stack([dndx[c], dndy[c], dndz[c]],
                                               dim=-1)
                                   for c in range(NPE)], dim=1)
                ppressure, dppressure, hydro_diff_max = \
                    F.update_pore_pressure(
                        s.ppressure, s.dppressure, s.coord, ctx.conn, dnd,
                        s.volume, stress.t(), old_mean_stress, s.hmass,
                        s.dt, ctrl.gravity, M.perm(tab, s.emw),
                        M.mu_fluid(tab, s.emw), M.alpha_biot(tab, s.emw),
                        phi_e, M.beta_fluid(tab, s.emw), bulkm, shearm,
                        ctx.pp_bc_mask,
                        lambda c: node_sum(c, ctx.gather_idx,
                                           ctx.gather_mask))
            else:
                positive = s.hmass > 0.0
                upd = torch.where(
                    positive,
                    pp_tdot * s.dt / torch.where(positive, s.hmass,
                                                 torch.ones_like(s.hmass)),
                    torch.zeros_like(s.hmass))
                ppressure = torch.where(ctx.pp_bc_mask, s.ppressure,
                                        s.ppressure - upd)
                dppressure = torch.where(ctx.pp_bc_mask, s.dppressure, upd)

        vel = bc_mod.apply_vbcs(ctx.vbc, vel, s.coord, time)

        # update_mesh (dynearthsol.cxx:431-473)
        dhacc, edvacc_surf = s.dhacc, s.edvacc_surf
        if ctrl.has_moving_mesh:
            coord = F.update_coordinate(s.coord, vel, s.dt)
            if surface:
                # the facet diffusion of the top (bc.cxx:1667-1831); the
                # moved velocity and coordinates ride ONE packed gather
                coord, dhacc, edvacc_surf, _ = SP.apply_surface_processes(
                    param, st, coord, s.dt, dhacc, edvacc_surf)
                g2 = cgather([vel, coord])
                (vxs2, vys2, vzs2), (xs2, ys2, zs2) = corners(g2, 0), \
                    corners(g2, 3)
            else:
                (vxs2, vys2, vzs2) = corners(cgather([vel]), 0)
                xs2 = tuple(xs[i] + vxs2[i] * s.dt for i in range(NPE))
                ys2 = tuple(ys[i] + vys2[i] * s.dt for i in range(NPE))
                zs2 = tuple(zs[i] + vzs2[i] * s.dt for i in range(NPE))
            volume_old = vol
            volume = volume_of(xs2, ys2, zs2)
            if ctx.surf.etop > 0 and ctrl.has_surface_correction:
                # correct_surface_element (bc.cxx:1613-1665); no surface
                # plastic-strain decay in 3D (bc.cxx:1805-1810 is 2D only)
                rdv = volume / vol
                tscale = torch.where(top_elem & (rdv >= 1.0), 1.0 / rdv,
                                     torch.ones_like(rdv))
                stress = stress * tscale
                strain = strain * tscale
                strain_rate = strain_rate * tscale
                plstrain = plstrain * tscale
                volume_old = torch.where(top_elem, volume, vol)
        else:
            coord, volume_old, volume = s.coord, s.volume_old, vol
            (vxs2, vys2, vzs2) = corners(cgather([vel]), 0)
            xs2, ys2, zs2 = xs, ys, zs

        # CFL dt, refreshed every 10 steps (dynearthsol.cxx:861-871)
        dt_new, vmax, gdtmin = compute_dt_cols(
            xs2, ys2, zs2, volume, vxs2, vys2, vzs2, shearm, rho_e,
            s.hydro_diff_max)
        if ctrl.use_global_velocity_scaling:
            dt_out = dt_new
        else:
            dt_out = torch.where(steps % 10 == 0, dt_new, s.dt)

        if ctrl.has_moving_mesh:
            # (pseudo-)mass matrices (geometry.cxx:1020-1154); the generic
            # step scales the pseudo-mass with this step's velocity
            # maximum, the flat step with the previous one
            mpack = asm_pack(mass_cols(
                volume, bulkm, shearm, rho_e, phi_e, tab, s.emw,
                vmax if generic else s.max_global_vel_mag,
                fluid_density=generic and hydraulic))
            volume_n = mpack[:, 0]
            mass = mpack[:, 1]
            tmass = mpack[:, 2]
            hmass = mpack[:, 3]
            ymass = mpack[:, 4]
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
            volume=volume, volume_old=volume_old, volume_n=volume_n,
            mass=mass, tmass=tmass, hmass=hmass, ymass=ymass,
            force=force, stress=stress, strain=strain,
            strain_rate=strain_rate, plstrain=plstrain,
            delta_plstrain=delta_plstrain, viscosity=viscosity,
            dpressure=dpressure, edvoldt=edvoldt, l2_residual=l2_res,
            dhacc=dhacc, edvacc_surf=edvacc_surf,
            dyn_fric_coeff=dyn_fric_coeff, state_variable=state_variable,
            ppressure=ppressure, dppressure=dppressure,
            old_mean_stress=old_mean_stress, hydro_diff_max=hydro_diff_max,
            dt=dt_out, time=time, steps=steps,
            max_global_vel_mag=vmax, global_dt_min=gdtmin, **upd_avg)

    def update_stress(*a):
        """update_stress_cols with the 2D module's result layout (the
        stressyy slot kept as is)."""
        st, pls, dpls, visc, dpr, dfc, sv = update_stress_cols(*a)
        return st, a[1].stressyy, pls, dpls, visc, dpr, dfc, sv

    step.stats = stats
    step.pieces = SimpleNamespace(
        ndims=3, NPE=NPE, npe=npe, stats=stats, gather=cgather,
        corners=corners, corner_sum=corner_sum, asm_pack=asm_pack,
        asm_gather=asm_gather,
        shape_fn=lambda X, vol: shape_fn(X[0], X[1], X[2], vol),
        volume_of=lambda X: volume_of(X[0], X[1], X[2]),
        strain_rate=lambda V, dnd: strain_rate_cols(V[0], V[1], V[2], *dnd),
        div=lambda sr: sr[0] + sr[1] + sr[2], anti_lock=_anti_lock,
        force_cols=lambda sc, dnd, buoy, vol: force_cols(sc, *dnd, buoy,
                                                          vol),
        mass_cols=mass_cols, update_stress=update_stress,
        boundary_forces=boundary_forces, pt_loop=pt_loop)
    return step


def make_chunk_runner(param: Param, ctx, compensation_pressure: float,
                      n: int, plain: bool = False, generic: bool = False):
    """run(ctx, state) -> state after n flat 3D steps (or generic steps):
    transpose the element tensors, step n times, transpose back (the
    counterpart of flat3d.make_chunk_runner).  ``run.stats`` is the step's
    count of pseudo-transient iterations and host reads."""
    step = make_flat_step(param, ctx, compensation_pressure, plain, generic)

    def run_chunk(sctx, state):
        g = state_to_flat(state)
        for _ in range(n):
            g = step(sctx, g)
        return flat_to_state(g)

    run_chunk.stats = step.stats
    return run_chunk
