"""Connectivity-driven 2D step in column layout (counterpart of
dynearthsol_tpu/ops/flat2d.py).

Covers any triangle mesh: it needs only ``conn`` and the node support, so
it is the step of unstructured meshes, and of structured meshes whose
feature set falls off the fused steps' gates.  Reference kernel order:
dynearthsol.cxx:746-956.

The step is the JAX package's ``make_flat_step``, operation for operation
and in the same order, on flat columns:

  element scalar   -> (nelem,)
  element tensor   -> (NSTR, nelem)
  corner values    -> one ``cgather`` of a packed nodal array, read back
                      as (nelem,) columns per corner and field
  assembly         -> ``asm_pack`` / ``asm_gather`` of packed corner
                      columns, each node's sum in node_sum's order

The gathers and assemblies of a step go through the three kernels of
ops/band2d.py (csrc/band2d.cu on the card, their plain versions on the
CPU): six per step (after surface processes the moved coordinates ride
the velocity's gather), and with the pseudo-transient loop one more
gather per step and per iteration two gathers, an assembly with its
re-gather and two assemblies.
Everything between them is element-wise column arithmetic, which the JAX
package leaves to XLA outside its Pallas kernels; here it is plain PyTorch
on the run's device.  A divisor that is a Python number is made a 0-d
tensor first: on the card PyTorch divides by a Python number as a product
with its reciprocal, an ulp off true division.

Scalars (dt, time, steps, the CFL metrics) stay 0-d tensors on the device;
a chunk runs with no host round trip, but for the pseudo-transient loop:
its condition (iteration count and relative residual change) is read on
the host once per iteration after the first, as ``jax.lax.while_loop``
reads it on the device.  ``step.stats`` counts those reads and the loop's
iterations.

A shard of a group of devices (parallel/) runs this step on its own
elements: its context's ``axis`` and ``halo`` complete each assembly with
the other shards' partial sums and take the CFL limits and the residual
over the group (``GroupHooks``); with neither the step is unchanged.

Every feature of the JAX package's flat step is computed: the facet and
Neumann tractions and the elastic foundation (bc.apply_stress_bcs and
apply_stress_bcs_neumann, fixed-order sums), surface processes 1 and 102
(ops/surface.py), Biot hydraulic diffusion, rate-and-state friction and
the pseudo-transient loop.  The step's pieces (``step.pieces``) also make
the isostasy and body-force pre-relaxations, so those launch the same
three kernels.
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
from .assembly import (halo_overlap_add, node_sum, node_sum_halo,
                       node_sum_scatter)
from .matprops import MIN_STRAIN_RATE

# element tensor fields stored k-major (NSTR, nelem) in the flat layout
E_TENSORS = ("stress", "strain", "strain_rate", "stress_avg",
             "strain_avg0")


def state_to_flat(s):
    """Transpose element tensor fields to contiguous (NSTR, nelem)."""
    return s.replace(**{f: getattr(s, f).t().contiguous()
                        for f in E_TENSORS})


def flat_to_state(g):
    return g.replace(**{f: getattr(g, f).t().contiguous()
                        for f in E_TENSORS})


def flat_step_applicable(param: Param, ctx) -> bool:
    """Static gate (flat2d.flat_step_applicable): one device (a shard of
    parallel/ runs the generic step).  The flat path applies to
    structured meshes too: the dispatcher checks the fused paths first."""
    rheol = param.mat.rheol_type
    return (ctx.axis is None and ctx.ndims == 2
            and rheol in (RH_ELASTIC, RH_VISCOUS, RH_MAXWELL, RH_EP,
                          RH_EVP, RH_EP_RSF, RH_EVP_RSF)
            and (rheol == RH_MAXWELL or rheol == RH_VISCOUS
                 or rheol == RH_ELASTIC or param.mat.is_plane_strain))


def generic_applicable(param: Param, ctx) -> bool:
    """Whether this module computes the JAX package's generic step for the
    config: in 2D, every rheology of the flat gate, plane strain or not.
    The JAX package reaches its generic step in 2D with the plastic
    rheologies without ``is_plane_strain`` (the principal-axes return map,
    rheology.cxx:298-457) or under ``DES_NO_FLAT``; ``make_flat_step(...,
    generic=True)`` computes it as the column step with the generic step's
    own choices where the two differ (the pseudo-mass's velocity scale,
    the fluid-filled density of the hydraulic mass and facet loads, and
    the pore-pressure update after the force assembly)."""
    return (ctx.ndims == 2
            and param.mat.rheol_type in (RH_ELASTIC, RH_VISCOUS, RH_MAXWELL,
                                         RH_EP, RH_EVP, RH_EP_RSF,
                                         RH_EVP_RSF))


def unported_features(param: Param, ctx) -> list:
    """What passes the gate above but this step does not compute: nothing
    (the simulation asks every step module)."""
    return []


class GroupHooks:
    """Where the column step meets the other shards of a group
    (parallel/group.py), from a shard's context: ``ctx.axis`` and, for the
    node-sharded halo step, ``ctx.halo``; with neither (one device) every
    hook is the identity and the step is unchanged.  Shared by
    ops/flat3d.py.

    ``complete`` makes a shard's nodal partial sums whole: the neighbours'
    overlap rows (halo step) or the group's sum in shard order
    (replicated-nodal shard step).  ``hx``, the second overlap exchange of
    the facet sums (halo step only).  ``residual``: the owned rows'
    squares summed over the group (halo step) or the whole replicated
    force (shard step).  ``dt_limits`` takes the CFL limits over the
    group in one meeting; ``pmax`` the velocity maximum of a fixed dt.
    ``node_asm``: (nelem, npe) -> (nnode,) sums for the pore pressure."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.axis, self.halo = ctx.axis, ctx.halo
        self.hx = (None if self.halo is None else
                   (lambda buf: halo_overlap_add(buf, self.axis,
                                                 self.halo)))

    def complete(self, sums):
        if self.halo is not None:
            return halo_overlap_add(sums, self.axis, self.halo)
        if self.axis is not None:
            return self.axis.psum(sums)
        return sums

    def residual(self, force):
        if self.halo is None:
            return F.residual_l2(force)
        return F.residual_l2(force, self.halo.own_mask, self.axis)

    def pmax(self, x):
        return x if self.axis is None else self.axis.pmax(x)

    def dt_limits(self, minl, dt_maxwell, dt_diffusion, hydro_h, vmax,
                  swave, five):
        """The shards' CFL limits combined in one meeting: the minima of
        the element heights and of the limits, the maxima of the velocity
        and of the S-wave speed.  The global dt floor min_e(minl /
        swave_e / 5) is minl / max_e(swave_e) / 5 bit for bit: IEEE
        division rounds monotonically."""
        lo, hi = self.axis.pminmax(
            torch.stack([minl, dt_maxwell, dt_diffusion, hydro_h]),
            torch.stack([vmax, swave.max()]))
        return (lo[0], lo[1], lo[2], lo[3], hi[0], lo[0] / hi[1] / five)

    def node_asm(self, c):
        ctx = self.ctx
        if self.halo is not None:
            return node_sum_halo(c, ctx.band, self.axis, self.halo)
        if self.axis is not None:
            return node_sum_scatter(c, ctx.band, self.axis)
        return node_sum(c, ctx.gather_idx, ctx.gather_mask)


def make_flat_step(param: Param, ctx, compensation_pressure: float = 0.0,
                   plain: bool = False, generic: bool = False):
    """Build step(ctx, fstate) -> fstate on flat column state (2D, any
    triangle mesh).  Mirrors flat2d.make_flat_step, or with ``generic`` the
    JAX package's generic step (simulation.make_step_fn) in 2D, where the
    two differ (see ``generic_applicable``).  ``plain`` runs the plain
    versions of the gathers and assemblies on the state's device instead
    of the wrappers (the reference the CUDA kernels are checked against on
    the card).  ``step.stats`` counts the pseudo-transient loop's
    iterations and host reads; ``step.pieces`` holds the step's pieces
    (the gathers and assemblies, the strain rate, the stress update, the
    force and mass columns, the boundary forces, the pseudo-transient
    loop) under the names and signatures ops/flat3d.py gives them, from
    which the pre-relaxations (simulation.py) are built."""
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
    visc_min = ctx.mat.visc_min
    rheol = mat.rheol_type
    is_rsf = rheol in (RH_EP_RSF, RH_EVP_RSF)
    rheol_ep = rheol in (RH_EP, RH_EP_RSF)
    rheol_evp = rheol in (RH_EVP, RH_EVP_RSF)
    hydraulic = ctrl.has_hydraulic_diffusion
    # the plastic rheologies without plane strain: the generic step only
    principal_axes = not mat.is_plane_strain
    if principal_axes and (rheol_ep or rheol_evp) and not generic:
        raise ValueError("the flat step's plasticity needs is_plane_strain")
    # the pore-pressure rate rides the force assembly (flat2d); the
    # generic step and the pseudo-transient loop recompute it after
    pp_in_force = hydraulic and not (generic or ctrl.has_PT)
    surface = ctrl.surface_process_option != 0 and ctx.surf.etop > 0
    pseudo_speed = max_vbc_val * ctrl.inertial_scaling

    def const(v):
        return torch.tensor(float(v), dtype=dtype, device=dev)

    npe = const(3.0)
    two = const(2.0)
    three = const(3.0)
    five = const(5.0)
    big = const(torch.finfo(dtype).max)
    c_therm_diff_max = const(ctx.mat.therm_diff_max)
    c_max_vbc = const(max_vbc_val)
    c_pseudo = const(pseudo_speed)
    c_pseudo2 = const(pseudo_speed * pseudo_speed)
    c_swave_ref = const(math.sqrt(mat.bulk_modulus[mat.mattype_ref]
                                  / mat.rho0[mat.mattype_ref]))
    c_half_visc_min = const(0.5 * visc_min)
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
    G = GroupHooks(ctx)

    eng_gather, eng_scatter, eng_scatter_gather = (
        (band2d.gather_corners, band2d.scatter_corners,
         band2d.scatter_gather_corners) if plain
        else (band2d.cgather, band2d.asm_pack, band2d.asm_gather))

    def cgather(pack):
        """(nnode, k) -> (k, 3, nelem): [field, corner] element columns."""
        return eng_gather(pack.contiguous(), bt)

    def _pack(slot_cols):
        """[corner][field] columns -> the (k, 3, nelem) element pack."""
        k = len(slot_cols[0])
        return torch.stack([slot_cols[c][j] for j in range(k)
                            for c in range(3)]).view(k, 3, bt.nelem)

    def asm_pack(slot_cols):
        """[corner][field] columns -> (nnode, k) sums, node_sum order."""
        return G.complete(eng_scatter(_pack(slot_cols), bt))

    def asm_gather(slot_cols, kg):
        """Assembly + corner re-gather of the first ``kg`` nodal sums:
        ((nnode, k) sums, (kg, 3, nelem) columns).  The step's transfer
        hops (dvoldt, NMD pressure smoothing) assemble and at once
        re-gather the same nodal field.  Under a group the gather needs
        the whole sums: assembly, the group's completion, then the
        gather."""
        if G.axis is None:
            return eng_scatter_gather(_pack(slot_cols), bt, kg)
        sums = asm_pack(slot_cols)
        return sums, eng_gather(sums[:, :kg].contiguous(), bt)

    def corner_sum(cols):
        return cols[0] + cols[1] + cols[2]

    def shape_fn(xs, zs, vol):
        iv = 1.0 / (2.0 * vol)
        dndx = (iv * (zs[1] - zs[2]), iv * (zs[2] - zs[0]),
                iv * (zs[0] - zs[1]))
        dndz = (iv * (xs[2] - xs[1]), iv * (xs[0] - xs[2]),
                iv * (xs[1] - xs[0]))
        return dndx, dndz

    def volume_of(xs, zs):
        return 0.5 * ((xs[1] - xs[0]) * (zs[2] - zs[0])
                      - (zs[1] - zs[0]) * (xs[2] - xs[0]))

    def min_height(xs, zs, vol):
        d01 = (xs[0] - xs[1]) ** 2 + (zs[0] - zs[1]) ** 2
        d12 = (xs[1] - xs[2]) ** 2 + (zs[1] - zs[2]) ** 2
        d02 = (xs[0] - xs[2]) ** 2 + (zs[0] - zs[2]) ** 2
        dmax = torch.maximum(torch.maximum(d01, d12), d02)
        return 2.0 * vol / torch.sqrt(dmax)

    def strain_rate_cols(vxs, vzs, dndx, dndz):
        """(lxx, lzz, lxz) of fields.cxx:408-483."""
        lxx = vxs[0] * dndx[0] + vxs[1] * dndx[1] + vxs[2] * dndx[2]
        lzz = vzs[0] * dndz[0] + vzs[1] * dndz[1] + vzs[2] * dndz[2]
        lxz = 0.5 * (vxs[0] * dndz[0] + vxs[1] * dndz[1]
                     + vxs[2] * dndz[2]
                     + vzs[0] * dndx[0] + vzs[1] * dndx[1]
                     + vzs[2] * dndx[2])
        return lxx, lzz, lxz

    def force_cols(stress_c, dndx, dndz, buoy, vol):
        """Each corner's internal-force contribution (fields.cxx:612-703)."""
        return [((stress_c[0] * dndx[c] + stress_c[2] * dndz[c]) * vol,
                 (stress_c[2] * dndx[c] + stress_c[1] * dndz[c] + buoy)
                 * vol) for c in range(3)]

    def mass_cols(volume, bulkm, shearm, rho_e, phi_e, tab, emw,
                  max_global_vel_mag, fluid_density=False):
        """Each element's (volume, mass, tmass, hmass, ymass) shares
        (geometry.cxx:1020-1154); ``fluid_density``: a dynamic run's mass
        is that of the fluid-filled rock (the generic step's, with
        hydraulic diffusion)."""
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
        bulk_comp = 1.0 / (bulkm + shearm / three)
        ab_e = M.alpha_biot(tab, emw)
        bf_e = M.beta_fluid(tab, emw)
        cp_e = M.cp(tab, emw)
        hm_coeff = ab_e + phi_e - ab_e * phi_e
        m = rho_m * volume / npe
        tm = rho_e * cp_e * volume / npe
        hm = (hm_coeff * bulk_comp + phi_e * bf_e) * volume / npe
        ym = 9.0 * bulkm * shearm / (3.0 * bulkm + shearm) / npe
        return [(volume, m, tm, hm, ym)] * 3

    def compute_dt_cols(xs, zs, vol, vxs, vzs, shearm, rho_e,
                        hydro_diff_max):
        """CFL dt (geometry.cxx:756-923); mirrors flat2d.compute_dt_cols,
        with the hydraulic diffusion limit when enabled."""
        vx_m = corner_sum(vxs) / npe
        vz_m = corner_sum(vzs) / npe
        vmag = torch.sqrt(vx_m * vx_m + vz_m * vz_m)
        vmax = torch.maximum(vmag.max(), c_max_vbc)
        if ctrl.fixed_dt != 0.0:
            fdt = const(ctrl.fixed_dt)
            return fdt, G.pmax(vmax), fdt
        minh = min_height(xs, zs, vol)
        minl = minh.min()
        dt_maxwell = (c_half_visc_min / (1e-40 + shearm)).min()
        dt_diffusion = (0.5 * minh * minh / c_therm_diff_max).min() \
            if ctrl.has_thermal_diffusion else big
        swave = torch.sqrt(shearm / rho_e)
        hydro_h = (0.5 * minh * minh).min() if hydraulic else big
        if G.axis is None:
            gdtmin = (minl / swave / five).min()
        else:
            (minl, dt_maxwell, dt_diffusion, hydro_h, vmax,
             gdtmin) = G.dt_limits(minl, dt_maxwell, dt_diffusion, hydro_h,
                                   vmax, swave, five)
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
                           torch.minimum(dt_advection, dt_diffusion))
        if hydraulic:
            dt_hydro = torch.where(hydro_diff_max > 0,
                                   hydro_h / hydro_diff_max, big)
            dt = torch.minimum(dt, dt_hydro)
        return dt * ctrl.dt_fraction, vmax, gdtmin

    def slip_rate2_c(s0, s1, s2, vx_m, vz_m):
        """Column form of rheology.slip_rate2 (rheology.cxx:107-148)."""
        d = s0 - s1
        rad = torch.sqrt(0.25 * (d * d) + s2 * s2)
        a = 0.5 * d
        b = -rad
        ok = b < -1e-15
        one = torch.ones_like(b)
        safe_b = torch.where(ok, b, one)
        cos2t = torch.where(ok, a / safe_b, one)
        sin2t = torch.where(ok, s2 / safe_b, torch.zeros_like(b))
        theta = 0.5 * torch.atan2(sin2t, cos2t)
        dx = torch.cos(theta + math.pi / 4)
        dz = torch.sin(theta + math.pi / 4)
        return torch.abs(vx_m * dx + vz_m * dz)

    def update_stress_cols(tab, s, de, edot, sr, bulkm, shearm, temp_e, dt,
                           dpp=None, vmean=None):
        """Constitutive switch (rheology.cxx:676-991) on columns; mirrors
        flat2d.update_stress_cols: the Biot effective-stress increment
        ``dpp`` (rheology.cxx:696-755) and the rate-and-state variants
        (rheology.cxx:882-914, matprops.cxx:532-552), with ``vmean`` the
        element-mean pre-update velocity columns."""
        stress = (s.stress[0], s.stress[1], s.stress[2])
        old_tr = stress[0] + stress[1]
        stressyy = s.stressyy
        plstrain, delta_plstrain = s.plstrain, s.delta_plstrain
        viscosity = s.viscosity
        dyn_fric_coeff = s.dyn_fric_coeff
        state_variable = s.state_variable

        if is_rsf:
            slip = slip_rate2_c(stress[0], stress[1], stress[2],
                                vmean[0], vmean[1])
            (amc_r, anphi_r, anpsi_r, hardn_r, ten_max_r,
             dyn_fric_coeff, state_variable) = M.plastic_props_rsf(
                tab, s.emw, s.plstrain, slip, s.state_variable, dt,
                mat.state_var_model)

        def creep_visc():
            s0 = (stress[0] + stress[1]) / 2.0
            rII2 = 0.25 * (sr[0] - sr[1]) ** 2 + sr[2] ** 2
            ed = torch.clamp(torch.sqrt(rII2), min=MIN_STRAIN_RATE)
            return M.visc_core(tab, s.emw, temp_e, s0, ed)

        def mc_props():
            if is_rsf:
                return amc_r, anphi_r, anpsi_r, hardn_r, ten_max_r
            return M.plastic_props(tab, s.emw, s.plstrain)

        def plastic(amc, anphi, anpsi, hardn, ten_max):
            """(stress, stressyy, depls): plane strain (rheology.cxx:
            459-674) or principal axes (:298-457, stressyy untouched)."""
            if principal_axes:
                sp, depls, _ = R.elasto_plastic2_c(
                    bulkm, shearm, amc, anphi, anpsi, hardn, ten_max,
                    de, stress, dpp)
                return sp, s.stressyy, depls
            sp, spyy, depls, _ = R.elasto_plastic2d_c(
                bulkm, shearm, amc, anphi, anpsi, hardn, ten_max,
                de, stress, s.stressyy, dpp)
            return sp, spyy, depls

        if rheol == RH_ELASTIC:
            stress = R.elastic2_c(bulkm, shearm, de, stress, dpp)
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
        elif rheol_ep:
            stress, stressyy, depls = plastic(*mc_props())
            plstrain = s.plstrain + depls
            delta_plstrain = depls
        elif rheol_evp:
            viscosity = creep_visc()
            dv = s.volume / s.volume_old - 1.0
            sv = R.maxwell2_c(bulkm, shearm, viscosity, dt, dv, de,
                              stress)
            svII = 0.25 * (sv[0] - sv[1]) ** 2 + sv[2] ** 2
            sp, spyy, depls = plastic(*mc_props())
            spII = 0.25 * (sp[0] - sp[1]) ** 2 + sp[2] ** 2
            # min-magnitude selection (rheology.cxx:869-879)
            use_v = svII < spII
            stress = tuple(torch.where(use_v, a, b)
                           for a, b in zip(sv, sp))
            stressyy = torch.where(use_v, s.stressyy, spyy)
            plstrain = torch.where(use_v, s.plstrain, s.plstrain + depls)
            delta_plstrain = torch.where(use_v, s.delta_plstrain, depls)
        else:  # pragma: no cover - gated
            raise ValueError(f"flat step: unsupported rheology {rheol}")
        if ctrl.is_using_mixed_stress:
            dpressure = stress[0] + stress[1] - old_tr
        else:
            dpressure = s.dpressure
        return (stress, stressyy, plstrain, delta_plstrain, viscosity,
                dpressure, dyn_fric_coeff, state_variable)

    def boundary_forces(force, coord, coord0, rho_e, phi_e,
                        fluid=generic and hydraulic, neumann=True):
        """Facet tractions and the elastic foundation (only with gravity),
        then the Neumann tractions (flat2d.py:526-530).  The generic step
        loads them with the fluid-filled rock's density under hydraulic
        diffusion (simulation.py:323-326): ``fluid``.  The isostasy
        pre-relaxation adds no Neumann tractions."""
        if ctrl.gravity != 0:
            rho_eff = rho_e
            if fluid:
                rho_eff = rho_e * (1.0 - phi_e) + 1000.0 * phi_e
            force = bc_mod.apply_stress_bcs(param, sbc, coord, force,
                                            rho_eff, compensation_pressure,
                                            coord0, G.hx)
        if neumann:
            force = bc_mod.apply_stress_bcs_neumann(sbc, coord, force,
                                                    G.hx)
        return force

    def _anti_lock(sr, edv):
        """The strain rate with the anti-mesh-locking volumetric part
        (rheology.cxx:755-763)."""
        adj = (edv - (sr[0] + sr[1])) / 2.0
        return (sr[0] + adj, sr[1] + adj, sr[2])

    def pt_loop(ctx, s, sc, l2_res, time, bulkm, shearm, rho_e, phi_e,
                buoy, temp_e_pt, fluid=generic and hydraulic):
        """The pseudo-transient inner relaxation (dynearthsol.cxx:779-840)
        in columns: the step's kernel sequence with zeroed vbc values,
        surface processes skipped (dynearthsol.cxx:439-444), hydraulic
        diffusion suspended (:781-784) and no NMD smoothing (a main-loop
        kernel), until the residual's relative change drops below
        PT_relative_tolerance or PT_max_iter iterations have run.  It is
        also the body-force pre-relaxation's loop (dynearthsol.cxx:526-571),
        which loads the facets with the rock's own density (``fluid``
        False)."""
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
            gp = cgather(torch.cat([coordp, velp], dim=1))
            xsp = tuple(gp[0, c] for c in range(3))
            zsp = tuple(gp[1, c] for c in range(3))
            vxp = tuple(gp[2, c] for c in range(3))
            vzp = tuple(gp[3, c] for c in range(3))
            if ctrl.has_moving_mesh:
                volp = volume_of(xsp, zsp)
                mpk = asm_pack(mass_cols(volp, bulkm, shearm, rho_e, phi_e,
                                         tab, s.emw, sc.max_global_vel_mag))
                sc = sc.replace(
                    coord=coordp, volume=volp, volume_old=volp_old,
                    volume_n=mpk[:, 0], mass=mpk[:, 1], tmass=mpk[:, 2],
                    hmass=mpk[:, 3], ymass=mpk[:, 4])
            else:
                volp = sc.volume
            vnp = cgather(sc.volume_n[:, None])
            dndxp, dndzp = shape_fn(xsp, zsp, volp)
            srp = strain_rate_cols(vxp, vzp, dndxp, dndzp)
            lxxp, lzzp, lxzp = srp
            _, gdvp = asm_gather([((lxxp + lzzp) * volp,)] * 3, kg=1)
            edvp = corner_sum([gdvp[0, c] / vnp[0, c] for c in range(3)]) \
                / npe
            edotp = _anti_lock(srp, edvp)
            dep = (edotp[0] * sc.dt, edotp[1] * sc.dt, edotp[2] * sc.dt)
            strainp = torch.stack([sc.strain[0] + dep[0],
                                   sc.strain[1] + dep[1],
                                   sc.strain[2] + dep[2]])
            vmeanp = ((corner_sum(vxp) / npe, corner_sum(vzp) / npe)
                      if is_rsf else None)
            sc1 = sc.replace(vel=velp, edvoldt=edvp)
            (stp, syyp, plsp, dplsp, viscp, dprp, dfcp, svp) = \
                update_stress_cols(tab, sc1, dep, edotp, srp, bulkm, shearm,
                                   temp_e_pt, sc.dt, None, vmeanp)
            forcep = -asm_pack(force_cols(stp, dndxp, dndzp, buoy, volp))
            resp = G.residual(forcep)
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
                stressyy=syyp, strain=strainp,
                strain_rate=torch.stack(edotp), plstrain=plsp,
                delta_plstrain=dplsp, viscosity=viscp, dpressure=dprp,
                l2_residual=resp, dyn_fric_coeff=dfcp, state_variable=svp)
            k += 1
        stats["pt_iterations"] += k
        return sc

    def step(ctx, s):
        tab = ctx.mat
        dt = s.dt
        steps = s.steps + 1
        time = s.time + s.dt

        # ONE packed corner gather (coord, vel, T [, pp, dpp], volume_n),
        # read back as columns; volume_n rides along so the dvoldt/NMD
        # transfer hops can divide their re-gathered nodal sums per corner
        # (elementwise-identical to dividing nodally)
        cols = [s.coord, s.vel, s.temperature[:, None]]
        if hydraulic:
            cols += [s.ppressure[:, None], s.dppressure[:, None]]
        cols.append(s.volume_n[:, None])
        slots = cgather(torch.cat(cols, dim=1))  # [field][corner]
        xs = tuple(slots[0, c] for c in range(3))
        zs = tuple(slots[1, c] for c in range(3))
        vxs = tuple(slots[2, c] for c in range(3))
        vzs = tuple(slots[3, c] for c in range(3))
        ts = tuple(slots[4, c] for c in range(3))
        vns = tuple(slots[-1, c] for c in range(3))

        vol = s.volume
        dndx, dndz = shape_fn(xs, zs, vol)
        temp_e = corner_sum(ts) / npe
        bulkm = M.bulkm(tab, s.emw)
        shearm = M.shearm(tab, s.emw)
        rho_e = M.rho_from_T(tab, s.emw, temp_e)

        sr = strain_rate_cols(vxs, vzs, dndx, dndz)
        lxx, lzz, lxz = sr

        # thermal diffusion + dvoldt share ONE assembly (k = 1 + 1)
        etmp = (lxx + lzz) * vol
        if ctrl.has_thermal_diffusion:
            kappa = M.therm_cond(tab, s.emw)
            source = s.radiogenic_source * vol * rho_e / npe
            kv = kappa * vol
            gtx = dndx[0] * ts[0] + dndx[1] * ts[1] + dndx[2] * ts[2]
            gtz = dndz[0] * ts[0] + dndz[1] * ts[1] + dndz[2] * ts[2]
            both, gdv = asm_gather([
                (etmp, kv * (dndx[c] * gtx + dndz[c] * gtz) - source)
                for c in range(3)], kg=1)
            tdot = both[:, 1]
            temperature = torch.where(
                ctx.top_mask, surface_T,
                s.temperature - s.dt * tdot / s.tmass)
        else:
            _, gdv = asm_gather([(etmp,)] * 3, kg=1)
            temperature = s.temperature

        # anti-mesh-locking dvoldt/edvoldt (geometry.cxx:202-276): the
        # nodal dv sums come back at the corners from the fused kernel;
        # dividing by corner volume_n equals gathering dv_sum/volume_n
        # bit for bit
        edvoldt = corner_sum([gdv[0, c] / vns[c] for c in range(3)]) / npe

        edot = _anti_lock(sr, edvoldt)
        de = (edot[0] * dt, edot[1] * dt, edot[2] * dt)
        strain = torch.stack([s.strain[0] + de[0], s.strain[1] + de[1],
                              s.strain[2] + de[2]])
        strain_rate = torch.stack(edot)

        # Biot effective-stress increment from nodal dppressure
        # (rheology.cxx:696-755) and this step's pre-update mean stress
        # for the poroelastic source (fields.cxx:297-406)
        old_mean_stress = s.old_mean_stress
        dpp = None
        if hydraulic:
            old_mean_stress = (s.stress[0] + s.stress[1]) / two
            alpha_b = M.alpha_biot(tab, s.emw)
            dpp = alpha_b * corner_sum([slots[6, c] for c in range(3)]) \
                / npe
        vmean = ((corner_sum(vxs) / npe, corner_sum(vzs) / npe)
                 if is_rsf else None)

        (stress_c, stressyy, plstrain, delta_plstrain, viscosity,
         dpressure, dyn_fric_coeff, state_variable) = update_stress_cols(
            tab, s.replace(edvoldt=edvoldt), de, edot, sr, bulkm, shearm,
            temp_e, dt, dpp, vmean)

        if ctrl.is_using_mixed_stress:
            # NMD pressure smoothing (geometry.cxx:279-331), fused
            # assemble+regather with per-corner volume_n division
            _, gdp = asm_gather([(dpressure * vol,)] * 3, kg=1)
            ddp = (corner_sum([gdp[0, c] / vns[c] for c in range(3)]) / npe
                   - dpressure) / 2.0
            stress_c = (stress_c[0] + ddp, stress_c[1] + ddp, stress_c[2])
        stress = torch.stack(stress_c)

        # force assembly (fields.cxx:612-703)
        phi_e = M.phi_porosity(tab, s.emw)
        if ctrl.gravity != 0:
            buoy = (rho_e * (1.0 - phi_e) + 1000.0 * phi_e) \
                * ctrl.gravity / npe
        else:
            buoy = torch.zeros_like(vol)
        fcols = force_cols(stress_c, dndx, dndz, buoy, vol)
        if pp_in_force:
            # the pore-pressure diffusion contributions (fields.cxx:297-406)
            # ride the force assembly (k = 3): they need only the updated
            # stress and the pre-move geometry, and the reference updates
            # the pore pressure after the velocity
            mean_change = (stress_c[0] + stress_c[1]) / two \
                - old_mean_stress
            matrix_comp = 1.0 / (bulkm + 4.0 * shearm / three)
            bulk_comp2 = 1.0 / (bulkm + shearm / three)
            perm_e = M.perm(tab, s.emw)
            mu_e = M.mu_fluid(tab, s.emw)
            beta_f = M.beta_fluid(tab, s.emw)
            hc = perm_e * gamma_w / mu_e
            kv_h = hc * vol
            diff_e = hc / (phi_e * beta_f + alpha_b * matrix_comp) \
                / c_gamma_w
            hydro_diff_max = torch.clamp(diff_e.max(), min=1e-38)
            pe_src = alpha_b * mean_change * bulk_comp2 * vol / npe / dt
            heads = tuple(slots[5, c] / c_gamma_w + zs[c] for c in range(3))
            ghx = dndx[0] * heads[0] + dndx[1] * heads[1] \
                + dndx[2] * heads[2]
            ghz = dndz[0] * heads[0] + dndz[1] * heads[1] \
                + dndz[2] * heads[2]
            fpack = asm_pack([
                fcols[c] + (kv_h * (dndx[c] * ghx + dndz[c] * ghz)
                            + pe_src,) for c in range(3)])
            pp_tdot = fpack[:, 2]
            force = -fpack[:, :2]
        else:
            hydro_diff_max = s.hydro_diff_max
            force = -asm_pack(fcols)
        l2_res = G.residual(force)

        force = boundary_forces(force, s.coord, s.coord0, rho_e, phi_e)
        force = F.apply_damping(force, s.vel, s.mass, s.ymass,
                                ctrl.damping_option, ctrl.damping_factor)
        vel = F.update_velocity(s.vel, force, s.mass, s.dt)

        if ctrl.has_PT:
            sc0 = s.replace(
                vel=vel, stress=stress, stressyy=stressyy, strain=strain,
                strain_rate=strain_rate, plstrain=plstrain,
                delta_plstrain=delta_plstrain, viscosity=viscosity,
                dpressure=dpressure, dyn_fric_coeff=dyn_fric_coeff,
                state_variable=state_variable, edvoldt=edvoldt,
                temperature=temperature, l2_residual=l2_res)
            # loop-invariant: the post-diffusion element temperature
            temp_e_pt = corner_sum(cgather(temperature[:, None])[0]) / npe
            s_pt = pt_loop(ctx, s, sc0, l2_res, time, bulkm, shearm, rho_e,
                           phi_e, buoy, temp_e_pt)
            (stress, stressyy, strain, strain_rate, plstrain,
             delta_plstrain, viscosity, dpressure, dyn_fric_coeff,
             state_variable, vel, force, l2_res, edvoldt) = (
                s_pt.stress, s_pt.stressyy, s_pt.strain, s_pt.strain_rate,
                s_pt.plstrain, s_pt.delta_plstrain, s_pt.viscosity,
                s_pt.dpressure, s_pt.dyn_fric_coeff, s_pt.state_variable,
                s_pt.vel, s_pt.force, s_pt.l2_residual, s_pt.edvoldt)
            s = s.replace(
                coord=s_pt.coord, volume=s_pt.volume,
                volume_old=s_pt.volume_old, volume_n=s_pt.volume_n,
                mass=s_pt.mass, tmass=s_pt.tmass, hmass=s_pt.hmass,
                ymass=s_pt.ymass)
            vol = s.volume

        # pore-pressure update after the velocity, before the vbcs
        # (dynearthsol.cxx:842-850 order)
        ppressure, dppressure = s.ppressure, s.dppressure
        if hydraulic:
            if not pp_in_force:
                # from the updated (relaxed) stress, with the step's first
                # shape-function gradients (as the JAX package)
                dnd = torch.stack([torch.stack([dndx[c], dndz[c]], dim=-1)
                                   for c in range(3)], dim=1)
                ppressure, dppressure, hydro_diff_max = \
                    F.update_pore_pressure(
                        s.ppressure, s.dppressure, s.coord, ctx.conn, dnd,
                        s.volume, stress.t(), old_mean_stress, s.hmass,
                        s.dt, ctrl.gravity, M.perm(tab, s.emw),
                        M.mu_fluid(tab, s.emw), M.alpha_biot(tab, s.emw),
                        phi_e, M.beta_fluid(tab, s.emw), bulkm, shearm,
                        ctx.pp_bc_mask, G.node_asm, G.axis)
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
                # nodal surface processes (bc.cxx:1667-1831); the moved
                # velocity and coordinates ride ONE packed gather
                coord, dhacc, edvacc_surf, _ = SP.apply_surface_processes(
                    param, st, coord, s.dt, dhacc, edvacc_surf, G.hx)
                g2 = cgather(torch.cat([vel, coord], dim=1))
                vxs2 = tuple(g2[0, c] for c in range(3))
                vzs2 = tuple(g2[1, c] for c in range(3))
                xs2 = tuple(g2[2, c] for c in range(3))
                zs2 = tuple(g2[3, c] for c in range(3))
            else:
                v2 = cgather(vel)
                vxs2 = tuple(v2[0, c] for c in range(3))
                vzs2 = tuple(v2[1, c] for c in range(3))
                xs2 = tuple(xs[i] + vxs2[i] * s.dt for i in range(3))
                zs2 = tuple(zs[i] + vzs2[i] * s.dt for i in range(3))
            volume_old = vol
            volume = volume_of(xs2, zs2)
            if ctx.surf.etop > 0 and ctrl.has_surface_correction:
                # correct_surface_element (bc.cxx:1613-1665), broadcast
                # over the k-major (NSTR, nelem) tensor layout
                rdv = volume / vol
                tscale = torch.where(top_elem & (rdv >= 1.0), 1.0 / rdv,
                                     torch.ones_like(rdv))
                stress = stress * tscale
                strain = strain * tscale
                strain_rate = strain_rate * tscale
                plstrain = plstrain * tscale
                volume_old = torch.where(top_elem, volume, vol)
                qcsi = param.mesh.quality_check_step_interval
                plstrain = SP.surface_plstrain_decay(
                    top_elem, plstrain, s.emw, s.dt,
                    param.mat.mattype_oceanic_crust,
                    apply=(steps % qcsi) == 0)
        else:
            coord, volume_old, volume = s.coord, s.volume_old, vol
            v2 = cgather(vel)
            vxs2 = tuple(v2[0, c] for c in range(3))
            vzs2 = tuple(v2[1, c] for c in range(3))
            xs2, zs2 = xs, zs

        # CFL dt, refreshed every 10 steps (dynearthsol.cxx:861-871)
        dt_new, vmax, gdtmin = compute_dt_cols(
            xs2, zs2, volume, vxs2, vzs2, shearm, rho_e, s.hydro_diff_max)
        if ctrl.use_global_velocity_scaling:
            dt_out = dt_new
        else:
            dt_out = torch.where(steps % 10 == 0, dt_new, s.dt)

        if ctrl.has_moving_mesh:
            # (pseudo-)mass matrices (geometry.cxx:1020-1154)
            # the generic step scales the pseudo-mass with this step's
            # velocity maximum, the flat step with the previous one
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
            dndx2, dndz2 = shape_fn(xs2, zs2, volume)
            w2 = 0.5 * ((vzs2[0] * dndx2[0] + vzs2[1] * dndx2[1]
                         + vzs2[2] * dndx2[2])
                        - (vxs2[0] * dndz2[0] + vxs2[1] * dndz2[1]
                           + vxs2[2] * dndz2[2]))
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
            force=force, stress=stress, stressyy=stressyy, strain=strain,
            strain_rate=strain_rate, plstrain=plstrain,
            delta_plstrain=delta_plstrain, viscosity=viscosity,
            dpressure=dpressure, edvoldt=edvoldt, l2_residual=l2_res,
            dhacc=dhacc, edvacc_surf=edvacc_surf,
            dyn_fric_coeff=dyn_fric_coeff, state_variable=state_variable,
            ppressure=ppressure, dppressure=dppressure,
            old_mean_stress=old_mean_stress, hydro_diff_max=hydro_diff_max,
            dt=dt_out, time=time, steps=steps,
            max_global_vel_mag=vmax, global_dt_min=gdtmin, **upd_avg)

    step.stats = stats
    step.pieces = SimpleNamespace(
        ndims=2, NPE=3, npe=npe, stats=stats,
        gather=lambda cols: cgather(torch.cat(cols, dim=1)),
        corners=lambda g, j0: [tuple(g[j0 + d, c] for c in range(3))
                               for d in range(2)],
        corner_sum=corner_sum, asm_pack=asm_pack, asm_gather=asm_gather,
        shape_fn=lambda X, vol: shape_fn(X[0], X[1], vol),
        volume_of=lambda X: volume_of(X[0], X[1]),
        strain_rate=lambda V, dnd: strain_rate_cols(V[0], V[1], *dnd),
        div=lambda sr: sr[0] + sr[1],
        anti_lock=_anti_lock,
        force_cols=lambda sc, dnd, buoy, vol: force_cols(sc, *dnd, buoy,
                                                          vol),
        mass_cols=mass_cols, update_stress=update_stress_cols,
        boundary_forces=boundary_forces, pt_loop=pt_loop)
    return step


def make_chunk_runner(param: Param, ctx, compensation_pressure: float,
                      n: int, plain: bool = False, generic: bool = False):
    """run(ctx, state) -> state after n flat steps: transpose the element
    tensors, step n times, transpose back (the counterpart of
    flat2d.make_chunk_runner, with its arguments; the Winkler reference
    pressure ``compensation_pressure`` enters the facet tractions).
    ``run.stats`` is the step's count of pseudo-transient iterations and
    host reads."""
    step = make_flat_step(param, ctx, compensation_pressure, plain, generic)

    def run_chunk(sctx, state):
        g = state_to_flat(state)
        for _ in range(n):
            g = step(sctx, g)
        return flat_to_state(g)

    run_chunk.stats = step.stats
    return run_chunk
