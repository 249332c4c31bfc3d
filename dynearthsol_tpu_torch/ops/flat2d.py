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

The six gathers and assemblies of a step go through the three kernels of
ops/band2d.py (csrc/band2d.cu on the card, their plain versions on the
CPU).  Everything between them is element-wise column arithmetic, which
the JAX package leaves to XLA outside its Pallas kernels; here it is plain
PyTorch on the run's device.  A divisor that is a Python number is made a
0-d tensor first: on the card PyTorch divides by a Python number as a
product with its reciprocal, an ulp off true division.

Scalars (dt, time, steps, the CFL metrics) stay 0-d tensors on the device;
a chunk runs with no host round trip.

Not ported yet (``unported_features`` names them and the simulation
refuses such configs): hydraulic diffusion, rate-and-state friction, the
pseudo-transient loop, surface processes, gravity-facet and Neumann
tractions, the elastic foundation.
"""

from __future__ import annotations

import math

import torch

from .. import bc as bc_mod
from ..config import (RH_ELASTIC, RH_EP, RH_EP_RSF, RH_EVP, RH_EVP_RSF,
                      RH_MAXWELL, RH_VISCOUS, Param)
from . import band2d
from . import fields as F
from . import matprops as M
from . import rheology as R
from . import surface as SP
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
    """Static gate (flat2d.flat_step_applicable; this package has no
    sharded step, so its ``ctx.axis is None`` always holds).  The flat
    path applies to structured meshes too: the dispatcher checks the fused
    paths first."""
    rheol = param.mat.rheol_type
    return (ctx.ndims == 2
            and rheol in (RH_ELASTIC, RH_VISCOUS, RH_MAXWELL, RH_EP,
                          RH_EVP, RH_EP_RSF, RH_EVP_RSF)
            and (rheol == RH_MAXWELL or rheol == RH_VISCOUS
                 or rheol == RH_ELASTIC or param.mat.is_plane_strain))


def unported_features(param: Param, ctx) -> list:
    """Features that pass the gate above but that this package's flat step
    does not compute yet (flat2d.py:541-685, :724-735, :455-514;
    bc.apply_stress_bcs and apply_stress_bcs_neumann)."""
    ctrl = param.control
    out = []
    if ctrl.has_hydraulic_diffusion:
        out.append("hydraulic diffusion")
    if param.mat.rheol_type in (RH_EP_RSF, RH_EVP_RSF):
        out.append("rate-and-state friction")
    if ctrl.has_PT:
        out.append("the pseudo-transient loop")
    if ctrl.surface_process_option != 0:
        out.append(f"surface process option {ctrl.surface_process_option}")
    if ctx.sbc.n_grav > 0:
        out.append("gravity-facet tractions (Winkler / water loading / "
                   "lithostatic side walls)")
    if ctx.sbc.n_neu > 0:
        out.append("Neumann tractions")
    if param.bc.has_elastic_foundation:
        out.append("the elastic foundation")
    return out


def make_flat_step(param: Param, ctx, plain: bool = False):
    """Build step(ctx, fstate) -> fstate on flat column state (2D, any
    triangle mesh).  Mirrors flat2d.make_flat_step.  ``plain`` runs the
    plain versions of the gathers and assemblies on the state's device
    instead of the wrappers (the reference the CUDA kernels are checked
    against on the card)."""
    ctrl = param.control
    mat = param.mat
    missing = unported_features(param, ctx)
    if missing:
        raise NotImplementedError(
            "this package's flat step lacks: " + "; ".join(missing))
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
    pseudo_speed = max_vbc_val * ctrl.inertial_scaling

    def const(v):
        return torch.tensor(float(v), dtype=dtype, device=dev)

    npe = const(3.0)
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
        return eng_scatter(_pack(slot_cols), bt)

    def asm_gather(slot_cols, kg):
        """Assembly + corner re-gather of the first ``kg`` nodal sums:
        ((nnode, k) sums, (kg, 3, nelem) columns).  The step's transfer
        hops (dvoldt, NMD pressure smoothing) assemble and at once
        re-gather the same nodal field."""
        return eng_scatter_gather(_pack(slot_cols), bt, kg)

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

    def compute_dt_cols(xs, zs, vol, vxs, vzs, shearm, rho_e):
        """CFL dt (geometry.cxx:756-923); mirrors flat2d.compute_dt_cols
        without the hydraulic diffusion limit."""
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
        dt = torch.minimum(
            torch.minimum(dt_elastic, dt_maxwell),
            torch.minimum(dt_advection, dt_diffusion)) * ctrl.dt_fraction
        return dt, vmax, gdtmin

    def update_stress_cols(tab, s, de, edot, sr, bulkm, shearm, temp_e, dt):
        """Constitutive switch (rheology.cxx:676-991) on columns; mirrors
        flat2d.update_stress_cols without the Biot increment and the
        rate-and-state variants."""
        stress = (s.stress[0], s.stress[1], s.stress[2])
        old_tr = stress[0] + stress[1]
        stressyy = s.stressyy
        plstrain, delta_plstrain = s.plstrain, s.delta_plstrain
        viscosity = s.viscosity

        def creep_visc():
            s0 = (stress[0] + stress[1]) / 2.0
            rII2 = 0.25 * (sr[0] - sr[1]) ** 2 + sr[2] ** 2
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
            amc, anphi, anpsi, hardn, ten_max = M.plastic_props(
                tab, s.emw, s.plstrain)
            stress, stressyy, depls, _ = R.elasto_plastic2d_c(
                bulkm, shearm, amc, anphi, anpsi, hardn, ten_max,
                de, stress, s.stressyy)
            plstrain = s.plstrain + depls
            delta_plstrain = depls
        elif rheol == RH_EVP:
            viscosity = creep_visc()
            dv = s.volume / s.volume_old - 1.0
            sv = R.maxwell2_c(bulkm, shearm, viscosity, dt, dv, de,
                              stress)
            svII = 0.25 * (sv[0] - sv[1]) ** 2 + sv[2] ** 2
            amc, anphi, anpsi, hardn, ten_max = M.plastic_props(
                tab, s.emw, s.plstrain)
            sp, spyy, depls, _ = R.elasto_plastic2d_c(
                bulkm, shearm, amc, anphi, anpsi, hardn, ten_max,
                de, stress, s.stressyy)
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
                dpressure)

    def step(ctx, s):
        tab = ctx.mat
        dt = s.dt
        steps = s.steps + 1
        time = s.time + s.dt

        # ONE packed corner gather (coord, vel, T, volume_n), read back as
        # columns; volume_n rides along so the dvoldt/NMD transfer hops
        # can divide their re-gathered nodal sums per corner
        # (elementwise-identical to dividing nodally)
        nodal_pack = torch.cat([s.coord, s.vel, s.temperature[:, None],
                                s.volume_n[:, None]], dim=1)
        slots = cgather(nodal_pack)         # [x z vx vz T volume_n][corner]
        xs = tuple(slots[0, c] for c in range(3))
        zs = tuple(slots[1, c] for c in range(3))
        vxs = tuple(slots[2, c] for c in range(3))
        vzs = tuple(slots[3, c] for c in range(3))
        ts = tuple(slots[4, c] for c in range(3))
        vns = tuple(slots[5, c] for c in range(3))

        vol = s.volume
        dndx, dndz = shape_fn(xs, zs, vol)
        temp_e = (ts[0] + ts[1] + ts[2]) / npe
        bulkm = M.bulkm(tab, s.emw)
        shearm = M.shearm(tab, s.emw)
        rho_e = M.rho_from_T(tab, s.emw, temp_e)

        # strain rate (fields.cxx:408-483)
        lxx = vxs[0] * dndx[0] + vxs[1] * dndx[1] + vxs[2] * dndx[2]
        lzz = vzs[0] * dndz[0] + vzs[1] * dndz[1] + vzs[2] * dndz[2]
        lxz = 0.5 * (vxs[0] * dndz[0] + vxs[1] * dndz[1]
                     + vxs[2] * dndz[2]
                     + vzs[0] * dndx[0] + vzs[1] * dndx[1]
                     + vzs[2] * dndx[2])
        sr = (lxx, lzz, lxz)

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
        dvs = [gdv[0, c] / vns[c] for c in range(3)]
        edvoldt = (dvs[0] + dvs[1] + dvs[2]) / npe

        adj = (edvoldt - (lxx + lzz)) / 2.0
        edot = (lxx + adj, lzz + adj, lxz)
        de = (edot[0] * dt, edot[1] * dt, edot[2] * dt)
        strain = torch.stack([s.strain[0] + de[0], s.strain[1] + de[1],
                              s.strain[2] + de[2]])
        strain_rate = torch.stack(edot)

        (stress_c, stressyy, plstrain, delta_plstrain, viscosity,
         dpressure) = update_stress_cols(
            tab, s.replace(edvoldt=edvoldt), de, edot, sr, bulkm, shearm,
            temp_e, dt)

        if ctrl.is_using_mixed_stress:
            # NMD pressure smoothing (geometry.cxx:279-331), fused
            # assemble+regather with per-corner volume_n division
            _, gdp = asm_gather([(dpressure * vol,)] * 3, kg=1)
            dps = [gdp[0, c] / vns[c] for c in range(3)]
            ddp = ((dps[0] + dps[1] + dps[2]) / npe - dpressure) / 2.0
            stress_c = (stress_c[0] + ddp, stress_c[1] + ddp, stress_c[2])
        stress = torch.stack(stress_c)

        # force assembly (fields.cxx:612-703)
        phi_e = M.phi_porosity(tab, s.emw)
        if ctrl.gravity != 0:
            buoy = (rho_e * (1.0 - phi_e) + 1000.0 * phi_e) \
                * ctrl.gravity / npe
        else:
            buoy = torch.zeros_like(vol)
        fpack = asm_pack([
            ((stress_c[0] * dndx[c] + stress_c[2] * dndz[c]) * vol,
             (stress_c[2] * dndx[c] + stress_c[1] * dndz[c] + buoy)
             * vol)
            for c in range(3)])
        force = -fpack
        l2_res = F.residual_l2(force)

        # no boundary tractions here: unported_features refuses the
        # configs that have any (bc.apply_stress_bcs, _neumann)
        force = F.apply_damping(force, s.vel, s.mass, s.ymass,
                                ctrl.damping_option, ctrl.damping_factor)
        vel = F.update_velocity(s.vel, force, s.mass, s.dt)
        vel = bc_mod.apply_vbcs(ctx.vbc, vel, s.coord, time)

        # update_mesh (dynearthsol.cxx:431-473)
        if ctrl.has_moving_mesh:
            coord = F.update_coordinate(s.coord, vel, s.dt)
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
            bulk_comp = 1.0 / (bulkm + shearm / npe)
            ab_e = M.alpha_biot(tab, s.emw)
            bf_e = M.beta_fluid(tab, s.emw)
            cp_e = M.cp(tab, s.emw)
            hm_coeff = ab_e + phi_e - ab_e * phi_e
            m = rho_m * volume / npe
            tm = rho_e * cp_e * volume / npe
            hm = (hm_coeff * bulk_comp + phi_e * bf_e) * volume / npe
            ym = 9.0 * bulkm * shearm / (3.0 * bulkm + shearm) / npe
            mpack = asm_pack([(volume, m, tm, hm, ym)] * 3)
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
            dt=dt_out, time=time, steps=steps,
            max_global_vel_mag=vmax, global_dt_min=gdtmin, **upd_avg)

    return step


def make_chunk_runner(param: Param, ctx, compensation_pressure: float,
                      n: int, plain: bool = False):
    """run(ctx, state) -> state after n flat steps: transpose the element
    tensors, step n times, transpose back (the counterpart of
    flat2d.make_chunk_runner, with its arguments).  The Winkler reference
    pressure ``compensation_pressure`` is read by the facet tractions only,
    which unported_features refuses."""
    step = make_flat_step(param, ctx, plain)

    def run_chunk(sctx, state):
        g = state_to_flat(state)
        for _ in range(n):
            g = step(sctx, g)
        return flat_to_state(g)

    return run_chunk
