"""Simulation driver: initialisation + the chunked time loop (counterpart
of dynearthsol_tpu/simulation.py).

Mesh, topology, markers and initial conditions are built on the host in
numpy, then the state moves to ``device`` (the card unless the caller asks
for the CPU).  The time loop dispatches in the JAX package's order: in 2D
(ops/fused2d.py) the resident chunk runner where the JAX package picks
``pallas2d_res`` and the tiled runner where it picks ``pallas2d``; in 3D
(ops/fused3d.py) the fused 5-tet step where it picks ``pallas3d``; then the
column step of ops/flat2d.py (any 2D triangle mesh) where it picks
``flat2d``, and in its generic mode where it picks ``generic`` in 2D; and
the column step of ops/flat3d.py (any tetrahedral mesh) where it picks
``flat3d``.  The JAX package's ``grid2d``, ``grid3d`` and 3D generic steps
are not ported yet; a configuration that needs one raises
``NotImplementedError`` naming it.  The JAX package's switches
``DES_NO_PALLAS`` (no fused step) and ``DES_NO_FLAT`` (no column step) are
read where it reads them, when a chunk runner is built.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from functools import partial
from typing import Optional

import numpy as np
import torch

from . import bc as bc_mod
from . import ic as ic_mod
from . import markers as mk
from .config import (RH_ELASTIC, RH_EP, RH_EP_RSF, RH_EVP, RH_EVP_RSF,
                     RH_MAXWELL, RH_VISCOUS, Param)
from .constants import BOUNDZ1, IBOUNDZ0
from .mesh import MeshData, build_topology, create_new_mesh
from .ops import band2d, flat2d, flat3d, fused2d, fused3d
from .ops import geometry as G
from .ops import matprops as M
from .ops import surface as SP
from .ops.assembly import node_sum
from .ops.shapefn import compute_volume
from .ops.structured import detect_structured_2d, detect_structured_3d
from .state import State, allocate_state


@dataclass(frozen=True)
class StepCtx:
    """Per-mesh context for the step: topology tensors on the run's device
    and the static boundary/material descriptions."""

    ndims: int
    nnode: int
    nelem: int
    conn: torch.Tensor          # (nelem, ndims + 1) int64
    gather_idx: torch.Tensor    # (nnode, max_degree) int64
    gather_mask: torch.Tensor   # (nnode, max_degree) bool
    top_mask: torch.Tensor      # (nnode,) bool, BOUNDZ1 nodes (Dirichlet T)
    pp_bc_mask: torch.Tensor    # (nnode,) bool, Dirichlet pore-pressure nodes
    vbc: bc_mod.VBCSpec
    sbc: bc_mod.StressBCSpec
    mat: M.MatTables
    surf: SP.SurfInfo
    max_vbc_val: float
    # (nx, nz) / (nx, ny, nz) when the mesh is the raster structured grid
    sgrid: Optional[tuple] = None
    # gather/assembly tables of the flat step, attached at its dispatch
    band: Optional[band2d.GatherTables] = None


def make_finalize_fn(param: Param, *, with_dt: bool = True,
                     with_mass: bool = True):
    """Initialisation and restart tail (dynearthsol.cxx:186-190, 411-420):
    apply vbcs -> [CFL dt] -> [(pseudo-)masses] -> viscosity.  Plain
    PyTorch: it runs once."""
    ctrl = param.control

    def fin(ctx: StepCtx, s: State) -> State:
        vel = bc_mod.apply_vbcs(ctx.vbc, s.vel, s.coord, s.time)
        s = s.replace(vel=vel)
        bulkm = M.bulkm(ctx.mat, s.emw)
        shearm = M.shearm(ctx.mat, s.emw)
        rho_e = M.rho(ctx.mat, s.emw, s.temperature, ctx.conn)
        if with_dt:
            s = _with_dt(s, ctx, vel, shearm, rho_e)
        if with_mass:
            s = _with_mass(s, ctx, bulkm, shearm, rho_e)
        viscosity = M.visc(ctx.mat, s.emw, s.temperature, ctx.conn,
                           s.stress, s.strain_rate)
        return s.replace(viscosity=viscosity)

    def _with_dt(s, ctx, vel, shearm, rho_e):
        hydro = s.hydro_diff_max if ctrl.has_hydraulic_diffusion else None
        dt, vmax, gdtmin = G.compute_dt(
            s.coord, ctx.conn, s.volume, vel, shearm, rho_e,
            ctx.mat.visc_min, ctx.mat.therm_diff_max, ctx.max_vbc_val,
            fixed_dt=ctrl.fixed_dt, dt_fraction=ctrl.dt_fraction,
            inertial_scaling=ctrl.inertial_scaling,
            is_quasi_static=ctrl.is_quasi_static,
            has_thermal_diffusion=ctrl.has_thermal_diffusion,
            use_global_velocity_scaling=ctrl.use_global_velocity_scaling,
            bulk_modulus_ref=param.mat.bulk_modulus[param.mat.mattype_ref],
            rho0_ref=param.mat.rho0[param.mat.mattype_ref],
            hydro_diff_max=hydro)
        return s.replace(dt=dt, max_global_vel_mag=vmax,
                         global_dt_min=gdtmin)

    def _with_mass(s, ctx, bulkm, shearm, rho_e):
        volume_n, mass, tmass, hmass, ymass = G.compute_mass(
            s.volume, bulkm, shearm, rho_e, M.cp(ctx.mat, s.emw),
            M.phi_porosity(ctx.mat, s.emw), M.alpha_biot(ctx.mat, s.emw),
            M.beta_fluid(ctx.mat, s.emw),
            lambda c: node_sum(c, ctx.gather_idx, ctx.gather_mask),
            pseudo_speed=ctx.max_vbc_val * ctrl.inertial_scaling,
            pseudo_speed_atp=s.max_global_vel_mag * ctrl.inertial_scaling,
            is_quasi_static=ctrl.is_quasi_static,
            use_global_velocity_scaling=ctrl.use_global_velocity_scaling,
            ndims=ctx.ndims,
            has_hydraulic_diffusion=ctrl.has_hydraulic_diffusion)
        return s.replace(volume_n=volume_n, mass=mass, tmass=tmass,
                         hmass=hmass, ymass=ymass)

    return fin


def _jax_path_name(param: Param, ctx: StepCtx) -> str:
    """The JAX package's step path for a config off the fused gates
    (grid2d/grid3d.grid_step_applicable, flat3d.flat3d_step_applicable,
    else the generic step; ``flat2d`` where the flat gate holds).  With
    ``DES_NO_FLAT`` set the flat paths give way to the generic step, as
    in the JAX dispatch (simulation.py:1411, :1422)."""
    ctrl, rheol = param.control, param.mat.rheol_type
    basic = (RH_ELASTIC, RH_VISCOUS, RH_MAXWELL, RH_EP, RH_EVP)
    no_flat = bool(os.environ.get("DES_NO_FLAT"))
    if ctx.ndims == 3:
        if fused3d.grid_step_applicable(param, ctx):
            return "grid3d"
        if rheol in basic + (RH_EP_RSF, RH_EVP_RSF) and not no_flat:
            return "flat3d"
        return "generic"
    if (ctx.sgrid is not None and not ctrl.has_hydraulic_diffusion
            and not ctrl.has_PT and rheol in basic
            and (rheol not in (RH_EP, RH_EVP) or param.mat.is_plane_strain)):
        return "grid2d"
    if flat2d.flat_step_applicable(param, ctx) and not no_flat:
        return "flat2d"
    return "generic"


def _detect_sgrid(topo):
    if topo.ndims == 2:
        return detect_structured_2d(topo.connectivity, topo.nnode)
    return detect_structured_3d(topo.connectivity, topo.nnode)


class Simulation:
    """End-to-end simulation: mesh/topology/IC on the host, stepping on
    ``device``.  The default device is the card ("cuda"); without one the
    constructor raises rather than run on the CPU, which a caller asks for
    with ``device="cpu"``.  ``_restart`` is the array dict of
    io/restart.read_frame (io/restart.restart builds it)."""

    def __init__(self, param: Param, device=None,
                 _restart: Optional[dict] = None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Simulation runs on the CUDA device by default and "
                    "none is available; pass device='cpu' to run the "
                    "plain PyTorch versions on the CPU")
            device = "cuda"
        if param.ic.temperature_option == 3:
            raise NotImplementedError("the dome geotherm is not ported yet")
        self.param = param
        self.device = torch.device(device)
        self.dtype = torch.float64 if param.sim.float_dtype == "float64" \
            else torch.float32
        if _restart is not None:
            mesh = MeshData(param.sim.ndims, _restart["coord"],
                            _restart["conn"])
            topo = _restart["topo"]
        elif param.mesh.mesh_from_run:
            # the reference binary's own mesh, node for node
            from .io.restart import load_mesh_from_run
            mesh, topo = load_mesh_from_run(param.mesh.mesh_from_run,
                                            param.mesh.mesh_from_run_frame)
        else:
            mesh = create_new_mesh(param)
            topo = build_topology(mesh, param.mesh.xlength,
                                  param.mesh.ylength, param.mesh.zlength)
        self.mesh = mesh
        self.topo = topo
        dev = self.device
        max_vbc_val = (param.control.characteristic_speed
                       if param.control.characteristic_speed != 0
                       else bc_mod.find_max_vbc(param.bc, param.sim.ndims))
        self.ctx = StepCtx(
            ndims=param.sim.ndims, nnode=topo.nnode, nelem=topo.nelem,
            conn=torch.as_tensor(topo.connectivity, device=dev).long(),
            gather_idx=torch.as_tensor(topo.gather_idx, device=dev).long(),
            gather_mask=torch.as_tensor(topo.gather_mask, device=dev),
            top_mask=torch.as_tensor((topo.bcflag & BOUNDZ1) != 0,
                                     device=dev),
            pp_bc_mask=torch.as_tensor(
                bc_mod.pp_bc_mask(param.bc, topo.bcflag), device=dev),
            vbc=bc_mod.VBCSpec.from_param(param, topo.bcflag, device=dev),
            sbc=bc_mod.StressBCSpec.from_topo(param, topo),
            mat=M.MatTables.from_param(param.mat, dtype=self.dtype,
                                       device=dev),
            surf=SP.make_surf_info(topo), max_vbc_val=max_vbc_val,
            sgrid=_detect_sgrid(topo))
        # driver scalars (parameters.hpp Variables), checkpointed with the
        # state; the Winkler reference pressure is set by the initial
        # stress state
        self.info_display_next_step = param.sim.info_display_step_interval
        self.reference_frame_time = 0.0
        self.compensation_pressure = 0.0
        self.bottom_temperature = param.bc.mantle_temperature
        if _restart is None:
            self.state = self._init_state()
        else:
            self.state = self._restart_state(_restart)
        self._chunk_fns = {}
        # name of the dispatched step implementation, set by _chunk_fn:
        # "pallas2d_res", "pallas2d", "pallas3d", "flat2d", "generic" (2D)
        # or "flat3d", the JAX package's names
        self.step_path = None

    def _dev(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               device=self.device).to(self.dtype)

    # ---- init (dynearthsol.cxx:158-225) ----
    def _init_state(self) -> State:
        param, topo, ctx = self.param, self.topo, self.ctx
        s = allocate_state(topo.nnode, topo.nelem, ctx.ndims,
                           param.mat.nmat, netop=ctx.surf.etop,
                           dtype=self.dtype, device=self.device)
        coord = self._dev(self.mesh.coord)
        volume = compute_volume(coord, ctx.conn)

        # markers BEFORE the temperature/stress ICs (dynearthsol.cxx:172
        # vs :202-203): the half-space diffusivity and lithostatic bulk
        # modulus are element 0's marker mixtures (ic.cxx:845, :333)
        if param.markers.markers_per_element > 0:
            self.markers = mk.create_markers(param, self.mesh.coord,
                                             topo.connectivity)
            emw_h = mk.emw_from_markers(self.markers, topo.nelem,
                                        param.mat.nmat)
        else:
            self.markers = None
            emw_h = ic_mod.initial_material_weights(
                param, self.mesh.coord, topo.connectivity)

        temperature_h = ic_mod.initial_temperature(param, self.mesh.coord,
                                                   emw0=emw_h[0])
        bot = topo.bnodes[IBOUNDZ0]
        if len(bot):
            self.bottom_temperature = float(temperature_h[bot[0]])
        stress, stressyy, old_mean, strain, self.compensation_pressure = \
            ic_mod.initial_stress_state(param, self.mesh.coord,
                                        topo.connectivity, emw=emw_h)
        plstrain = ic_mod.initial_weak_zone(param, self.mesh.coord,
                                            topo.connectivity)
        emw = self._dev(emw_h)
        extra = {}
        if param.control.has_hydraulic_diffusion:
            extra["ppressure"] = self._dev(ic_mod.initial_hydrostatic_state(
                param, self.mesh.coord, topo.bcflag))
        if param.mat.rheol_type in (RH_EP_RSF, RH_EVP_RSF):
            # from the weights in the run's dtype, as the JAX package
            dfc0, sv0 = ic_mod.initial_rsf_state(param,
                                                 emw.cpu().numpy())
            extra.update(dyn_fric_coeff=self._dev(dfc0),
                         state_variable=self._dev(sv0))
        s = s.replace(
            coord=coord, coord0=coord, volume=volume, volume_old=volume,
            temperature=self._dev(temperature_h),
            stress=self._dev(stress), stressyy=self._dev(stressyy),
            old_mean_stress=self._dev(old_mean), strain=self._dev(strain),
            plstrain=self._dev(plstrain),
            radiogenic_source=self._dev(ic_mod.initial_radiogenic_source(
                param, self.mesh.coord, topo.connectivity)),
            emw=emw, hydro_diff_max=self._dev(1e-1), **extra)
        return make_finalize_fn(param)(ctx, s)

    # ---- restart (dynearthsol.cxx:227-420) ----
    def _restart_state(self, r: dict) -> State:
        """The state of a checkpointed frame.  With the exact-restart
        extras of io/output.py (volume, the masses, old_mean_stress) the
        run continues bit for bit; without them (the reference's files)
        volume and the masses are recomputed."""
        param, topo, ctx = self.param, self.topo, self.ctx
        s = allocate_state(topo.nnode, topo.nelem, ctx.ndims,
                           param.mat.nmat, netop=ctx.surf.etop,
                           dtype=self.dtype, device=self.device)

        def a(name, default):
            return self._dev(r[name]) if name in r else default

        coord = self._dev(r["coord"])
        volume = a("volume", None)
        if volume is None:
            volume = compute_volume(coord, ctx.conn)
        self.markers = r.get("markers")
        emw = s.emw
        if self.markers is not None:
            emw = self._dev(mk.emw_from_markers(self.markers, topo.nelem,
                                                param.mat.nmat))
        scal = r["scalars"]
        self.info_display_next_step = int(scal[1])
        self.compensation_pressure = float(scal[2])
        self.bottom_temperature = float(scal[3])
        self.reference_frame_time = float(scal[6])
        s = s.replace(
            coord=coord, coord0=a("coord0", coord), vel=a("vel", s.vel),
            temperature=a("temperature", s.temperature),
            ppressure=a("ppressure", s.ppressure), volume=volume,
            volume_old=a("volume_old", volume),
            stress=a("stress", s.stress), stressyy=a("stressyy", s.stressyy),
            strain=a("strain", s.strain), plstrain=a("plstrain", s.plstrain),
            delta_plstrain=a("delta_plstrain", s.delta_plstrain),
            old_mean_stress=a("old_mean_stress", s.old_mean_stress),
            state_variable=a("state_variable", s.state_variable),
            dhacc=a("dhacc", s.dhacc),
            edvacc_surf=a("edvacc_surf", s.edvacc_surf), emw=emw,
            time=self._dev(scal[0]), dt=self._dev(scal[4]),
            steps=torch.tensor(r["steps"], dtype=torch.int64,
                               device=self.device),
            max_global_vel_mag=self._dev(scal[5]),
            hydro_diff_max=self._dev(1e-1))
        if "old_mean_stress" not in r and "stress" in r \
                and param.control.has_hydraulic_diffusion:
            # the reference's files lack it: the saved stress's mean
            # (JAX simulation.py:914-918)
            st = np.asarray(r["stress"])[:, :ctx.ndims]
            s = s.replace(old_mean_stress=self._dev(
                st.sum(axis=1) / ctx.ndims))
        if param.ic.is_restarting_weakzone:
            # the weak zone re-created on the restored geometry
            # (dynearthsol.cxx:386-389) overwrites the saved plstrain
            s = s.replace(plstrain=self._dev(ic_mod.initial_weak_zone(
                param, np.asarray(r["coord"], dtype=np.float64),
                topo.connectivity)))
        # re-apply vbcs, recompute the masses unless saved
        # (dynearthsol.cxx:411-420)
        if "mass" in r:
            s = s.replace(volume_n=self._dev(r["volume_n"]),
                          mass=self._dev(r["mass"]),
                          tmass=self._dev(r["tmass"]),
                          hmass=self._dev(r["hmass"]),
                          ymass=self._dev(r["ymass"]))
            return make_finalize_fn(param, with_dt=False,
                                    with_mass=False)(ctx, s)
        return make_finalize_fn(param, with_dt=False)(ctx, s)

    # ---- derived element fields for output (output.cxx:213-233) ----
    def elem_density(self) -> np.ndarray:
        s = self.state
        return M.rho(self.ctx.mat, s.emw, s.temperature, self.ctx.conn
                     ).detach().cpu().double().numpy()

    def elem_quality(self) -> np.ndarray:
        s = self.state
        return G.elem_quality(s.coord, self.ctx.conn, s.volume
                              ).detach().cpu().double().numpy()

    # ---- stepping ----
    def _chunk_fn(self, n: int):
        if n not in self._chunk_fns:
            param, ctx = self.param, self.ctx
            # the JAX package's order (simulation.py:1356-1420)
            jax_path = _jax_path_name(param, ctx)
            fused = not os.environ.get("DES_NO_PALLAS")
            if fused and fused2d.resident_applicable(param, ctx):
                path, mod = "pallas2d_res", fused2d
                make = fused2d.make_resident_chunk_runner
            elif fused and fused2d.pallas_step_applicable(param, ctx):
                path, mod = "pallas2d", fused2d
                make = fused2d.make_chunk_runner
            elif fused and fused3d.pallas3d_step_applicable(param, ctx):
                path, mod = "pallas3d", fused3d
                make = fused3d.make_chunk_runner
            elif jax_path == "flat2d":
                path, mod = "flat2d", flat2d
                make = flat2d.make_chunk_runner
            elif jax_path == "generic" and flat2d.generic_applicable(param,
                                                                     ctx):
                path, mod = "generic", flat2d
                make = partial(flat2d.make_chunk_runner, generic=True)
            elif jax_path == "flat3d":
                path, mod = "flat3d", flat3d
                make = flat3d.make_chunk_runner
            else:
                raise NotImplementedError(
                    "this config is off the fused steps' gates; the JAX "
                    f"package runs it on its {jax_path!r} path, which is "
                    "not ported yet")
            missing = mod.unported_features(param, ctx)
            if missing:
                raise NotImplementedError(
                    f"the JAX package runs this config on {path!r}, but "
                    "this package's step lacks: " + "; ".join(missing))
            if mod in (flat2d, flat3d) and ctx.band is None:
                # built once per Simulation, for any node numbering
                ctx = self.ctx = replace(ctx, band=band2d.build_tables(
                    self.topo.connectivity, self.topo.nnode, self.device))
            self.step_path = path
            # every runner takes the Winkler reference pressure, as the
            # JAX package's do (simulation.py:1368-1425)
            self._chunk_fns[n] = make(param, ctx, self.compensation_pressure,
                                      n)
        return self._chunk_fns[n]

    def run_steps(self, n: int, chunk: Optional[int] = None) -> State:
        """Advance n steps, ``chunk`` steps per runner call."""
        chunk = chunk or min(n, self.param.sim.scan_chunk_steps or 100)
        done = 0
        while done < n:
            c = min(chunk, n - done)
            self.state = self._chunk_fn(c)(self.ctx, self.state)
            done += c
        return self.state
