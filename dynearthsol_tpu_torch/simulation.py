"""Simulation driver: initialisation + the chunked time loop (counterpart
of dynearthsol_tpu/simulation.py).

Mesh, topology, markers and initial conditions are built on the host in
numpy, then the state moves to ``device`` (the card unless the caller asks
for the CPU).  The time loop dispatches in the JAX package's order: in 2D
(ops/fused2d.py) the resident chunk runner where the JAX package picks
``pallas2d_res`` and the tiled runner where it picks ``pallas2d``; in 3D
(ops/fused3d.py) the fused 5-tet step where it picks ``pallas3d``; then
the structured plane steps of ops/grid2d.py and ops/grid3d.py where it
picks ``grid2d`` or ``grid3d`` (a raster mesh off the fused gates: float64,
or a feature or layout they refuse); the column step of ops/flat2d.py
(any 2D triangle mesh) where it picks ``flat2d``, and in its generic mode
where it picks ``generic`` in 2D; and the column step of ops/flat3d.py
(any tetrahedral mesh) where it picks ``flat3d``, and in its generic mode
where it picks ``generic`` in 3D.  The isostasy and body-force
pre-relaxations (``isostasy_adjustment``, ``body_force_adjustment``) run
before the first step on the column steps' pieces, on any mesh.  The JAX
package's switches
``DES_NO_PALLAS`` (no fused step: the raster meshes go to the plane
steps) and ``DES_NO_FLAT`` (no column step) are read where it reads them,
when a chunk runner is built.  A remesh
(remeshing.remesh) gives the Simulation a new topology, mesh, context and
state (``_set_mesh``); the chunk runners and band tables of the old mesh
are dropped and built for the new one at the next chunk, on the path the
new mesh takes.  The surface-marker bookkeeping (``sync_surface_markers``)
runs on the host at the CLI's quality-check cadence, and the surface
increments of GoSPL and the custom hook (``apply_host_surface_dh``) and
the phase changes (phasechanges.py, on ``markers`` and
``hydrous_markers``) at its wakes; the dome geotherm (temperature_option
3) turns the markers in its adiabatic region into asthenosphere.
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
from .constants import BOUNDZ0, BOUNDZ1, IBOUNDZ0, YEAR2SEC
from .mesh import (MeshData, build_topology, build_topology_from_arrays,
                   create_new_mesh)
from .ops import band2d, flat2d, flat3d, fused2d, fused3d, grid2d, grid3d
from .ops import fields as F
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
    # a shard's context under a group of devices (parallel/): its handle
    # on the group (parallel.group.ShardAxis), for the node-sharded halo
    # step its node window (ops/assembly.HaloSpec), and 1/0 on its real
    # elements; None on one device
    axis: Optional[object] = None
    halo: Optional[object] = None
    elem_mask: Optional[torch.Tensor] = None


def make_finalize_fn(param: Param, *, with_dt: bool = True,
                     with_mass: bool = True):
    """Initialisation, restart and remesh tail (dynearthsol.cxx:186-190,
    411-420, remeshing.cxx:3048-3080): apply vbcs -> [CFL dt] ->
    [(pseudo-)masses] -> viscosity.  After a remesh ``dv`` (the remapped
    volume / volume_old - 1) gives volume_old against the new volumes
    first.  Plain PyTorch: it runs once per event."""
    ctrl = param.control

    def fin(ctx: StepCtx, s: State, dv=None) -> State:
        if dv is not None:
            s = s.replace(volume_old=s.volume / (1.0 + dv))
        vel = bc_mod.apply_vbcs(ctx.vbc, s.vel, s.coord, s.time)
        s = s.replace(vel=vel)
        bulkm = M.bulkm(ctx.mat, s.emw)
        shearm = M.shearm(ctx.mat, s.emw)
        rho_e = M.rho(ctx.mat, s.emw, s.temperature, ctx.conn)
        if with_dt:
            s = _with_dt(s, ctx, vel, shearm, rho_e)
        if with_mass:
            s = with_mass_fields(param, ctx, s, bulkm, shearm, rho_e)
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

    return fin


def with_mass_fields(param: Param, ctx: StepCtx, s: State, bulkm=None,
                     shearm=None, rho_e=None) -> State:
    """``s`` with its nodal volume and (pseudo-)masses recomputed from its
    volume and weights (geometry.cxx:1020-1154): the finalize's mass part,
    and the mass tail of a host-applied surface increment."""
    ctrl = param.control
    if bulkm is None:
        bulkm = M.bulkm(ctx.mat, s.emw)
        shearm = M.shearm(ctx.mat, s.emw)
        rho_e = M.rho(ctx.mat, s.emw, s.temperature, ctx.conn)
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


def _jax_path_name(param: Param, ctx: StepCtx) -> str:
    """The JAX package's step path for a config off the fused gates
    (grid2d/grid3d.grid_step_applicable, flat3d.flat3d_step_applicable,
    else the generic step; ``flat2d`` where the flat gate holds).  With
    ``DES_NO_FLAT`` set the flat paths give way to the generic step, as
    in the JAX dispatch (simulation.py:1411, :1422)."""
    rheol = param.mat.rheol_type
    no_flat = bool(os.environ.get("DES_NO_FLAT"))
    if ctx.ndims == 3:
        if grid3d.grid_step_applicable(param, ctx):
            return "grid3d"
        if rheol in (RH_ELASTIC, RH_VISCOUS, RH_MAXWELL, RH_EP, RH_EVP,
                     RH_EP_RSF, RH_EVP_RSF) and not no_flat:
            return "flat3d"
        return "generic"
    if grid2d.grid_step_applicable(param, ctx):
        return "grid2d"
    if flat2d.flat_step_applicable(param, ctx) and not no_flat:
        return "flat2d"
    return "generic"


def _detect_sgrid(topo):
    if topo.ndims == 2:
        return detect_structured_2d(topo.connectivity, topo.nnode)
    return detect_structured_3d(topo.connectivity, topo.nnode)


def make_step_ctx(param: Param, topo, device, mat: M.MatTables,
                  max_vbc_val: float, sgrid, coord: np.ndarray) -> StepCtx:
    """The step context of ``topo`` on ``device``: at initialisation and
    after every remesh (with no band tables: ``_chunk_fn`` builds them for
    the mesh it steps).  ``coord`` gives the inclined boundaries'
    normals."""
    return StepCtx(
        ndims=param.sim.ndims, nnode=topo.nnode, nelem=topo.nelem,
        conn=torch.as_tensor(topo.connectivity, device=device).long(),
        gather_idx=torch.as_tensor(topo.gather_idx, device=device).long(),
        gather_mask=torch.as_tensor(topo.gather_mask, device=device),
        top_mask=torch.as_tensor((topo.bcflag & BOUNDZ1) != 0,
                                 device=device),
        pp_bc_mask=torch.as_tensor(bc_mod.pp_bc_mask(param.bc, topo.bcflag),
                                   device=device),
        vbc=bc_mod.VBCSpec.from_param(param, topo.bcflag, device=device,
                                      topo=topo, coord=coord),
        sbc=bc_mod.StressBCSpec.from_topo(param, topo), mat=mat,
        surf=SP.make_surf_info(topo), max_vbc_val=max_vbc_val, sgrid=sgrid)


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
            if mesh.segment is not None and mesh.segment.size:
                # the mesher's own segments (Exodus side sets, the 3D
                # .poly facets, a 2D .poly's kept internal segments) flag
                # the nodes in place of the box coordinate tests
                # (create_boundary_flags from segment flags, mesh.cxx:2811;
                # JAX simulation.py:684-697)
                bcflag = np.zeros(mesh.nnode, dtype=np.uint32)
                for seg, fl in zip(mesh.segment, mesh.segflag):
                    bcflag[seg] |= np.uint32(fl)
                topo = build_topology_from_arrays(
                    param.sim.ndims, mesh.connectivity, bcflag,
                    mesh.segment, mesh.segflag)
            else:
                topo = build_topology(mesh, param.mesh.xlength,
                                      param.mesh.ylength,
                                      param.mesh.zlength)
        self.mesh = mesh
        self.topo = topo
        dev = self.device
        max_vbc_val = (param.control.characteristic_speed
                       if param.control.characteristic_speed != 0
                       else bc_mod.find_max_vbc(param.bc, param.sim.ndims))
        self.ctx = make_step_ctx(
            param, topo, dev,
            M.MatTables.from_param(param.mat, dtype=self.dtype, device=dev),
            max_vbc_val, _detect_sgrid(topo), mesh.coord)
        # driver scalars (parameters.hpp Variables), checkpointed with the
        # state; the Winkler reference pressure is set by the initial
        # stress state
        self.info_display_next_step = param.sim.info_display_step_interval
        self.reference_frame_time = 0.0
        self.compensation_pressure = 0.0
        self.bottom_temperature = param.bc.mantle_temperature
        # the hydrous markers of phase changes (phasechanges.py); a restart
        # starts without them, as the JAX package's does
        self.hydrous_markers = None
        if _restart is None:
            self.state = self._init_state()
        else:
            self.state = self._restart_state(_restart)
        self._chunk_fns = {}
        # name of the dispatched step implementation, set by _chunk_fn:
        # "pallas2d_res", "pallas2d", "pallas3d", "grid2d", "grid3d",
        # "flat2d", "flat3d" or "generic", the JAX package's names
        self.step_path = None
        # remeshing_option 100's frozen structured dims, set by the first
        # structured regeneration (remesh_impl.remesh_simulation)
        self._struct_regen_dims = None
        # host seconds of the last remesh, by part (remesh_simulation)
        self.remesh_seconds = None
        # the last body-force pre-relaxation's PT iterations and host reads
        self.prerelax_stats = None
        # the metric-driven remeshing's frozen initial nodal element size,
        # set at the first remesh and carried to the new nodes at each
        # (remesh_impl.compute_init_elem_size_n)
        self.init_elem_size_n = None

    def _set_mesh(self, topo, mesh: MeshData, sgrid) -> None:
        """Take a regenerated mesh: its topology, a new step context on
        the run's device, and no chunk runner or band table of the old
        mesh (the runners pack the context's tables when built).
        ``step_path`` keeps the last path run until the next chunk."""
        ctx = self.ctx
        self.topo, self.mesh = topo, mesh
        self.ctx = make_step_ctx(self.param, topo, self.device, ctx.mat,
                                 ctx.max_vbc_val, sgrid, mesh.coord)
        self._chunk_fns = {}

    def _dev(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               device=self.device).to(self.dtype)

    @staticmethod
    def _host(t) -> np.ndarray:
        """A state field on the host in float64, as the JAX package's host
        code reads it."""
        return t.detach().cpu().double().numpy()

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
        # modulus are element 0's marker mixtures (ic.cxx:845, :333); a
        # .poly or Exodus mesh's regional attributes give the materials
        regattr = self.mesh.regattr
        if param.markers.markers_per_element > 0:
            self.markers = mk.create_markers(param, self.mesh.coord,
                                             topo.connectivity,
                                             regattr=regattr)
            if param.ic.temperature_option == 3:
                # markers inside the adiabatic region become asthenosphere
                # (ic.cxx:820-830: the eta-weighted nodal in_asth >= 0.5
                # flips the marker's mattype)
                in_asth = ic_mod.dome_geotherm(
                    param, self.mesh.coord)[1].astype(float)
                ms = self.markers
                n = ms.n
                w = (in_asth[topo.connectivity[ms.elem[:n]]]
                     * ms.eta[:n]).sum(axis=1)
                ms.mattype[:n] = np.where(
                    w >= 0.5, param.mat.mattype_asthenosphere,
                    ms.mattype[:n])
            emw_h = mk.emw_from_markers(self.markers, topo.nelem,
                                        param.mat.nmat)
        else:
            self.markers = None
            emw_h = ic_mod.initial_material_weights(
                param, self.mesh.coord, topo.connectivity, regattr=regattr)

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

    # ---- pre-run relaxations (dynearthsol.cxx:476-571) ----
    def _column_pieces(self, plain: bool = False):
        """The column step's pieces (ops/flat2d.py, ops/flat3d.py
        ``step.pieces``) on this mesh, in the generic step's form (its
        stress update is the JAX package's ``_update_stress``): the
        pre-relaxations are built from them on any mesh, so they launch
        the band kernels on the card.  The band tables are built once per
        mesh, as for a column-step chunk.  ``plain`` takes the kernels'
        plain versions on the state's device."""
        if self.ctx.band is None:
            self.ctx = replace(self.ctx, band=band2d.build_tables(
                self.topo.connectivity, self.topo.nnode, self.device))
        mod = flat3d if self.ctx.ndims == 3 else flat2d
        return mod.make_flat_step(self.param, self.ctx,
                                  self.compensation_pressure, plain=plain,
                                  generic=True).pieces

    def isostasy_adjustment(self, plain: bool = False) -> int:
        """Vertical-only relaxation toward isostatic equilibrium before the
        run starts (isostasy_adjustment, dynearthsol.cxx:476-524; JAX
        simulation.py:933-1023): step the momentum balance with free
        boundaries, zeroing the horizontal velocity (and the bottom's
        vertical velocity without a Winkler foundation), for
        isostasy_adjustment_time_in_yr at the initial dt.  dt, time and
        steps do not advance; the mass is recomputed every step.  Returns
        the number of steps."""
        param = self.param
        yr = param.ic.isostasy_adjustment_time_in_yr
        if yr <= 0:
            return 0
        dt0 = float(self.state.dt)
        iso_steps = max(int(yr * YEAR2SEC / dt0), 1)
        P = self._column_pieces(plain)
        bottom = None
        if not param.bc.has_winkler_foundation:
            bottom = torch.as_tensor((self.topo.bcflag & BOUNDZ0) != 0,
                                     device=self.device)
        g = flat2d.state_to_flat(self.state)
        for _ in range(iso_steps):
            g = _isostasy_step(P, param, self.ctx, g, bottom)
        self.state = flat2d.flat_to_state(g)
        return iso_steps

    def body_force_adjustment(self, plain: bool = False) -> int:
        """Pre-run gravity relaxation by pseudo-transient iteration
        (initial_body_force_adjustment, dynearthsol.cxx:526-571, invoked
        at :731-739; JAX simulation.py:1025-1135): the pseudo-transient
        loop of the column steps from the initial state, with zeroed
        boundary-velocity values and hydraulic diffusion suspended, the
        facets loaded with the rock's own density, from the state's L2
        residual until its relative change drops below
        PT_relative_tolerance or PT_max_iter is reached; the loop's
        condition is read on the host once per iteration after the first.
        Only with the PT loop, as the reference.  Returns the iteration
        count."""
        param = self.param
        ctrl = param.control
        if not (param.ic.has_body_force_adjustment and ctrl.has_PT):
            return 0
        P = self._column_pieces(plain)
        tab = self.ctx.mat
        g = flat2d.state_to_flat(self.state)
        t = P.gather([g.temperature[:, None]])
        temp_e = P.corner_sum([t[0, c] for c in range(P.NPE)]) / P.npe
        bulkm = M.bulkm(tab, g.emw)
        shearm = M.shearm(tab, g.emw)
        rho_e = M.rho_from_T(tab, g.emw, temp_e)
        phi_e = M.phi_porosity(tab, g.emw)
        if ctrl.gravity != 0:
            buoy = (rho_e * (1.0 - phi_e) + 1000.0 * phi_e) \
                * ctrl.gravity / P.npe
        else:
            buoy = torch.zeros_like(g.volume)
        g = P.pt_loop(self.ctx, g, g, g.l2_residual, g.time, bulkm, shearm,
                      rho_e, phi_e, buoy, temp_e, fluid=False)
        self.state = flat2d.flat_to_state(g)
        self.prerelax_stats = dict(P.stats)
        return P.stats["pt_iterations"]

    # ---- host-applied surface increments (options 11 and 101) ----
    def apply_host_surface_dh(self, dh_top):
        """Apply a surface increment computed on the host (GoSPL coupling,
        surface_process_option 11, and the custom hook, option 101) at a
        wake of the CLI, as the in-step dh is applied (bc.cxx:1727-1760;
        JAX simulation.py:1137-1203): the coordinates, dhacc and each top
        facet's edvacc in float64 on the host, then the volume and the
        masses recomputed on the run's device."""
        surf = self.ctx.surf
        if surf.etop == 0:
            return
        ndims = self.ctx.ndims
        coord = self._host(self.state.coord).copy()
        dh = np.zeros(self.topo.nnode)
        dh[np.asarray(surf.top_nodes)] = np.asarray(dh_top,
                                                    dtype=np.float64)
        coord[:, ndims - 1] += dh
        dhacc = self._host(self.state.dhacc) + dh
        f = np.asarray(surf.facet_nodes)
        dh_e = dh[f].sum(axis=1)
        if ndims == 2:
            base = np.abs(coord[f[:, 1], 0] - coord[f[:, 0], 0])
        else:
            d01 = coord[f[:, 1]] - coord[f[:, 0]]
            d02 = coord[f[:, 2]] - coord[f[:, 0]]
            base = 0.5 * (d01[:, 0] * d02[:, 1] - d01[:, 1] * d02[:, 0])
        edv = self._host(self.state.edvacc_surf) + dh_e * base / ndims
        c = self._dev(coord)
        s = self.state.replace(
            coord=c, volume=compute_volume(c, self.ctx.conn),
            dhacc=self._dev(dhacc), edvacc_surf=self._dev(edv))
        self.state = with_mass_fields(self.param, self.ctx, s)

    # ---- surface marker bookkeeping (host, quality-check cadence) ----
    def _set_emw_from_markers(self):
        self.state = self.state.replace(emw=self._dev(mk.emw_from_markers(
            self.markers, self.topo.nelem, self.param.mat.nmat)))

    def correct_surface_markers(self):
        """Erosion/deposition marker correction (correct_surface_marker,
        markerset.cxx:1529-1735; JAX simulation.py:1205-1254).
        Surface-element markers keep their physical position across the
        accumulated surface motion: each is placed on the pre-dh geometry
        (node z minus dhacc) and its eta recomputed on the current one.
        Markers that fall outside their element are relocated or deleted
        (eroded away), and depleted surface elements are replenished to 3
        markers (markerset.cxx:1692-1720)."""
        if self.markers is None or self.ctx.surf.etop == 0:
            return
        from .barycentric import ETA_TOL, bary_coords
        from .mesh.locate import ElementLocator
        from .remesh_impl import replenish_markers

        dhacc = self._host(self.state.dhacc)
        if not np.abs(dhacc).any():
            return
        coord = self._host(self.state.coord)
        conn = self.topo.connectivity
        ate = np.asarray(self.ctx.surf.all_top_elems)
        ms = self.markers
        idx = np.flatnonzero(np.isin(ms.elem[:ms.n], ate))
        if idx.size == 0:
            return
        coord0 = coord.copy()
        coord0[:, -1] -= dhacc
        e_m = ms.elem[idx]
        pts = np.einsum("mk,mkd->md", ms.eta[idx], coord0[conn[e_m]])
        eta_new = bary_coords(coord, conn, e_m, pts)
        inside = (eta_new >= ETA_TOL).all(axis=1)
        ms.eta[idx[inside]] = eta_new[inside]
        out = idx[~inside]
        if out.size:
            e2, eta2, found = ElementLocator(coord, conn).locate(
                pts[~inside])
            ms.elem[out[found]] = e2[found].astype(ms.elem.dtype)
            ms.eta[out[found]] = eta2[found]
            if (~found).any():
                ms.remove(out[~found])
            replenish_markers(
                ms, coord, conn, self.param,
                self.param.markers.random_seed + int(self.state.steps),
                only_elems=ate, fill_to=3)
        self._set_emw_from_markers()

    def sync_surface_markers(self):
        """Create sediment markers from the accumulated deposition and
        reset the dh accumulator (set_surface_marker, markerset.cxx:261-458;
        JAX simulation.py:1256-1315), after the erosion-side correction
        (bc.cxx:1795-1799 call order).  The CLI calls it at the
        quality-check cadence (bc.cxx:1795-1812)."""
        if self.markers is None or self.ctx.surf.etop == 0:
            return
        self.correct_surface_markers()
        from .barycentric import bary_coords

        param, ndims, ms = self.param, self.ctx.ndims, self.markers
        edv = self._host(self.state.edvacc_surf).copy()
        volume = self._host(self.state.volume)
        coord = self._host(self.state.coord)
        conn = self.topo.connectivity
        top_elems = np.asarray(self.ctx.surf.top_elems)
        facet_nodes = np.asarray(self.ctx.surf.facet_nodes)

        hist = ms.elem_histogram(self.topo.nelem, param.mat.nmat)
        nmark = np.maximum(hist.sum(axis=1)[top_elems], 1.0)
        edv[edv < 0] = 0.0
        sel = np.nonzero(nmark * edv >= volume[top_elems])[0]
        if sel.size:
            rng = np.random.default_rng(
                param.markers.random_seed + int(self.state.steps))
            e = top_elems[sel]
            dv_apply = volume[e] / nmark[sel]
            fverts = coord[facet_nodes[sel]]         # (k, ndims, ndims)
            # random point on the top facet, lowered by 0.8 * dv/base
            # (marker_dh_applied_ratio, markerset.cxx:268)
            w = rng.random((sel.size, ndims))
            w /= w.sum(axis=1, keepdims=True)
            pts = np.einsum("kf,kfd->kd", w, fverts)
            if ndims == 2:
                base = np.abs(fverts[:, 1, 0] - fverts[:, 0, 0])
            else:
                d01 = fverts[:, 1] - fverts[:, 0]
                d02 = fverts[:, 2] - fverts[:, 0]
                base = 0.5 * (d01[:, 0] * d02[:, 1] - d01[:, 1] * d02[:, 0])
            pts[:, ndims - 1] -= 0.8 * dv_apply / np.maximum(base, 1e-300)
            eta = bary_coords(coord, conn, e, pts)
            eta = np.clip(eta, 0.0, None)
            eta /= eta.sum(axis=1, keepdims=True)
            ms.append(eta, e.astype(np.int32), param.mat.mattype_sed,
                      time=float(self.state.time), z=pts[:, ndims - 1],
                      distance=pts[:, 0], genesis=2)
            edv[sel] -= dv_apply
            self._set_emw_from_markers()
        # reset dhacc after the marker correction (bc.cxx:1800-1806)
        self.state = self.state.replace(
            edvacc_surf=self._dev(edv),
            dhacc=torch.zeros_like(self.state.dhacc))

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
            elif jax_path in ("grid2d", "grid3d"):
                # the structured plane step: the state goes to planes once
                # per chunk (simulation.py:1390-1405)
                mod = grid2d if jax_path == "grid2d" else grid3d
                path, make = jax_path, mod.make_chunk_runner
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
            elif jax_path == "generic" and flat3d.generic_applicable(param,
                                                                     ctx):
                path, mod = "generic", flat3d
                make = partial(flat3d.make_chunk_runner, generic=True)
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
                # built once per mesh (a remesh drops them), for any node
                # numbering
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

    def step_once(self) -> State:
        """Advance one step through the one-step chunk runner."""
        self.state = self._chunk_fn(1)(self.ctx, self.state)
        return self.state


def _isostasy_step(P, param: Param, ctx: StepCtx, s: State, bottom):
    """One step of the isostasy pre-relaxation on flat column state, from
    the column pieces ``P`` (JAX simulation.py:958-1015): strain rate,
    dvoldt, the stress update, the force with its facet tractions (the
    fluid-filled rock's density under hydraulic diffusion, no Neumann
    tractions) and damping, the velocity with its horizontal components
    zeroed (and the vertical one at the ``bottom`` nodes when given), the
    moved coordinates, volume and masses."""
    ctrl = param.control
    tab = ctx.mat
    nd, npe = P.ndims, P.npe
    hydraulic = ctrl.has_hydraulic_diffusion
    cols = [s.coord, s.vel, s.temperature[:, None]]
    if hydraulic:
        cols.append(s.dppressure[:, None])
    cols.append(s.volume_n[:, None])
    g = P.gather(cols)

    def csum(j):
        return P.corner_sum([g[j, c] for c in range(P.NPE)])

    X, V = P.corners(g, 0), P.corners(g, nd)
    temp_e = csum(2 * nd) / npe
    vol = s.volume
    dnd = P.shape_fn(X, vol)
    bulkm = M.bulkm(tab, s.emw)
    shearm = M.shearm(tab, s.emw)
    rho_e = M.rho_from_T(tab, s.emw, temp_e)
    phi_e = M.phi_porosity(tab, s.emw)
    sr = P.strain_rate(V, dnd)
    _, gdv = P.asm_gather([(P.div(sr) * vol,)] * P.NPE, kg=1)
    edv = P.corner_sum([gdv[0, c] / g[-1, c] for c in range(P.NPE)]) / npe
    edot = P.anti_lock(sr, edv)
    de = tuple(e * s.dt for e in edot)
    dpp = (M.alpha_biot(tab, s.emw) * csum(2 * nd + 1) / npe
           if hydraulic else None)
    vmean = (tuple(P.corner_sum(v) / npe for v in V)
             if param.mat.rheol_type in (RH_EP_RSF, RH_EVP_RSF) else None)
    (stress_c, stressyy, plstrain, delta_plstrain, viscosity, dpressure,
     _, _) = P.update_stress(tab, s.replace(edvoldt=edv), de, edot, sr,
                             bulkm, shearm, temp_e, s.dt, dpp, vmean)
    buoy = (rho_e * (1.0 - phi_e) + 1000.0 * phi_e) * ctrl.gravity / npe
    force = -P.asm_pack(P.force_cols(stress_c, dnd, buoy, vol))
    force = P.boundary_forces(force, s.coord, s.coord0, rho_e, phi_e,
                              fluid=hydraulic, neumann=False)
    force = F.apply_damping(force, s.vel, s.mass, s.ymass,
                            ctrl.damping_option, ctrl.damping_factor)
    vel = F.update_velocity(s.vel, force, s.mass, s.dt)
    # vertical-only displacement (dynearthsol.cxx:503-516)
    vel[:, :nd - 1] = 0.0
    if bottom is not None:
        vel[:, nd - 1] = vel[:, nd - 1] * torch.where(
            bottom, torch.zeros_like(vel[:, 0]), torch.ones_like(vel[:, 0]))
    coord = F.update_coordinate(s.coord, vel, s.dt)
    volume = P.volume_of(P.corners(P.gather([coord]), 0))
    mp = P.asm_pack(P.mass_cols(volume, bulkm, shearm, rho_e, phi_e, tab,
                                s.emw, s.max_global_vel_mag,
                                fluid_density=hydraulic))
    return s.replace(
        vel=vel, coord=coord, volume=volume, volume_old=vol,
        volume_n=mp[:, 0], mass=mp[:, 1], tmass=mp[:, 2], hmass=mp[:, 3],
        ymass=mp[:, 4], stress=torch.stack(stress_c), stressyy=stressyy,
        strain=torch.stack([s.strain[i] + de[i] for i in range(len(de))]),
        strain_rate=torch.stack(edot), plstrain=plstrain,
        delta_plstrain=delta_plstrain, viscosity=viscosity,
        dpressure=dpressure, force=force, edvoldt=edv)
