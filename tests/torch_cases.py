"""Configs and comparison helpers shared by the tests of the PyTorch port
(tests/test_torch_*.py).  Imports neither JAX nor the port at module
level; ``run_both`` imports both when it is called."""

from types import SimpleNamespace

import numpy as np


def make_sim_cfg(**over):
    """tests/test_pallas.py make_sim config: 16 x 128 cells, EVP, f32."""
    d = {
        "sim": {"ndims": 2, "float_dtype": "float32",
                "is_outputting_averaged_fields": False},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": 16e3, "ylength": 0.0, "zlength": 128e3,
                 "resolution": 1e3,
                 "quality_check_step_interval": 10**8},
        "control": {"gravity": 10.0, "inertial_scaling": 1e5,
                    "has_thermal_diffusion": True, "damping_option": 1},
        "bc": {"vbc_x0": 1, "vbc_val_x0": -1e-9,
               "vbc_x1": 1, "vbc_val_x1": 1e-9,
               "vbc_z0": 0, "vbc_z1": 0,
               "has_winkler_foundation": False,
               "has_water_loading": False},
        "mat": {"rheology_type": "elasto-visco-plastic",
                "is_plane_strain": True,
                "rho0": [2800.0], "bulk_modulus": [50e9],
                "shear_modulus": [30e9],
                "visc_max": 1e24, "visc_min": 1e19},
    }
    return _merge(d, over)


def production_cfg(rheology="elasto-visco-plastic", **over):
    """tests/test_pallas.py _production_sim: the examples/rifting-2d.cfg
    feature set (Winkler foundation, water loading, surface process 1, the
    surface-element correction, two materials by markers) on make_sim's 16
    x 128 cells, damping 2 (factor 0.4)."""
    d = make_sim_cfg(
        control={"surface_process_option": 1, "surface_diffusivity": 1e-6,
                 "has_surface_correction": True, "damping_option": 2,
                 "damping_factor": 0.4},
        bc={"has_winkler_foundation": True, "has_water_loading": True,
            "winkler_delta_rho": 100.0},
        markers={"markers_per_element": 4, "init_marker_option": 1},
        ic={"mattype_layer_depths": [0.3], "layer_mattypes": [0, 1]},
        mat={"nmat": 2, "rho0": [2800.0, 3300.0],
             "bulk_modulus": [50e9, 80e9], "shear_modulus": [30e9, 48e9],
             "rheology_type": rheology})
    return _merge(d, over)


def flagship_cfg(nx_cells=512, nz_cells=256, **over):
    """bench.py flagship_param: 100 km x 50 km at 512 x 256 cells, EVP,
    thermal diffusion, damping 1, a weak zone, default markers (4 per
    element).  Smaller cell counts keep the cell size and shrink x."""
    resolution = 50e3 / nz_cells
    d = {
        "sim": {"max_steps": 10**9, "ndims": 2, "float_dtype": "float32",
                "is_outputting_averaged_fields": False},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": nx_cells * resolution, "ylength": 0.0,
                 "zlength": 50e3, "resolution": resolution,
                 "quality_check_step_interval": 10**8},
        "control": {"gravity": 10.0, "inertial_scaling": 1e5,
                    "has_thermal_diffusion": True, "damping_option": 1},
        "bc": {"vbc_x0": 1, "vbc_val_x0": -1e-9,
               "vbc_x1": 1, "vbc_val_x1": 1e-9,
               "vbc_z0": 0, "vbc_z1": 0,
               "has_winkler_foundation": False,
               "has_water_loading": False,
               "surface_temperature": 273.0,
               "mantle_temperature": 1600.0},
        "ic": {"weakzone_option": 2, "weakzone_plstrain": 0.5,
               "weakzone_xcenter": 0.5, "weakzone_zcenter": 0.2,
               "weakzone_xsemi_axis": 3e3, "weakzone_zsemi_axis": 3e3},
        "mat": {"rheology_type": "elasto-visco-plastic",
                "is_plane_strain": True,
                "rho0": [2800.0], "bulk_modulus": [50e9],
                "shear_modulus": [30e9],
                "visc_max": 1e24, "visc_min": 1e19},
    }
    return _merge(d, over)


def make_sim3d_cfg(**over):
    """tests/test_pallas3d.py make_sim config narrowed in y: 128 x 4 x 8
    cells (20,480 tets; the fused 3D gate needs nxc % 128 == 0 and
    nzc % 8 == 0), EVP, f32."""
    d = {
        "sim": {"ndims": 3, "float_dtype": "float32",
                "is_outputting_averaged_fields": False},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": 128e3, "ylength": 4e3, "zlength": 8e3,
                 "resolution": 1e3,
                 "quality_check_step_interval": 10**8},
        "control": {"gravity": 10.0, "inertial_scaling": 1e5,
                    "has_thermal_diffusion": True, "damping_option": 1},
        "bc": {"vbc_x0": 1, "vbc_val_x0": -1e-9,
               "vbc_x1": 1, "vbc_val_x1": 1e-9,
               "vbc_y0": 1, "vbc_val_y0": 0.0,
               "vbc_y1": 1, "vbc_val_y1": 0.0,
               "vbc_z0": 0, "vbc_z1": 0,
               "has_winkler_foundation": False,
               "has_water_loading": False},
        "mat": {"rheology_type": "elasto-visco-plastic",
                "is_plane_strain": False,
                "rho0": [2800.0], "bulk_modulus": [50e9],
                "shear_modulus": [30e9],
                "visc_max": 1e24, "visc_min": 1e19},
    }
    return _merge(d, over)


# tests/test_pallas3d.py:135-153 _multimat_over: two layers of two
# materials (crust over mantle) by markers, with contrasting properties
MULTIMAT3 = {
    "mat": {"num_materials": 2, "rho0": [2700.0, 3300.0],
            "bulk_modulus": [40e9, 120e9], "shear_modulus": [24e9, 70e9],
            "heat_capacity": [1000.0, 1200.0], "therm_cond": [2.5, 3.3],
            "alpha": [3e-5, 2e-5], "visc_coefficient": [1e2, 1e3],
            "visc_activation_energy": [3.0e5, 4.0e5],
            "cohesion0": [4e7, 6e7], "friction_angle0": [30.0, 25.0],
            "visc_max": 1e24, "visc_min": 1e19},
    "ic": {"num_mattype_layers": 2, "layer_mattypes": [0, 1],
           "mattype_layer_depths": [0.4]},
    "markers": {"markers_per_element": 4, "random_seed": 11}}


def multimat3d_cfg(rheology="elasto-visco-plastic", **over):
    """make_sim3d_cfg with MULTIMAT3 (128 x 4 x 8 cells)."""
    d = make_sim3d_cfg(**{k: dict(v) for k, v in MULTIMAT3.items()})
    d["mat"]["rheology_type"] = rheology
    return _merge(d, over)


# bench.py production3d_param's boundary processes (surface process 1 with
# the surface correction, the Winkler foundation, water loading), the base
# level raised to 10 m so that the flat top takes water pressure
# (tests/test_pallas3d.py:233)
BOUNDARY3 = {
    "control": {"surface_process_option": 1, "surface_diffusivity": 1e-6,
                "has_surface_correction": True, "surf_base_level": 10.0},
    "bc": {"has_winkler_foundation": True, "has_water_loading": True,
           "winkler_delta_rho": 100.0}}


def flagship3d_multimat_cfg():
    """bench.py flagship3d_param(nmat=2): 256 x 48 x 16 cells of 1 km,
    983,040 tets, EVP, crust (0-40 %) over mantle by 4 markers per
    element."""
    return {
        "sim": {"max_steps": 10**9, "ndims": 3, "float_dtype": "float32",
                "is_outputting_averaged_fields": False},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": 256e3, "ylength": 48e3, "zlength": 16e3,
                 "resolution": 1e3, "quality_check_step_interval": 10**8},
        "markers": {"markers_per_element": 4, "init_marker_option": 1},
        "ic": {"mattype_layer_depths": [0.4], "layer_mattypes": [0, 1]},
        "control": {"gravity": 10.0, "inertial_scaling": 1e5,
                    "has_thermal_diffusion": True, "damping_option": 1},
        "bc": {"vbc_x0": 1, "vbc_val_x0": -1e-9, "vbc_x1": 1,
               "vbc_val_x1": 1e-9, "vbc_y0": 1, "vbc_val_y0": 0.0,
               "vbc_y1": 1, "vbc_val_y1": 0.0, "vbc_z0": 0, "vbc_z1": 0,
               "has_winkler_foundation": False, "has_water_loading": False,
               "surface_temperature": 273.0, "mantle_temperature": 1600.0},
        "mat": {"rheology_type": "elasto-visco-plastic",
                "is_plane_strain": False, "nmat": 2,
                "rho0": [2800.0, 3300.0], "bulk_modulus": [50e9, 80e9],
                "shear_modulus": [30e9, 48e9], "visc_max": 1e24,
                "visc_min": 1e19},
    }


def flat_cfg(rheology="elasto-visco-plastic", dtype="float64", **over):
    """tests/test_flat.py mk_param config: a 16 km x 8 km Delaunay box at
    1 km (262 triangles, 156 nodes), EVP, plane strain, thermal diffusion,
    damping 1, quality-check interval 7."""
    d = {
        "sim": {"ndims": 2, "float_dtype": dtype,
                "is_outputting_averaged_fields": False},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 0,
                 "xlength": 16e3, "ylength": 0.0, "zlength": 8e3,
                 "resolution": 1e3, "quality_check_step_interval": 7},
        "control": {"gravity": 10.0, "inertial_scaling": 1e5,
                    "has_thermal_diffusion": True, "damping_option": 1},
        "bc": {"vbc_x0": 1, "vbc_val_x0": -1e-9, "vbc_x1": 1,
               "vbc_val_x1": 1e-9, "vbc_z0": 0, "vbc_z1": 0,
               "has_winkler_foundation": False,
               "has_water_loading": False},
        "mat": {"rheology_type": rheology, "is_plane_strain": True,
                "rho0": [2800.0], "bulk_modulus": [50e9],
                "shear_modulus": [30e9], "visc_max": 1e24,
                "visc_min": 1e19},
    }
    return _merge(d, over)


def flat3d_cfg(rheology="maxwell", dtype="float64", **over):
    """tests/test_flat.py mk_param3d config: an 8 km x 4 km x 4 km
    Delaunay box at 1 km (886 tets, 225 nodes), thermal diffusion,
    damping 1, the surface correction, the x walls pulled apart."""
    d = {
        "sim": {"ndims": 3, "float_dtype": dtype,
                "is_outputting_averaged_fields": False},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 0,
                 "xlength": 8e3, "ylength": 4e3, "zlength": 4e3,
                 "resolution": 1e3, "quality_check_step_interval": 10**8},
        "control": {"gravity": 10.0, "inertial_scaling": 1e5,
                    "has_thermal_diffusion": True, "damping_option": 1,
                    "has_surface_correction": True},
        "bc": {"vbc_x0": 1, "vbc_val_x0": -1e-9, "vbc_x1": 1,
               "vbc_val_x1": 1e-9, "vbc_y0": 1, "vbc_val_y0": 0.0,
               "vbc_y1": 1, "vbc_val_y1": 0.0, "vbc_z0": 0, "vbc_z1": 0,
               "has_winkler_foundation": False,
               "has_water_loading": False},
        "ic": {"weakzone_option": 0 if rheology == "maxwell" else 1},
        "mat": {"rheology_type": rheology, "is_plane_strain": False,
                "rho0": [2800.0], "bulk_modulus": [50e9],
                "shear_modulus": [30e9], "visc_max": 1e24,
                "visc_min": 1e19},
    }
    return _merge(d, over)


# tests/test_flat.py:38-42: the fields its flat-vs-generic gate compares
FLAT_FIELDS = ("coord", "vel", "temperature", "stress", "stressyy", "strain",
               "strain_rate", "plstrain", "delta_plstrain", "viscosity",
               "volume", "volume_old", "volume_n", "mass", "tmass", "hmass",
               "ymass", "force", "edvoldt", "dt", "time",
               "max_global_vel_mag", "global_dt_min", "l2_residual")


def halo_cfg(rheology="elasto-visco-plastic", **over):
    """tests/test_halo.py _mk_param config: a 64 km x 8 km raster at 1 km
    (64 x 8 cells, 1,024 triangles, 585 nodes), f64, EVP, plane strain,
    thermal diffusion, damping 1, 4 markers per element."""
    d = {
        "sim": {"ndims": 2, "float_dtype": "float64",
                "is_outputting_averaged_fields": False},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": 64e3, "ylength": 0.0, "zlength": 8e3,
                 "resolution": 1e3,
                 "quality_check_step_interval": 10**8},
        "markers": {"markers_per_element": 4},
        "control": {"gravity": 10.0, "inertial_scaling": 1e5,
                    "has_thermal_diffusion": True, "damping_option": 1},
        "bc": {"vbc_x0": 1, "vbc_val_x0": -1e-9, "vbc_x1": 1,
               "vbc_val_x1": 1e-9, "vbc_z0": 0, "vbc_z1": 0,
               "has_winkler_foundation": False,
               "has_water_loading": False},
        "mat": {"rheology_type": rheology, "is_plane_strain": True,
                "rho0": [2800.0], "bulk_modulus": [50e9],
                "shear_modulus": [30e9]},
    }
    return _merge(d, over)


# the halo tests' feature sets (tests/test_halo.py): Biot hydraulic
# diffusion, and the facet tractions (Winkler, water loading, a Neumann
# face) with surface process 1
HALO_HYD = {"porosity": [0.1], "hydraulic_perm": [1e-15],
            "fluid_bulk_modulus": [2.2e9], "biot_coeff": [0.8]}
HALO_FACETS = {
    "bc": {"has_winkler_foundation": True, "winkler_delta_rho": 100.0,
           "has_water_loading": True, "stress_bc_x1": 1,
           "stress_val_x1": -1e6},
    "control": {"surface_process_option": 1, "surface_diffusivity": 1e-6}}
# tests/test_halo.py _compare's fields
HALO_FIELDS = ("coord", "vel", "stress", "plstrain", "temperature", "dt",
               "time", "mass", "strain", "viscosity", "l2_residual",
               "max_global_vel_mag")


def with_param(sim, param):
    """A stand-in for ``sim`` (a Simulation of either package) with another
    param on the same mesh, context and state: what the chunk runners and
    step plans read of a Simulation.  The tests that share one Simulation
    between configs that differ only in the step (rheology, damping,
    switches) run each config's step from the shared state."""
    return SimpleNamespace(param=param, ctx=sim.ctx, state=sim.state,
                           device=getattr(sim, "device", None),
                           compensation_pressure=getattr(
                               sim, "compensation_pressure", 0.0))


def run_both(cfg, n, band=False, sims=None):
    """n steps of both packages' flat chunk runners (flat2d, or flat3d for
    a 3D config) from the JAX initial state; with ``band`` the JAX side
    runs its band engine (ctx.band set as tests/test_flat.py:443-461
    does).  Returns numpy dicts (jax, torch) of every State field; a dict
    ``sims`` receives both Simulations ("jax", "torch") for reuse."""
    import dataclasses

    import dynearthsol_tpu as jdes
    import dynearthsol_tpu_torch as tdes
    from dynearthsol_tpu.ops import band2d as jband
    from dynearthsol_tpu.ops import flat2d as jflat
    from dynearthsol_tpu.ops import flat3d as jflat3d
    from dynearthsol_tpu_torch.state import (FIELD_NAMES, state_from_numpy,
                                             state_to_numpy)

    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    path = "flat3d" if cfg["sim"]["ndims"] == 3 else "flat2d"
    if path == "flat3d":
        jflat = jflat3d
        assert jflat.flat3d_step_applicable(js.param, js.ctx)
    else:
        assert jflat.flat_step_applicable(js.param, js.ctx)
    jctx = js.ctx
    if band:
        bt = jband.build_band_tables(np.asarray(js.topo.connectivity),
                                     js.topo.nnode)
        assert bt is not None
        jctx = dataclasses.replace(js.ctx, band=bt)
    run = jflat.make_chunk_runner(js.param, js.ctx,
                                  js.compensation_pressure, n)
    ref = run(jctx, js.state)
    s0 = state_from_numpy({f: np.asarray(getattr(js.state, f))
                           for f in FIELD_NAMES}, dtype=ts.dtype)
    out = ts._chunk_fn(n)(ts.ctx, s0)
    assert ts.step_path == path
    if sims is not None:
        sims.update(jax=js, torch=ts)
    return ({f: np.asarray(getattr(ref, f)) for f in FIELD_NAMES},
            state_to_numpy(out))


def carry(src, dst):
    """``dst``, a Simulation of the other package on the same mesh, takes
    ``src``'s state (every State field through numpy, in dst's dtype), its
    markers and its hydrous markers (MarkerSet.from_arrays of the other
    package from their save and checkpoint arrays, both ways)."""
    import dynearthsol_tpu_torch.state as tstate
    to_port = type(dst).__module__.startswith("dynearthsol_tpu_torch")
    if to_port:
        from dynearthsol_tpu_torch.markers import MarkerSet
        dst.state = tstate.state_from_numpy(
            {f: np.asarray(getattr(src.state, f))
             for f in tstate.FIELD_NAMES}, dtype=dst.dtype)
    else:
        import jax.numpy as jnp

        from dynearthsol_tpu.markers import MarkerSet
        from dynearthsol_tpu.state import State
        dst.state = State(**{f: jnp.asarray(v) for f, v in
                             tstate.state_to_numpy(src.state).items()})
    for nm in ("markers", "hydrous_markers"):
        ms = getattr(src, nm, None)
        setattr(dst, nm, None if ms is None else MarkerSet.from_arrays(
            ms.ndims, ms.save_arrays(), ms.chkpt_arrays(), name=ms.name))


def assert_same_markers(a, b):
    """Two marker sets (either package) equal bit for bit."""
    assert (a is None) == (b is None)
    if a is None:
        return
    assert (a.name, a.n, a.last_id) == (b.name, b.n, b.last_id)
    for nm in ("eta", "elem", "mattype", "id", "time", "z", "distance",
               "slope", "genesis"):
        assert np.array_equal(a.live(nm), b.live(nm)), (a.name, nm)


def subduction_cfg(dtype="float64", **over):
    """tests/test_phasechanges.py subduction_param: a 40 km x 40 km box at
    5 km (8 x 8 cells, 128 triangles), elastic, 8 materials,
    phase_change_option 1 with the hydration processes, 4 markers per
    element; here sediment (4), oceanic crust (2) and mantle (0) by depth,
    and the half-space geotherm of a 30 Myr plate (273-881 K), so that
    markers dehydrate and the mantle beside them serpentinizes."""
    d = {
        "sim": {"ndims": 2, "float_dtype": dtype,
                "is_outputting_averaged_fields": False},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": 40e3, "ylength": 0.0, "zlength": 40e3,
                 "resolution": 5e3, "quality_check_step_interval": 10**8},
        "markers": {"markers_per_element": 4, "random_seed": 2},
        "control": {"gravity": 10.0, "inertial_scaling": 1e5,
                    "has_hydration_processes": True,
                    "hydration_migration_speed": 3e-9},
        "bc": {"vbc_x0": 1, "vbc_val_x0": 0.0, "vbc_x1": 1,
               "vbc_val_x1": 0.0, "vbc_z0": 0, "vbc_z1": 0,
               "has_winkler_foundation": False,
               "has_water_loading": False,
               "surface_temperature": 273.0,
               "mantle_temperature": 1600.0},
        "ic": {"num_mattype_layers": 3, "layer_mattypes": [4, 2, 0],
               "mattype_layer_depths": [0.1, 0.3], "temperature_option": 1,
               "oceanic_plate_age_in_yr": 3e7},
        "mat": {"rheology_type": "elastic", "nmat": 8,
                "phase_change_option": 1,
                "rho0": [3210.0], "bulk_modulus": [128e9],
                "shear_modulus": [80e9]},
    }
    return _merge(d, over)


def rsf_monitor_cfg(nsteps=300, **over):
    """tests/test_monitor.py monitor_param: the reference's simple-shear
    rate-and-state benchmark (a 1 m x 1 m box, 2 triangles, float64,
    use_global_velocity_scaling, the top dragged at 1e-5 m/s) with a
    monitor of 2 points (stress, dynamic friction, state variable) every
    10 steps, its CSVs ``mon_point_<i>.csv`` in the working directory."""
    d = {
        "sim": {"max_steps": nsteps, "output_step_interval": nsteps,
                "ndims": 2, "float_dtype": "float64",
                "is_outputting_averaged_fields": False},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": 1.0, "ylength": 0.0, "zlength": 1.0,
                 "resolution": 1.0, "quality_check_step_interval": 100},
        "markers": {"markers_per_element": 4},
        "control": {"gravity": 0.0, "fixed_dt": 1.0,
                    "inertial_scaling": 1e5,
                    "use_global_velocity_scaling": True,
                    "damping_option": 1, "has_thermal_diffusion": False},
        "ic": {"weakzone_option": 0},
        "bc": {"vbc_x0": 1, "vbc_val_x0": 0.0, "vbc_x1": 1,
               "vbc_val_x1": 0.0, "vbc_z0": 1, "vbc_val_z0": 0.0,
               "vbc_z1": 4, "vbc_val_z1": 1e-5,
               "surface_temperature": 273.0, "mantle_temperature": 273.0},
        "mat": {"rheology_type": "elasto-plastic-rate-state-friction",
                "is_plane_strain": True, "rho0": [1.0], "alpha": [0.0],
                "bulk_modulus": [2e8], "shear_modulus": [2e8],
                "pls0": [0.0], "pls1": [0.1],
                "cohesion0": [1e6], "cohesion1": [1e6],
                "friction_angle0": [30.0], "friction_angle1": [30.0],
                "dilation_angle0": [0.0], "dilation_angle1": [0.0],
                "max_tension": 5.67e6, "direct_a": [0.2],
                "evolution_b": [0.1], "characteristic_distance": [1e-3],
                "characteristic_velocity": [1e-6], "state_var_model": 0},
        "monitor": {"enabled": True, "output_prefix": "mon",
                    "step_interval": 10, "num_points": 2,
                    "points_x": [1 / 3, 2 / 3], "points_y": [-2 / 3, -1 / 3],
                    "points_unit": "m", "remesh_rebind": "initial_coord",
                    "write_header": True, "output_coord": False,
                    "output_velocity": False, "output_stress": True,
                    "output_dynamic_friction": True,
                    "output_state_variable": True},
    }
    return _merge(d, over)


def rsf_events_cfg(nsteps=60, **over):
    """rsf_monitor_cfg with earthquake tracking and adaptive output: a
    cohesion of 1e4 Pa, so that it yields within the first steps,
    seismic_moment_calculate_output, earthquake_output_step_interval 5,
    start and end factors 0.5 and 1.5, a frame (with its checkpoint) every
    20 steps."""
    d = rsf_monitor_cfg(nsteps)
    d["sim"].update(output_step_interval=20, checkpoint_frame_interval=1,
                    seismic_moment_calculate_output=True,
                    earthquake_output_step_interval=5,
                    earthquake_start_factor=0.5, earthquake_end_factor=1.5)
    d["mat"].update(cohesion0=[1e4], cohesion1=[1e4])
    return _merge(d, over)


def tagged_arrays(path) -> dict:
    """{name: raw bytes} of a tagged frame or checkpoint file, in file
    order, each array's extent from the offsets."""
    from dynearthsol_tpu_torch.io.tagged import TaggedReader
    with TaggedReader(path) as r:
        pos = sorted(r.offset.items(), key=lambda kv: kv[1])
        r.f.seek(0, 2)
        ends = [p for _, p in pos[1:]] + [r.f.tell()]
        out = {}
        for (name, p), e in zip(pos, ends):
            r.f.seek(p)
            out[name] = r.f.read(e - p)
        return out


# arrays of a frame that hold integers or marker placements: equal bit for
# bit between the packages
_EXACT = ("connectivity", "bcflag", "segment", "segflag", "material")
_EXACT_MARKER = (" size", ".eta", ".elem", ".mattype", ".id", ".time", ".z",
                 ".distance", ".slope", ".genesis")


def assert_frames_close(path_a, path_b, tol=1e-10, eta_exact=True):
    """Two frames (or checkpoints) of a float64 run: the same arrays in the
    same order; integers and marker placements bit for bit, every other
    array within ``tol`` of its max |value| (its infinities equal).
    ``eta_exact=False`` takes the markers' barycentric coordinates as the
    other floats (a remesh relocates them from the node coordinates).
    Returns the worst difference of those, each at its max |value|."""
    a, b = tagged_arrays(path_a), tagged_arrays(path_b)
    assert list(a) == list(b)
    worst = 0.0
    exact_marker = _EXACT_MARKER if eta_exact else tuple(
        m for m in _EXACT_MARKER if m != ".eta")
    for name in a:
        assert len(a[name]) == len(b[name]), name
        if name in _EXACT or name.endswith(exact_marker):
            assert a[name] == b[name], name
            continue
        x, y = (np.frombuffer(v[name], np.float64) for v in (a, b))
        fin = np.isfinite(x)
        assert np.array_equal(x[~fin], y[~fin], equal_nan=True), name
        x, y = x[fin], y[fin]
        scale = max(np.abs(x).max(initial=0.0), 1e-300)
        err = np.abs(x - y).max(initial=0.0) / scale
        assert err <= tol, (name, err)
        worst = max(worst, float(err))
    return worst


def write_cfg(path, d: dict) -> None:
    """Write a cfg dict as a .cfg file that both packages' load_config
    read."""
    def val(v):
        if isinstance(v, bool):
            return "yes" if v else "no"
        if isinstance(v, (list, tuple)):
            return "[ " + ", ".join(map(str, v)) + " ]"
        return str(v)
    with open(path, "w") as f:
        f.write("".join(f"[{sec}]\n" + "".join(f"{k} = {val(v)}\n"
                                               for k, v in kv.items())
                        for sec, kv in d.items()))


def run_both_clis(tmp_path, cfg, over_jax=None, over_port=None,
                  wake_log=None):
    """Run ``cfg`` through the JAX CLI in ``tmp_path/jax`` (model "jax")
    and the port's CLI on the CPU in ``tmp_path/our`` (model "our"), each
    from a .cfg file, so that the files each writes in its working
    directory (monitor CSVs, the seismic moment log) stay apart; returns
    the port's Simulation.  ``over_*`` are context managers (or None)
    entered around each run; ``wake_log`` goes to the port's run."""
    import contextlib
    import os

    from dynearthsol_tpu import load_config as jload
    from dynearthsol_tpu.__main__ import run as jrun
    from dynearthsol_tpu_torch import load_config as tload
    from dynearthsol_tpu_torch.__main__ import run as trun

    cwd = os.getcwd()
    try:
        for name, over in (("jax", over_jax), ("our", over_port)):
            d = tmp_path / name
            d.mkdir(exist_ok=True)
            os.chdir(d)
            cfg["sim"]["modelname"] = name
            write_cfg(f"{name}.cfg", cfg)
            with over or contextlib.nullcontext():
                if name == "jax":
                    jrun(jload("jax.cfg"))
                else:
                    return trun(tload("our.cfg"), device="cpu",
                                wake_log=wake_log)
    finally:
        os.chdir(cwd)


def write_poly2d(path):
    """A 16 km x 8 km box split at z = -4 km; the lower right segment is
    marked 64."""
    pts = [(0, -8e3), (16e3, -8e3), (16e3, -4e3), (16e3, 0), (0, 0),
           (0, -4e3)]
    segs = [(0, 1, 16), (1, 2, 64), (2, 3, 2), (3, 4, 32), (4, 5, 1),
            (5, 0, 1), (5, 2, 0)]
    regions = [(8e3, -6e3, 1, 1.0), (8e3, -2e3, 0, 2.0)]
    lines = [f"{len(pts)} 2 0 0"]
    lines += [f"{i} {x} {z}" for i, (x, z) in enumerate(pts)]
    lines += [f"{len(segs)} 1"]
    lines += [f"{i} {a} {b} {f}" for i, (a, b, f) in enumerate(segs)]
    lines += ["0", f"{len(regions)}"]
    lines += [f"{i} {x} {z} {m} {s}" for i, (x, z, m, s) in
              enumerate(regions)]
    path.write_text("\n".join(lines) + "\n")


def write_poly3d(path):
    """An 8 x 4 x 4 km block whose x walls lean inwards by 1 km over its
    height (x0 flagged 128, x1 64), split at z = -2 km by an
    internal facet; the side walls are facets above and below it."""
    pts = [(0, 0, -4e3), (8e3, 0, -4e3), (8e3, 4e3, -4e3), (0, 4e3, -4e3),
           (500, 0, -2e3), (7.5e3, 0, -2e3), (7.5e3, 4e3, -2e3),
           (500, 4e3, -2e3),
           (1e3, 0, 0), (7e3, 0, 0), (7e3, 4e3, 0), (1e3, 4e3, 0)]
    facets = [([0, 1, 2, 3], 16), ([8, 9, 10, 11], 32), ([4, 5, 6, 7], 0),
              ([0, 1, 5, 4], 4), ([4, 5, 9, 8], 4),
              ([3, 2, 6, 7], 8), ([7, 6, 10, 11], 8),
              ([0, 3, 7, 4], 128), ([4, 7, 11, 8], 128),
              ([1, 2, 6, 5], 64), ([5, 6, 10, 9], 64)]
    regions = [(4e3, 2e3, -3e3, 1, 1.0), (4e3, 2e3, -1e3, 0, 1.0)]
    lines = [f"{len(pts)} 3 0 0"]
    lines += [f"{i} {x} {y} {z}" for i, (x, y, z) in enumerate(pts)]
    lines += [f"{len(facets)} 1"]
    for poly, flag in facets:
        lines += [f"1 0 {flag}", f"{len(poly)} " + " ".join(map(str, poly))]
    lines += ["0", f"{len(regions)}"]
    lines += [f"{i} {x} {y} {z} {m} {s}" for i, (x, y, z, m, s) in
              enumerate(regions)]
    path.write_text("\n".join(lines) + "\n")


# Exodus side s of a tet, 1-based local corners (Exodus Table 4.2)
_SIDES = np.array([[1, 2, 4], [2, 3, 4], [1, 4, 3], [1, 3, 2]]) - 1


def write_exodus(path):
    """The 5-tet grid of an 8 x 4 x 4 km box at 2 km, sheared so that its
    x walls lean by 500 m, in two element blocks (below and above z = -2
    km), with one side set per wall: x0 64, x1 128, y0, y1, z0,
    z1 their box bits."""
    from scipy.io import netcdf_file

    from dynearthsol_tpu_torch.mesh.generate import regular_grid_3d

    g = regular_grid_3d(8e3, 4e3, 4e3, 2e3)
    box, conn = g.coord, g.connectivity
    lower = box[conn, 2].mean(axis=1) < -2e3
    order = np.concatenate([np.flatnonzero(lower), np.flatnonzero(~lower)])
    conn = conn[order]
    nlow = int(lower.sum())
    coord = box.copy()
    coord[:, 0] += 0.125 * (box[:, 2] + 4e3)
    faces = conn[:, _SIDES]                         # (nelem, 4, 3)
    key = np.sort(faces, axis=2).reshape(-1, 3)
    _, inv, cnt = np.unique(key, axis=0, return_inverse=True,
                            return_counts=True)
    onb = (cnt[inv.ravel()] == 1).reshape(len(conn), 4)
    walls = [(0, 0.0, 64), (0, 8e3, 128), (1, 0.0, 4),
             (1, 4e3, 8), (2, -4e3, 16), (2, 0.0, 32)]
    f = netcdf_file(str(path), "w")
    f.createDimension("num_dim", 3)
    f.createDimension("num_nodes", len(coord))
    f.createDimension("num_elem", len(conn))
    f.createDimension("num_el_blk", 2)
    f.createDimension("num_side_sets", len(walls))
    for d, name in enumerate(("coordx", "coordy", "coordz")):
        f.createVariable(name, "d", ("num_nodes",))[:] = coord[:, d]
    f.createVariable("eb_prop1", "i", ("num_el_blk",))[:] = [2, 1]
    for b, part in enumerate((conn[:nlow], conn[nlow:])):
        f.createDimension(f"num_el_in_blk{b + 1}", len(part))
        f.createDimension(f"num_nod_per_el{b + 1}", 4)
        f.createVariable(f"connect{b + 1}", "i", (
            f"num_el_in_blk{b + 1}", f"num_nod_per_el{b + 1}"))[:] = part + 1
    f.createVariable("ss_prop1", "i", ("num_side_sets",))[:] = [
        w[2] for w in walls]
    for i, (ax, at, _) in enumerate(walls):
        on = onb & (np.abs(box[faces, ax] - at) < 1.0).all(axis=2)
        e, s = np.nonzero(on)
        f.createDimension(f"num_side_ss{i + 1}", len(e))
        f.createVariable(f"elem_ss{i + 1}", "i",
                         (f"num_side_ss{i + 1}",))[:] = e + 1
        f.createVariable(f"side_ss{i + 1}", "i",
                         (f"num_side_ss{i + 1}",))[:] = s + 1
    f.close()


# two materials of the .poly and Exodus configs (regions 0 and 1)
MAT2 = {"nmat": 2, "rho0": [2800.0, 3000.0], "bulk_modulus": [50e9, 60e9],
        "shear_modulus": [30e9, 35e9]}


def poly2d_cfg(path, keep):
    """flat_cfg on write_poly2d's mesh (option 91 at 2 km), its internal
    segment kept or discarded; markers only where it is discarded."""
    return flat_cfg(
        mesh={"meshing_option": 91, "poly_filename": str(path),
              "resolution": 2e3, "is_discarding_internal_segments": not keep},
        markers={"markers_per_element": 0 if keep else 3},
        mat=dict(MAT2))


def poly3d_cfg(path):
    """flat3d_cfg on write_poly3d's mesh (option 91 at 1 km), inclined
    BCs of types 13 (BOUNDN0) and 3 (BOUNDN1)."""
    return flat3d_cfg(
        mesh={"meshing_option": 91, "poly_filename": str(path)},
        markers={"markers_per_element": 2}, mat=dict(MAT2),
        bc={"vbc_n0": 13, "vbc_val_n0": 1e-9, "vbc_n1": 3,
            "vbc_val_n1": -1e-9})


def exodus_cfg(path):
    """flat3d_cfg on write_exodus's mesh, inclined BCs of types 1
    (BOUNDN0) and 11 (BOUNDN1)."""
    return flat3d_cfg(
        mesh={"meshing_option": 95, "exo_filename": str(path)},
        markers={"markers_per_element": 2}, mat=dict(MAT2),
        bc={"vbc_n0": 1, "vbc_val_n0": -1e-9, "vbc_n1": 11,
            "vbc_val_n1": 1e-9})


def _merge(d, over):
    for sec, kv in over.items():
        d.setdefault(sec, {}).update(kv)
    return d


def rel_err(a, b) -> float:
    """max |a - b| / max |a| in float64."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


# test_pallas.py:91-106: maxwell trajectory gate
MAXWELL_FIELDS = ("coord", "vel", "temperature", "stress", "strain",
                  "plstrain", "stressyy", "volume", "volume_n", "mass",
                  "tmass", "force", "strain_rate", "edvoldt",
                  "delta_plstrain", "hmass")


def assert_maxwell_close(ref, out, get, vmax_tol=1e-5):
    """Fields within 2e-4 of each field's max (force 1e-3), log-viscosity
    median below 0.02, dt/time/vmax within 1e-5 relative
    (test_pallas.py:91-106; vmax within ``vmax_tol``).  ``get(state,
    name)`` -> numpy."""
    tols = {"force": 1e-3}
    for f in MAXWELL_FIELDS:
        err = rel_err(get(ref, f), get(out, f))
        assert err < tols.get(f, 2e-4), (f, err)
    va = np.log(np.asarray(get(ref, "viscosity"), dtype=np.float64))
    vb = np.log(np.asarray(get(out, "viscosity"), dtype=np.float64))
    assert np.median(np.abs(va - vb)) < 0.02
    assert np.isfinite(vb).all()
    for f, tol in (("dt", 1e-5), ("time", 1e-5),
                   ("max_global_vel_mag", vmax_tol)):
        a, b = float(get(ref, f)), float(get(out, f))
        assert abs(a - b) <= tol * max(abs(a), 1e-300), f


EVP_ONE_STEP_FIELDS = ("coord", "vel", "stress", "strain", "plstrain",
                       "force")


def assert_evp_one_step_close(ref, out, get, tol=2e-6,
                              fields=EVP_ONE_STEP_FIELDS):
    """Single-step EVP gate at f32 roundoff (test_pallas.py:108-117)."""
    for f in fields:
        err = rel_err(get(ref, f), get(out, f))
        assert err < tol, (f, err)


def assert_resident_matches_tiled(tiled, res, get):
    """The resident runner against the tiled runner over the same steps,
    with the bounds of test_pallas.py:151-169: 1e-6 of each field's max,
    looser on the fields chosen by the EVP min-select, which may show a
    near-tie flip."""
    select_tol = {"stressyy": 5e-5, "plstrain": 5e-5,
                  "delta_plstrain": 5e-4, "viscosity": 5e-4}
    for f in MAXWELL_FIELDS + ("viscosity",):
        err = rel_err(get(tiled, f), get(res, f))
        assert err < select_tol.get(f, 1e-6), (f, err)
    for f in ("dt", "time", "max_global_vel_mag", "global_dt_min",
              "steps"):
        a, b = float(get(tiled, f)), float(get(res, f))
        assert abs(a - b) <= 1e-6 * max(abs(a), 1e-300), f


# test_pallas3d.py:79-82 and :112-131: the 3D gates
FIELDS3 = ("coord", "vel", "temperature", "stress", "strain", "plstrain",
           "volume", "volume_n", "mass", "tmass", "hmass", "force",
           "strain_rate", "edvoldt", "delta_plstrain", "volume_old")


# one-step cases of the fused 3D step beyond the EVP and maxwell gates:
# every rheology, and on EVP the damping options and the switches the step
# reads
STEP3_CASES = {
    "elastic": {"mat": {"rheology_type": "elastic"}},
    "viscous": {"mat": {"rheology_type": "viscous"}},
    "elasto_plastic": {"mat": {"rheology_type": "elasto-plastic"}},
    **{f"damping{k}": {"control": {"damping_option": k,
                                   "damping_factor": 0.4}}
       for k in (0, 2, 3)},
    "no_nmd": {"control": {"is_using_mixed_stress": False}},
    "no_surface_correction": {"control": {"has_surface_correction": False}},
    "global_velocity_scaling": {
        "control": {"use_global_velocity_scaling": True}},
}


def assert_maxwell3_close(ref, out, get):
    """10 maxwell steps: fields within 1e-3 of each field's max (force
    5e-3), dt/time/vmax/L2 within 1e-3 relative (test_pallas3d.py:112-116).
    ``get(state, name)`` -> numpy."""
    for f in FIELDS3:
        err = rel_err(get(ref, f), get(out, f))
        assert err < (5e-3 if f == "force" else 1e-3), (f, err)
    assert np.isfinite(get(out, "viscosity")).all()
    for f in ("dt", "time", "max_global_vel_mag", "l2_residual"):
        a, b = float(get(ref, f)), float(get(out, f))
        assert abs(a - b) <= 1e-3 * max(abs(a), 1e-300), f


def assert_evp3_one_step_close(ref, out, get):
    """One EVP step: fields within 1e-4 (force 1e-3), log-viscosity median
    below 0.02 (test_pallas3d.py:126-132)."""
    for f in FIELDS3:
        err = rel_err(get(ref, f), get(out, f))
        assert err < (1e-3 if f == "force" else 1e-4), (f, err)
    va = np.log(np.asarray(get(ref, "viscosity"), dtype=np.float64))
    vb = np.log(np.asarray(get(out, "viscosity"), dtype=np.float64))
    assert np.median(np.abs(va - vb)) < 0.02
    assert np.isfinite(vb).all()


def run_path_both(cfg, n, path):
    """n steps of both packages' chunk runners on the path their
    dispatches pick for ``cfg`` (asserted to be ``path``), from the JAX
    initial state.  Returns numpy dicts (jax, torch) of every State
    field."""
    import dynearthsol_tpu as jdes
    import dynearthsol_tpu_torch as tdes
    from dynearthsol_tpu_torch.state import (FIELD_NAMES, state_from_numpy,
                                             state_to_numpy)

    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    ref = js._chunk_fn(n)(js.ctx, js.state)
    assert js.step_path == path
    s0 = state_from_numpy({f: np.asarray(getattr(js.state, f))
                           for f in FIELD_NAMES}, dtype=ts.dtype)
    out = ts._chunk_fn(n)(ts.ctx, s0)
    assert ts.step_path == path
    return ({f: np.asarray(getattr(ref, f)) for f in FIELD_NAMES},
            state_to_numpy(out))


def grid3d_cfg(rheology="maxwell", dtype="float64", winkler=True):
    """tests/test_structured.py:254-305's inputs (Winkler foundation,
    water loading, surface process 1 with the surface correction, thermal
    diffusion, damping 1) on 8 x 2 x 4 cells of 1 km, the base level
    raised to 10 m as in BOUNDARY3: at 0 m the flat top's water pressure
    switches on the sign of its rounding.  Without ``winkler`` the bottom
    is free of the foundation, whose balance with the column's weight
    leaves the bottom nodes a velocity of rounding that grows to 1e-10 of
    the strain rate's scale in 20 float64 steps."""
    return {
        "sim": {"ndims": 3, "float_dtype": dtype,
                "is_outputting_averaged_fields": False},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": 8e3, "ylength": 2e3, "zlength": 4e3,
                 "resolution": 1e3, "quality_check_step_interval": 10**8},
        "control": {"gravity": 10.0, "inertial_scaling": 1e5,
                    "has_thermal_diffusion": True, "damping_option": 1,
                    "surface_process_option": 1,
                    "surface_diffusivity": 1e-6,
                    "has_surface_correction": True,
                    "surf_base_level": 10.0},
        "bc": {"vbc_x0": 1, "vbc_val_x0": -1e-9, "vbc_x1": 1,
               "vbc_val_x1": 1e-9, "vbc_y0": 1, "vbc_val_y0": 0.0,
               "vbc_y1": 1, "vbc_val_y1": 0.0,
               "has_winkler_foundation": winkler,
               "has_water_loading": True, "winkler_delta_rho": 100.0},
        "mat": {"rheology_type": rheology, "is_plane_strain": False,
                "rho0": [2800.0], "bulk_modulus": [50e9],
                "shear_modulus": [30e9], "visc_max": 1e24,
                "visc_min": 1e19},
    }
