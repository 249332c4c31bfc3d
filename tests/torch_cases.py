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
