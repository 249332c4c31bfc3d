"""The features of the port's column step (ops/flat2d.py) against the JAX
package's flat2d, each package's chunk runner from the JAX initial state
(torch_cases.run_both), on the CPU: the facet and Neumann tractions, the
elastic foundation, surface processes 1 and 102, Biot hydraulic
diffusion, rate-and-state friction and the pseudo-transient loop, with the
configs of tests/test_flat.py.  Then the functions behind them on the same
inputs, with no step built, and the dispatch switches DES_NO_PALLAS (onto
the plane steps grid2d and grid3d) and DES_NO_FLAT.

Tolerances, each of a field's max:
  f64 trajectories: 1e-10 (torch and XLA differ in exp/log by ulps; the
    Winkler feedback grows an ulp to ~3e-11 over 20 steps).  Fields that
    are zero but for roundoff (the RSF shear's stressyy and edvoldt, a
    pore-pressure increment) are judged at the scale of the field they
    are a part of, as tests/test_flat.py:262-268 and :158-163 judge them.
  f32, the production feature set with maxwell over 20 steps, against the
    JAX band engine: the maxwell gate of tests/test_pallas.py:91-106, but
    on the velocity, its gradients and the surface accumulators, which
    take the 5e-3 that tests/test_pallas.py:277-283 sets for this feature
    set's trajectory: the Winkler-balanced column's free nodes move by the
    rounding of a force balance (measured: vel 1.0e-3, strain_rate 2.3e-3,
    edvoldt 1.7e-3, dhacc 2.9e-3, edvacc_surf 3.4e-3; the JAX package's
    own float32 and float64 runs part by 1.4e-2 in vel and 2.6e-2 in
    strain_rate over the same 20 steps).
  The functions on one input: 1e-13 (the same operations in the same
    order; exp and atan in torch and XLA differ by an ulp).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu import bc as jbc
from dynearthsol_tpu.ops import surface as jSP
from dynearthsol_tpu_torch import bc as tbc
from dynearthsol_tpu_torch.ops import surface as tSP
from torch_cases import (FLAT_FIELDS, MAXWELL_FIELDS, flat_cfg,
                         make_sim3d_cfg, make_sim_cfg, rel_err, run_both)

# tests/test_flat.py:188-203 and :403-420: the Biot material
HYD = {"porosity": [0.1], "hydraulic_perm": [1e-15],
       "fluid_bulk_modulus": [2.2e9], "biot_coeff": [0.8]}
HYD_FIELDS = ("ppressure", "dppressure", "old_mean_stress",
              "hydro_diff_max")


def rsf_cfg(rheology, state_var_model):
    """tests/test_flat.py:220-281: simple shear of a 1 m box, no gravity,
    fixed dt, global velocity scaling."""
    return {
        "sim": {"ndims": 2, "float_dtype": "float64",
                "is_outputting_averaged_fields": False},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 0,
                 "xlength": 1.0, "ylength": 0.0, "zlength": 1.0,
                 "resolution": 1.0, "quality_check_step_interval": 10**8},
        "control": {"gravity": 0.0, "fixed_dt": 1.0,
                    "inertial_scaling": 1e5,
                    "use_global_velocity_scaling": True,
                    "damping_option": 1, "has_thermal_diffusion": False},
        "ic": {"weakzone_option": 0},
        "bc": {"vbc_x0": 1, "vbc_val_x0": 0.0, "vbc_x1": 1,
               "vbc_val_x1": 0.0, "vbc_z0": 1, "vbc_val_z0": 0.0,
               "vbc_z1": 4, "vbc_val_z1": 1e-5},
        "mat": {"rheology_type": rheology, "is_plane_strain": True,
                "rho0": [1.0], "alpha": [0.0],
                "bulk_modulus": [2e8], "shear_modulus": [2e8],
                "cohesion0": [1e6], "cohesion1": [1e6],
                "friction_angle0": [30.0], "friction_angle1": [30.0],
                "direct_a": [0.2], "evolution_b": [0.1],
                "characteristic_distance": [1e-3],
                "characteristic_velocity": [1e-6],
                "state_var_model": state_var_model},
    }


# (config, steps, extra fields, fields judged at another field's scale)
CASES = {
    # the Winkler foundation, water loading on a top below the base level
    # (raised to 10 m, as tests/test_pallas3d.py:233) and a free x1 wall:
    # the three facet kinds (tests/test_flat.py:205-218); with them the
    # elastic foundation and surface process 1
    "facets_foundation_surface_process_1": (flat_cfg(
        "maxwell",
        control={"surf_base_level": 10.0, "surface_process_option": 1,
                 "surface_diffusivity": 1e-6,
                 "has_surface_correction": True},
        bc={"has_winkler_foundation": True, "has_water_loading": True,
            "winkler_delta_rho": 100.0, "vbc_x1": 0,
            "has_elastic_foundation": True}), 20,
        ("dhacc", "edvacc_surf"), {}),
    # tests/test_flat.py:83-100
    "surface_process_102": (flat_cfg(
        control={"surface_process_option": 102,
                 "surface_diffusivity": 1e-6,
                 "has_surface_correction": True,
                 "terrig_sediment_area": 3.17e-7}), 20,
        ("dhacc", "edvacc_surf"), {}),
    # tests/test_flat.py:188-203
    "hydraulic": (flat_cfg(
        "maxwell", control={"has_hydraulic_diffusion": True}, mat=HYD),
        20, HYD_FIELDS, {}),
    # tests/test_flat.py:403-420: a structured mesh lands on flat2d
    "hydraulic_structured": (flat_cfg(
        mesh={"meshing_elem_shape": 1},
        control={"has_hydraulic_diffusion": True},
        mat={"porosity": [0.1], "hydraulic_perm": [1e-15],
             "fluid_rho0": [1000.0], "fluid_bulk_modulus": [2e9],
             "fluid_visc": [1e-3], "biot_coeff": [0.8]}), 20,
        ("ppressure",), {"dppressure": "ppressure"}),
    # tests/test_flat.py:220-281, and the visco-plastic variant with the
    # aging law
    "ep_rsf": (rsf_cfg("elasto-plastic-rate-state-friction", 0), 30,
               ("dyn_fric_coeff", "state_variable"),
               {"stressyy": "stress", "edvoldt": "strain_rate"}),
    "evp_rsf_aging": (rsf_cfg("elasto-visco-plastic-rate-state-friction",
                              1), 30,
                      ("dyn_fric_coeff", "state_variable"),
                      {"stressyy": "stress", "edvoldt": "strain_rate"}),
    # tests/test_flat.py:570-598
    "pseudo_transient": (flat_cfg(
        control={"has_PT": True, "PT_max_iter": 8,
                 "PT_relative_tolerance": 1e-12}), 6, (), {}),
    "pseudo_transient_hydraulic_neumann": (flat_cfg(
        "elastic",
        control={"has_PT": True, "PT_max_iter": 8,
                 "PT_relative_tolerance": 1e-12,
                 "has_hydraulic_diffusion": True,
                 "has_thermal_diffusion": False},
        bc={"vbc_z0": 1, "vbc_val_z0": 0.0, "stress_bc_z1": 3,
            "stress_val_z1": -1e5},
        mat={"porosity": [0.3], "hydraulic_perm": [1e-13],
             "biot_coeff": [1.0], "fluid_bulk_modulus": [2.2e9]}), 6,
        ("ppressure", "old_mean_stress", "hydro_diff_max"),
        {"dppressure": "ppressure"}),
}


def assert_case_close(ref, out, fields, scaled, tol=1e-10):
    for f in fields:
        if f in scaled:
            continue
        assert ref[f].shape == out[f].shape and ref[f].dtype == out[f].dtype
        err = rel_err(ref[f], out[f])
        assert err < tol, (f, err)
    for f, by in scaled.items():
        err = (np.abs(ref[f] - out[f]).max()
               / max(np.abs(ref[by]).max(), 1e-300))
        assert err < tol, (f, by, err)
    assert int(out["steps"]) == int(ref["steps"])


def test_f32_production_maxwell_20_steps_vs_band_engine():
    """The production feature set (Winkler delta rho 100, water loading,
    surface process 1 at 1e-6 m^2/s with the surface correction, two
    materials by 4 markers per element, damping 2) on the Delaunay box,
    maxwell, float32."""
    cfg = flat_cfg(
        "maxwell", "float32",
        control={"surface_process_option": 1, "surface_diffusivity": 1e-6,
                 "has_surface_correction": True, "damping_option": 2,
                 "damping_factor": 0.4},
        bc={"has_winkler_foundation": True, "has_water_loading": True,
            "winkler_delta_rho": 100.0},
        markers={"markers_per_element": 4, "init_marker_option": 1},
        ic={"mattype_layer_depths": [0.3], "layer_mattypes": [0, 1]},
        mat={"nmat": 2, "rho0": [2800.0, 3300.0],
             "bulk_modulus": [50e9, 80e9], "shear_modulus": [30e9, 48e9]})
    ref, out = run_both(cfg, 20, band=True)
    amplified = ("vel", "strain_rate", "edvoldt", "dhacc", "edvacc_surf")
    for f in MAXWELL_FIELDS + amplified[3:]:
        tol = 5e-3 if f in amplified else (1e-3 if f == "force" else 2e-4)
        err = rel_err(ref[f], out[f])
        assert err < tol, (f, err)
    va = np.log(ref["viscosity"].astype(np.float64))
    vb = np.log(out["viscosity"].astype(np.float64))
    assert np.median(np.abs(va - vb)) < 0.02
    for f in ("dt", "time", "max_global_vel_mag"):
        assert abs(float(ref[f]) - float(out[f])) \
            <= 1e-5 * abs(float(ref[f])), f
    assert np.abs(out["dhacc"]).max() > 0
    assert (out["emw"][:, 1] > 0).any()


def test_3d_hydraulic_names_flat3d():
    """A 3D config off the fused gate (hydraulic diffusion on the
    structured box) takes flat3d in both packages, with the gather tables
    at npe = 4."""
    cfg = make_sim3d_cfg(control={"has_hydraulic_diffusion": True},
                         mat={"is_plane_strain": False, **HYD})
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    js._chunk_fn(1)
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    ts._chunk_fn(1)
    assert js.step_path == ts.step_path == "flat3d"
    assert ts.ctx.band.npe == 4 and ts.ctx.sgrid is not None


@pytest.mark.parametrize("switch,cfg,path", [
    ("DES_NO_PALLAS", make_sim_cfg(), "grid2d"),
    ("DES_NO_PALLAS", make_sim3d_cfg(), "grid3d"),
    ("DES_NO_FLAT", flat_cfg(), "generic")],
    ids=["no_pallas_2d", "no_pallas_3d", "no_flat"])
def test_dispatch_switches_match_jax(switch, cfg, path, monkeypatch):
    """Under each switch the port takes the JAX package's path (grid2d,
    grid3d, generic): without it both take pallas2d_res, pallas3d and
    flat2d.  Read when the runner is built."""
    monkeypatch.setenv(switch, "1")
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    js._chunk_fn(1)
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    assert js.step_path == path
    ts._chunk_fn(1)
    assert ts.step_path == js.step_path


# ---- the functions on one input

def _sims(cfg):
    return (jdes.Simulation(jdes.param_from_dict(cfg)),
            tdes.Simulation(tdes.param_from_dict(cfg), device="cpu"))


@functools.lru_cache(maxsize=None)
def _shared_sims(what):
    """Both packages' Simulations, built once for the tests that read only
    their tables and parameters."""
    if what == "surface":
        return _sims(flat_cfg(control={"surface_process_option": 102,
                                       "surface_diffusivity": 1e-6}))
    cfg = rsf_cfg("elasto-plastic-rate-state-friction", 0)
    cfg["mat"].update({"num_materials": 2, "rho0": [1.0, 1.0],
                       "alpha": [0.0, 0.0],
                       "bulk_modulus": [2e8, 2e8],
                       "shear_modulus": [2e8, 2e8],
                       "cohesion0": [1e6, 2e6], "cohesion1": [1e6, 5e5],
                       "friction_angle0": [30.0, 20.0],
                       "friction_angle1": [30.0, 10.0],
                       "direct_a": [0.2, 0.01], "evolution_b": [0.1, 0.02],
                       "characteristic_distance": [1e-3, 1e-2],
                       "characteristic_velocity": [1e-6, 1e-9]})
    return _sims(cfg)


def _close(a, b, tol=1e-13):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-300)


def test_stress_bcs_on_one_input():
    """apply_stress_bcs (Winkler, water, side walls with the hydraulic
    reference density, the elastic foundation) and
    apply_stress_bcs_neumann on a moved mesh, from the same force."""
    cfg = flat_cfg(
        "maxwell", control={"surf_base_level": 10.0,
                            "has_hydraulic_diffusion": True},
        mat=HYD,
        bc={"has_winkler_foundation": True, "has_water_loading": True,
            "winkler_delta_rho": 100.0, "vbc_x1": 0,
            "has_elastic_foundation": True,
            "stress_bc_x0": 1, "stress_val_x0": 2e6,
            "stress_bc_z0": 3, "stress_val_z0": -1e6})
    js, ts = _sims(cfg)
    assert ts.ctx.sbc.n_grav > 0 and ts.ctx.sbc.n_neu > 0
    assert set(ts.ctx.sbc.kind.tolist()) == {0, 1, 2}
    rng = np.random.default_rng(3)
    coord0 = np.asarray(js.state.coord)
    coord = coord0 + rng.normal(0.0, 30.0, coord0.shape)
    force = rng.normal(0.0, 1e9, coord0.shape)
    rho = 2800.0 + rng.normal(0.0, 50.0, js.topo.nelem)
    cp = 3.5e8
    j = jnp.asarray
    want = jbc.apply_stress_bcs_neumann(
        js.ctx.sbc, j(coord),
        jbc.apply_stress_bcs(js.param, js.ctx.sbc, j(coord), j(force),
                             j(rho), cp, j(coord0)))
    sbc = ts.ctx.sbc.on("cpu")
    t = torch.as_tensor
    got = tbc.apply_stress_bcs_neumann(
        sbc, t(coord),
        tbc.apply_stress_bcs(ts.param, sbc, t(coord), t(force), t(rho), cp,
                             t(coord0)))
    _close(want, got.numpy())
    assert np.abs(got.numpy() - force).max() > 0


def _top(js):
    top = np.asarray(js.ctx.surf.top_nodes)
    x = np.asarray(js.state.coord)[top, 0]
    assert (np.diff(x) > 0).all()   # the top nodes run along x
    return top, x


def test_surface_dh_2d_on_one_input():
    js, ts = _shared_sims("surface")
    top, x = _top(js)
    coord = np.array(js.state.coord)
    coord[top, 1] = 300.0 * np.sin(x / 2e3) - 50.0
    st = tSP.surf_tables(ts.ctx.surf, ts.ctx.nnode, torch.float64, "cpu")
    for ratios in ((1.0, 1.0), (0.5, 2.0)):
        want = jSP.surface_dh_2d(jnp.asarray(coord), js.ctx.surf, 1e-6,
                                 3e10, 0.0, *ratios)
        got = tSP.surface_dh_2d(torch.as_tensor(coord), st, 1e-6,
                                torch.tensor(3e10, dtype=torch.float64),
                                0.0, *ratios)
        _close(want, got.numpy())


def check_f64_matches_jax(case):
    cfg, n, extra, scaled = CASES[case]
    ref, out = run_both(cfg, n)
    assert_case_close(ref, out, FLAT_FIELDS + extra, scaled)
    # the feature moved something
    if "surface_process" in case:
        assert np.abs(out["dhacc"]).max() > 0
    if "hydraulic" in case:
        assert np.abs(out["dppressure"]).max() > 0
    if "rsf" in case:
        assert np.ptp(out["dyn_fric_coeff"]) > 0
        if "aging" in case:
            assert np.ptp(out["state_variable"]) > 0
