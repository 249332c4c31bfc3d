"""The port's column step (ops/flat2d.py) against the JAX package's
flat2d on the Delaunay box of tests/test_flat.py, from the same initial
state (the JAX Simulation's, loaded with state_from_numpy), on the CPU.

Tolerances, each of a field's max:
  f64, 20 steps (maxwell and EVP) and 2-10 steps of every switch: 1e-10.
    The JAX test holds flat against generic at 1e-12; torch and XLA differ
    in exp/log by ulps.
  f32 maxwell, 20 steps, against the JAX band engine: the maxwell gate of
    tests/test_pallas.py:91-106 (2e-4, force 1e-3), as the fused 2D port is
    held.  Not the 1e-5 that the JAX package holds between its own two
    engines: XLA on the CPU contracts a * b + c into a fused multiply-add,
    PyTorch rounds twice, so after one step 16 % of the post-move volumes
    differ by an ulp, which maxwell's dv = V / V_old - 1 multiplies by the
    bulk modulus (measured 1.5e-4 after 20 steps).
  f32 EVP, 1 step: 1e-5.
"""

import dataclasses

import numpy as np
import pytest

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.ops import band2d as jband
from dynearthsol_tpu.ops import flat2d as jflat
from dynearthsol_tpu_torch.ops import flat2d as tflat
from dynearthsol_tpu_torch.state import (FIELD_NAMES, state_from_numpy,
                                         state_to_numpy)
from torch_cases import (FLAT_FIELDS, assert_maxwell_close, flat_cfg,
                         make_sim_cfg, rel_err)


def run_both(cfg, n, band=False):
    """n steps of both flat chunk runners from the JAX initial state; with
    ``band`` the JAX side runs its band engine (ctx.band set as
    tests/test_flat.py:443-461 does).  Returns numpy dicts (jax, torch)."""
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
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
    assert ts.step_path == "flat2d"
    return ({f: np.asarray(getattr(ref, f)) for f in FIELD_NAMES},
            state_to_numpy(out))


def assert_fields_close(ref, out, tol, fields=FLAT_FIELDS):
    for f in fields:
        assert ref[f].shape == out[f].shape and ref[f].dtype == out[f].dtype
        err = rel_err(ref[f], out[f])
        assert err < tol, (f, err)
    assert int(out["steps"]) == int(ref["steps"])


@pytest.mark.parametrize("rheology", ["maxwell", "elasto-visco-plastic"])
def test_f64_20_steps(rheology):
    ref, out = run_both(flat_cfg(rheology), 20)
    assert_fields_close(ref, out, 1e-10)


def test_f32_maxwell_20_steps_vs_band_engine():
    ref, out = run_both(flat_cfg("maxwell", "float32"), 20, band=True)
    assert_maxwell_close(ref, out, lambda s, f: s[f])
    assert_fields_close(ref, out, 1e-5, ("temperature", "ymass", "dt",
                                          "global_dt_min", "time"))


def test_f32_evp_one_step_vs_band_engine():
    ref, out = run_both(flat_cfg(dtype="float32"), 1, band=True)
    assert_fields_close(ref, out, 1e-5)


TWO_MATS = {"mat": {"rho0": [2800.0, 3300.0], "bulk_modulus": [50e9, 120e9],
                    "shear_modulus": [30e9, 70e9], "num_materials": 2},
            "ic": {"mattype_option": 0, "num_mattype_layers": 2,
                   "layer_mattypes": [0, 1], "mattype_layer_depths": [0.5]}}

# every switch the step reads, a few per case, as (overrides, steps): 10
# steps cross the plstrain decay (quality-check interval 7) and the dt
# refresh (step 10).  Two steps where the config itself is unstable on this
# coarse mesh (viscous flow, damping 4 and global velocity scaling run away
# within a few steps in both packages, and roundoff with them).  The
# dynamic run (true density, metres per second) is on maxwell: its EVP
# min-select flips on an ulp at step 2 even in f64.
SWITCH_CASES = {
    "elastic_damping0": ({"mat": {"rheology_type": "elastic"},
                          "control": {"damping_option": 0}}, 10),
    "viscous_damping2": ({"mat": {"rheology_type": "viscous"},
                          "control": {"damping_option": 2,
                                      "damping_factor": 0.4}}, 2),
    "elasto_plastic_two_materials_damping3_no_nmd": (
        {"mat": {"rheology_type": "elasto-plastic", **TWO_MATS["mat"]},
         "ic": TWO_MATS["ic"],
         "control": {"damping_option": 3, "damping_factor": 0.4,
                     "is_using_mixed_stress": False}}, 10),
    "damping4_global_velocity_scaling": (
        {"control": {"damping_option": 4, "damping_factor": 0.4,
                     "use_global_velocity_scaling": True}}, 2),
    "maxwell_dynamic_no_thermal_no_surface_correction": (
        {"mat": {"rheology_type": "maxwell"},
         "control": {"is_quasi_static": False,
                     "has_thermal_diffusion": False,
                     "has_surface_correction": False}}, 10),
    "averaged_fields_weakzone": (
        {"sim": {"is_outputting_averaged_fields": True},
         "ic": {"weakzone_option": 1}}, 10),
    "maxwell_no_gravity_fixed_dt_fixed_mesh": (
        {"mat": {"rheology_type": "maxwell"},
         "control": {"gravity": 0.0, "fixed_dt": 1e7,
                     "has_moving_mesh": False}}, 10),
}


@pytest.mark.parametrize("case", list(SWITCH_CASES))
def test_f64_switches(case):
    over, n = SWITCH_CASES[case]
    ref, out = run_both(flat_cfg(**over), n)
    fields = FLAT_FIELDS
    if "averaged" in case:
        fields += ("stress_avg", "delta_plstrain_avg", "coord_avg0",
                   "strain_avg0", "time_avg0")
        assert np.abs(out["stress_avg"]).max() > 0
    if "two_materials" in case:
        assert out["emw"].shape[1] == 2 and (out["emw"][:, 1] > 0).any()
    assert_fields_close(ref, out, 1e-10, fields)


GATE_CASES = {
    "unstructured_evp": flat_cfg(),
    "structured": flat_cfg(mesh={"meshing_elem_shape": 1}),
    "pseudo_transient": flat_cfg(control={"has_PT": True}),
    "ep_not_plane_strain": flat_cfg("elasto-plastic",
                                    mat={"is_plane_strain": False}),
    "maxwell_not_plane_strain": flat_cfg("maxwell",
                                         mat={"is_plane_strain": False}),
    "fused_2d": make_sim_cfg(),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gate_matches_jax(case):
    """flat_step_applicable over the configs of tests/test_flat.py:324-345
    and the edges of its rheology clause."""
    cfg = GATE_CASES[case]
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    want = jflat.flat_step_applicable(js.param, js.ctx)
    assert tflat.flat_step_applicable(ts.param, ts.ctx) == want
    assert want == (case != "ep_not_plane_strain")


REFUSED = {
    "pseudo-transient": {"control": {"has_PT": True}},
    "surface process option 102": {
        "control": {"surface_process_option": 102,
                    "surface_diffusivity": 1e-6}},
    "gravity-facet": {"bc": {"has_winkler_foundation": True}},
    "Neumann": {"bc": {"stress_bc_x1": 1, "stress_val_x1": 1e6,
                       "vbc_x1": 0}},
    "elastic foundation": {"bc": {"has_elastic_foundation": True}},
}


@pytest.mark.parametrize("what", list(REFUSED))
def test_refused_features_raise(what):
    ts = tdes.Simulation(tdes.param_from_dict(flat_cfg(**REFUSED[what])),
                         device="cpu")
    assert tflat.flat_step_applicable(ts.param, ts.ctx)
    with pytest.raises(NotImplementedError, match=what):
        ts.run_steps(1)
    assert ts.step_path is None


@pytest.mark.parametrize("over", [
    {"control": {"has_hydraulic_diffusion": True}},
    {"mat": {"rheology_type": "elasto-plastic-rsf"}}],
    ids=["hydraulic", "rsf"])
def test_refused_at_construction(over):
    with pytest.raises(NotImplementedError):
        tdes.Simulation(tdes.param_from_dict(flat_cfg(**over)), device="cpu")


def test_flat_step_needs_tables():
    ts = tdes.Simulation(tdes.param_from_dict(flat_cfg()), device="cpu")
    with pytest.raises(ValueError, match="build_tables"):
        tflat.make_chunk_runner(ts.param, ts.ctx, 0.0, 1)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_slice_matches_jax(dtype):
    """The slice as a user calls it, each package from its own initial
    state: Simulation(param).run_steps(20, chunk=10), maxwell (an EVP
    trajectory parts at the first min-select tie).  f64: 1e-9 (the initial
    volumes differ by an ulp); f32: the maxwell gate."""
    cfg = flat_cfg("maxwell", dtype)
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    ref = js.run_steps(20, chunk=10)
    out = state_to_numpy(ts.run_steps(20, chunk=10))
    assert ts.step_path == js.step_path == "flat2d"
    ref = {f: np.asarray(getattr(ref, f)) for f in FIELD_NAMES}
    assert int(out["steps"]) == 20
    if dtype == "float64":
        assert_fields_close(ref, out, 1e-9)
    else:
        assert_maxwell_close(ref, out, lambda s, f: s[f])
