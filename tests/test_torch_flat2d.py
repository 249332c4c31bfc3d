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

import numpy as np
import pytest

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu_torch.ops import flat2d as tflat
from dynearthsol_tpu_torch.state import FIELD_NAMES, state_to_numpy
from torch_cases import (FLAT_FIELDS, assert_maxwell_close, flat_cfg,
                         make_sim_cfg, rel_err, run_both)


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
