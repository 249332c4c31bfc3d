"""The port's 3D generic step (ops/flat3d.py in its generic mode) against
the JAX package's generic step (simulation.make_step_fn), on the CPU, in
float64, under DES_NO_FLAT (the JAX package's only way to its generic
step in 3D), each from the JAX initial state on the 3D Delaunay box of
torch_cases.flat3d_cfg (886 tets).

The cases carry tests/test_torch_generic2d.py's to 3D: they cover the
choices where the generic step differs from flat3d (the pseudo-mass
scaled by this step's velocity maximum under global velocity scaling, the
fluid-filled density of the hydraulic mass and facet loads, the
pore-pressure update after the force assembly) and the pseudo-transient
loop.  Tolerance 1e-10 of each field's max, as the flat cases; dpressure
at the stress's scale and dppressure at the pore pressure's (see
tests/test_torch_flat3d.py).  EVP runs one step, with a cohesion that
lets a few elements yield, from the state of three maxwell generic steps
of the JAX package, as flat3d's EVP case runs from a deformed state: from
rest the min-select ties where an element's corners have not moved.
"""

import jax
import numpy as np
import pytest

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.simulation import make_step_fn
from dynearthsol_tpu_torch.state import (FIELD_NAMES, state_from_numpy,
                                         state_to_numpy)
from torch_cases import FLAT_FIELDS, flat3d_cfg

HYD = {"porosity": [0.1], "hydraulic_perm": [1e-15],
       "fluid_bulk_modulus": [2.2e9], "biot_coeff": [0.8]}
WEAK = {"cohesion0": [3e4], "cohesion1": [3e4], "friction_angle0": [0.0],
        "friction_angle1": [0.0]}
HYD_FIELDS = ("ppressure", "dppressure", "old_mean_stress",
              "hydro_diff_max")

# (config, steps, extra fields); a case named evp_* starts from three
# maxwell steps (the module docstring)
CASES = {
    "maxwell_hydraulic_global_velocity_scaling": (flat3d_cfg(
        mat=dict(HYD), control={"has_hydraulic_diffusion": True,
                                "use_global_velocity_scaling": True}),
        3, HYD_FIELDS),
    "ep_hydraulic_dynamic_winkler": (flat3d_cfg(
        "elasto-plastic", mat=dict(HYD),
        control={"has_hydraulic_diffusion": True,
                 "is_quasi_static": False},
        bc={"has_winkler_foundation": True, "winkler_delta_rho": 100.0}),
        4, HYD_FIELDS),
    "maxwell_pseudo_transient": (flat3d_cfg(
        control={"has_PT": True, "PT_max_iter": 8,
                 "PT_relative_tolerance": 1e-12}), 3, ()),
    "evp_one_step_surface1": (flat3d_cfg(
        "elasto-visco-plastic", mat=dict(WEAK),
        control={"surface_process_option": 1,
                 "surface_diffusivity": 1e-6}), 1,
        ("dhacc", "edvacc_surf")),
}

SCALE_OF = {"dpressure": "stress", "dppressure": "ppressure"}


@pytest.mark.parametrize("case", list(CASES))
def test_f64_matches_jax_generic3d(case, monkeypatch):
    cfg, n, extra = CASES[case]
    monkeypatch.setenv("DES_NO_FLAT", "1")
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    js._chunk_fn(n)
    assert js.step_path == "generic"
    start = js.state
    if case.startswith("evp"):
        maxwell = jdes.param_from_dict({**cfg, "mat": {
            **cfg["mat"], "rheology_type": "maxwell"}})
        mstep = jax.jit(make_step_fn(maxwell, js.compensation_pressure))
        for _ in range(3):
            start = mstep(js.ctx, start)
    step = jax.jit(make_step_fn(js.param, js.compensation_pressure))
    ref = start
    for _ in range(n):
        ref = step(js.ctx, ref)
    s0 = state_from_numpy({f: np.asarray(getattr(start, f))
                           for f in FIELD_NAMES}, dtype=ts.dtype)
    run = ts._chunk_fn(n)
    out = state_to_numpy(run(ts.ctx, s0))
    assert ts.step_path == "generic"
    for f in FLAT_FIELDS + extra + ("dpressure",):
        r = np.asarray(getattr(ref, f), dtype=np.float64)
        scale = np.abs(np.asarray(getattr(ref, SCALE_OF.get(f, f)))).max()
        err = np.abs(r - out[f]).max()
        assert err <= 1e-10 * scale or err == 0.0, (f, err, scale)
    if cfg["control"].get("has_PT"):
        assert run.stats["pt_iterations"] > n
