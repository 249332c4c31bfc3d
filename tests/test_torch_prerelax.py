"""The isostasy and body-force pre-relaxations of the port
(Simulation.isostasy_adjustment, Simulation.body_force_adjustment, built
from the column steps' pieces) against the JAX package's, on the CPU in
float64, each from the JAX initial state.

Each case holds the returned step or iteration count equal to the JAX
package's and every State field within 1e-10 of its max, as the flat
cases; dpressure (a difference of traces, zero but for rounding where the
stress is hydrostatic) is judged at the stress's scale and dppressure (a
per-step increment) at the pore pressure's.  The isostasy times are cut to
a few steps at each mesh's initial dt (1.8e6 s on the 2D Delaunay box);
the body-force cases run until the residual's relative change drops below
the tolerance, or to PT_max_iter.
"""

import numpy as np
import pytest

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu_torch.state import (FIELD_NAMES, state_from_numpy,
                                         state_to_numpy)
from torch_cases import flat3d_cfg, flat_cfg, make_sim_cfg

HYD = {"porosity": [0.1], "hydraulic_perm": [1e-15],
       "fluid_bulk_modulus": [2.2e9], "biot_coeff": [0.8]}
WINKLER = {"has_winkler_foundation": True, "winkler_delta_rho": 100.0}
PT = {"has_PT": True, "PT_max_iter": 30}

# (config, method)
CASES = {
    # the bottom held (no Winkler foundation)
    "isostasy_2d_delaunay": (flat_cfg(
        ic={"isostasy_adjustment_time_in_yr": 0.3}), "isostasy_adjustment"),
    # the bottom free on the foundation; the fluid-filled density of the
    # facet loads and the mass, and the Biot increment
    "isostasy_2d_delaunay_winkler_hydraulic": (flat_cfg(
        "elasto-plastic", ic={"isostasy_adjustment_time_in_yr": 0.3},
        bc=dict(WINKLER), mat=dict(HYD),
        control={"has_hydraulic_diffusion": True}), "isostasy_adjustment"),
    "isostasy_2d_raster_winkler": (make_sim_cfg(
        sim={"float_dtype": "float64"}, bc=dict(WINKLER),
        ic={"isostasy_adjustment_time_in_yr": 0.3}), "isostasy_adjustment"),
    "isostasy_3d_delaunay": (flat3d_cfg(
        ic={"isostasy_adjustment_time_in_yr": 0.006}),
        "isostasy_adjustment"),
    "body_force_2d": (flat_cfg(
        ic={"has_body_force_adjustment": True},
        control={**PT, "PT_relative_tolerance": 1e-3}),
        "body_force_adjustment"),
    # hydraulic diffusion suspended in the loop, the mesh moving
    "body_force_3d_hydraulic_moving_mesh": (flat3d_cfg(
        "elasto-plastic", ic={"has_body_force_adjustment": True},
        mat=dict(HYD), control={**PT, "PT_relative_tolerance": 1e-12,
                                "has_hydraulic_diffusion": True,
                                "has_moving_mesh": True}),
        "body_force_adjustment"),
}

# fields judged at another field's scale (the module docstring)
SCALE_OF = {"dpressure": "stress", "dppressure": "ppressure"}


@pytest.mark.parametrize("case", list(CASES))
def test_prerelaxation_matches_jax(case):
    cfg, method = CASES[case]
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    ts.state = state_from_numpy({f: np.asarray(getattr(js.state, f))
                                 for f in FIELD_NAMES}, dtype=ts.dtype)
    n_jax = getattr(js, method)()
    n_port = getattr(ts, method)()
    assert n_port == n_jax > 1
    out = state_to_numpy(ts.state)
    ref = {f: np.asarray(getattr(js.state, f), dtype=np.float64)
           for f in FIELD_NAMES}
    for f in FIELD_NAMES:
        scale = np.abs(ref[SCALE_OF.get(f, f)]).max(initial=0.0)
        err = np.abs(ref[f] - out[f]).max(initial=0.0)
        assert err <= 1e-10 * scale or err == 0.0, (f, err, scale)
    if method == "body_force_adjustment":
        # one host read of the loop's condition per iteration after the
        # first, and one more where the tolerance ended it
        assert ts.prerelax_stats["host_syncs"] in (n_port - 1, n_port)
