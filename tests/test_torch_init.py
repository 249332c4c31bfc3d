"""The port's initial State against the JAX package's, on the make_sim
config (tests/test_pallas.py) and a flagship-shaped 64 x 128-cell config
with default markers.

Host-built fields (mesh, markers, initial conditions) and integers must be
bitwise equal.  Fields computed in f32 on the device (volumes, masses, the
CFL scalars, viscosity) may differ by association order: 4 ulp relative to
each field's max (5e-7); in f64, 1e-12.
"""

import numpy as np
import pytest

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu_torch.state import FIELD_NAMES, state_to_numpy
from torch_cases import flagship_cfg, make_sim_cfg, rel_err

COMPUTED = ("volume", "volume_old", "volume_n", "mass", "tmass", "hmass",
            "ymass", "viscosity", "dt", "max_global_vel_mag",
            "global_dt_min", "vel")


@pytest.mark.parametrize(
    "cfg", [make_sim_cfg(), make_sim_cfg(sim={"float_dtype": "float64"}),
            flagship_cfg(64, 128)],
    ids=["make_sim", "make_sim_f64", "flagship_64x128"])
def test_initial_state_matches_jax(cfg):
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    out = state_to_numpy(ts.state)
    tol = 5e-7 if cfg["sim"]["float_dtype"] == "float32" else 1e-12
    for f in FIELD_NAMES:
        a = np.asarray(getattr(js.state, f))
        b = out[f]
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if f in COMPUTED:
            assert rel_err(a, b) <= tol, (f, rel_err(a, b))
        else:
            assert np.array_equal(a, b), f
    assert ts.ctx.sgrid == js.ctx.sgrid
    np.testing.assert_array_equal(ts.topo.gather_idx, js.topo.gather_idx)
    for i in range(len(js.topo.bfacets)):
        np.testing.assert_array_equal(ts.topo.bfacets[i],
                                      js.topo.bfacets[i])
    assert ts.compensation_pressure == js.compensation_pressure
    if cfg["sim"]["float_dtype"] == "float32":
        js._chunk_fn(10)
        ts._chunk_fn(10)
        assert ts.step_path == js.step_path == "pallas2d_res"


def test_tiled_dispatch_matches_jax():
    """Off the resident gate (global velocity scaling) both packages
    dispatch to the per-step tiled kernel."""
    cfg = make_sim_cfg(control={"use_global_velocity_scaling": True})
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    js._chunk_fn(1)
    ts._chunk_fn(1)
    assert ts.step_path == js.step_path == "pallas2d"


def test_unported_config_raises():
    """A config the JAX package runs on its grid2d path has no step here."""
    cfg = make_sim_cfg(sim={"float_dtype": "float64"})
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    with pytest.raises(NotImplementedError, match="grid2d"):
        ts.run_steps(1)
