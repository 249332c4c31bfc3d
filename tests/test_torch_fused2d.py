"""The port's fused 2D step (ops/fused2d.py, plain version on the CPU)
against the JAX package's Pallas step (ops/pallas2d.py, interpret mode as
tests/test_pallas.py runs it), both started from the same JAX State
(state_from_numpy).  Tolerances are test_pallas.py's: a maxwell trajectory
gate and a one-step EVP gate, because the EVP min-select
(rheology.cxx:869-879) flips at f32 roundoff and then amplifies.  One pair
of Simulations serves the EVP cases that differ only in the step (the
damping options: the param of each case on the shared mesh and state),
and one the maxwell ones."""

import numpy as np
import pytest
import torch

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.ops import pallas2d
from dynearthsol_tpu_torch.ops import fused2d
from dynearthsol_tpu_torch.state import FIELD_NAMES, state_from_numpy
from torch_cases import (assert_maxwell_close, assert_resident_matches_tiled,
                         make_sim_cfg, rel_err)


def get(s, f):
    v = getattr(s, f)
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _sims(cfg):
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    s0 = state_from_numpy({f: np.asarray(getattr(js.state, f))
                           for f in FIELD_NAMES}, dtype=torch.float32)
    return js, ts, s0


def _jax_run(js, n, resident=False):
    old = pallas2d.INTERPRET
    pallas2d.INTERPRET = True
    try:
        mk = (pallas2d.make_resident_chunk_runner if resident
              else pallas2d.make_chunk_runner)
        return mk(js.param, js.ctx, js.compensation_pressure, n)(
            js.ctx, js.state)
    finally:
        pallas2d.INTERPRET = old


def _port_run(ts, s0, n, resident=False):
    mk = (fused2d.make_resident_chunk_runner if resident
          else fused2d.make_chunk_runner)
    return mk(ts.param, ts.ctx, ts.compensation_pressure, n)(ts.ctx, s0)


@pytest.fixture(scope="module")
def evp():
    return _sims(make_sim_cfg())


@pytest.fixture(scope="module")
def maxwell():
    return _sims(make_sim_cfg(mat={"rheology_type": "maxwell"}))


def test_maxwell_10_steps(maxwell):
    """Ends on a dt-refresh step (dynearthsol.cxx:861-871 cadence)."""
    js, ts, s0 = maxwell
    assert_maxwell_close(_jax_run(js, 10), _port_run(ts, s0, 10), get)


CASES = {f"damping{k}": {"control": {"damping_option": k,
                                     "damping_factor": 0.4}}
         for k in range(5)}
CASES["two_materials"] = {
    "markers": {"markers_per_element": 4, "init_marker_option": 1},
    "ic": {"mattype_layer_depths": [0.3], "layer_mattypes": [0, 1]},
    "mat": {"nmat": 2, "rho0": [2800.0, 3300.0],
            "bulk_modulus": [50e9, 80e9], "shear_modulus": [30e9, 48e9]}}


def test_resident_25_steps(evp, maxwell):
    """Across dt refreshes at steps 10 and 20.  EVP: the resident runner
    against the port's tiled runner, same core (test_pallas.py:151-169
    bounds; the branch-selected fields may show a near-tie flip).  Maxwell:
    the port's resident runner against the JAX resident kernel, at the
    25-step bounds test_pallas.py:171-183 sets between two
    implementations."""
    n = 25
    js, ts, s0 = evp
    assert_resident_matches_tiled(_port_run(ts, s0, n),
                                  _port_run(ts, s0, n, resident=True), get)

    js, ts, s0 = maxwell
    ref = _jax_run(js, n, resident=True)
    out = _port_run(ts, s0, n, resident=True)
    tols = {"force": 2e-3, "vel": 1e-3, "stress": 1e-3, "plstrain": 5e-4}
    for f in ("coord", "vel", "temperature", "stress", "strain",
              "plstrain", "volume", "mass"):
        err = rel_err(get(ref, f), get(out, f))
        assert err < tols.get(f, 2e-4), (f, err)
    for f in ("dt", "time", "max_global_vel_mag", "steps"):
        a, b = float(get(ref, f)), float(get(out, f))
        assert abs(a - b) <= 1e-5 * max(abs(a), 1e-300), f


def test_volume_fixed_point():
    """A step with dt = 0 leaves coordinates unchanged, so the post-move
    volume must equal the initial volume bit for bit (simulation.py
    initialises it with the same operations)."""
    ts = tdes.Simulation(tdes.param_from_dict(make_sim_cfg()), device="cpu")
    P = fused2d.make_plan(ts.param, ts.ctx, "cpu", ts.compensation_pressure)
    b = fused2d.make_buffers(P, ts.ctx, ts.state, 1, tiled=False)
    b.scal[0] = 0.0
    fused2d.fused_chunk(P, b, 1, tiled=False)
    vol = fused2d._eslot("volume")
    assert torch.equal(b.ein[vol], b.eout[vol])
