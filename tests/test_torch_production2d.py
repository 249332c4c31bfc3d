"""The port's fused 2D step on the production feature set
(tests/test_pallas.py _production_sim: Winkler foundation, water loading,
surface process 1, the surface-element correction, two materials; 16 x 128
cells), plain version on the CPU, against the JAX package's Pallas step in
interpret mode, both started from the same JAX State (state_from_numpy).
One JAX Simulation and one of the port serve every case: the rheology and
the base level change only the step, so each case is a param of its own on
the shared mesh, state and compensation pressure.  The maxwell trajectory
raises the base level 1 km above the top, so that water loads every top
facet (at the default level the flat top takes no water pressure).

Tolerances:

- One EVP step: the one-step gate of tests/test_torch_fused2d.py (2e-6 of
  each field's max) on coord, stress, strain, plstrain and force, and on
  the velocity at the scale of its increment dt f / m, the force's gate
  carried over.  The velocity's own max is the side walls' 1e-9 m/s, where
  the largest forces meet a fixed velocity; at a free node of the
  Winkler-balanced column the force is the residual of ~1e12 N element
  terms, which XLA:CPU's FMA contraction (PyTorch contracts nothing) moves
  by 4e-8 of the force's max, 7e-5 of the velocity's (measured).  dhacc
  and edvacc_surf at 1e-4, the bound test_pallas.py:226-232 sets for them
  at one step (slope differences of ~1e5 m f32 coordinates).
- 12 maxwell steps: the maxwell gate of test_pallas.py:91-106 (2e-4, force
  1e-3, log-viscosity median 0.02, dt/time/vmax 1e-5) on every field but
  the velocity, its gradients (strain_rate, edvoldt) and the surface
  accumulators.  vel, dhacc and edvacc_surf take the 5e-3 that
  test_pallas.py:280-283 sets for them over this trajectory;
  strain_rate and edvoldt, which that test does not bound, 2e-3, about
  three times their measured error: the Winkler column's near-balance
  amplifies f32 rounding (measured against pallas2d: vel 2.9e-4,
  strain_rate 5.3e-4, edvoldt 6.5e-4, dhacc 3.6e-4, edvacc_surf 2.1e-3;
  the port's own f32 and f64 runs part by 1.8e-2 in vel and dhacc and
  1.2e-1 in edvacc_surf over the same 12 steps).
- The resident runner against the tiled one: test_pallas.py:151-169's
  bounds (tests/torch_cases.assert_resident_matches_tiled).
"""

import dataclasses

import numpy as np
import pytest
import torch

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.ops import pallas2d
from dynearthsol_tpu_torch.ops import fused2d
from dynearthsol_tpu_torch.state import FIELD_NAMES, state_from_numpy
from torch_cases import (MAXWELL_FIELDS, assert_evp_one_step_close,
                         assert_resident_matches_tiled, production_cfg,
                         rel_err)

PRODUCTION = production_cfg()
MAXWELL = production_cfg("maxwell", control={"surf_base_level": 1000.0})
N = 12


def get(s, f):
    v = getattr(s, f)
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.fixture(scope="module")
def sims():
    js = jdes.Simulation(jdes.param_from_dict(PRODUCTION))
    ts = tdes.Simulation(tdes.param_from_dict(PRODUCTION), device="cpu")
    s0 = state_from_numpy({f: np.asarray(getattr(js.state, f))
                           for f in FIELD_NAMES}, dtype=torch.float32)
    return js, ts, s0


def _jax_run(js, cfg, n):
    old = pallas2d.INTERPRET
    pallas2d.INTERPRET = True
    try:
        return pallas2d.make_chunk_runner(
            jdes.param_from_dict(cfg), js.ctx, js.compensation_pressure,
            n)(js.ctx, js.state)
    finally:
        pallas2d.INTERPRET = old


def _port_run(ts, s0, cfg, n, resident=False):
    mk = (fused2d.make_resident_chunk_runner if resident
          else fused2d.make_chunk_runner)
    return mk(tdes.param_from_dict(cfg), ts.ctx, ts.compensation_pressure,
              n)(ts.ctx, s0)


@pytest.fixture(scope="module")
def maxwell(sims):
    """N maxwell steps: the JAX tiled runner, the port's resident and
    tiled runners."""
    js, ts, s0 = sims
    return (_jax_run(js, MAXWELL, N),
            _port_run(ts, s0, MAXWELL, N, resident=True),
            _port_run(ts, s0, MAXWELL, N))


def test_evp_one_step(sims):
    js, ts, s0 = sims
    ref, out = _jax_run(js, PRODUCTION, 1), _port_run(ts, s0, PRODUCTION, 1)
    assert_evp_one_step_close(
        ref, out, get, fields=("coord", "stress", "strain", "plstrain",
                               "force"))
    inc = float(s0.dt) * np.abs(get(ref, "force")
                                / s0.mass.numpy()[:, None]).max()
    assert np.abs(get(ref, "vel") - get(out, "vel")).max() < 2e-6 * inc
    for f in ("dhacc", "edvacc_surf"):
        assert rel_err(get(ref, f), get(out, f)) < 1e-4, f
    assert np.abs(get(out, "dhacc")).max() > 0  # the surface moved


def test_water_loading_adds_force(sims):
    """With the base level above the top the water pressure is positive on
    every top facet: its tractions change the vertical force of every top
    node and no other force (the plan without them as the baseline; the
    initial top is flat, so the tractions have no x component).  The two
    packages agree on the trajectory (test_maxwell_12_steps)."""
    js, ts, s0 = sims
    param = tdes.param_from_dict(MAXWELL)
    P = fused2d.make_plan(param, ts.ctx, "cpu", ts.compensation_pressure)
    assert P.grav["water"] and P.grav["winkler"]
    dry = dataclasses.replace(P, grav={**P.grav, "water": False})
    b = fused2d.make_buffers(P, ts.ctx, s0, 1, tiled=True)
    b.tgt = fused2d.vbc_targets(ts.ctx, b.nin, b.scal[3] + b.scal[0])
    args = (b.ein, b.nin, b.cep, b.cnp, b.tgt, b.scal[0],
            b.scal[1] * P.k["inertial"], torch.tensor(False),
            torch.tensor(False))
    wet = fused2d.step_planes_plain(P, *args)[1]
    dry = fused2d.step_planes_plain(dry, *args)[1]
    d = [(wet[fused2d._nslot(f)] - dry[fused2d._nslot(f)]).abs()
         for f in ("force_x", "force_z")]
    assert float(d[1][:, -1].min()) > 0
    assert float(d[1][:, :-1].max()) == float(d[0].max()) == 0


def test_maxwell_12_steps(maxwell):
    ref, out, _ = maxwell
    amplified = {"vel": 5e-3, "dhacc": 5e-3, "edvacc_surf": 5e-3,
                 "strain_rate": 2e-3, "edvoldt": 2e-3}
    for f in MAXWELL_FIELDS + ("dhacc", "edvacc_surf"):
        tol = amplified.get(f, 1e-3 if f == "force" else 2e-4)
        err = rel_err(get(ref, f), get(out, f))
        assert err < tol, (f, err)
    va = np.log(get(ref, "viscosity").astype(np.float64))
    vb = np.log(get(out, "viscosity").astype(np.float64))
    assert np.median(np.abs(va - vb)) < 0.02
    for f in ("dt", "time", "max_global_vel_mag"):
        a, b = float(get(ref, f)), float(get(out, f))
        assert abs(a - b) <= 1e-5 * max(abs(a), 1e-300), f
    assert np.abs(get(out, "dhacc")).max() > 0


def test_resident_matches_tiled(maxwell):
    _, res, tiled = maxwell
    assert_resident_matches_tiled(tiled, res, get)
    for f in ("dhacc", "edvacc_surf"):
        assert rel_err(get(tiled, f), get(res, f)) < 1e-6, f


def test_slice_runs_production(sims):
    """Simulation.run_steps dispatches the production config to the
    resident runner, which takes the Winkler reference pressure of the
    initial stress state, as the JAX package's does."""
    js, ts, _ = sims
    assert ts.compensation_pressure == js.compensation_pressure > 0
    sim = tdes.Simulation(tdes.param_from_dict(MAXWELL), device="cpu")
    ref = _port_run(sim, sim.state, MAXWELL, 2, resident=True)
    out = sim.run_steps(2, chunk=2)
    js._chunk_fn(2)
    assert sim.step_path == js.step_path == "pallas2d_res"
    for f in ("coord", "vel", "force", "dhacc", "edvacc_surf", "stress"):
        assert torch.equal(getattr(ref, f), getattr(out, f)), f


def _swap_one_bottom_facet(sbc):
    """The facet table with the first bottom facet's nodes reversed."""
    fn = np.array(sbc.facet_nodes)
    r = int(np.where(np.asarray(sbc.kind) == 0)[0][0])
    fn[r] = fn[r, ::-1]
    return dataclasses.replace(sbc, facet_nodes=fn)


def test_gate_matches_jax(sims):
    """Both packages' gates take the production config to the resident
    runner and the port names nothing unported; a facet table that is not
    the canonical bottom row (one facet's nodes in the other order) falls
    off both gates."""
    js, ts, _ = sims
    assert pallas2d.pallas_step_applicable(js.param, js.ctx)
    assert fused2d.pallas_step_applicable(ts.param, ts.ctx)
    assert pallas2d.resident_applicable(js.param, js.ctx)
    assert fused2d.resident_applicable(ts.param, ts.ctx)
    assert fused2d.unported_features(ts.param, ts.ctx) == []
    jctx = dataclasses.replace(js.ctx, sbc=_swap_one_bottom_facet(js.ctx.sbc))
    tctx = dataclasses.replace(ts.ctx, sbc=_swap_one_bottom_facet(ts.ctx.sbc))
    assert not pallas2d.pallas_step_applicable(js.param, jctx)
    assert not fused2d.pallas_step_applicable(ts.param, tctx)
