"""The port's fused 3D step with the boundary processes of bench.py's
production3d (the Winkler and water facet tractions of pallas3d.py:
1221-1290 and surface process 1 of :1324-1394), plain version on the CPU,
against the JAX package's grid3d step (the oracle of pallas3d in
tests/test_pallas3d.py), both started from the same JAX State
(state_from_numpy), at 128 x 4 x 8 cells (torch_cases.make_sim3d_cfg).  One
JAX and one port Simulation per config, shared by the module's tests.

Tolerances are test_pallas3d.py:231-320's:

- the maxwell trajectory over 10 steps with the tractions and surface
  process 1: every field within 1e-3 of its max (force 5e-3), dhacc and
  edvacc_surf within 5e-3 with dhacc nonzero.  It runs in float64 in
  both packages.  A free bottom node of the Winkler column moves by the
  residual of its foundation pressure and the column's weight, which
  cancel to the float32 rounding of either: over 10 float32 steps the
  port's own float32 and float64 velocities part by more than the gate
  itself (test_float32_winkler_column_is_rounding), so a float32
  comparison would compare rounding.  The float32 arithmetic is
  the kernel's, held against the plain version on the card
  (tests/test_torch_cuda.py, chip_smoke.py phase 6c);
- the full production3d feature set (two materials, EVP) over one float32
  step: every field within 1e-3 (force 1e-3), dhacc and edvacc_surf
  excluded as test_pallas3d.py excludes them (the min-select amplifies a
  1e-7 perturbation of the oracle itself into them), held over every
  value: the ties of rounding that fused3d.evp_tie_reach names are
  counted and capped at 5 % of the elements, none set aside.

The chunk form must give its complete steps' planes bit for bit, the
accumulator planes included, and the planes must carry dhacc and
edvacc_surf through a State round trip exactly.
"""

import copy

import numpy as np
import pytest
import torch

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.ops import pallas3d
from dynearthsol_tpu_torch.ops import fused3d
from dynearthsol_tpu_torch.state import (FIELD_NAMES, state_from_numpy,
                                         state_to_numpy)
from test_torch_fused3d import (SCALARS, _grid_run, complete_steps, get,
                                torch_threads)
from torch_cases import (BOUNDARY3, FIELDS3, make_sim3d_cfg, multimat3d_cfg,
                         rel_err)

# test_pallas3d.py:287-303: the production3d feature set, two materials,
# EVP
PRODUCTION = multimat3d_cfg(**BOUNDARY3)
# test_pallas3d.py:231-242 and :262-276: one material, maxwell
MAXWELL64 = make_sim3d_cfg(sim={"float_dtype": "float64"},
                           mat={"rheology_type": "maxwell"},
                           ic={"weakzone_option": 0},
                           **BOUNDARY3)


def _pair(cfg, dtype):
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    s0 = state_from_numpy({f: np.asarray(getattr(js.state, f))
                           for f in FIELD_NAMES}, dtype=dtype)
    return js, ts, s0


@pytest.fixture(scope="module")
def production():
    return _pair(PRODUCTION, torch.float32)


@pytest.fixture(scope="module")
def maxwell64():
    return _pair(MAXWELL64, torch.float64)


def _port_run(ts, s0, n):
    return fused3d.make_chunk_runner(ts.param, ts.ctx,
                                     ts.compensation_pressure, n)(ts.ctx, s0)


def test_decode_and_gates_match_jax(production):
    """The facet groups and the edvacc_surf placement equal the JAX
    package's decoders on the same mesh; both gates send production3d to
    pallas3d with nothing unported, and both refuse surface process 102."""
    js, ts, _ = production
    assert fused3d.grav_facets(ts.ctx) == \
        pallas3d._grav_facets_structured_3d(js.param, js.ctx)
    tri, nid = fused3d.surf_maps(ts.ctx)
    tri_j, nid_j = pallas3d._surf_maps(js.ctx, *js.ctx.sgrid)
    assert np.array_equal(tri, tri_j) and np.array_equal(nid, nid_j)
    assert pallas3d.pallas3d_step_applicable(js.param, js.ctx)
    assert fused3d.pallas3d_step_applicable(ts.param, ts.ctx)
    assert fused3d.unported_features(ts.param, ts.ctx) == []
    js._chunk_fn(1)
    ts._chunk_fn(1)
    assert ts.step_path == js.step_path == "pallas3d"
    assert ts.compensation_pressure == js.compensation_pressure > 0
    P = fused3d.make_plan(ts.param, ts.ctx, "cpu", ts.compensation_pressure)
    assert P.facets and P.sw["surf_on"] and P.nn == fused3d.NN_SURF
    assert not P.uniform
    cfg = copy.deepcopy(PRODUCTION)
    cfg["control"]["surface_process_option"] = 102
    assert not pallas3d.pallas3d_step_applicable(
        jdes.param_from_dict(cfg), js.ctx)
    assert not fused3d.pallas3d_step_applicable(
        tdes.param_from_dict(cfg), ts.ctx)


@pytest.fixture(scope="module")
def port64(maxwell64):
    """The port's 10 float64 steps of MAXWELL64."""
    _, ts, s0 = maxwell64
    return _port_run(ts, s0, 10)


def test_maxwell_10_steps_f64_vs_grid3d(maxwell64, port64):
    """The Winkler and water tractions with surface process 1 and the
    surface correction, one trajectory for both mechanisms (each traced
    JAX program costs this file about 2 s): the tractions show in the
    force, velocities and coordinates, surface process 1 in dhacc and
    edvacc_surf."""
    ref, out = _grid_run(maxwell64[0], 10, jit=True), port64
    for f in FIELDS3:
        err = rel_err(get(ref, f), get(out, f))
        assert err < (5e-3 if f == "force" else 1e-3), (f, err)
    for f in ("dt", "time", "max_global_vel_mag", "l2_residual"):
        a, b = float(get(ref, f)), float(get(out, f))
        assert abs(a - b) <= 1e-3 * max(abs(a), 1e-300), f
    assert float(np.abs(get(ref, "dhacc")).max()) > 0
    for f in ("dhacc", "edvacc_surf"):
        err = rel_err(get(ref, f), get(out, f))
        assert err < 5e-3, (f, err)


def test_float32_winkler_column_is_rounding(maxwell64, port64):
    """Why the trajectory above runs in float64: over its 10 maxwell steps
    the port's float32 velocity parts from its float64 one by more than
    the 1e-3 gate, while every float32 force stays within it (the
    tractions balance the column's weight)."""
    _, ts, s0 = maxwell64
    cfg = copy.deepcopy(MAXWELL64)
    cfg["sim"]["float_dtype"] = "float32"
    P = fused3d.make_plan(tdes.param_from_dict(cfg), ts.ctx, "cpu",
                          ts.compensation_pressure)
    out32 = fused3d.run_chunk(P, ts.ctx, state_from_numpy(
        state_to_numpy(s0), "cpu", P.dtype), 10)
    assert rel_err(get(port64, "vel"), get(out32, "vel")) > 1e-2
    assert rel_err(get(port64, "force"), get(out32, "force")) < 5e-3


def test_production3d_evp_one_step_vs_grid3d(production):
    js, ts, s0 = production
    P = fused3d.make_plan(ts.param, ts.ctx, "cpu", ts.compensation_pressure)
    elems, _, gap = fused3d.evp_tie_reach(P, ts.ctx, s0)
    assert gap < 1 and int(elems.sum()) <= 0.05 * elems.numel()
    ref = _grid_run(js, 1)
    out = _port_run(ts, s0, 1)
    for f in FIELDS3:
        err = rel_err(get(ref, f), get(out, f))
        assert err < 1e-3, (f, err)
    va = np.log(np.asarray(get(ref, "viscosity"), dtype=np.float64))
    vb = np.log(np.asarray(get(out, "viscosity"), dtype=np.float64))
    assert np.median(np.abs(va - vb)) < 0.02
    for f in SCALARS:
        a, b = float(get(ref, f)), float(get(out, f))
        assert abs(a - b) <= 1e-3 * max(abs(a), 1e-300), f
    assert np.abs(get(out, "dhacc")).max() > 0


@pytest.mark.parametrize("rheology", ["maxwell", "elasto-visco-plastic"],
                         ids=["maxwell", "evp"])
def test_chunk_equals_complete_steps(production, rheology):
    """3 steps of the chunk form against 3 complete steps, every plane
    (the 17 nodal planes: dhacc, edv_a, edv_b included), bit for bit, at
    one intra-op thread (tests/test_torch_fused3d.py)."""
    _, ts, s0 = production
    cfg = copy.deepcopy(PRODUCTION)
    cfg["mat"]["rheology_type"] = rheology
    P = fused3d.make_plan(tdes.param_from_dict(cfg), ts.ctx, "cpu",
                          ts.compensation_pressure)
    n = 3
    with torch_threads(1):
        out = fused3d.run_chunk(P, ts.ctx, s0, n)
        ein, nin, scal = complete_steps(P, ts.ctx, s0, n)
    e, nd = fused3d.state_to_planes(out, P.nx, P.ny, P.nz, P.smaps)
    assert nd.shape[0] == fused3d.NN_SURF
    for i in range(fused3d.NE):
        assert torch.equal(e[i], ein[i]), i
    for i, nm in enumerate(fused3d.N_SLOTS + fused3d.SURF_SLOTS):
        assert torch.equal(nd[i], nin[i]), nm
    for i, f in enumerate(("dt", "max_global_vel_mag", "global_dt_min",
                           "time")):
        assert torch.equal(getattr(out, f), scal[i]), f
    assert bool(out.dhacc.abs().max() > 0)
    assert bool(out.edvacc_surf.abs().max() > 0)


def test_state_planes_round_trip(production):
    """dhacc and edvacc_surf go onto their planes and back exactly, and
    the chunk buffers start with both nodal buffers holding them (only the
    top lane's nodes are written by a step)."""
    _, ts, s0 = production
    P = fused3d.make_plan(ts.param, ts.ctx, "cpu", ts.compensation_pressure)
    rng = np.random.default_rng(7)
    s = s0.replace(
        dhacc=torch.as_tensor(rng.standard_normal(s0.dhacc.shape),
                              dtype=torch.float32),
        edvacc_surf=torch.as_tensor(
            rng.standard_normal(s0.edvacc_surf.shape), dtype=torch.float32))
    e, nd = fused3d.state_to_planes(s, P.nx, P.ny, P.nz, P.smaps)
    back = fused3d.planes_to_state(s0, e, nd, P.nx, P.ny, P.nz, P.smaps)
    assert torch.equal(back.dhacc, s.dhacc)
    assert torch.equal(back.edvacc_surf, s.edvacc_surf)
    # each top facet has a node and slot of its own
    tri, nid = P.smaps
    assert len(set(zip(tri.tolist(), nid.tolist()))) == tri.numel()
    b = fused3d.make_buffers(P, ts.ctx, s, 1)
    assert torch.equal(b.nout[fused3d.NN:], b.nin[fused3d.NN:])
