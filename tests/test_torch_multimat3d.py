"""The port's fused 3D step with two materials (the const pack of
pallas3d.py:469 and the in-kernel mixtures, matprops.cxx:115-144), plain
version on the CPU, against the JAX package's grid3d step, both started
from the same JAX State (state_from_numpy), on the multi-material config
of tests/test_pallas3d.py:135-216 narrowed to 128 x 4 x 8 cells
(tests/torch_cases.multimat3d_cfg).  One JAX Simulation and one of the
port (EVP, a weak zone) serve both gates: the maxwell trajectory is a
param of its own on the shared mesh and state (maxwell reads no plastic
strain).

Tolerances are test_pallas3d.py's (tests/torch_cases): maxwell over 10
steps at 1e-3 of each field's max (force 5e-3; dt, time, vmax, L2 1e-3),
EVP over one step at 1e-4 (force 1e-3, log-viscosity median 0.02), over
every element: the step's exact EVP ties (fused3d.evp_ties, 1.2 % of the
elements here) resolve alike in both packages, so none is set aside.  The
ties of equal nonzero invariants must be ties of rounding (their float64
gap below 1 of the f32 step's own error in them) and reach at most 5 % of
the elements (measured 0.090 and 3.2 %).  The chunk form must give its
complete steps' planes bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.ops import pallas3d
from dynearthsol_tpu_torch.ops import fused3d
from dynearthsol_tpu_torch.state import FIELD_NAMES, state_from_numpy
from test_torch_fused3d import (SCALARS, _grid_run, chunk_setup,
                                complete_steps, get, torch_threads)
from torch_cases import (assert_evp3_one_step_close, assert_maxwell3_close,
                         flagship3d_multimat_cfg, multimat3d_cfg, with_param)

EVP = multimat3d_cfg(ic={"weakzone_option": 1})
MAXWELL = multimat3d_cfg("maxwell", ic={"weakzone_option": 1})


@pytest.fixture(scope="module")
def sims():
    js = jdes.Simulation(jdes.param_from_dict(EVP))
    ts = tdes.Simulation(tdes.param_from_dict(EVP), device="cpu")
    s0 = state_from_numpy({f: np.asarray(getattr(js.state, f))
                           for f in FIELD_NAMES}, dtype=torch.float32)
    return js, ts, s0


def test_mixed_plan(sims):
    """Two materials take the const pack: radiogenic source and the raw
    weights, nmat + 1 planes, and the gates send the config to pallas3d in
    both packages with nothing unported."""
    js, ts, s0 = sims
    P = fused3d.make_plan(ts.param, ts.ctx, "cpu")
    assert not P.uniform and P.nmat == 2
    cep = fused3d.const_epack(P, s0)
    assert tuple(cep.shape) == (3, 5, *P.cells)
    w = cep[1:].sum(0)
    assert bool((cep[1] > 0).logical_and(cep[2] > 0).any())  # mixed tets
    assert torch.equal(w, s0.emw.sum(1).reshape(*P.cells, 5)
                       .permute(3, 0, 1, 2))
    assert pallas3d.pallas3d_step_applicable(js.param, js.ctx)
    assert fused3d.pallas3d_step_applicable(ts.param, ts.ctx)
    assert fused3d.unported_features(ts.param, ts.ctx) == []


def test_maxwell_10_steps_vs_grid3d(sims):
    js, ts, s0 = sims
    ref = _grid_run(with_param(js, jdes.param_from_dict(MAXWELL)), 10)
    out = fused3d.make_chunk_runner(tdes.param_from_dict(MAXWELL), ts.ctx,
                                    0.0, 10)(ts.ctx, s0)
    assert_maxwell3_close(ref, out, get)


def test_evp_one_step_vs_grid3d(sims):
    js, ts, s0 = sims
    P = fused3d.make_plan(ts.param, ts.ctx, "cpu")
    tie = fused3d.evp_ties(P, ts.ctx, s0)
    assert 0 < int(tie.sum()) <= 0.02 * tie.numel()
    # the ties of equal nonzero invariants are ties of rounding (the card
    # may resolve them apart; tests/test_torch_cuda.py sets their reach
    # aside): the invariants' float64 gap is below the f32 step's own
    # error in them, and the reach is within 5 % of the elements
    elems, _, gap = fused3d.evp_tie_reach(P, ts.ctx, s0)
    assert 0 < gap < 1
    assert 0 < int(elems.sum()) <= 0.05 * elems.numel()
    out = fused3d.make_chunk_runner(ts.param, ts.ctx, 0.0, 1)(ts.ctx, s0)
    ref = _grid_run(js, 1)
    assert_evp3_one_step_close(ref, out, get)
    for f in SCALARS:
        a, b = float(get(ref, f)), float(get(out, f))
        assert abs(a - b) <= 1e-3 * max(abs(a), 1e-300), f


@pytest.mark.parametrize("rheology", ["maxwell", "evp"])
def test_chunk_equals_complete_steps(sims, rheology):
    """The chunk form with the const pack: 3 steps, every plane, bit for
    bit, at one intra-op thread (tests/test_torch_fused3d.py)."""
    _, ts, s0 = sims
    cfg = MAXWELL if rheology == "maxwell" else EVP
    P, s = chunk_setup(with_param(ts, tdes.param_from_dict(cfg)), s0,
                       torch.float32)
    n = 3
    with torch_threads(1):
        out = fused3d.run_chunk(P, ts.ctx, s, n)
        ein, nin, scal = complete_steps(P, ts.ctx, s, n)
    e, nd = fused3d.state_to_planes(out, P.nx, P.ny, P.nz)
    assert torch.equal(e, ein) and torch.equal(nd, nin)
    for i, f in enumerate(("dt", "max_global_vel_mag", "global_dt_min",
                           "time")):
        assert torch.equal(getattr(out, f), scal[i]), f


def test_flagship3d_multimat_gate(sims):
    """bench.py flagship3d_param(nmat=2) (256 x 48 x 16 cells) passes the
    port's gate exactly when it passes the JAX gate, with nothing
    unported; a y extent that no TPU tile divides (7 cells) fails both.
    The gates read the grid's shape, the facet tables and the top surface
    of the mesh, so the small mesh stands in with the flagship's shape."""
    js, ts, _ = sims
    cfg = flagship3d_multimat_cfg()
    jp, tp = jdes.param_from_dict(cfg), tdes.param_from_dict(cfg)
    for grid, want in (((257, 49, 17), True), ((257, 8, 17), False)):
        jctx = dataclasses.replace(js.ctx, sgrid=grid)
        tctx = dataclasses.replace(ts.ctx, sgrid=grid)
        assert pallas3d.pallas3d_step_applicable(jp, jctx) is want
        assert fused3d.pallas3d_step_applicable(tp, tctx) is want
    assert fused3d.unported_features(tp, ts.ctx) == []
    P = fused3d.make_plan(tp, ts.ctx, "cpu")
    assert not P.uniform and P.nmat == 2


def test_production3d_names_only_facets_and_surface_process():
    """bench.py production3d_param's features on the small multi-material
    mesh: the port still refuses them, naming the facet tractions and
    surface process 1 and nothing of the materials."""
    cfg = multimat3d_cfg(
        control={"surface_process_option": 1, "surface_diffusivity": 1e-6,
                 "has_surface_correction": True},
        bc={"has_winkler_foundation": True, "has_water_loading": True,
            "winkler_delta_rho": 100.0})
    sim = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    missing = fused3d.unported_features(sim.param, sim.ctx)
    assert len(missing) == 2
    assert "gravity-facet" in missing[0] and "surface process" in missing[1]
    with pytest.raises(NotImplementedError, match="pallas3d") as e:
        sim.run_steps(1)
    assert "material" not in str(e.value)
