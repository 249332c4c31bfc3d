"""Phase changes and the hydrous markers (phasechanges.py) against the JAX
package's, on the CPU.

- ``simple_subduction`` on random depths, pressures and temperatures that
  reach every branch of the phase diagram: the same materials and
  releases bit for bit;
- four wakes of ``phase_changes`` and ``advect_hydrous_markers`` on
  tests/torch_cases.py subduction_cfg (float64), the JAX run stepped 10
  steps between wakes and the port taking its state, markers and hydrous
  markers at each (torch_cases.carry): the same material arrays, the same
  hydrous markers (eta and elem among them) bit for bit, the same
  ``emw``;
- a chunk after a phase change computes with the new weights, on the
  column step (float64) and on the resident 2D runner (float32, 8
  materials: the kernel's mixed instance, its plain version here): the
  runner built before the change gives the result of one built after it.
"""

import numpy as np
import pytest
import torch

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu import phasechanges as jpc
from dynearthsol_tpu.markers import MarkerSet as JMarkerSet
from dynearthsol_tpu_torch import phasechanges as tpc
from dynearthsol_tpu_torch.markers import MarkerSet
from dynearthsol_tpu_torch.state import state_to_numpy
from torch_cases import (assert_same_markers, carry, make_sim_cfg,
                         subduction_cfg)

NWAKES = 4


def test_simple_subduction_every_branch_matches_jax():
    rng = np.random.default_rng(7)
    n = 4000
    ms = MarkerSet.empty(2, cap=n)
    ms.append(rng.dirichlet(np.ones(3), n), rng.integers(0, 50, n), 0)
    ms.mattype[:n] = rng.integers(0, 8, n)
    jms = JMarkerSet.from_arrays(2, ms.save_arrays(), ms.chkpt_arrays())
    Z = -rng.uniform(0.0, 150e3, n)
    T = rng.uniform(273.0, 1400.0, n)
    P = rng.uniform(0.0, 8e9, n)
    hyd_count = rng.integers(0, 2, 50).astype(float)
    new_j, hyd_j = jpc.simple_subduction(None, jms, Z, P, T, hyd_count)
    new_t, hyd_t = tpc.simple_subduction(None, ms, Z, P, T, hyd_count)
    assert np.array_equal(new_j, new_t) and np.array_equal(hyd_j, hyd_t)
    moved = {(a, b) for a, b in zip(ms.live("mattype"), new_t) if a != b}
    assert moved == {(2, 3), (4, 5), (1, 0), (0, 1)}
    assert hyd_t.any() and not hyd_t.all()


def _copies(sim):
    """(markers, hydrous markers) of ``sim``, copied."""
    return tuple(None if m is None else type(m).from_arrays(
        m.ndims, m.save_arrays(), m.chkpt_arrays(), name=m.name)
        for m in (sim.markers, sim.hydrous_markers))


@pytest.fixture(scope="module")
def wakes():
    """Four wakes on both packages from the same state.  Per wake: the
    (JAX, port) marker copies after phase_changes, both emw, the port's
    stats, and the (JAX, port) copies after the advection."""
    cfg = subduction_cfg()
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    out = []
    for w in range(NWAKES):
        if w:
            js.run_steps(10, chunk=10)
        carry(js, ts)
        jpc.phase_changes(js)
        stats = tpc.phase_changes(ts)
        rec = {"pc": (_copies(js), _copies(ts)), "stats": stats,
               "emw": (np.asarray(js.state.emw),
                       state_to_numpy(ts.state)["emw"])}
        # 3e-9 m/s over 3e11 s: 900 m up, across element sides
        jpc.advect_hydrous_markers(js, 3e11)
        tpc.advect_hydrous_markers(ts, 3e11)
        rec["adv"] = (_copies(js), _copies(ts))
        out.append(rec)
    return out


def test_phase_changes_match_jax_wake_by_wake(wakes):
    for rec in wakes:
        (jm, jh), (tm, th) = rec["pc"]
        assert_same_markers(jm, tm)
        assert_same_markers(jh, th)
        assert np.array_equal(*rec["emw"])
    assert sum(r["stats"]["released"] for r in wakes) == th.n > 0
    # the geotherm dehydrates crust and sediment, and the mantle beside
    # them serpentinizes
    assert "0->1" in set().union(*(r["stats"]["transitions"]
                                   for r in wakes))


def test_hydrous_advection_matches_jax(wakes):
    for rec in wakes:
        (_, jh), (_, th) = rec["adv"]
        assert_same_markers(jh, th)
    before, after = wakes[-1]["pc"][1][1], wakes[-1]["adv"][1][1]
    assert not np.array_equal(before.live("elem"), after.live("elem"))


@pytest.mark.parametrize("path", ["flat2d", "pallas2d_res"])
def test_chunk_after_phase_change_reads_new_weights(path):
    """The runner cached before a phase change reads the new emw at its
    next chunk: its result equals that of a runner built after the
    change, and differs from its result on the old weights."""
    mat = {"nmat": 8, "phase_change_option": 1,
           "rho0": [3300.0 - 50.0 * m for m in range(8)],
           "bulk_modulus": [50e9 + 5e9 * m for m in range(8)],
           "shear_modulus": [30e9 + 3e9 * m for m in range(8)]}
    if path == "flat2d":
        cfg = subduction_cfg(mesh={"meshing_elem_shape": 0}, mat=mat)
    else:
        cfg = make_sim_cfg(
            mat={**mat, "rheology_type": "maxwell"},
            markers={"markers_per_element": 4},
            ic={"num_mattype_layers": 3, "layer_mattypes": [4, 2, 0],
                "mattype_layer_depths": [0.02, 0.05]},
            control={"has_hydration_processes": True})
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    ts.run_steps(2, chunk=2)
    assert ts.step_path == path
    runner = ts._chunk_fns[2]
    # at 700 K the crust dehydrates at the first wake, and at the second
    # the mantle in the elements that hold hydrous markers serpentinizes
    ts.state = ts.state.replace(
        temperature=torch.full_like(ts.state.temperature, 700.0))
    s_old = ts.state
    tpc.phase_changes(ts)
    assert "0->1" in tpc.phase_changes(ts)["transitions"]
    assert not torch.equal(ts.state.emw, s_old.emw)
    cached = runner(ts.ctx, ts.state)
    ts._chunk_fns = {}
    fresh = ts._chunk_fn(2)(ts.ctx, ts.state)
    for f in ("stress", "vel", "force", "mass", "dt"):
        assert torch.equal(getattr(cached, f), getattr(fresh, f)), f
    assert not torch.equal(cached.stress, runner(ts.ctx, s_old).stress)
