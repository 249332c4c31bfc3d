"""The port's structured 3D plane step (ops/grid3d.py) against the JAX
package's grid3d, each package's dispatch from the same state, on the CPU
at 8 x 2 x 4 cells of 1 km (tests/test_structured.py:254-305's inputs:
water loading, surface process 1 with the surface correction, thermal
diffusion, damping 1); the plane round trip; and the step path both
dispatches pick for a float64 structured 3D config and for the
evp-remesh-3d golden.

Tolerances, each of a field's max (dpressure, a difference of traces, at
the stress's):
  maxwell over 20 float64 steps, without the Winkler foundation: 1e-10
    (torch and XLA differ in exp/log/cos by ulps).  Under the foundation
    the bottom nodes move by the rounding of its balance with the
    column's weight, which grows to 1.6e-10 of the strain rate's scale
    in 20 steps.
  EVP on one float64 step with the Winkler foundation, from the JAX
    maxwell run's 20-step state with a cohesion at which every element
    yields: 1e-10.  From rest, elements with unmoved corners tie exactly
    in the min-select (rheology.cxx:869-879) and XLA and PyTorch pick
    apart (ROADMAP.md, limits of comparison).
  maxwell over 20 float32 steps, damping 2: the maxwell trajectory gate
    of tests/test_pallas.py:91-106 (2e-4).  Damping 1 turns on sign(v),
    and the y velocity of this y-invariant box is rounding: two correct
    float32 runs part by 3e-4 of |v| in 20 steps (chip_smoke.py phase 13
    records 1.4e-3 in 10 for the fused step).
"""

import os

import numpy as np
import pytest
import torch

from torch_cases import (assert_maxwell_close, grid3d_cfg, rel_err,
                         run_path_both)

FIELDS = ("coord", "vel", "temperature", "stress", "strain", "strain_rate",
          "plstrain", "delta_plstrain", "viscosity", "volume", "volume_old",
          "volume_n", "mass", "tmass", "hmass", "ymass", "force", "edvoldt",
          "dhacc", "edvacc_surf", "dt", "time", "max_global_vel_mag",
          "global_dt_min", "l2_residual")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "runs",
                      "evp-remesh-3d")
# every element yields on the EVP step (tests/test_torch_flat3d.py WEAK)
WEAK = {"cohesion0": [3e4], "cohesion1": [3e4], "friction_angle0": [0.0],
        "friction_angle1": [0.0]}


def _assert_f64(ref, out, label):
    for f in FIELDS:
        err = rel_err(ref[f], out[f])
        assert err < 1e-10, (label, f, err)
    err = (np.abs(ref["dpressure"] - out["dpressure"]).max()
           / np.abs(ref["stress"]).max())
    assert err < 1e-10, (label, "dpressure", err)


def _evp_from_maxwell():
    """One EVP step of both packages from the JAX maxwell run's state."""
    import dynearthsol_tpu as jdes
    import dynearthsol_tpu_torch as tdes
    from dynearthsol_tpu_torch.state import (FIELD_NAMES, state_from_numpy,
                                             state_to_numpy)

    js = jdes.Simulation(jdes.param_from_dict(grid3d_cfg("maxwell")))
    m = js._chunk_fn(20)(js.ctx, js.state)
    cfg = grid3d_cfg("elasto-visco-plastic")
    cfg["mat"].update(WEAK)
    je = jdes.Simulation(jdes.param_from_dict(cfg))
    te = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    ref = je._chunk_fn(1)(je.ctx, m)
    s0 = state_from_numpy({f: np.asarray(getattr(m, f))
                           for f in FIELD_NAMES}, dtype=te.dtype)
    out = te._chunk_fn(1)(te.ctx, s0)
    assert je.step_path == te.step_path == "grid3d"
    ref = {f: np.asarray(getattr(ref, f)) for f in FIELD_NAMES}
    assert (ref["delta_plstrain"] > 0).all()
    return ref, state_to_numpy(out)


@pytest.mark.parametrize("case", ["maxwell-20", "evp-1"])
def test_grid3d_matches_jax_float64(case):
    if case == "maxwell-20":
        ref, out = run_path_both(grid3d_cfg("maxwell", winkler=False), 20,
                                 "grid3d")
        assert out["steps"] == 20
    else:
        ref, out = _evp_from_maxwell()
    _assert_f64(ref, out, case)


def test_grid3d_float32_maxwell():
    cfg = grid3d_cfg("maxwell", "float32", winkler=False)
    cfg["control"].update(damping_option=2, damping_factor=0.4)
    ref, out = run_path_both(cfg, 20, "grid3d")
    assert_maxwell_close(ref, out, lambda s, f: s[f])


def test_grid3d_plane_round_trip():
    import dynearthsol_tpu_torch as tdes
    from dynearthsol_tpu_torch.ops import grid3d
    from dynearthsol_tpu_torch.state import FIELD_NAMES

    sim = tdes.Simulation(tdes.param_from_dict(grid3d_cfg()), device="cpu")
    g = torch.Generator().manual_seed(3)
    s = sim.state.replace(**{
        f: torch.rand(getattr(sim.state, f).shape, generator=g,
                      dtype=torch.float64)
        for f in grid3d.E_SCALARS + grid3d.E_TENSORS + ("emw",)})
    dims = sim.ctx.sgrid
    p = grid3d.state_to_grid(s, *dims)
    nx, ny, nz = dims
    assert p.stress.shape == (6, 5, nz - 1, ny - 1, nx - 1)
    # element e = ((i * nyc + j) * nzc + k) * 5 + t sits at [t, k, j, i]
    e = ((3 * (ny - 1) + 1) * (nz - 1) + 2) * 5 + 4
    assert p.volume[4, 2, 1, 3] == s.volume[e]
    assert torch.equal(p.stress[:, 4, 2, 1, 3], s.stress[e])
    back = grid3d.grid_to_state(p, *dims)
    for f in FIELD_NAMES:
        assert torch.equal(getattr(back, f), getattr(s, f)), f


def _jax_path(param):
    import dynearthsol_tpu as jdes
    js = jdes.Simulation(param)
    js._chunk_fn(1)      # the dispatch names the path; nothing compiles
    return js.step_path


@pytest.mark.parametrize("case,path", [("f64-box", "grid3d"),
                                       ("evp-remesh-3d", "flat3d")])
def test_grid3d_step_path_matches_jax(case, path, tmp_path, monkeypatch):
    """The f64 box goes to grid3d.  The golden runs on the reference
    binary's own mesh (mesh_from_run), whose node numbering is not the
    raster one, so both packages step it on flat3d from the start."""
    import dynearthsol_tpu as jdes
    import dynearthsol_tpu_torch as tdes

    if case == "f64-box":
        jp = jdes.param_from_dict(grid3d_cfg("elasto-visco-plastic"))
        tp = tdes.param_from_dict(grid3d_cfg("elasto-visco-plastic"))
    else:
        from test_torch_golden import _prepare_case
        _prepare_case(GOLDEN, str(tmp_path))
        monkeypatch.chdir(tmp_path)
        jp = jdes.load_config("case.cfg")
        tp = tdes.load_config("case.cfg")
    ts = tdes.Simulation(tp, device="cpu")
    ts._chunk_fn(1)
    assert ts.step_path == _jax_path(jp) == path
    assert (ts.ctx.sgrid is not None) == (path == "grid3d")
