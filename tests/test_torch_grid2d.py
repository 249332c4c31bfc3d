"""The port's structured 2D plane step (ops/grid2d.py) against the JAX
package's grid2d, each package's dispatch from the same state, on the
CPU: the flagship (bench.py flagship_param) in float64 at 32 x 16 cells
(the fused gates refuse float64, so both packages take grid2d), surface
process 102 on the production feature set of
tests/test_structured.py:306-333; the plane round trip and the step path.

Tolerances, each of a field's max (dpressure, a difference of traces, at
the stress's):
  maxwell over 20 float64 steps: 1e-10 (torch and XLA differ in
    exp/log/cos by ulps).
  EVP on one float64 step from the JAX maxwell run's 20-step state: 1e-10.
    From rest, elements with unmoved corners tie exactly in the
    min-select (rheology.cxx:869-879) and XLA and PyTorch pick apart
    (ROADMAP.md, limits of comparison).
  surface process 102 over 15 float64 steps: 1e-10 on the fields of
    tests/test_structured.py:329.
  maxwell over 20 float32 steps: the maxwell trajectory gate of
    tests/test_pallas.py:91-106 (2e-4), but for the velocity maximum, a
    max over the velocity field, which takes the fields' 2e-4 as in
    tests/test_torch_flat3d.py (here the packages part by 3.8e-5 in it).
"""

import numpy as np
import pytest
import torch

from torch_cases import (assert_maxwell_close, flagship_cfg, rel_err,
                         run_path_both)

FIELDS = ("coord", "vel", "temperature", "stress", "stressyy", "strain",
          "strain_rate", "plstrain", "delta_plstrain", "viscosity",
          "volume", "volume_old", "volume_n", "mass", "tmass", "hmass",
          "ymass", "force", "edvoldt", "dhacc", "edvacc_surf", "dt", "time",
          "max_global_vel_mag", "global_dt_min", "l2_residual")
SP102_FIELDS = ("coord", "vel", "stress", "plstrain", "dhacc", "edvacc_surf",
                "dt", "time")


def flagship64(rheology="maxwell", dtype="float64"):
    cfg = flagship_cfg(32, 16)
    cfg["sim"]["float_dtype"] = dtype
    cfg["mat"]["rheology_type"] = rheology
    return cfg


def sp102_cfg():
    """tests/test_structured.py:197-220 and :306-333 (surface process 102
    with a terrigenous supply, the surface correction, the Winkler
    foundation, water loading) on maxwell, 16 x 8 cells, the base level
    raised to 10 m: at 0 m the flat top's water pressure and basin switch
    on the sign of its rounding."""
    return {
        "sim": {"ndims": 2, "float_dtype": "float64",
                "is_outputting_averaged_fields": False},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": 10e3, "ylength": 0.0, "zlength": 5e3,
                 "resolution": 10e3 / 16, "quality_check_step_interval": 7},
        "control": {"gravity": 10.0, "inertial_scaling": 1e5,
                    "has_thermal_diffusion": True, "damping_option": 1,
                    "surface_process_option": 102,
                    "terrig_sediment_area": 3.17e-7,
                    "surface_diffusivity": 1e-6,
                    "has_surface_correction": True,
                    "surf_base_level": 10.0},
        "bc": {"vbc_x0": 1, "vbc_val_x0": -1e-9, "vbc_x1": 1,
               "vbc_val_x1": 1e-9, "has_winkler_foundation": True,
               "has_water_loading": True, "winkler_delta_rho": 100.0},
        "mat": {"rheology_type": "maxwell", "is_plane_strain": True,
                "rho0": [2800.0], "bulk_modulus": [50e9],
                "shear_modulus": [30e9], "visc_max": 1e24,
                "visc_min": 1e19},
    }


def _assert_f64(ref, out, label, fields=FIELDS):
    for f in fields:
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

    js = jdes.Simulation(jdes.param_from_dict(flagship64()))
    m = js._chunk_fn(20)(js.ctx, js.state)
    cfg = flagship64("elasto-visco-plastic")
    je = jdes.Simulation(jdes.param_from_dict(cfg))
    te = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    ref = je._chunk_fn(1)(je.ctx, m)
    s0 = state_from_numpy({f: np.asarray(getattr(m, f))
                           for f in FIELD_NAMES}, dtype=te.dtype)
    out = te._chunk_fn(1)(te.ctx, s0)
    assert je.step_path == te.step_path == "grid2d"
    ref = {f: np.asarray(getattr(ref, f)) for f in FIELD_NAMES}
    assert (ref["delta_plstrain"] > 0).any()
    return ref, state_to_numpy(out)


@pytest.mark.parametrize("case", ["flagship-maxwell-20", "flagship-evp-1",
                                  "surface-process-102"])
def test_grid2d_matches_jax_float64(case):
    if case == "flagship-maxwell-20":
        ref, out = run_path_both(flagship64(), 20, "grid2d")
    elif case == "flagship-evp-1":
        ref, out = _evp_from_maxwell()
    else:
        # tests/test_structured.py:306-333's steps and fields: the
        # foundation's balance leaves the bottom nodes a velocity of
        # rounding that grows to 1.2e-10 of the strain rate's scale in
        # 20 steps
        ref, out = run_path_both(sp102_cfg(), 15, "grid2d")
        assert np.abs(out["dhacc"]).max() > 0
        for f in SP102_FIELDS:
            err = rel_err(ref[f], out[f])
            assert err < 1e-10, (case, f, err)
        return
    _assert_f64(ref, out, case)


def test_grid2d_float32_maxwell():
    ref, out = run_path_both(flagship64("maxwell", "float32"), 20, "grid2d")
    assert_maxwell_close(ref, out, lambda s, f: s[f], vmax_tol=2e-4)


def test_grid2d_plane_round_trip():
    import dynearthsol_tpu_torch as tdes
    from dynearthsol_tpu_torch.ops import grid2d
    from dynearthsol_tpu_torch.state import FIELD_NAMES

    sim = tdes.Simulation(tdes.param_from_dict(flagship64()), device="cpu")
    g = torch.Generator().manual_seed(5)
    s = sim.state.replace(**{
        f: torch.rand(getattr(sim.state, f).shape, generator=g,
                      dtype=torch.float64)
        for f in grid2d.E_SCALARS + grid2d.E_TENSORS + ("emw",)})
    nx, nz = sim.ctx.sgrid
    p = grid2d.state_to_grid(s, nx, nz)
    assert p.stress.shape == (3, 2, nx - 1, nz - 1)
    # element e = (i * nzc + j) * 2 + t sits at [t, i, j]
    e = (5 * (nz - 1) + 3) * 2 + 1
    assert p.volume[1, 5, 3] == s.volume[e]
    assert torch.equal(p.stress[:, 1, 5, 3], s.stress[e])
    back = grid2d.grid_to_state(p, nx, nz)
    for f in FIELD_NAMES:
        assert torch.equal(getattr(back, f), getattr(s, f)), f


def test_grid2d_step_path_matches_jax():
    """The float64 flagship and the production feature set go to grid2d
    in both packages, and so does the float32 flagship under
    DES_NO_PALLAS (the fused gates aside, as in the JAX dispatch)."""
    import os

    import dynearthsol_tpu as jdes
    import dynearthsol_tpu_torch as tdes

    for cfg, env in ((flagship64("elasto-visco-plastic"), None),
                     (sp102_cfg(), None),
                     (flagship_cfg(32, 16), "1")):
        old = os.environ.pop("DES_NO_PALLAS", None)
        if env:
            os.environ["DES_NO_PALLAS"] = env
        try:
            js = jdes.Simulation(jdes.param_from_dict(cfg))
            js._chunk_fn(1)   # the dispatch names the path; nothing compiles
            ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
            ts._chunk_fn(1)
        finally:
            os.environ.pop("DES_NO_PALLAS", None)
            if old is not None:
                os.environ["DES_NO_PALLAS"] = old
        assert ts.step_path == js.step_path == "grid2d", cfg
