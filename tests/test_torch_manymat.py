"""More materials than the fused kernels' MAXMAT (8): the configs run on
the fused paths in both packages, and the port's plain step (ops/fused2d.py,
ops/fused3d.py on the CPU) matches the JAX package's.

The materials are layers of equal depth by markers, each with properties
of its own (tests/torch_cases.manymat_over), on the production feature set
at make_sim's 16 x 128 cells in 2D (Winkler and water tractions, surface
process 1, the surface correction) and at 128 x 4 x 8 cells in 3D.  Both
packages send 9 and 24 materials to pallas2d_res, 12 with global velocity
scaling to the tiled pallas2d, and 9 and 16 to pallas3d, with nothing
unported.

References: in 2D the JAX package's Pallas step in interpret mode (as
tests/test_pallas.py runs it), in 3D its grid3d step, the XLA oracle that
tests/test_pallas3d.py holds pallas3d to (pallas3d in interpret mode takes
about 50 s on a CPU for 5 steps at 12 materials, grid3d about 6 s).  One
EVP step is held at the one-step rule of test_pallas.py (2e-6 of each
field's max on coord, stress, strain, plstrain and force;
tests/torch_cases assert_evp_one_step_close).

The 10-step maxwell trajectories: many thin layers over the Winkler
column make the velocity and its gradients sensitive to rounding.  The
JAX package's two f32 paths (pallas2d_res in interpret mode, grid2d under
DES_NO_PALLAS) round alike (XLA:CPU contracts into FMAs, PyTorch
contracts nothing) and part by 3.5e-4 of the velocity at 12 materials,
the port by 3.7e-3 (the same at 2 and 8 layered materials), and every
f32 run lies 3.5e-2 from the f64 run.  So the port is held within the
larger of the JAX package's own distances, its fused path to its XLA
path and its f32 run to its f64 run, each first held under a fixed limit
about 3 times what it measures, so that a fault of the JAX paths cannot
widen the bound; or within the production maxwell gate of
tests/test_torch_production2d.py (3D: test_pallas3d.py's maxwell gate)
where that is wider.

The suite keeps at most 7 items in a file (tests/test_torch_io_refusals.py
says why).
"""

import os
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.ops import pallas2d
from dynearthsol_tpu_torch.ops import fused2d, fused3d
from dynearthsol_tpu_torch.state import FIELD_NAMES, state_from_numpy
from test_torch_fused3d import _grid_run, get
from torch_cases import (assert_evp_one_step_close, make_sim3d_cfg,
                         manymat_over, production_cfg, rel_err, with_param)


def cfg2d(nmat, rheology="elasto-visco-plastic", **control):
    cfg = production_cfg(rheology, **manymat_over(nmat))
    cfg["control"].update(control)
    return cfg


def cfg3d(nmat, rheology="elasto-visco-plastic"):
    cfg = make_sim3d_cfg(**manymat_over(nmat))
    cfg["mat"]["rheology_type"] = rheology
    return cfg


@contextmanager
def jax_env(no_pallas=False):
    """The JAX package's Pallas kernels in interpret mode, and with
    ``no_pallas`` its plain-XLA paths (DES_NO_PALLAS)."""
    old, env = pallas2d.INTERPRET, os.environ.pop("DES_NO_PALLAS", None)
    pallas2d.INTERPRET = True
    if no_pallas:
        os.environ["DES_NO_PALLAS"] = "1"
    try:
        yield
    finally:
        pallas2d.INTERPRET = old
        os.environ.pop("DES_NO_PALLAS", None)
        if env is not None:
            os.environ["DES_NO_PALLAS"] = env


def _sims(cfg):
    """(JAX Simulation, port Simulation, the JAX initial state as a port
    State)."""
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    s0 = state_from_numpy({f: np.asarray(getattr(js.state, f))
                           for f in FIELD_NAMES}, dtype=torch.float32)
    return js, ts, s0


def run_both(cfg, n, path):
    """n steps of both packages' dispatched runners from the JAX initial
    state; both must take ``path`` with nothing unported.  Returns (JAX
    State, port State, JAX Simulation, port Simulation)."""
    js, ts, s0 = _sims(cfg)
    with jax_env():
        ref = js._chunk_fn(n)(js.ctx, js.state)
    out = ts._chunk_fn(n)(ts.ctx, s0)
    assert js.step_path == ts.step_path == path, (js.step_path,
                                                   ts.step_path)
    assert fused2d.unported_features(ts.param, ts.ctx) == []
    return ref, out, js, ts


@pytest.mark.parametrize("nmat,path,control", [
    (9, "pallas2d_res", {}),
    (24, "pallas2d_res", {}),
    (12, "pallas2d", {"use_global_velocity_scaling": True}),
], ids=["9_resident", "24_resident", "12_tiled_gvs"])
def test_2d_one_evp_step(nmat, path, control):
    ref, out, _, ts = run_both(cfg2d(nmat, **control), 1, path)
    P = fused2d.make_plan(ts.param, ts.ctx, "cpu", ts.compensation_pressure)
    assert P.nmat == nmat and P.mtab is not None
    assert tuple(P.mtab.shape) == (nmat, 15)
    assert_evp_one_step_close(ref, out, get, fields=(
        "coord", "stress", "strain", "plstrain", "force"))


# The JAX package's own distances after 10 maxwell steps at 12 materials:
# its fused path (pallas2d_res, interpret mode) against its plain-XLA path
# (grid2d, DES_NO_PALLAS), and its float32 trajectory against its float64
# one (grid2d), each held under a limit about 3 times the measured value
# (field: measured fused-XLA, measured f32-f64).  Both XLA paths round
# alike (XLA:CPU contracts into FMAs; PyTorch contracts nothing), so the
# first is small; the second is the trajectory's own sensitivity to f32
# rounding, which the near-balanced Winkler column amplifies.  The port's
# distance from pallas2d_res must stay below the larger of the two, or
# below tests/test_torch_production2d.py's production maxwell gate where
# that is wider.
TRAJ = {  # field: (production gate, limit of each JAX distance)
    "coord": (2e-4, 1e-7),         # 1.9e-9, 1.7e-8
    "vel": (5e-3, 0.1),            # 3.5e-4, 3.5e-2
    "temperature": (2e-4, 1e-7),   # 0, 0
    "stress": (2e-4, 6e-4),        # 1.6e-6, 2.1e-4
    "strain": (2e-4, 6e-4),
    "volume": (2e-4, 1e-4),
    "volume_n": (2e-4, 1e-4),
    "mass": (2e-4, 1e-4),
    "force": (1e-3, 1e-3),
    "strain_rate": (2e-3, 2.0),    # 2.3e-3, 6.7e-1
    "edvoldt": (2e-3, 1.6),        # 1.3e-3, 5.3e-1
    "dhacc": (5e-3, 0.4),          # 1.4e-5, 1.2e-1
    "edvacc_surf": (5e-3, 0.3),    # 5.6e-6, 8.8e-2
}


def test_2d_maxwell_10_steps():
    cfg = cfg2d(12, "maxwell")
    ref, out, js, _ = run_both(cfg, 10, "pallas2d_res")
    js._chunk_fns.clear()
    with jax_env(no_pallas=True):
        xla = js._chunk_fn(10)(js.ctx, js.state)
    assert js.step_path == "grid2d"
    cfg["sim"]["float_dtype"] = "float64"
    j64 = jdes.Simulation(jdes.param_from_dict(cfg))
    f64 = j64._chunk_fn(10)(j64.ctx, j64.state)
    for f, (gate, limit) in TRAJ.items():
        a = get(ref, f).astype(np.float64)
        jax_d = max(rel_err(a, get(xla, f)), rel_err(get(f64, f), a))
        assert jax_d < limit, (f, "JAX distance", jax_d)
        port_d = rel_err(a, get(out, f))
        assert port_d < max(jax_d, gate), (f, port_d, jax_d)
    for f in ("dt", "time", "max_global_vel_mag"):
        assert rel_err(get(ref, f), get(out, f)) < 1e-5, f


@pytest.fixture(scope="module")
def sims3d():
    """{nmat: (JAX Simulation, port Simulation, initial port State)} of
    the 3D configs, built once."""
    return {n: _sims(cfg3d(n)) for n in (9, 16)}


@pytest.mark.parametrize("nmat", [9, 16])
def test_3d_one_evp_step(nmat, sims3d):
    js, ts, s0 = sims3d[nmat]
    with jax_env():
        js._chunk_fn(1)   # the dispatch names the path; nothing compiles
    ts._chunk_fn(1)
    assert js.step_path == ts.step_path == "pallas3d"
    assert fused3d.unported_features(ts.param, ts.ctx) == []
    P = fused3d.make_plan(ts.param, ts.ctx, "cpu")
    assert tuple(P.mtab.shape) == (nmat, 24)
    out = fused3d.make_chunk_runner(ts.param, ts.ctx, 0.0, 1)(ts.ctx, s0)
    assert_evp_one_step_close(_grid_run(js, 1), out, get, fields=(
        "coord", "stress", "strain", "plstrain", "force"))


# 10 maxwell steps at 16 materials: the port against grid3d within
# test_pallas3d.py's maxwell gate, or within the JAX package's own
# distance between its float32 and float64 grid3d trajectories where that
# is wider (field: limit of that distance, about 3 times what it
# measures).  The two float32 runs agree to 1.3e-7 in vel after one step,
# 2.3e-5 after three and 2.4e-3 after ten, each 2.2e-2 from the float64
# run: the relaxation amplifies rounding, and more so across 16 layers in
# 8 cells (4.8e-4 at 2 materials).
TRAJ3 = {"coord": 1e-6, "vel": 0.07, "temperature": 1e-6, "stress": 0.04,
         "strain": 0.07, "plstrain": 2e-6, "volume": 6e-5,
         "volume_n": 4e-5, "mass": 4e-5, "tmass": 4e-5, "hmass": 4e-5,
         "force": 0.03, "strain_rate": 0.04, "edvoldt": 0.04,
         "delta_plstrain": 1e-6, "volume_old": 6e-5}


def test_3d_maxwell_10_steps(sims3d):
    js, ts, s0 = sims3d[16]
    cfg = cfg3d(16, "maxwell")
    out = fused3d.make_chunk_runner(tdes.param_from_dict(cfg), ts.ctx, 0.0,
                                    10)(ts.ctx, s0)
    ref = _grid_run(with_param(js, jdes.param_from_dict(cfg)), 10,
                    jit=True)
    cfg["sim"]["float_dtype"] = "float64"
    j64 = jdes.Simulation(jdes.param_from_dict(cfg))
    f64 = _grid_run(j64, 10, jit=True)
    for f, limit in TRAJ3.items():
        a = get(ref, f).astype(np.float64)
        jax_d = rel_err(get(f64, f), a)
        assert jax_d < limit, (f, "JAX f32-f64", jax_d)
        port_d = rel_err(a, get(out, f))
        assert port_d < max(jax_d, 5e-3 if f == "force" else 1e-3), \
            (f, port_d, jax_d)
    for f in ("dt", "time", "max_global_vel_mag", "l2_residual"):
        a, b = float(get(ref, f)), float(get(out, f))
        assert abs(a - b) <= 1e-3 * max(abs(a), 1e-300), f
