"""The port's fused 3D step (ops/fused3d.py, plain version on the CPU)
against the JAX package on the 128 x 4 x 8-cell 3D config: the grid3d step
(the JAX package's oracle for pallas3d, tests/test_pallas3d.py) and the
Pallas step in interpret mode, both started from the same JAX State
(state_from_numpy); and the slice end to end through ``run_steps``.  One
JAX and one port Simulation serve the file (the EVP config with a weak
zone; the maxwell gates take its mesh and state with a maxwell param,
which reads no plastic strain), and each JAX reference is computed once:
the 10-step maxwell trajectory on grid3d serves the trajectory gate and
the slice, the one-step EVP grid3d state the EVP gate and the scalars
test.

The chunk form of the step (each step's tensor epilogue, the NMD stress
correction, Jaumann rotation and surface-element scaling, pending until the
next step's rheology; one finalize after the last step) must give the State
of its complete steps (fused3d_step: step, then epilogue) bit for bit,
every plane, in f32 and f64: plain version only, no JAX.

Tolerances are test_pallas3d.py's (tests/torch_cases.py): the 3D EVP
min-select is chaotic at f32 roundoff, so trajectories are gated on
maxwell over 10 steps (ending on a dt-refresh step) and EVP on one step.
"""

from contextlib import contextmanager
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.ops import grid3d, pallas3d
from dynearthsol_tpu_torch.ops import fused2d, fused3d
from dynearthsol_tpu_torch.state import (FIELD_NAMES, state_from_numpy,
                                         state_to_numpy)
from torch_cases import (assert_evp3_one_step_close, assert_maxwell3_close,
                         make_sim3d_cfg, rel_err, with_param)

SCALARS = ("time", "dt", "max_global_vel_mag", "global_dt_min",
           "l2_residual")


def get(s, f):
    v = getattr(s, f)
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


_SIMS = {}


def _sims(cfg):
    """(JAX Simulation, port Simulation, the JAX initial state as a port
    State) of a config, built once per process for this file and
    tests/test_torch_fused3d_cases.py, which only read them."""
    key = repr(cfg)
    if key not in _SIMS:
        js = jdes.Simulation(jdes.param_from_dict(cfg))
        ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
        s0 = state_from_numpy({f: np.asarray(getattr(js.state, f))
                               for f in FIELD_NAMES}, dtype=torch.float32)
        _SIMS[key] = js, ts, s0
    return _SIMS[key]


def _grid_run(js, n, jit=False):
    """n grid3d steps from the JAX Simulation's state, with its Winkler
    reference pressure.  ``jit``: the step compiled as one program, which
    the persistent compile cache of tests/conftest.py keeps (op by op it
    is compiled anew in every process).  XLA then contracts products and
    sums into FMAs, a rounding of its own: used for the maxwell
    trajectories, whose gates allow it, not for the EVP steps, where it
    resolves ties of rounding of the min-select its own way."""
    nx, ny, nz = js.ctx.sgrid
    step = grid3d.make_grid_step(js.param, js.ctx, js.compensation_pressure)
    gstep = jax.jit(lambda g: step(js.ctx, g)) if jit else \
        (lambda g: step(js.ctx, g))
    g = grid3d.state_to_grid(js.state, nx, ny, nz)
    for _ in range(n):
        g = gstep(g)
    return grid3d.grid_to_state(g, nx, ny, nz)


def _pallas_run(js, n):
    old = pallas3d.INTERPRET
    pallas3d.INTERPRET = True
    try:
        return pallas3d.make_chunk_runner(js.param, js.ctx, 0.0, n)(
            js.ctx, js.state)
    finally:
        pallas3d.INTERPRET = old


EVP_CFG = make_sim3d_cfg(ic={"weakzone_option": 1})
MAXWELL_CFG = make_sim3d_cfg(mat={"rheology_type": "maxwell"},
                             ic={"weakzone_option": 1})


@pytest.fixture(scope="module")
def maxwell():
    """The EVP config's Simulations with the maxwell param (with_param),
    and its initial state."""
    js, ts, s0 = _sims(EVP_CFG)
    return (with_param(js, jdes.param_from_dict(MAXWELL_CFG)),
            with_param(ts, tdes.param_from_dict(MAXWELL_CFG)), s0)


@pytest.fixture(scope="module")
def maxwell_ref(maxwell):
    """10 maxwell steps of the JAX package's grid3d step from its initial
    state."""
    return _grid_run(maxwell[0], 10, jit=True)


@pytest.fixture(scope="module")
def evp():
    js, ts, s0 = _sims(EVP_CFG)
    port = fused3d.make_chunk_runner(ts.param, ts.ctx, 0.0, 1)(ts.ctx, s0)
    return js, ts, s0, port


@pytest.fixture(scope="module")
def evp_ref(evp):
    return _grid_run(evp[0], 1)


def test_maxwell_10_steps_vs_grid3d(maxwell, maxwell_ref):
    _, ts, s0 = maxwell
    out = fused3d.make_chunk_runner(ts.param, ts.ctx, 0.0, 10)(ts.ctx, s0)
    assert_maxwell3_close(maxwell_ref, out, get)


def test_evp_one_step_vs_grid3d(evp, evp_ref):
    assert_evp3_one_step_close(evp_ref, evp[3], get)


def test_evp_one_step_vs_pallas3d(evp):
    js, _, _, port = evp
    assert_evp3_one_step_close(_pallas_run(js, 1), port, get)


def test_evp_ties_are_few(evp, maxwell):
    """The exact ties of the EVP min-select at step 1 (fused3d.evp_ties):
    where the deviatoric trial increment lies below the f32 resolution of
    the lithostatic stress, both invariants round to 0 while the branches
    differ in pressure.  A few per cent of the elements at most, and
    none off EVP."""
    _, ts, s0, _ = evp
    tie = fused3d.evp_ties(fused3d.make_plan(ts.param, ts.ctx, "cpu"),
                           ts.ctx, s0)
    assert 0 < int(tie.sum()) <= 0.02 * tie.numel()
    _, tm, m0 = maxwell
    assert not fused3d.evp_ties(fused3d.make_plan(tm.param, tm.ctx, "cpu"),
                                tm.ctx, m0).any()


def test_scalars_set_every_step(evp, evp_ref):
    """Step 1 is off the dt-refresh cadence: dt stays, while vmax and
    gdtmin come from the step's own partials (pallas3d.py:1649-1690), as
    in the JAX step; the 2D mode of dt_refresh would have kept them."""
    _, _, s0, port = evp
    ref = evp_ref
    for f in SCALARS:
        a, b = float(get(ref, f)), float(get(port, f))
        assert abs(a - b) <= 1e-3 * max(abs(a), 1e-300), f
    assert float(port.dt) == float(s0.dt)
    assert float(port.max_global_vel_mag) != float(s0.max_global_vel_mag)
    assert float(port.global_dt_min) != float(s0.global_dt_min)


def test_dt0_step_keeps_volume(maxwell):
    """A step with dt = 0 recomputes the initial volume bit for bit
    (ops/shapefn.compute_volume has the step's operation order)."""
    _, ts, _ = maxwell
    P = fused3d.make_plan(ts.param, ts.ctx, "cpu")
    b = fused3d.make_buffers(P, ts.ctx, ts.state, 1)
    b.scal[0] = 0.0
    fused3d.fused3d_step(P, b)
    vol = fused3d._eslot("volume")
    assert torch.equal(b.eout[vol], b.ein[vol])


def test_slice_matches_jax(maxwell, maxwell_ref):
    """The port's Simulation(...).run_steps(10, chunk=10) from its own
    initial state against 10 steps of the JAX package from its own
    (maxwell), every State field.  The JAX side is its grid3d step, the
    plain reference of pallas3d (which test_evp_one_step_vs_pallas3d runs
    in interpret mode): a second interpreted lowering would cost this file
    15 s."""
    ts = tdes.Simulation(tdes.param_from_dict(MAXWELL_CFG), device="cpu")
    ref = maxwell_ref
    out = state_to_numpy(ts.run_steps(10, chunk=10))
    js = _sims(EVP_CFG)[0]   # the JAX Simulation of this mesh
    js._chunk_fn(10)
    assert ts.step_path == js.step_path == "pallas3d"
    tols = {"force": 5e-3, "dpressure": 5e-3}
    for f in FIELD_NAMES:
        a, b = np.asarray(getattr(ref, f)), out[f]
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert np.isfinite(b).all(), f
        if f == "viscosity":
            d = np.abs(np.log(a.astype(np.float64))
                       - np.log(b.astype(np.float64)))
            assert np.median(d) < 0.02
        elif f in SCALARS:
            assert abs(float(a) - float(b)) <= 1e-3 * abs(float(a)), f
        elif f == "steps":
            assert int(a) == int(b) == 10
        else:
            assert rel_err(a, b) < tols.get(f, 1e-3), (f, rel_err(a, b))


# ---- the chunk form against complete steps (plain version, bit for bit)

@contextmanager
def torch_threads(n):
    """Run at n intra-op threads (these planes are small: a pool of
    threads per element-wise op costs more than it saves)."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


# (sims fixture, steps, dtype, switches set off in the step plan)
CHUNK_CASES = {
    "maxwell_10_f32": ("maxwell", 10, torch.float32, ()),
    "maxwell_10_f64": ("maxwell", 10, torch.float64, ()),
    "evp_3_f32": ("evp", 3, torch.float32, ()),
    "evp_3_f64": ("evp", 3, torch.float64, ()),
    "evp_3_no_jaumann_no_surface_correction": (
        "evp", 3, torch.float32, ("jaumann", "surf_corr")),
    "evp_3_no_nmd": ("evp", 3, torch.float32, ("nmd",)),
}


def chunk_setup(ts, s0, dtype, off=()):
    """The plan of the port's Simulation ``ts`` in ``dtype`` with the
    switches ``off`` set to 0 (in ``sw`` and in the kernel's ``ip``), and
    the initial state ``s0`` in ``dtype``."""
    P = replace(fused3d.make_plan(ts.param, ts.ctx, ts.device), dtype=dtype)
    for name in off:
        P.sw[name] = 0
        P.ip[fused3d.IP_FIELDS.index(name)] = 0
    return P, state_from_numpy(state_to_numpy(s0), ts.device, dtype)


def complete_steps(P, ctx, s, n):
    """n complete steps (fused3d_step, the runner's scalar update, swap):
    the planes and scalars after them."""
    b = fused3d.make_buffers(P, ctx, s, n)
    for k in range(n):
        b.tgt = fused3d.vbc_targets(ctx, b.nin, b.scal[3] + b.scal[0])
        fused3d.fused3d_step(P, b)
        fused2d.dt_refresh(P, b, k, tiled=True, every=True)
        b.swap()
    return b.ein, b.nin, b.scal


