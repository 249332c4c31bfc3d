"""The functions behind the column step's surface process 102 and rate-and-
state friction, and the initial pore pressure and RSF state, against the JAX
package's on one input each (1e-13).

The helpers are in tests/test_torch_flat2d_features.py, beside the rest of
its tests. The suite keeps at most 7 items in a file: pytest-xdist's file
scheduler (--dist loadfile) sends the files with the most items first, and
the long golden file (tests/test_golden_vs_reference.py, 7 items) must start
early.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynearthsol_tpu import ic as jic
from dynearthsol_tpu.ops import matprops as jM, surface as jSP
from dynearthsol_tpu_torch import bc as tbc, ic as tic
from dynearthsol_tpu_torch.ops import matprops as tM, surface as tSP
from test_torch_flat2d_features import _close, _shared_sims, _sims, _top, HYD
from torch_cases import flat_cfg


@pytest.mark.parametrize("rates", [(3.17e-11, 1.585e-12), (0.0, 0.0)],
                         ids=["hemipelagic", "terrigenous_only"])
def test_option_102_on_one_input(rates):
    """terrigenous_dh with a basin (a trough below the base level between
    land on both sides), hemipelagic_dh, and apply_surface_processes with
    option 102 on those heights."""
    js, ts = _shared_sims("surface")
    jp, tp = copy.deepcopy(js.param), copy.deepcopy(ts.param)
    for p in (jp, tp):
        p.control.hemipelagic_sedimentation_rate = rates[0]
        p.control.pelagic_sedimentation_rate = rates[1]
    top, x = _top(js)
    z_top = 200.0 - 800.0 * np.exp(-((x - 8e3) / 3e3) ** 2)
    assert z_top.min() < 0.0 < z_top[0] and z_top[-1] > 0.0
    dt = 3e11
    want = jSP.terrigenous_dh(jp, jnp.asarray(x), jnp.asarray(z_top), dt)
    got = tSP.terrigenous_dh(tp, torch.as_tensor(x),
                             torch.as_tensor(z_top),
                             torch.tensor(dt, dtype=torch.float64))
    assert np.asarray(want).max() > 0
    _close(want, got.numpy())
    if rates[0] > 0:
        want = jSP.hemipelagic_dh(jp, jnp.asarray(z_top), dt)
        got = tSP.hemipelagic_dh(tp, torch.as_tensor(z_top),
                                 torch.tensor(dt, dtype=torch.float64))
        assert np.asarray(want).max() > 0
        _close(want, got.numpy())
    coord = np.array(js.state.coord)
    coord[top, 1] = z_top
    netop = js.ctx.surf.etop
    rng = np.random.default_rng(5)
    dhacc = rng.normal(0.0, 1.0, js.topo.nnode)
    edv = rng.normal(0.0, 1.0, netop)
    want = jSP.apply_surface_processes(jp, js.ctx.surf,
                                       jnp.asarray(coord), dt,
                                       jnp.asarray(dhacc), jnp.asarray(edv))
    st = tSP.surf_tables(ts.ctx.surf, ts.ctx.nnode, torch.float64, "cpu")
    got = tSP.apply_surface_processes(
        tp, st, torch.as_tensor(coord),
        torch.tensor(dt, dtype=torch.float64), torch.as_tensor(dhacc),
        torch.as_tensor(edv))
    for w, g in zip(want, got):
        _close(w, g.numpy())


@pytest.mark.parametrize("model", [0, 1, 2])
def test_plastic_props_rsf_on_one_input(model):
    """plastic_props_rsf (state evolution, dynamic friction, the
    Mohr-Coulomb quantities) for the three state laws, two materials."""
    js, ts = _shared_sims("rsf")
    rng = np.random.default_rng(11 + model)
    n = 64
    emw = rng.integers(0, 5, (n, 2)).astype(np.float64)
    emw[emw.sum(axis=1) == 0, 0] = 1.0
    pls = rng.uniform(0.0, 1.0, n)
    slip = 10.0 ** rng.uniform(-12, -3, n)
    sv = 10.0 ** rng.uniform(-3, 6, n)
    j = jnp.asarray
    want = jM.plastic_props_rsf(js.ctx.mat, j(emw), j(pls), j(slip), j(sv),
                                0.7, model)
    t = torch.as_tensor
    got = tM.plastic_props_rsf(ts.ctx.mat, t(emw), t(pls), t(slip), t(sv),
                               torch.tensor(0.7, dtype=torch.float64),
                               model)
    for w, g in zip(want, got):
        _close(w, g.numpy())


def test_initial_pore_pressure_and_rsf_state():
    """initial_hydrostatic_state with an excess pore pressure on the
    free nodes (a Dirichlet top), and initial_rsf_state from two
    materials' weights, as the Simulations set them."""
    cfg = flat_cfg("elasto-plastic-rsf",
                   control={"has_hydraulic_diffusion": True},
                   ic={"excess_pore_pressure": 3e6},
                   bc={"hbc_z1": 1},
                   mat={**HYD, "rho0": [2800.0, 2900.0],
                        "bulk_modulus": [50e9, 40e9],
                        "shear_modulus": [30e9, 20e9],
                        "num_materials": 2,
                        "friction_angle0": [30.0, 20.0],
                        "characteristic_velocity": [1e-6, 0.0],
                        "characteristic_distance": [1e-3, 1e-2]},
                   markers={"markers_per_element": 4,
                            "init_marker_option": 1})
    cfg["ic"].update({"mattype_layer_depths": [0.5],
                      "layer_mattypes": [0, 1]})
    js, ts = _sims(cfg)
    p = ts.param
    coord = np.asarray(js.mesh.coord)
    want = jic.initial_hydrostatic_state(js.param, coord, js.topo.bcflag)
    got = tic.initial_hydrostatic_state(p, coord, ts.topo.bcflag)
    np.testing.assert_array_equal(want, got)
    mask = tbc.pp_bc_mask(p.bc, ts.topo.bcflag)
    assert mask.any() and (~mask).any()
    emw = np.asarray(js.state.emw)
    assert (emw[:, 1] > 0).any()
    for w, g in zip(jic.initial_rsf_state(js.param, emw),
                    tic.initial_rsf_state(p, emw)):
        np.testing.assert_array_equal(w, g)
    for f in ("ppressure", "dyn_fric_coeff", "state_variable"):
        _close(np.asarray(getattr(js.state, f)),
               getattr(ts.state, f).numpy(), 0.0)
    np.testing.assert_array_equal(np.asarray(js.ctx.pp_bc_mask),
                                  ts.ctx.pp_bc_mask.numpy())
    _close(np.asarray(js.state.dt), ts.state.dt.numpy())
