"""The port's 3D host setup against the JAX package's, on the 128 x 4 x 8-cell
3D config (tests/torch_cases.make_sim3d_cfg): the initial State, the
structured-grid bookkeeping, the dispatch to the fused 3D step and the
features that step refuses; and the default device of ``Simulation``.

Tolerances are tests/test_torch_init.py's: host-built fields and integers
bitwise, fields computed in f32 on the device 4 ulp relative to each
field's max (5e-7).
"""

import inspect

import numpy as np
import pytest
import torch

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.ops import pallas3d
from dynearthsol_tpu.ops import structured as JS
from dynearthsol_tpu_torch.ops import fused3d
from dynearthsol_tpu_torch.ops import structured as TS
from dynearthsol_tpu_torch.state import FIELD_NAMES, state_to_numpy
from torch_cases import make_sim3d_cfg, rel_err

COMPUTED = ("volume", "volume_old", "volume_n", "mass", "tmass", "hmass",
            "ymass", "viscosity", "dt", "max_global_vel_mag",
            "global_dt_min", "vel")


def _port(cfg):
    return tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")


@pytest.fixture(scope="module")
def sims():
    cfg = make_sim3d_cfg(ic={"weakzone_option": 1})
    return jdes.Simulation(jdes.param_from_dict(cfg)), _port(cfg)


def test_initial_state_matches_jax(sims):
    js, ts = sims
    out = state_to_numpy(ts.state)
    for f in FIELD_NAMES:
        a = np.asarray(getattr(js.state, f))
        b = out[f]
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if f in COMPUTED:
            assert rel_err(a, b) <= 5e-7, (f, rel_err(a, b))
        else:
            assert np.array_equal(a, b), f
    assert ts.ctx.sgrid == js.ctx.sgrid == (129, 5, 9)
    np.testing.assert_array_equal(ts.topo.gather_idx, js.topo.gather_idx)
    for i in range(len(js.topo.bfacets)):
        np.testing.assert_array_equal(ts.topo.bfacets[i],
                                      js.topo.bfacets[i])
    np.testing.assert_array_equal(ts.ctx.surf.facet_nodes,
                                  np.asarray(js.ctx.surf.facet_nodes))
    assert ts.compensation_pressure == js.compensation_pressure


def test_dispatch_matches_jax(sims):
    js, ts = sims
    js._chunk_fn(10)
    ts._chunk_fn(10)
    assert ts.step_path == js.step_path == "pallas3d"


def test_structured_tables_match_jax(sims):
    js, ts = sims
    assert TS.tet_tables() == JS.tet_tables()
    np.testing.assert_array_equal(TS.structured_conn_3d(6, 4, 5),
                                  JS.structured_conn_3d(6, 4, 5))
    conn = ts.topo.connectivity
    assert TS.detect_structured_3d(conn, ts.topo.nnode) \
        == JS.detect_structured_3d(conn, ts.topo.nnode) == (129, 5, 9)
    bad = conn.copy()
    bad[7, [1, 2]] = bad[7, [2, 1]]
    assert TS.detect_structured_3d(bad, ts.topo.nnode) is None
    assert JS.detect_structured_3d(bad, ts.topo.nnode) is None


@pytest.mark.parametrize("over", [
    {"sim": {"float_dtype": "float64"}},
    {"mesh": {"xlength": 64e3}},
    {"bc": {"vbc_y0": 0, "vbc_y1": 0}},
], ids=["f64", "nxc64", "free_y"])
def test_gate_matches_jax(over):
    """Configs the TPU kernel refuses are refused by the fused step here
    too; both packages run them on grid3d."""
    cfg = make_sim3d_cfg(**over)
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = _port(cfg)
    assert not pallas3d.pallas3d_step_applicable(js.param, js.ctx)
    assert not fused3d.pallas3d_step_applicable(ts.param, ts.ctx)
    js._chunk_fn(1)      # the dispatch names the path; nothing compiles
    ts.run_steps(1)
    assert ts.step_path == js.step_path == "grid3d"


def test_default_device_is_the_card(monkeypatch):
    """Simulation(param) targets "cuda"; without a card it raises rather
    than run on the CPU."""
    sig = inspect.signature(tdes.Simulation.__init__)
    assert sig.parameters["device"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdes.Simulation(tdes.param_from_dict(make_sim3d_cfg()))
