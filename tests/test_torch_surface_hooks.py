"""Host-applied surface increments (hooks.py, gospl_driver.py,
Simulation.apply_host_surface_dh) and the profiler trace against the JAX
package's, on the CPU.

- ``apply_host_surface_dh`` from one state (2D and 3D, float64): every
  State field within 1e-12 of its scale;
- surface_process_option 101 with one hook registered in both packages,
  and option 11 with tests/test_gospl_wiring.py's stand-in for
  GoSPLDriver, through both CLIs (tests/test_gospl_wiring.py's 10 km x 5
  km box, float64, 5 steps, a frame every step): every frame within 1e-10
  of each array's scale;
- ``generate_gospl_mesh`` equal to the JAX function's, point for point;
- without ``gospl`` the CLI prints the ImportError and exits 1, as the JAX
  CLI does;
- ``DES_PROFILE_DIR`` writes a Chrome trace of the run.
"""

import contextlib
import json

import numpy as np
import pytest

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu import gospl_driver as jgospl
from dynearthsol_tpu import hooks as jhooks
from dynearthsol_tpu_torch import gospl_driver as tgospl
from dynearthsol_tpu_torch import hooks as thooks
from dynearthsol_tpu_torch.state import FIELD_NAMES, state_to_numpy
from test_gospl_wiring import _MockGoSPL
from test_gospl_wiring import _param as wiring_param
from torch_cases import (assert_frames_close, carry, flat3d_cfg, flat_cfg,
                         rel_err, run_both_clis, write_cfg)


def _wiring_cfg(opt, **ctrl):
    """tests/test_gospl_wiring.py _param as a cfg dict."""
    p = wiring_param(opt, **ctrl)
    out = {}
    for sec in ("sim", "mesh", "markers", "control", "bc", "mat"):
        defaults = type(getattr(p, sec))()
        out[sec] = {k: v for k, v in vars(getattr(p, sec)).items()
                    if v != getattr(defaults, k) and not k.startswith("_")}
    return out


@pytest.mark.parametrize("cfg", [
    flat_cfg(), flat3d_cfg(sim={"float_dtype": "float64"})],
    ids=["2d", "3d"])
def test_apply_host_surface_dh_matches_jax(cfg):
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    js.run_steps(3, chunk=3)
    carry(js, ts)
    top = np.asarray(ts.ctx.surf.top_nodes)
    dh = np.sin(np.arange(top.size)) * 3.0
    js.apply_host_surface_dh(dh)
    ts.apply_host_surface_dh(dh)
    out = state_to_numpy(ts.state)
    for f in FIELD_NAMES:
        ref = np.asarray(getattr(js.state, f))
        if np.abs(ref).max(initial=0.0) > 0:
            assert rel_err(ref, out[f]) <= 1e-12, f
        else:
            assert not np.abs(out[f]).any(), f
    assert np.array_equal(out["dhacc"][top], dh)


def _hook(sim, dt_elapsed):
    """Half a metre of erosion per wake, graded along the surface."""
    n = int(sim.ctx.surf.ntop)
    return -0.5 * (1.0 + np.arange(n) / n)


@pytest.mark.parametrize("opt", [101, 11])
def test_host_surface_processes_through_both_clis(tmp_path, monkeypatch,
                                                  opt):
    if opt == 101:
        cfg = _wiring_cfg(101)

        @contextlib.contextmanager
        def hooked(mod):
            mod.set_custom_surface_process(_hook)
            try:
                yield
            finally:
                mod.set_custom_surface_process(None)
        over = hooked(jhooks), hooked(thooks)
    else:
        cfg = _wiring_cfg(11, gospl_coupling_frequency=2,
                          gospl_coupling_mode="steps")
        monkeypatch.setattr(jgospl, "GoSPLDriver", _MockGoSPL)
        monkeypatch.setattr(tgospl, "GoSPLDriver", _MockGoSPL)
        over = None, None
    wakes = []
    sim = run_both_clis(tmp_path, cfg, *over, wake_log=wakes)
    for frame in range(6):
        assert_frames_close(tmp_path / "jax" / f"jax.save.{frame:06d}",
                            tmp_path / "our" / f"our.save.{frame:06d}")
    applied = [w for w in wakes if "surface_dh_ms" in w]
    assert len(applied) == (5 if opt == 101 else 2)
    if opt == 11:
        assert sim.gospl.couplings == 2 and sim.gospl.initialized


def test_generate_gospl_mesh_matches_jax():
    rng = np.random.default_rng(3)
    xg, yg = np.meshgrid(np.linspace(0.0, 100.0, 11),
                         np.linspace(0.0, 100.0, 11))
    cases = [(xg.ravel(), yg.ravel(), 10.0, 0.0, 0.1),
             (xg.ravel(), yg.ravel(), 10.0, 0.3, 0.1),
             (np.linspace(0, 100, 11), np.zeros(11), 10.0, 0.0, 0.1),
             (rng.uniform(0, 5e4, 200), rng.uniform(0, 3e4, 200), -1.0, 0.3,
              0.2)]
    for x, y, res, pert, pad in cases:
        pj, cj = jgospl.generate_gospl_mesh(x, y, res, pert, pad)
        pt, ct = tgospl.generate_gospl_mesh(x, y, res, pert, pad)
        assert np.array_equal(pj, pt) and np.array_equal(cj, ct)


def test_cli_without_gospl_exits_1(tmp_path, monkeypatch, capsys):
    from dynearthsol_tpu_torch.__main__ import main

    assert not tgospl.gospl_available()
    monkeypatch.chdir(tmp_path)
    cfg = _wiring_cfg(11)
    cfg["sim"]["modelname"] = "nogospl"
    write_cfg("nogospl.cfg", cfg)
    with pytest.raises(SystemExit) as e:
        main(["--device", "cpu", "nogospl.cfg"])
    assert e.value.code == 1
    assert "Error: surface_process_option 11 requires the `gospl` " \
        "package" in capsys.readouterr().err


def test_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    from dynearthsol_tpu_torch.__main__ import run

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DES_PROFILE_DIR", str(tmp_path / "prof"))
    cfg = flat_cfg()
    cfg["sim"].update(modelname="prof", max_steps=3)
    run(tdes.param_from_dict(cfg), device="cpu")
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
