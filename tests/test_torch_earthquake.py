"""Earthquake tracking and adaptive output (earthquake.py) against the JAX
package's, on the CPU.

- ``handle_ats_output`` on each schedule of tests/test_ats.py (regular
  cadence and catch-up, earthquake frames with the regular frame's dedup,
  the averaged-fields gate, the time-interval schedule, the checkpoint
  cadence), each package with its own params and a recording stand-in for
  Output: the same frame steps, checkpoint steps and next regular frame;
- ``update_earthquake_tracking`` over one float64 rate-and-state state
  (plastic strain-rate set) whose velocity is scaled to start, hold and
  end an event: the same
  tracking state and the same seismic_moment_magnitude.txt, numbers within
  1e-10.
"""

import dataclasses
import re
from types import SimpleNamespace

import numpy as np
import pytest

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu import earthquake as jeq
from dynearthsol_tpu.constants import YEAR2SEC
from dynearthsol_tpu_torch import earthquake as teq
from torch_cases import carry, rsf_monitor_cfg

INT_MAX = 2**31 - 1


def _params(**sim_over):
    """tests/test_ats.py mk_param in both packages."""
    d = {"sim": {"ndims": 2, "output_step_interval": 10,
                 "checkpoint_frame_interval": 3,
                 "is_outputting_averaged_fields": False},
         "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                  "xlength": 1.0, "ylength": 0.0, "zlength": 1.0,
                  "resolution": 1.0, "quality_check_step_interval": 5}}
    out = []
    for pkg in (jdes, tdes):
        p = pkg.param_from_dict(d)
        for k, v in sim_over.items():
            setattr(p.sim, k, v)
        out.append(p)
    return out


class _Recorder:
    def __init__(self):
        self.frames, self.checkpoints = [], []

    def write(self, sim):
        self.frames.append(int(sim.state.steps))

    def write_checkpoint(self, sim):
        self.checkpoints.append(int(sim.state.steps))


def _drive(mod, p, visits, eq_mode=None, interval=2):
    """Visit (step, time) in turn; ``eq_mode`` puts the tracker in an
    event whose earthquake output the step-interval rule allows."""
    eq = mod.EarthquakeState.init(p)
    out, nrf = _Recorder(), 1
    if eq_mode:
        eq.in_earthquake_mode = True
    for s, t in visits:
        if eq_mode:
            eq.allow_earthquake_output = s - eq.last_output_step >= interval
        sim = SimpleNamespace(state=SimpleNamespace(steps=s, time=t))
        nrf = mod.handle_ats_output(p, sim, out, eq, 0.0, 0, nrf)
    return out.frames, out.checkpoints, nrf, eq.last_output_step


SCHEDULES = {
    "regular_cadence": ({}, [(s, float(s)) for s in range(1, 31)], False),
    "catch_up": ({}, [(47, 47.0)], False),
    "earthquake_dedup": ({"earthquake_output_step_interval": 2},
                         [(s, float(s)) for s in range(1, 11)], True),
    "averaged_fields_gate": ({"is_outputting_averaged_fields": True,
                              "output_step_interval": 4},
                             [(s, float(s)) for s in range(1, 13)], False),
    "time_interval": ({"output_step_interval": INT_MAX,
                       "output_time_interval_in_yr": 2.0},
                      [(s, s * YEAR2SEC) for s in range(1, 8)], False),
    "checkpoint_cadence": ({}, [(s, float(s)) for s in range(1, 61)], False),
}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_ats_schedule_matches_jax(case):
    over, visits, eq_mode = SCHEDULES[case]
    pj, pt = _params(**over)
    ref = _drive(jeq, pj, visits, eq_mode)
    got = _drive(teq, pt, visits, eq_mode)
    assert got == ref
    assert ref[0], case


NUM = r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?"


def _numbers(text):
    return [float(x) for x in re.findall(NUM, text)]


def test_earthquake_tracking_matches_jax(tmp_path, monkeypatch):
    cfg = rsf_monitor_cfg(nsteps=40)
    cfg["sim"]["seismic_moment_calculate_output"] = True
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    js.run_steps(20, chunk=20)
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    carry(js, ts)
    states, logs = [], {}
    for tag, sim, mod in (("jax", js, jeq), ("port", ts, teq)):
        d = tmp_path / tag
        d.mkdir()
        monkeypatch.chdir(d)
        eq = mod.EarthquakeState.init(sim.param)
        trace = []
        base = sim.state
        # a fast event (10x the plate rate) on a yielding fault, held,
        # then quiet (0.1x)
        for k, scale in enumerate((10.0, 10.0, 0.1)):
            st = dict(vel=base.vel * scale,
                      delta_plstrain=base.delta_plstrain + 1e-7,
                      steps=base.steps + k, time=base.time + k * base.dt)
            if tag == "jax":
                sim.state = dataclasses.replace(base, **st)
            else:
                sim.state = base.replace(**st)
            mod.update_earthquake_tracking(sim.param, sim, eq)
            trace.append((eq.in_earthquake_mode, eq.allow_earthquake_output,
                          eq.last_output_step,
                          eq.cumulative_moment_by_mat.copy()))
        states.append(trace)
        logs[tag] = (d / "seismic_moment_magnitude.txt").read_text()
    for a, b in zip(*states):
        assert a[:3] == b[:3]
        np.testing.assert_allclose(b[3], a[3], rtol=1e-10, atol=0)
    assert [r[0] for r in states[1]] == [True, True, False]
    assert re.sub(NUM, "#", logs["jax"]) == re.sub(NUM, "#", logs["port"])
    np.testing.assert_allclose(_numbers(logs["port"]), _numbers(logs["jax"]),
                               rtol=1e-10, atol=0)
    assert "Moment magnitude (Mw)" in logs["port"]
