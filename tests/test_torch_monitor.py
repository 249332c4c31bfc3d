"""The monitor (monitor.py) and a short rate-and-state run with earthquake
tracking and adaptive output through both packages' CLIs, on the CPU.

tests/torch_cases.py rsf_events_cfg (tests/test_monitor.py's simple-shear
benchmark, float64, with a cohesion low enough to yield within the first
steps, an event threshold under the plate rate and an end threshold above
it, so that events start and end at alternate wakes, the seismic moment
log on and an earthquake output interval of 5 steps), 60 steps through the JAX
CLI and the port's (torch_cases.run_both_clis): the monitor CSVs (the same
header, every number within 1e-10 relative), the same
seismic_moment_magnitude.txt (numbers within 1e-10), and the same frames
at the same steps.  Beside it, the monitor's binding, its capture before a
remesh and its rebinding on one moved mesh, against the JAX Monitor.
"""

import csv
import re

import numpy as np
import pytest

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.monitor import Monitor as JMonitor
from dynearthsol_tpu_torch.monitor import Monitor
from dynearthsol_tpu_torch.postproc import OutputReader
from torch_cases import carry, flat_cfg, rsf_events_cfg, run_both_clis

NUM = r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?"


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rsf")
    wakes = []
    sim = run_both_clis(tmp, rsf_events_cfg(), wake_log=wakes)
    return tmp, sim, wakes


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_monitor_csv_matches_jax(both):
    tmp, sim, _ = both
    for i in range(2):
        ref = _rows(tmp / "jax" / f"mon_point_{i}.csv")
        got = _rows(tmp / "our" / f"mon_point_{i}.csv")
        assert got[0] == ref[0] and "dynamic_friction" in got[0]
        assert len(got) == len(ref) == 8     # header + steps 0, 10, ..., 60
        for a, b in zip(ref[1:], got[1:]):
            # step, matched node and element, as written
            assert (a[0], a[4], a[5]) == (b[0], b[4], b[5])
            np.testing.assert_allclose(np.float64(b), np.float64(a),
                                       rtol=1e-10, atol=0)
    assert sim.step_path == "flat2d"


def test_event_log_matches_jax(both):
    tmp, _, _ = both
    ref = (tmp / "jax" / "seismic_moment_magnitude.txt").read_text()
    got = (tmp / "our" / "seismic_moment_magnitude.txt").read_text()
    assert re.sub(NUM, "#", got) == re.sub(NUM, "#", ref)
    assert got.count("Earthquake event ended") >= 2
    np.testing.assert_allclose([float(x) for x in re.findall(NUM, got)],
                               [float(x) for x in re.findall(NUM, ref)],
                               rtol=1e-10, atol=0)


def test_adaptive_frames_match_jax(both):
    tmp, sim, wakes = both
    ref, our = (OutputReader(str(tmp / d / d)) for d in ("jax", "our"))
    assert our.frames == ref.frames and our.steps == ref.steps
    assert [w["step"] for w in wakes if w.get("frame")] == \
        our.steps[1:]
    assert all("tracking_ms" in w and "monitor_ms" in w
               for w in wakes if w["step"] % 10 == 0)


def test_monitor_binds_and_rebinds_as_jax(tmp_path, monkeypatch):
    """On a Delaunay box with 4 points: the matched nodes and elements at
    the start, the points captured before a remesh from a moved mesh, and
    the rebinding on it (remesh_rebind "previous_coord")."""
    monkeypatch.chdir(tmp_path)
    cfg = flat_cfg(monitor={
        "enabled": True, "num_points": 4, "points_unit": "km",
        "points_x": [1.0, 5.5, 9.2, 15.0], "points_z": [-1.0, -3.3, -6.1,
                                                        -7.9],
        "remesh_rebind": "previous_coord", "output_prefix": "m"})
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    mons = (JMonitor(js.param, js), Monitor(ts.param, ts))
    for a in ("node_id", "elem_id", "points"):
        assert np.array_equal(getattr(mons[0], a), getattr(mons[1], a)), a
    js.run_steps(7, chunk=7)
    carry(js, ts)
    mons[0].before_remesh(js)
    mons[1].before_remesh(ts)
    assert np.array_equal(mons[0].rebind_points, mons[1].rebind_points)
    mons[0].rebind(js)
    mons[1].rebind(ts)
    for a in ("node_id", "elem_id"):
        assert np.array_equal(getattr(mons[0], a), getattr(mons[1], a)), a
    for m in mons:
        m.finalize()
