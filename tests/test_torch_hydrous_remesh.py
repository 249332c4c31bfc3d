"""The hydrous markers of phase changes through the rest of a run against
the JAX package's, on the CPU: frames and checkpoints, restart, and the
CLI through wakes and remeshes.

- From one state with markers and hydrous markers (the JAX Simulation's
  after two wakes, carried to the port with torch_cases.carry) both
  packages' Output write a frame and a checkpoint: the same arrays in the
  same order, the ``hydrous-markerset.*`` arrays among them, every array
  byte for byte but the derived density and mesh quality (1e-12).
- Restart: the JAX package's restart reads only ``markerset``
  (io/restart.py:83-91), so a restarted run has no hydrous markers; the
  port's does the same (ROADMAP, "Behaviour of the reference already on
  record").
- tests/torch_cases.py subduction_cfg on a Delaunay mesh, float64, through
  both CLIs for 30 steps with a remesh (option 11) at every quality check:
  every frame and checkpoint within 1e-10 of each array's scale, the
  markers and hydrous markers bit for bit.
"""

import numpy as np
import pytest

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu import phasechanges as jpc
from dynearthsol_tpu.io import Output as JOutput
from dynearthsol_tpu.io import restart as jrestart
from dynearthsol_tpu_torch.io import Output, restart
from torch_cases import (assert_frames_close, carry, run_both_clis,
                         subduction_cfg, tagged_arrays)

DERIVED = ("density", "mesh quality")


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Frame and checkpoint 0 of one state with hydrous markers, written
    by each package into its own directory."""
    tmp = tmp_path_factory.mktemp("hyd")
    cfg = subduction_cfg(sim={"checkpoint_frame_interval": 1})
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    for _ in range(2):
        jpc.phase_changes(js)
        jpc.advect_hydrous_markers(js, 3e11)
    carry(js, ts)
    assert ts.hydrous_markers.n > 0
    dirs = {}
    for tag, sim, out_cls in (("jax", js, JOutput), ("port", ts, Output)):
        d = tmp / tag
        d.mkdir()
        sim.param.sim.modelname = str(d / "hyd")
        out = out_cls(sim.param)
        out.write_checkpoint(sim)
        out.write_exact(sim)
        dirs[tag] = str(d / "hyd")
    return js, ts, dirs


@pytest.mark.parametrize("kind", ["save", "chkpt"])
def test_hydrous_frame_and_checkpoint_match_jax_writer(written, kind):
    _, _, dirs = written
    ja = tagged_arrays(f"{dirs['jax']}.{kind}.000000")
    ta = tagged_arrays(f"{dirs['port']}.{kind}.000000")
    assert list(ja) == list(ta)
    assert "hydrous-markerset size" in ta
    assert ("hydrous-markerset.eta" in ta) == (kind == "save")
    for name in ja:
        if name in DERIVED:
            a, b = (np.frombuffer(x[name], np.float64) for x in (ja, ta))
            assert np.abs(a - b).max() <= 1e-12 * np.abs(a).max(), name
        else:
            assert ja[name] == ta[name], name


def test_restart_drops_hydrous_markers_as_jax_does(written):
    """Both restarts read the markers and not the hydrous markers."""
    js, ts, dirs = written
    for pkg, rst, tag in ((jdes, jrestart, "jax"), (tdes, restart, "port")):
        p = pkg.param_from_dict(subduction_cfg(sim={
            "is_restarting": True, "restarting_from_frame": 0,
            "restarting_from_modelname": dirs[tag]}))
        sim, frame = rst(p) if pkg is jdes else rst(p, device="cpu")
        assert frame == 0
        assert sim.markers.n == ts.markers.n
        assert getattr(sim, "hydrous_markers", None) is None


def test_cli_subduction_run_matches_jax(tmp_path):
    """30 float64 steps through both CLIs: phase changes and the
    hydrous-marker advection at every 10-step wake, a remesh at every
    quality check (option 11, min_quality 0.99), a frame and checkpoint
    every 10 steps."""
    cfg = subduction_cfg(mesh={"meshing_elem_shape": 0,
                               "remeshing_option": 11, "min_quality": 0.99,
                               "quality_check_step_interval": 10})
    cfg["sim"].update(max_steps=30, output_step_interval=10,
                      checkpoint_frame_interval=1)
    wakes = []
    sim = run_both_clis(tmp_path, cfg, wake_log=wakes)
    assert sim.step_path == "flat2d"
    assert [w["step"] for w in wakes] == [10, 20, 30]
    assert [w["chunk_steps"] for w in wakes] == [10, 10, 10]
    assert all(w["hydrous"] > 0 for w in wakes)
    for frame in range(4):
        for kind in ("save", "chkpt"):
            a = tmp_path / "jax" / f"jax.{kind}.{frame:06d}"
            b = tmp_path / "our" / f"our.{kind}.{frame:06d}"
            assert_frames_close(a, b, 1e-10)
    names = tagged_arrays(tmp_path / "our" / "our.save.000003")
    assert "hydrous-markerset.eta" in names
