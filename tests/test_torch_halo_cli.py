"""``DES_N_DEVICES`` in the port's CLI (``python -m dynearthsol_tpu_torch
--device cpu``): the node-sharded halo step on 4 shards of the CPU through
a remesh and a restart, as tests/test_halo.py drives the JAX CLI, on a
128 km x 8 km Delaunay box at 1 km (60 steps, frames every 30, a quality
check every 25 that remeshes at steps 25 and 50).

* The 4-shard run prints the JAX package's multi-chip line and its frames
  equal the single-device run's within 1e-9 of each array's largest value
  (integers bit for bit); against the JAX CLI's own 4-device run (the
  reference, made once) within 1e-9 beyond the distance of the port's
  single-device frames to it (tests/test_torch_halo.py says why the two
  packages' steps differ).
* A 4-shard checkpoint restarts bit for bit on 4 shards.
* Surface process 102 prints the JAX package's warning and runs on one
  device.

The suite keeps at most 7 items in a file (tests/test_torch_io_refusals.py
says why).
"""

import contextlib
import os

import pytest
import torch

from test_torch_halo import one_thread  # noqa: F401
from torch_cases import assert_frames_close, write_cfg

MULTI = "Multi-chip: node-sharded halo step on 4 devices."


def _cfg(**sim):
    return {
        "sim": {"modelname": "run", "max_steps": 60,
                "output_step_interval": 30,
                "checkpoint_frame_interval": 1000000,
                "is_outputting_averaged_fields": False, **sim},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 0,
                 "xlength": 128e3, "ylength": 0, "zlength": 8e3,
                 "resolution": 1e3, "quality_check_step_interval": 25,
                 "remeshing_option": 1, "max_boundary_distortion": 1e-6},
        "markers": {"markers_per_element": 4, "random_seed": 7},
        "control": {"gravity": 10, "inertial_scaling": 1e5,
                    "has_thermal_diffusion": True, "damping_option": 1},
        "bc": {"vbc_x0": 1, "vbc_val_x0": -1e-9, "vbc_x1": 1,
               "vbc_val_x1": 1e-9, "vbc_z0": 0, "vbc_z1": 0,
               "surface_temperature": 273, "mantle_temperature": 1600},
        "mat": {"rheology_type": "elasto-visco-plastic", "rho0": [2800],
                "bulk_modulus": [50e9], "shear_modulus": [30e9],
                "max_viscosity": 1e24, "min_viscosity": 1e19},
    }


@contextlib.contextmanager
def _in(path, n_devices):
    cwd = os.getcwd()
    old = os.environ.pop("DES_N_DEVICES", None)
    path.mkdir(parents=True, exist_ok=True)
    os.chdir(path)
    if n_devices > 1:
        os.environ["DES_N_DEVICES"] = str(n_devices)
    try:
        yield
    finally:
        os.chdir(cwd)
        os.environ.pop("DES_N_DEVICES", None)
        if old is not None:
            os.environ["DES_N_DEVICES"] = old


def _port(path, cfg, n_devices):
    from dynearthsol_tpu_torch import load_config
    from dynearthsol_tpu_torch.__main__ import run

    with _in(path, n_devices):
        write_cfg("case.cfg", cfg)
        return run(load_config("case.cfg"), device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's single-device and 4-shard runs and the JAX CLI's
    4-device run of the remesh config, each once, with their output."""
    import io
    from contextlib import redirect_stdout

    from dynearthsol_tpu import load_config as jload
    from dynearthsol_tpu.__main__ import run as jrun

    root = tmp_path_factory.mktemp("halo_cli")
    out = {}
    for tag in ("single", "multi", "jax"):
        buf = io.StringIO()
        with redirect_stdout(buf):
            if tag == "jax":
                with _in(root / tag, 4):
                    write_cfg("case.cfg", _cfg())
                    jrun(jload("case.cfg"))
            else:
                _port(root / tag, _cfg(), 4 if tag == "multi" else 1)
        out[tag] = buf.getvalue()
    return root, out


def test_cli_halo_remesh_matches_single_device(runs):
    root, out = runs
    assert MULTI in out["multi"] and MULTI not in out["single"]
    assert "Path:     halo" in out["multi"]
    for tag in ("single", "multi"):
        assert out[tag].count("remeshing (trigger") == 2, tag
    for frame in ("000001", "000002"):
        assert_frames_close(root / "single" / f"run.save.{frame}",
                            root / "multi" / f"run.save.{frame}",
                            tol=1e-9, eta_exact=False)


def test_cli_halo_matches_jax_cli(runs):
    root, out = runs
    assert MULTI in out["jax"]
    for frame in ("000001", "000002"):
        ref = root / "jax" / f"run.save.{frame}"
        steps = assert_frames_close(ref, root / "single" / f"run.save.{frame}",
                                    tol=1e-6, eta_exact=False)
        assert_frames_close(ref, root / "multi" / f"run.save.{frame}",
                            tol=1e-9 + steps, eta_exact=False)


def test_cli_halo_checkpoint_restart_bitexact(tmp_path):
    """A checkpoint a 4-shard run wrote restarts bit for bit on 4 shards
    (the JAX package's test_cli_multichip_checkpoint_restart_bitexact)."""
    from torch_cases import tagged_arrays

    cfg = _cfg(checkpoint_frame_interval=1)
    cfg["mesh"].update(quality_check_step_interval=1000000)
    _port(tmp_path / "cont", cfg, 4)
    assert (tmp_path / "cont" / "run.chkpt.000001").exists()
    rw = tmp_path / "restart"
    rw.mkdir()
    for f in os.listdir(tmp_path / "cont"):
        if f.startswith("run."):
            (rw / f).write_bytes((tmp_path / "cont" / f).read_bytes())
    cfg["sim"].update(is_restarting=True, restarting_from_modelname="run",
                      restarting_from_frame=1)
    _port(rw, cfg, 4)
    a = tagged_arrays(tmp_path / "cont" / "run.save.000002")
    b = tagged_arrays(rw / "run.save.000002")
    assert list(a) == list(b)
    for name in a:
        assert a[name] == b[name], name


def test_cli_surface102_runs_single_device(tmp_path, capsys):
    """The halo step refuses surface process 102: the JAX package's
    warning, word for word, and the run goes on on one device."""
    import dynearthsol_tpu as jdes
    from dynearthsol_tpu.__main__ import _make_stepper as jmake

    cfg = _cfg(max_steps=4, output_step_interval=4)
    cfg["control"].update(surface_process_option=102,
                          surface_diffusivity=1e-6)
    sim = _port(tmp_path / "port", cfg, 4)
    said = capsys.readouterr().out
    assert MULTI not in said and sim.step_path != "halo"
    assert int(sim.state.steps) == 4
    warn = [ln for ln in said.splitlines() if ln.startswith("Warning")]
    with _in(tmp_path / "jax", 4):
        jmake(jdes.Simulation(jdes.param_from_dict(cfg)))
    jwarn = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("Warning")]
    assert warn == jwarn and len(warn) == 1, (warn, jwarn)
    assert torch.isfinite(sim.state.coord).all()
