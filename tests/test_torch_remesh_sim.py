"""Remesh events through the port's Simulation and CLI against the JAX
package's (remeshing.remesh on both, from the same state: the port's is
the JAX state through state_from_numpy, its markers the JAX markers
through MarkerSet.from_arrays):

- option 11 on the 16 km x 8 km Delaunay box in float64 (flat2d): the same
  mesh and markers bit for bit, every State field within 1e-12 of its
  max, then within 1e-10 after 20 more flat2d steps;
- option 100 from meshing_elem_shape 0 on make_sim_cfg's 16 km x 128 km
  box in float32: the structured regeneration takes both packages back to
  pallas2d_res (the JAX side in interpret mode, as
  tests/test_torch_fused2d.py runs it), held to the maxwell trajectory
  gate over 10 steps; a second remesh with the same dims, whose next
  chunk equals that of a runner built fresh on the new context;
- option 100 in 3D, float64, the remesh only;
- the CLI through remeshes (options 11), frames written around each,
  against the JAX CLI's last frame; and the hydrous-marker remap on the 3D
  and metric-driven remeshing paths, bit for bit."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.ops import pallas2d
from dynearthsol_tpu.remeshing import remesh as jremesh
from dynearthsol_tpu_torch.markers import MarkerSet
from dynearthsol_tpu_torch.ops import fused2d
from dynearthsol_tpu_torch.remeshing import remesh as tremesh
from dynearthsol_tpu_torch.state import (FIELD_NAMES, state_from_numpy,
                                         state_to_numpy)
from torch_cases import (assert_maxwell_close, flat_cfg, make_sim3d_cfg,
                         make_sim_cfg, rel_err, write_cfg)

MARKER_FIELDS = ("eta", "elem", "mattype", "id", "time", "z", "distance",
                 "slope", "genesis")


def get(s, f):
    v = getattr(s, f)
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _pair(cfg, jax_steps=0, move=None):
    """Both Simulations on cfg; the JAX one runs ``jax_steps`` (or has its
    coordinates moved by ``move``), then the port takes its state and
    markers."""
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    if jax_steps:
        js.run_steps(jax_steps, chunk=jax_steps)
    if move is not None:
        import jax.numpy as jnp
        c = move(np.asarray(js.state.coord, dtype=np.float64), js.topo)
        js.state = dataclasses.replace(
            js.state, coord=jnp.asarray(c, dtype=js.state.coord.dtype))
    ts.state = state_from_numpy({f: np.asarray(getattr(js.state, f))
                                 for f in FIELD_NAMES}, dtype=ts.dtype)
    if js.markers is not None:
        m = js.markers
        ts.markers = MarkerSet.from_arrays(cfg["sim"]["ndims"],
                                           m.save_arrays(), m.chkpt_arrays())
    return js, ts


def _assert_same_mesh_and_markers(js, ts):
    for f in ("connectivity", "bcflag", "segment", "segflag"):
        assert np.array_equal(getattr(js.topo, f), getattr(ts.topo, f)), f
    for a, b in zip(js.topo.bfacets, ts.topo.bfacets):
        assert np.array_equal(a, b)
    assert js.ctx.sgrid == ts.ctx.sgrid
    a, b = js.markers, ts.markers
    assert (a.n, a.last_id) == (b.n, b.last_id)
    for nm in MARKER_FIELDS:
        assert np.array_equal(a.live(nm), b.live(nm)), nm


def _assert_fields_within(js, ts, tol):
    ref, out = ({f: np.asarray(getattr(js.state, f)) for f in FIELD_NAMES},
                state_to_numpy(ts.state))
    for f in FIELD_NAMES:
        assert ref[f].shape == out[f].shape, f
        if ref[f].size and np.abs(ref[f]).max() > 0:
            assert rel_err(ref[f], out[f]) <= tol, (f, rel_err(ref[f],
                                                               out[f]))
        else:
            assert not np.abs(out[f]).any(), f


def test_option11_remesh_then_flat2d_steps():
    cfg = flat_cfg(mesh={"remeshing_option": 11})
    js, ts = _pair(cfg, jax_steps=21)
    jremesh(js, 1)
    tremesh(ts, 1)
    _assert_same_mesh_and_markers(js, ts)
    assert ts.ctx.band is None and not ts._chunk_fns
    _assert_fields_within(js, ts, 1e-12)
    assert set(ts.remesh_seconds) == {"spr", "regen", "locate", "acm",
                                      "markers", "finalize"}
    js.run_steps(20, chunk=20)
    ts.run_steps(20, chunk=20)
    assert js.step_path == ts.step_path == "flat2d"
    _assert_fields_within(js, ts, 1e-10)


@pytest.fixture(scope="module")
def option100():
    """make_sim_cfg's box on a Delaunay mesh, maxwell, option 100: 10
    flat2d steps, then the structured regeneration in both packages."""
    cfg = make_sim_cfg(mat={"rheology_type": "maxwell"},
                       mesh={"meshing_elem_shape": 0,
                             "remeshing_option": 100})
    js, ts = _pair(cfg, jax_steps=10)
    assert js.step_path == "flat2d" and ts.ctx.sgrid is None
    jremesh(js, 1)
    tremesh(ts, 1)
    return js, ts


def test_option100_returns_to_the_resident_kernel(option100):
    js, ts = option100
    _assert_same_mesh_and_markers(js, ts)
    assert ts.ctx.sgrid == (17, 129)
    assert fused2d.resident_applicable(ts.param, ts.ctx)
    # the finalize's volumes and masses are float32 device work
    _assert_fields_within(js, ts, 1e-6)
    old = pallas2d.INTERPRET
    pallas2d.INTERPRET = True
    try:
        js.run_steps(10, chunk=10)
    finally:
        pallas2d.INTERPRET = old
    ts.run_steps(10, chunk=10)
    assert js.step_path == ts.step_path == "pallas2d_res"
    assert_maxwell_close(js.state, ts.state, get)


def test_second_remesh_same_dims_next_chunk_equals_fresh_runner(option100):
    """Runs after the test above: the port's run goes on from its own
    state.  The remesh keeps the dims, drops the runners, and the next
    chunk equals that of a resident runner built on the new context."""
    _, ts = option100
    tremesh(ts, 1)
    assert ts.ctx.sgrid == (17, 129) and not ts._chunk_fns
    s0 = ts.state
    fresh = fused2d.make_resident_chunk_runner(
        ts.param, ts.ctx, ts.compensation_pressure, 5)(ts.ctx, s0)
    out = ts.run_steps(5, chunk=5)
    assert ts.step_path == "pallas2d_res"
    for f in FIELD_NAMES:
        assert torch.equal(getattr(fresh, f), getattr(out, f)), f


def _move3d(coord, topo):
    """Raise the top and shear the interior; walls and bottom stay."""
    c = coord.copy()
    x, z = c[:, 0], c[:, 2]
    bc = topo.bcflag
    c[:, 2] += np.where((bc & 16) != 0, 0.0,
                        150.0 * np.sin(np.pi * x / 8e3) * (1 + z / 4e3))
    inner = (bc & 3) == 0
    c[inner, 0] += 120.0 * np.sin(np.pi * z[inner] / 4e3)
    return c


def test_option100_3d_remesh():
    cfg = make_sim3d_cfg(sim={"float_dtype": "float64"},
                         mesh={"xlength": 8e3, "ylength": 2e3,
                               "zlength": 4e3, "remeshing_option": 100})
    js, ts = _pair(cfg, move=_move3d)
    jremesh(js, 1)
    tremesh(ts, 1)
    _assert_same_mesh_and_markers(js, ts)
    assert ts.ctx.sgrid == (9, 3, 5)
    _assert_fields_within(js, ts, 1e-12)


def test_cli_goes_on_through_remeshes(tmp_path, monkeypatch, capsys):
    """min_quality 0.99 makes every quality check (every 5 steps) remesh
    with option 11 over 15 steps, frames written before and after each;
    the last frame against the JAX CLI's within 1e-10."""
    from dynearthsol_tpu.__main__ import run as jrun
    from dynearthsol_tpu.compare import _frame_quantities, reldiff
    from dynearthsol_tpu.postproc import OutputReader
    from dynearthsol_tpu_torch.__main__ import main as cli_main

    monkeypatch.chdir(tmp_path)
    cfg = flat_cfg(mesh={"remeshing_option": 11, "min_quality": 0.99,
                         "quality_check_step_interval": 5})
    cfg["sim"].update(max_steps=15, output_step_interval=15,
                      has_output_during_remeshing=True)
    for name in ("jax", "our"):
        cfg["sim"]["modelname"] = name
        write_cfg(tmp_path / f"{name}.cfg", cfg)
    jrun(jdes.load_config("jax.cfg"))
    capsys.readouterr()
    assert cli_main(["--device", "cpu", "our.cfg"]) == 0
    printed = capsys.readouterr().out
    assert "Remesh:   " in printed and " / 3 = " in printed
    assert printed.count("remeshing (trigger 1)") == 3
    ref, our = OutputReader("jax"), OutputReader("our")
    assert our.frames == ref.frames and len(our.frames) == 8
    assert our.steps == ref.steps
    for frame in ref.frames:
        old = _frame_quantities(ref, frame, include_markers=False)
        new = _frame_quantities(our, frame, include_markers=False)
        for kind in old:
            mx, sg = reldiff(old[kind], new[kind])
            assert mx + sg <= 1e-10, (frame, kind, mx, sg)


# each case is a remeshing path (the 3D columns of generate_new_mesh_3d,
# the metric-driven path of use_mesh_optimizer) with the hydrous markers
# of phase changes, whose remap (JAX remesh_impl.py:1246-1257) both
# packages run
@pytest.mark.parametrize("over", [
    {"sim": {"ndims": 3}, "mesh": {"remeshing_option": 13,
                                   "ylength": 4e3}},
    {"mesh": {"use_mesh_optimizer": True}}],
    ids=["over0-generate_new_mesh_3d", "over1-use_mesh_optimizer"])
def test_cli_refuses_unported_remeshing(tmp_path, monkeypatch, over):
    """The hydrous-marker remap is ported: from one state, markers and
    hydrous markers (the JAX run's after 5 steps, a hydrous marker at each
    of its first 40 markers and one above the surface), both
    packages' remesh keep the same markers and hydrous markers bit for
    bit, the one above the surface deleted; and the CLI takes phase
    changes with the hydration processes."""
    from dynearthsol_tpu.markers import MarkerSet as JMarkerSet
    from dynearthsol_tpu_torch.__main__ import unported_driver_features
    from torch_cases import assert_same_markers, carry

    monkeypatch.chdir(tmp_path)
    cfg = flat_cfg(mesh={"quality_check_step_interval": 5})
    for sec, kv in over.items():
        cfg[sec].update(kv)
    cfg["mat"].update(nmat=2, rho0=[2800.0, 3300.0],
                      bulk_modulus=[50e9, 80e9], shear_modulus=[30e9, 48e9],
                      phase_change_option=1)
    cfg["control"]["has_hydration_processes"] = True
    param = tdes.param_from_dict(cfg)
    assert unported_driver_features(param) == []
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    js.run_steps(5, chunk=5)
    ts = tdes.Simulation(param, device="cpu")
    m, k = js.markers, 40
    hyd = JMarkerSet.empty(m.ndims, cap=64, name="hydrous-markerset")
    hyd.append(m.eta[:k], m.elem[:k], 0, genesis=3)
    # one more in a surface element, its eta extrapolated past the
    # element's highest node: above the surface, outside the new mesh
    top = int(js.ctx.surf.top_elems[0])
    z = np.asarray(js.state.coord)[js.topo.connectivity[top], -1]
    eta = np.full((1, m.ndims + 1), -2.0 / m.ndims)
    eta[0, np.argmax(z)] = 3.0
    hyd.append(eta, np.array([top], dtype=np.int32), 0, genesis=3)
    js.hydrous_markers = hyd
    carry(js, ts)
    jremesh(js, 1)
    tremesh(ts, 1)
    assert_same_markers(js.markers, ts.markers)
    assert_same_markers(js.hydrous_markers, ts.hydrous_markers)
    assert ts.hydrous_markers.n == k
