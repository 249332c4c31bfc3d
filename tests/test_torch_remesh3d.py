"""The 3D and metric-driven regenerations of the port (remesh_impl) against
the JAX package's, on the CPU in float64:

- ``generate_new_mesh_3d`` (the 5-tet columns under the interpolated
  surface) on a box whose top and bottom were moved by a seeded jitter,
  with the flattened bottom of option 13 and the interpolated one of
  option 100's fallback: every array bit for bit;
- ``compute_init_elem_size_n``, ``metric_spacing_interp`` (its spacing at
  seeded points) and ``generate_optimized_mesh_3d`` (same seed) on the
  Delaunay box of tests/test_flat.py:97-118 with a seeded plastic strain:
  bit for bit;
- a 3D option-13 remesh through Simulation (remeshing.remesh on both from
  the JAX state after 10 grid3d steps): the same mesh and markers bit for
  bit, every State field within 1e-12 of its max, then within 1e-10 after
  20 flat3d steps;
- a metric-driven 2D remesh (use_mesh_optimizer) through Simulation: the
  same mesh, markers and frozen size field, every field within 1e-12;
- a metric-driven 3D remesh through Simulation where the regeneration
  passes its own quality loop at the first try (a uniform spacing field,
  mmg_hmin_factor = mmg_hmax_factor = 2, on the unmoved box): the same
  mesh and markers, no retry, every volume positive, every field within
  1e-12;
- option 100's 3D fallback (an x0 wall that is no longer a plane refuses
  the structured regeneration) through Simulation onto
  generate_new_mesh_3d: the same mesh, markers and fields.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu import remesh_impl as jrm
from dynearthsol_tpu.remeshing import remesh as jremesh
from dynearthsol_tpu_torch import remesh_impl as trm
from dynearthsol_tpu_torch.remeshing import remesh as tremesh
from test_torch_remesh_sim import (_assert_fields_within,
                                   _assert_same_mesh_and_markers, _pair)
from torch_cases import flat3d_cfg, flat_cfg, grid3d_cfg


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def _jitter_top_bottom(coord, bcflag, seed, amp=60.0):
    r = np.random.default_rng(seed)
    c = coord.copy()
    for bit in (32, 16):                 # BOUNDZ1, BOUNDZ0
        on = (bcflag & bit) != 0
        c[on, 2] += r.uniform(-amp, amp, on.sum())
    return c


@pytest.mark.parametrize("option", [13, 100])
def test_generate_new_mesh_3d_equals_jax(option):
    cfg = grid3d_cfg()
    cfg["mesh"]["remeshing_option"] = option
    tp, jp = tdes.param_from_dict(cfg), jdes.param_from_dict(cfg)
    sim = tdes.Simulation(tp, device="cpu")
    topo = SimpleNamespace(bcflag=sim.topo.bcflag)
    coord = _jitter_top_bottom(sim.mesh.coord, sim.topo.bcflag, option)
    a = jrm.generate_new_mesh_3d(jp, coord, topo, 7)
    b = trm.generate_new_mesh_3d(tp, coord, topo, 7)
    _equal(a, b)
    assert len(b[1]) == len(sim.topo.connectivity)


def test_metric_path_functions_equal_jax():
    cfg = flat3d_cfg()
    tp, jp = tdes.param_from_dict(cfg), jdes.param_from_dict(cfg)
    sim = tdes.Simulation(tp, device="cpu")
    coord = _jitter_top_bottom(sim.mesh.coord, sim.topo.bcflag, 3, 40.0)
    conn = sim.topo.connectivity
    r = np.random.default_rng(11)
    v = coord[conn]
    vol = np.abs(np.einsum("ij,ij->i", v[:, 1] - v[:, 0],
                           np.cross(v[:, 2] - v[:, 0],
                                    v[:, 3] - v[:, 0]))) / 6.0
    pls = r.uniform(0.0, 0.5, len(conn))
    a = jrm.compute_init_elem_size_n(coord, conn, vol)
    b = trm.compute_init_elem_size_n(coord, conn, vol)
    _equal([a], [b])
    hj = jrm.metric_spacing_interp(jp, coord, conn, vol, pls, a)
    ht = trm.metric_spacing_interp(tp, coord, conn, vol, pls, b)
    pts = r.uniform([0, 0, -4e3], [8e3, 4e3, 0], (500, 3))
    pts[:20] += [9e3, 0, 0]              # outside: the nearest-node branch
    _equal([hj(pts)], [ht(pts)])
    topo = SimpleNamespace(bcflag=sim.topo.bcflag)
    ma = jrm.generate_optimized_mesh_3d(jp, coord, topo, 5, hj)
    mb = trm.generate_optimized_mesh_3d(tp, coord, topo, 5, ht)
    _equal(ma, mb)
    assert len(mb[1]) > len(conn) // 2


def test_option13_3d_remesh_then_flat3d_steps():
    cfg = grid3d_cfg("maxwell", winkler=False)
    cfg["mesh"]["remeshing_option"] = 13
    js, ts = _pair(cfg, jax_steps=10)
    assert js.step_path == "grid3d" and ts.ctx.sgrid is not None
    jremesh(js, 1)
    tremesh(ts, 1)
    _assert_same_mesh_and_markers(js, ts)
    assert ts.ctx.sgrid is None and ts.ctx.band is None
    _assert_fields_within(js, ts, 1e-12)
    js.run_steps(20, chunk=20)
    ts.run_steps(20, chunk=20)
    assert js.step_path == ts.step_path == "flat3d"
    _assert_fields_within(js, ts, 1e-10)


def test_metric_driven_2d_remesh():
    cfg = flat_cfg(mesh={"remeshing_option": 11,
                         "use_mesh_optimizer": True})
    js, ts = _pair(cfg, jax_steps=7)
    r = np.random.default_rng(2)
    pls = r.uniform(0.0, 0.3, ts.topo.nelem)
    import jax.numpy as jnp
    import torch
    js.state = dataclasses.replace(js.state, plstrain=jnp.asarray(pls))
    ts.state = ts.state.replace(plstrain=torch.tensor(pls))
    jremesh(js, 1)
    tremesh(ts, 1)
    _assert_same_mesh_and_markers(js, ts)
    assert np.array_equal(js.init_elem_size_n, ts.init_elem_size_n)
    assert len(ts.init_elem_size_n) == ts.topo.nnode
    _assert_fields_within(js, ts, 1e-12)


# the metric-driven 3D regeneration that survives: with a spacing field
# clipped flat (mmg_hmin_factor = mmg_hmax_factor = 2) its lattice is kept
# whole, and on the box before its top and walls move nothing is near
# coplanar; a graded field or a moved top leaves slivers in both packages
METRIC_3D_OVER = {
    "mesh": {"remeshing_option": 11, "use_mesh_optimizer": True,
             "mmg_hmin_factor": 2.0, "mmg_hmax_factor": 2.0},
    "ic": {"weakzone_option": 2, "weakzone_plstrain": 0.5,
           "weakzone_xcenter": 0.5, "weakzone_ycenter": 0.5,
           "weakzone_zcenter": 0.5, "weakzone_xsemi_axis": 1.5e3,
           "weakzone_ysemi_axis": 1.5e3, "weakzone_zsemi_axis": 1.5e3}}


def test_metric_driven_3d_remesh_passes_its_quality_loop(capsys):
    js, ts = _pair(flat3d_cfg(**METRIC_3D_OVER))
    assert float(ts.state.plstrain.max()) == 0.5
    jremesh(js, 1)
    tremesh(ts, 1)
    out = capsys.readouterr().out
    assert "retrying" not in out and "risks" not in out, out
    _assert_same_mesh_and_markers(js, ts)
    assert np.array_equal(js.init_elem_size_n, ts.init_elem_size_n)
    assert ts.ctx.sgrid is None and float(ts.state.volume.min()) > 0.0
    _assert_fields_within(js, ts, 1e-12)


def test_option100_3d_fallback_regenerates_columns():
    """An x0 wall that is no longer a plane refuses the structured
    regeneration (remesh_impl.structured_regen_3d), and both packages
    fall back to generate_new_mesh_3d: the same mesh and fields."""
    cfg = grid3d_cfg("maxwell", winkler=False)
    cfg["mesh"]["remeshing_option"] = 100

    def move(c, topo):
        c = _jitter_top_bottom(c, topo.bcflag, 9)
        x0 = (topo.bcflag & 1) != 0          # BOUNDX0
        c[x0, 0] += np.random.default_rng(4).uniform(0.0, 30.0, x0.sum())
        return c

    js, ts = _pair(cfg, move=move)
    jremesh(js, 1)
    tremesh(ts, 1)
    _assert_same_mesh_and_markers(js, ts)
    assert ts.ctx.sgrid is None and ts._struct_regen_dims is None
    assert np.abs(ts.mesh.coord[:, 0]).min() == 0.0
    _assert_fields_within(js, ts, 1e-12)
