"""The port's 2D regeneration and marker bookkeeping against the JAX
package's, in float64 on the same host arrays: the re-triangulation of the
kept points (remeshing options 1/2/11, reuse_points_2d) and the structured
columns of meshing_elem_shape 1, the marker remap with each replenishment
option, and the surface-marker bookkeeping (sync_surface_markers) over a
few quality-check wakes with surface process 1.  The port's markers start
as a copy of the JAX package's (MarkerSet.from_arrays) and its state as
the JAX state (state_from_numpy); meshes, element ids, barycentric
coordinates and markers must be equal bit for bit."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu import markers as jmk
from dynearthsol_tpu import remesh_impl as jrm
from dynearthsol_tpu.mesh.generate import renumber_mesh as jrenumber
from dynearthsol_tpu_torch import markers as tmk
from dynearthsol_tpu_torch import remesh_impl as trm
from dynearthsol_tpu_torch.constants import BOUNDZ0
from dynearthsol_tpu_torch.mesh import MeshData, build_topology
from dynearthsol_tpu_torch.mesh.generate import (regular_grid_2d,
                                                 renumber_mesh,
                                                 unstructured_box_2d)
from dynearthsol_tpu_torch.state import FIELD_NAMES, state_from_numpy
from torch_cases import flat_cfg

MARKER_FIELDS = ("eta", "elem", "mattype", "id", "time", "z", "distance",
                 "slope", "genesis")


def _moved_box(res=1e3):
    """The 16 km x 8 km Delaunay box with its top raised in the middle,
    the interior sheared and the bottom nodes off the flat bottom."""
    md = unstructured_box_2d(16e3, 8e3, res)
    coord, conn, _ = renumber_mesh(md.coord, md.connectivity)
    topo = build_topology(MeshData(2, coord, conn), 16e3, 0.0, 8e3)
    c = coord.copy()
    x, z = c[:, 0], c[:, 1]
    c[:, 1] += 400.0 * np.sin(np.pi * x / 16e3) * (1.0 + z / 8e3)
    c[:, 1] += np.where((topo.bcflag & BOUNDZ0) != 0,
                        30.0 * np.sin(3 * np.pi * x / 16e3), 0.0)
    inner = topo.bcflag == 0
    c[inner, 0] += 300.0 * np.sin(2 * np.pi * z[inner] / 8e3)
    return c, np.asarray(conn, np.int32), topo


def _assert_markers_equal(a, b):
    assert (a.n, a.last_id) == (b.n, b.last_id)
    for nm in MARKER_FIELDS:
        assert np.array_equal(a.live(nm), b.live(nm)), nm


@pytest.mark.parametrize("shape", [0, 1])
def test_generate_new_mesh_2d_equals_jax(shape):
    """meshing_elem_shape 0: the kept points of option 11 (bottom restored,
    near-bottom interior points dropped), the segment recovery, Ruppert
    refinement and culling, then the renumbering; shape 1: the structured
    columns under the moved top.  Coord, conn and bcflag equal."""
    coord, conn, topo = _moved_box()
    cfg = flat_cfg(mesh={"remeshing_option": 11,
                         "meshing_elem_shape": shape})
    jp, tp = jdes.param_from_dict(cfg), tdes.param_from_dict(cfg)
    vol = np.abs(trm._signed_volumes(coord, conn))
    jt = SimpleNamespace(bcflag=topo.bcflag, connectivity=conn)
    if shape == 0:
        ru = trm.reuse_points_2d(tp, coord, topo, 3, vol)
        jru = jrm.reuse_points_2d(jp, coord, jt, 3, vol)
        assert all(np.array_equal(x, y) for x, y in zip(jru, ru))
        c, k, bf = jrm.generate_new_mesh_2d(jp, coord, jt, 7, reuse_pts=jru)
        a = jrenumber(c, k, bcflag=bf)
        a = (a[0], a[1], a[3])
        b = trm.generate_new_mesh_2d(tp, coord, topo, 7, reuse_pts=ru)
        b = renumber_mesh(*b)
        assert len(b[1]) > 200
    else:
        a = jrm.generate_new_mesh_2d(jp, coord, jt, 7)
        b = trm.generate_new_mesh_2d(tp, coord, topo, 7)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.fixture(scope="module")
def marker_meshes():
    """Markers of two materials placed on the moved box, and a finer grid
    to remap them onto (so elements fall below the minimum count)."""
    coord, conn, _ = _moved_box()
    cfg = flat_cfg(markers={"markers_per_element": 4},
                   ic={"mattype_layer_depths": [0.5],
                       "layer_mattypes": [0, 1]},
                   mat={"nmat": 2, "rho0": [2800.0, 3300.0],
                        "bulk_modulus": [50e9, 80e9],
                        "shear_modulus": [30e9, 48e9]})
    ms = tmk.create_markers(tdes.param_from_dict(cfg), coord, conn)
    fine = regular_grid_2d(16e3, 8e3, 16e3 / 24)
    new_coord = fine.coord.copy()
    new_coord[:, 1] += 400.0 * np.sin(np.pi * new_coord[:, 0] / 16e3) \
        * (1.0 + new_coord[:, 1] / 8e3)
    return cfg, ms, coord, conn, new_coord, fine.connectivity


@pytest.mark.parametrize("option", [0, 1, 2])
def test_remap_and_replenish_markers_equal_jax(marker_meshes, option):
    """remap_markers (location on the new mesh, strays removed swap-with-
    last, depleted elements refilled with replenishment_option 0, 1 or
    2): every marker field equal."""
    cfg, ms, coord, conn, new_coord, new_conn = marker_meshes
    cfg = dict(cfg, markers={**cfg["markers"],
                             "replenishment_option": option})
    jp, tp = jdes.param_from_dict(cfg), tdes.param_from_dict(cfg)
    save, chk = ms.save_arrays(), ms.chkpt_arrays()
    a = jmk.MarkerSet.from_arrays(2, save, chk)
    b = tmk.MarkerSet.from_arrays(2, save, chk)
    jrm.remap_markers(a, coord, conn, new_coord, new_conn, jp, 33)
    trm.remap_markers(b, coord, conn, new_coord, new_conn, tp, 33)
    assert b.n > ms.n and b.n < ms.n + 4 * len(new_conn)
    _assert_markers_equal(a, b)
    assert np.array_equal(
        jmk.emw_from_markers(a, len(new_conn), 2),
        tmk.emw_from_markers(b, len(new_conn), 2))


def test_sync_surface_markers_equals_jax():
    """Three quality-check wakes of 7 steps with surface process 1: the
    JAX run steps, the port takes its state, and both packages' own
    marker sets go through sync_surface_markers.  A deposit on every
    other top facet (a third of the element volume a marker) and, at the
    third wake, 40 m of accumulated dh on the top nodes are added to both
    packages' states before the sync, so that sediment markers are made
    and surface markers relocated, eroded and replenished.  Markers, emw,
    edvacc_surf and dhacc equal bit for bit."""
    import jax.numpy as jnp

    cfg = flat_cfg(control={"surface_process_option": 1,
                            "surface_diffusivity": 1e-6},
                   markers={"markers_per_element": 4})
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    _assert_markers_equal(js.markers, ts.markers)
    top_e = np.asarray(js.ctx.surf.top_elems)
    top_n = np.asarray(js.ctx.surf.top_nodes)
    made = moved = 0
    for wake in range(3):
        js.run_steps(7, chunk=7)
        s = {f: np.asarray(getattr(js.state, f)) for f in FIELD_NAMES}
        s["edvacc_surf"] = s["edvacc_surf"].copy()
        s["edvacc_surf"][wake % 2::2] += s["volume"][top_e][wake % 2::2] / 3
        if wake == 2:
            s["dhacc"] = s["dhacc"].copy()
            s["dhacc"][top_n] += 40.0 * np.cos(
                3 * np.pi * s["coord"][top_n, 0] / 16e3)
        js.state = dataclasses.replace(js.state, **{
            k: jnp.asarray(s[k]) for k in ("edvacc_surf", "dhacc")})
        ts.state = state_from_numpy(s, dtype=torch.float64)
        before = dict(zip(ts.markers.live("id"), ts.markers.live("elem")))
        js.sync_surface_markers()
        ts.sync_surface_markers()
        _assert_markers_equal(js.markers, ts.markers)
        for f in ("emw", "edvacc_surf", "dhacc"):
            assert np.array_equal(np.asarray(getattr(js.state, f)),
                                  getattr(ts.state, f).numpy()), f
        made += int((ts.markers.live("genesis") == 2).sum())
        after = dict(zip(ts.markers.live("id"), ts.markers.live("elem")))
        moved += sum(after.get(i) != e for i, e in before.items())
    assert made > 0 and moved > 0
