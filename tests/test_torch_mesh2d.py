"""The port's unstructured 2D host setup against the JAX package's, on the
Delaunay box of tests/test_flat.py:15-36: mesh, topology and surface
tables equal array for array, the initial State as tests/test_torch_init.py
holds it (host-built fields bitwise; fields computed on the device within
4 ulp of each field's max in f32, 1e-12 in f64), no structured grid
detected, and the same dispatch.
"""

import numpy as np
import pytest

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.mesh import generate as jgen
from dynearthsol_tpu.mesh import refine2d as jrefine
from dynearthsol_tpu_torch.mesh import generate as tgen
from dynearthsol_tpu_torch.mesh import refine2d as trefine
from dynearthsol_tpu_torch.state import FIELD_NAMES, state_to_numpy
from test_torch_init import COMPUTED
from torch_cases import flat_cfg, rel_err

CFGS = {"f64": flat_cfg(),
        "f32_weakzone": flat_cfg(dtype="float32",
                                 ic={"weakzone_option": 1}),
        "two_materials_500m": flat_cfg(
            mesh={"resolution": 500.0},
            mat={"rho0": [2800.0, 3300.0], "bulk_modulus": [50e9, 120e9],
                 "shear_modulus": [30e9, 70e9], "num_materials": 2},
            ic={"mattype_option": 0, "num_mattype_layers": 2,
                "layer_mattypes": [0, 1], "mattype_layer_depths": [0.5]})}


@pytest.fixture(scope="module", params=list(CFGS))
def sims(request):
    cfg = CFGS[request.param]
    return (cfg, jdes.Simulation(jdes.param_from_dict(cfg)),
            tdes.Simulation(tdes.param_from_dict(cfg), device="cpu"))


def test_mesh_and_topology_equal_jax(sims):
    _, js, ts = sims
    for f in ("coord", "connectivity"):
        a, b = getattr(js.mesh, f), getattr(ts.mesh, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("bcflag", "gather_idx", "gather_mask", "segment", "segflag"):
        np.testing.assert_array_equal(getattr(ts.topo, f),
                                      getattr(js.topo, f), err_msg=f)
    for i in range(len(js.topo.bfacets)):
        np.testing.assert_array_equal(ts.topo.bfacets[i], js.topo.bfacets[i])
        np.testing.assert_array_equal(ts.topo.bnodes[i], js.topo.bnodes[i])
    assert ts.ctx.sgrid is None and js.ctx.sgrid is None
    for f in ("top_nodes", "facet_nodes", "top_elems", "all_top_elems"):
        np.testing.assert_array_equal(getattr(ts.ctx.surf, f),
                                      np.asarray(getattr(js.ctx.surf, f)))
    np.testing.assert_array_equal(
        ts.ctx.surf.top_elem_mask, np.asarray(js.ctx.surf.top_elem_mask) > 0)
    assert (ts.ctx.sbc.n_grav, ts.ctx.sbc.n_neu) == \
        (js.ctx.sbc.n_grav, js.ctx.sbc.n_neu) == (0, 0)


def test_initial_state_matches_jax(sims):
    cfg, js, ts = sims
    out = state_to_numpy(ts.state)
    tol = 5e-7 if cfg["sim"]["float_dtype"] == "float32" else 1e-12
    for f in FIELD_NAMES:
        a = np.asarray(getattr(js.state, f))
        b = out[f]
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if f in COMPUTED:
            assert rel_err(a, b) <= tol, (f, rel_err(a, b))
        else:
            assert np.array_equal(a, b), f
    assert ts.compensation_pressure == js.compensation_pressure
    if ts.markers is not None:
        np.testing.assert_array_equal(ts.markers.elem,
                                      js.markers.live("elem"))
        np.testing.assert_array_equal(ts.markers.eta, js.markers.live("eta"))


def test_dispatch_matches_jax(sims):
    _, js, ts = sims
    js._chunk_fn(3)
    ts._chunk_fn(3)
    assert ts.step_path == js.step_path == "flat2d"
    bt = ts.ctx.band
    assert bt is not None and bt.conn_cm.dtype.is_floating_point is False
    assert (bt.nelem, bt.nnode, bt.npe) == (ts.topo.nelem, ts.topo.nnode, 3)
    # built once per Simulation
    ts._chunk_fn(2)
    assert ts.ctx.band is bt


@pytest.mark.parametrize("res", [1e3, 300.0])
def test_unstructured_box_and_renumbering_equal_jax(res):
    a = jgen.unstructured_box_2d(16e3, 8e3, res, min_angle=32.0)
    b = tgen.unstructured_box_2d(16e3, 8e3, res, min_angle=32.0)
    assert np.array_equal(a.coord, b.coord)
    assert np.array_equal(a.connectivity, b.connectivity)
    assert jrefine.tri_min_angle(b.coord, b.connectivity).min() >= 32.0
    ja = jgen.renumber_mesh(a.coord, a.connectivity)
    tb = tgen.renumber_mesh(b.coord, b.connectivity)
    assert np.array_equal(ja[0], tb[0]) and np.array_equal(ja[1], tb[1])
    assert (np.diff(tb[0][:, 0]) >= 0).all()


def test_refine_min_angle_equals_jax():
    """The Ruppert refinement on a coarse random point set that needs
    several rounds, boundary flags from the box."""
    from dynearthsol_tpu.constants import BOUNDX0, BOUNDX1, BOUNDZ0, BOUNDZ1
    rng = np.random.default_rng(7)
    lx, lz = 10.0, 5.0
    xs, zs = np.linspace(0, lx, 6), np.linspace(-lz, 0, 4)
    pts = [(x, z) for x in xs for z in (-lz, 0.0)] \
        + [(x, z) for z in zs[1:-1] for x in (0.0, lx)]
    coord = np.concatenate([np.asarray(pts),
                            rng.random((12, 2)) * [lx, lz] - [0, lz]])
    flag = np.zeros(len(coord), np.uint32)
    flag[coord[:, 0] == 0] |= BOUNDX0
    flag[coord[:, 0] == lx] |= BOUNDX1
    flag[coord[:, 1] == -lz] |= BOUNDZ0
    flag[coord[:, 1] == 0] |= BOUNDZ1
    surf = lambda x: np.zeros_like(np.asarray(x, dtype=float))
    bot = lambda x: np.full_like(np.asarray(x, dtype=float), -lz)
    jc, jf, _, jconv = jrefine.refine_min_angle(
        coord, flag, jrefine.box_inside_fn(lx, surf, bot), min_angle=30.0)
    tc, tf, tconv = trefine.refine_min_angle(
        coord, flag, trefine.box_inside_fn(lx, surf, bot), min_angle=30.0)
    assert len(tc) > len(coord)
    assert np.array_equal(jc, tc) and np.array_equal(jf, tf)
    assert jconv == tconv


@pytest.mark.parametrize("over", [
    {"sim": {"ndims": 3}, "mesh": {"ylength": 4e3}},
    {"mesh": {"meshing_option": 2}},
    {"mesh": {"meshing_elem_shape": 2}}],
    ids=["3d", "refined_zone", "equilateral"])
def test_other_meshers_stay_refused(over):
    cfg = flat_cfg(**over)
    with pytest.raises(NotImplementedError, match="meshing_option"):
        tgen.create_new_mesh(tdes.param_from_dict(cfg))
