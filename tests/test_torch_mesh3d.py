"""The port's unstructured 3D host setup against the JAX package's: the
Delaunay box mesher (mesh/refine3d.py, generate.unstructured_box_3d) on
the box of tests/test_flat.py:97-118 (8 km x 4 km x 4 km at 1 km), point
for point; and, on a config with every 3D feature that host setup serves
off the fused path (hydraulic diffusion with an excess pore pressure,
rate-and-state friction, the three facet kinds of traction, a Neumann
traction, the elastic foundation, surface process 1), the topology, the
surface and stress-BC tables and the initial State as
tests/test_torch_mesh2d.py holds them (host-built fields bitwise; fields
computed on the device within 1e-12 of each field's max in f64), and the
dispatch to flat3d with its gather tables at npe = 4.
"""

import numpy as np
import pytest

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.mesh import generate as jgen
from dynearthsol_tpu.mesh import refine3d as jrefine3d
from dynearthsol_tpu_torch.mesh import generate as tgen
from dynearthsol_tpu_torch.mesh import refine3d as trefine3d
from dynearthsol_tpu_torch.state import FIELD_NAMES, state_to_numpy
from test_torch_init import COMPUTED
from torch_cases import flat3d_cfg, rel_err

CFG = flat3d_cfg(
    "elasto-visco-plastic-rate-state-friction",
    control={"has_hydraulic_diffusion": True, "surface_process_option": 1,
             "surface_diffusivity": 1e-6, "surf_base_level": 10.0},
    bc={"has_winkler_foundation": True, "has_water_loading": True,
        "vbc_y1": 0, "has_elastic_foundation": True, "stress_bc_z1": 3,
        "stress_val_z1": -1e5},
    ic={"excess_pore_pressure": 1e6},
    mat={"porosity": [0.1], "hydraulic_perm": [1e-15],
         "fluid_bulk_modulus": [2.2e9], "biot_coeff": [0.8],
         "direct_a": [0.2], "evolution_b": [0.1],
         "characteristic_distance": [1e-3],
         "characteristic_velocity": [1e-6]})


@pytest.fixture(scope="module")
def sims():
    return (jdes.Simulation(jdes.param_from_dict(CFG)),
            tdes.Simulation(tdes.param_from_dict(CFG), device="cpu"))


def test_unstructured_box_3d_equals_jax():
    a = jgen.unstructured_box_3d(8e3, 4e3, 4e3, 1e3)
    b = tgen.unstructured_box_3d(8e3, 4e3, 4e3, 1e3)
    assert np.array_equal(a.coord, b.coord)
    assert a.connectivity.dtype == b.connectivity.dtype
    assert np.array_equal(a.connectivity, b.connectivity)
    ratio, _, _ = trefine3d.tet_quality_stats(b.coord, b.connectivity)
    jratio, _, _ = jrefine3d.tet_quality_stats(b.coord, b.connectivity)
    assert np.array_equal(ratio, jratio) and ratio.max() <= 2.0
    ja = jgen.renumber_mesh(a.coord, a.connectivity)
    tb = tgen.renumber_mesh(b.coord, b.connectivity)
    assert np.array_equal(ja[0], tb[0]) and np.array_equal(ja[1], tb[1])


def test_refine_radius_edge_equals_jax():
    """The radius-edge refinement on a coarse random point set of a box
    that needs several rounds, with the box's inside and projection
    functions: the same points, in the same order."""
    rng = np.random.default_rng(3)
    lx, ly, lz = 4.0, 2.0, 2.0
    g = np.stack(np.meshgrid([0.0, lx], [0.0, ly], [-lz, 0.0],
                             indexing="ij"), axis=-1).reshape(-1, 3)
    coord = np.concatenate([g, rng.random((20, 3)) * [lx, ly, lz]
                            - [0, 0, lz]])
    surf = lambda x, y: np.zeros_like(np.asarray(x, dtype=float))
    bot = lambda x, y: np.full_like(np.asarray(x, dtype=float), -lz)
    out = []
    for mod in (jrefine3d, trefine3d):
        out.append(mod.refine_radius_edge(
            coord, mod.box_inside_fn_3d(lx, ly, surf, bot), max_ratio=2.0,
            project_fn=mod.box_project_fn_3d(lx, ly, surf, bot)))
    (jc, jconv), (tc, tconv) = out
    assert len(tc) > len(coord)
    assert np.array_equal(jc, tc) and jconv == tconv


def test_mesh_topology_and_tables_equal_jax(sims):
    js, ts = sims
    for f in ("coord", "connectivity"):
        a, b = getattr(js.mesh, f), getattr(ts.mesh, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("bcflag", "gather_idx", "gather_mask"):
        np.testing.assert_array_equal(getattr(ts.topo, f),
                                      getattr(js.topo, f), err_msg=f)
    for i in range(len(js.topo.bfacets)):
        np.testing.assert_array_equal(ts.topo.bfacets[i], js.topo.bfacets[i])
    assert ts.ctx.sgrid is None and js.ctx.sgrid is None
    for f in ("top_nodes", "facet_nodes", "top_elems", "all_top_elems"):
        np.testing.assert_array_equal(getattr(ts.ctx.surf, f),
                                      np.asarray(getattr(js.ctx.surf, f)))
    np.testing.assert_array_equal(
        ts.ctx.surf.top_elem_mask, np.asarray(js.ctx.surf.top_elem_mask) > 0)
    jb, tb = js.ctx.sbc, ts.ctx.sbc
    assert (tb.n_grav, tb.n_neu) == (jb.n_grav, jb.n_neu)
    assert set(tb.kind.tolist()) == {0, 1, 2} and tb.n_neu > 0
    for f in ("facet_nodes", "facet_elem", "kind", "neu_facet_nodes",
              "neu_dir", "neu_val", "z0_mask"):
        np.testing.assert_array_equal(getattr(tb, f),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    np.testing.assert_array_equal(ts.ctx.pp_bc_mask.numpy(),
                                  np.asarray(js.ctx.pp_bc_mask))


def test_initial_state_matches_jax(sims):
    js, ts = sims
    out = state_to_numpy(ts.state)
    for f in FIELD_NAMES:
        a = np.asarray(getattr(js.state, f))
        b = out[f]
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if f in COMPUTED + ("hydro_diff_max",):
            assert rel_err(a, b) <= 1e-12, (f, rel_err(a, b))
        else:
            assert np.array_equal(a, b), f
    # the hydraulic, RSF and Winkler initial fields are really set
    assert np.abs(out["ppressure"]).max() > 1e6
    assert (out["state_variable"] > 0).all()
    assert ts.compensation_pressure == js.compensation_pressure != 0


def test_dispatch_matches_jax(sims):
    js, ts = sims
    js._chunk_fn(2)
    ts._chunk_fn(2)
    assert ts.step_path == js.step_path == "flat3d"
    bt = ts.ctx.band
    assert (bt.nelem, bt.nnode, bt.npe) == (ts.topo.nelem, ts.topo.nnode, 4)
