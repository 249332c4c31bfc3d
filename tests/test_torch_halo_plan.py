"""The port's bookkeeping of the node-sharded halo step
(dynearthsol_tpu_torch/parallel/halo_step.py: build_plan, build_halo_ctx,
build_halo_state, unpack_state) against the JAX package's
(dynearthsol_tpu/parallel/halo_step.py), array for array, on the CPU,
for 4 shards: on tests/test_halo.py's raster (64 x 8 cells, f64), on its
option-1 post-remesh Delaunay mesh, and on a 32 km x 4 km x 4 km
tetrahedral box, each with the facet tractions and surface process 1 so
that every facet table is partitioned.  The JAX package's refusal of a
block narrower than 2h is the port's, word for word.

The suite keeps at most 7 items in a file (tests/test_torch_io_refusals.py
says why).
"""

import numpy as np
import pytest

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.parallel import halo_step as JH
from dynearthsol_tpu_torch.parallel import halo_step as TH
from dynearthsol_tpu_torch.state import FIELD_NAMES, state_from_numpy
from torch_cases import HALO_FACETS, _merge, flat3d_cfg, halo_cfg

NDEV = 4
MESHES = ("raster", "delaunay", "box3d")


def _cfg(name):
    if name == "raster":
        return halo_cfg(**HALO_FACETS)
    if name == "delaunay":
        return halo_cfg(mesh={"meshing_elem_shape": 0,
                              "remeshing_option": 1},
                        **HALO_FACETS)
    return _merge(flat3d_cfg(mesh={"xlength": 32e3}), HALO_FACETS)


@pytest.fixture(scope="module")
def pair():
    """(JAX Simulation, port Simulation) of a mesh, made once: the same
    mesh (the delaunay one after 10 steps and a remesh in each package),
    the port's state the JAX one's."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg = _cfg(name)
            js = jdes.Simulation(jdes.param_from_dict(cfg))
            ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
            if name == "delaunay":
                from dynearthsol_tpu.remesh_impl import \
                    remesh_simulation as jremesh
                from dynearthsol_tpu_torch.remesh_impl import \
                    remesh_simulation as tremesh
                js.run_steps(10, chunk=10)
                ts.run_steps(10, chunk=10)
                jremesh(js, 1)
                tremesh(ts, 1)
            assert np.array_equal(np.asarray(js.ctx.conn),
                                  ts.ctx.conn.numpy())
            ts.state = state_from_numpy(
                {f: np.asarray(getattr(js.state, f)) for f in FIELD_NAMES},
                dtype=ts.dtype)
            cache[name] = (js, ts)
        return cache[name]

    return get


def _eq(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if hasattr(b, "numpy") else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a.astype(np.float64), b.astype(np.float64)), what


@pytest.mark.parametrize("mesh", MESHES)
def test_plan_matches_jax(pair, mesh):
    js, ts = pair(mesh)
    jp = JH.build_plan(js.ctx, NDEV)
    tp = TH.build_plan(ts.ctx, NDEV)
    assert tp.width == tp.block + 2 * tp.h and tp.width < tp.nnode / 2
    for f in ("ndev", "nnode", "nelem", "h", "block", "width"):
        assert getattr(jp, f) == getattr(tp, f), f
    for f in ("eperm", "win_idx", "own_mask", "valid", "shard_of_elem",
              "eslot", "sperm"):
        _eq(getattr(jp, f), getattr(tp, f), f)
    # too many shards for the halo: the same refusal
    with pytest.raises(NotImplementedError) as ej:
        JH.build_plan(js.ctx, 64)
    with pytest.raises(NotImplementedError) as et:
        TH.build_plan(ts.ctx, 64)
    assert str(ej.value) == str(et.value)


@pytest.mark.parametrize("mesh", MESHES)
def test_ctx_matches_jax(pair, mesh):
    js, ts = pair(mesh)
    plan = TH.build_plan(ts.ctx, NDEV)
    jc, _ = JH.build_halo_ctx(js, JH.build_plan(js.ctx, NDEV))
    tc = TH.build_halo_ctx(ts, plan)
    assert (jc.nnode, jc.nelem) == (tc.nnode, tc.nelem)
    for f in ("conn", "elem_mask", "top_mask", "pp_bc_mask"):
        _eq(getattr(jc, f), getattr(tc, f), f)
    for f in ("x0", "x1", "y0", "y1", "z0", "z1"):
        _eq(getattr(jc.vbc, f), getattr(tc.vbc, f), "vbc." + f)
    assert tc.sbc.n_grav > 0 and tc.sbc.n_neu > 0 and tc.surf.etop > 0
    for f in ("n_grav", "n_neu"):
        assert getattr(jc.sbc, f) == getattr(tc.sbc, f), f
    for f in ("z0_mask", "facet_nodes", "facet_elem", "kind", "grav_mask",
              "neu_facet_nodes", "neu_dir", "neu_val", "neu_mask"):
        _eq(getattr(jc.sbc, f), getattr(tc.sbc, f), "sbc." + f)
    assert jc.surf.etop == tc.surf.etop
    for f in ("top_mask_f", "top_elem_mask", "facet_nodes", "top_elems",
              "facet_mask"):
        _eq(getattr(jc.surf, f), getattr(tc.surf, f), "surf." + f)
    _eq(jc.halo.own_mask, tc.halo.own_mask, "own_mask")
    assert (jc.halo.h, jc.halo.ndev) == (tc.halo.h, tc.halo.ndev)


def test_state_matches_jax_and_round_trips(pair):
    """The stacked state equals the JAX package's; unpack_state gives the
    flat state back bit for bit, from the stacked state and from the
    per-shard states a run holds (real elements only)."""
    js, ts = pair("raster")
    plan = TH.build_plan(ts.ctx, NDEV)
    assert plan.sperm is not None
    js_st, _ = JH.build_halo_state(js, JH.build_plan(js.ctx, NDEV))
    st = TH.build_halo_state(ts, plan)
    for f in FIELD_NAMES:
        _eq(getattr(js_st, f), getattr(st, f), f)
    shards = [TH.shard_state(st, plan, d, "cpu", ts.state)
              for d in range(NDEV)]
    assert sum(s.volume.shape[0] for s in shards) == plan.nelem
    for back in (TH.unpack_state(st, plan, ts.state),
                 TH.unpack_state(shards, plan, ts.state)):
        for f in FIELD_NAMES:
            a, b = getattr(ts.state, f), getattr(back, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert np.array_equal(a.numpy(), b.numpy()), f
