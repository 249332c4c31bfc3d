"""The .poly and Exodus meshers (meshing_option 90/91/95) and the inclined
velocity BCs against the JAX package, on the CPU, from inputs written
here: a 2D Triangle .poly (two regions split by an internal segment, kept
or discarded, and a boundary segment marked BOUNDN0), a 3D TetGen .poly
(two regions split by an internal facet, the x walls inclined and flagged
BOUNDN0/BOUNDN1) and an Exodus file written with scipy.io.netcdf_file (a
sheared 5-tet box in two element blocks, its side sets flagged with the
boundary bits, the inclined x walls BOUNDN0/BOUNDN1).

The meshes, the regional attributes, the node flags and segment flags of
the topology, the markers' materials and the material weights equal the
JAX package's bit for bit.  Then 5 float64 steps with the inclined BCs
(types 1 and 11 on the Exodus mesh, 3 and 13 on the TetGen mesh) at
1e-10 of each field's max, as the flat cases, on the column step; the
fused steps' gates refuse a context with inclined BCs.
"""

import dataclasses

import numpy as np
import pytest

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu_torch.constants import BOUNDN0, BOUNDN1
from dynearthsol_tpu_torch.ops import fused2d, fused3d
from dynearthsol_tpu_torch.state import (FIELD_NAMES, state_from_numpy,
                                         state_to_numpy)
from torch_cases import (FLAT_FIELDS, exodus_cfg, make_sim3d_cfg,
                         make_sim_cfg, poly2d_cfg, poly3d_cfg, write_exodus,
                         write_poly2d, write_poly3d)

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshes")
    write_poly2d(d / "box.poly")
    write_poly3d(d / "block.poly")
    write_exodus(d / "block.exo")
    return d


def both_sims(cfg):
    return (jdes.Simulation(jdes.param_from_dict(cfg)),
            tdes.Simulation(tdes.param_from_dict(cfg), device="cpu"))


def assert_same_setup(js, ts):
    """Mesh, regional attributes, topology flags, markers and weights
    equal bit for bit."""
    for a, b in ((js.mesh.coord, ts.mesh.coord),
                 (js.mesh.connectivity, ts.mesh.connectivity),
                 (js.mesh.regattr, ts.mesh.regattr),
                 (js.topo.bcflag, ts.topo.bcflag),
                 (js.topo.segment, ts.topo.segment),
                 (js.topo.segflag, ts.topo.segflag)):
        assert np.array_equal(a, b)
    for i in range(len(js.topo.bfacets)):
        assert np.array_equal(js.topo.bfacets[i], ts.topo.bfacets[i])
    assert (js.markers is None) == (ts.markers is None)
    if js.markers is not None:
        assert np.array_equal(js.markers.live("mattype"),
                              ts.markers.live("mattype"))
        assert np.array_equal(js.markers.live("eta"),
                              ts.markers.live("eta"))
    assert np.array_equal(np.asarray(js.state.emw), ts.state.emw.numpy())


@pytest.mark.parametrize("keep", [False, True], ids=["discard", "keep"])
def test_poly2d_mesh_matches_jax(inputs, keep):
    js, ts = both_sims(poly2d_cfg(inputs / "box.poly", keep))
    assert_same_setup(js, ts)
    assert set(np.unique(ts.mesh.regattr)) == {0, 1}
    # the kept internal segment rides the mesh with flag 0
    assert (ts.mesh.segment is not None) == keep


def test_poly3d_mesh_matches_jax(inputs):
    js, ts = both_sims(poly3d_cfg(inputs / "block.poly"))
    assert_same_setup(js, ts)
    assert set(np.unique(ts.mesh.regattr)) == {0, 1}
    assert (ts.topo.bcflag & (BOUNDN0 | BOUNDN1)).any()


def test_exodus_mesh_matches_jax(inputs):
    js, ts = both_sims(exodus_cfg(inputs / "block.exo"))
    assert_same_setup(js, ts)
    assert set(np.unique(ts.mesh.regattr)) == {0, 1}


@pytest.mark.parametrize("mesh", ["exodus", "poly3d"])
def test_inclined_vbcs_match_jax(inputs, mesh):
    """Five steps with the inclined BCs on the column step (types 1 and
    11 on the Exodus mesh, 3 and 13 on the TetGen mesh)."""
    cfg = (exodus_cfg(inputs / "block.exo") if mesh == "exodus"
           else poly3d_cfg(inputs / "block.poly"))
    js, ts = both_sims(cfg)
    assert ts.ctx.vbc.incl is not None
    assert ts.ctx.vbc.incl.present[:2] == (True, True)
    s0 = state_from_numpy({f: np.asarray(getattr(js.state, f))
                           for f in FIELD_NAMES}, dtype=ts.dtype)
    # the initial vbcs (the finalize) already equal
    assert np.abs(np.asarray(js.state.vel) - s0.vel.numpy()).max() \
        <= 1e-10 * np.abs(np.asarray(js.state.vel)).max()
    ref = js.run_steps(5, chunk=5)
    out = state_to_numpy(ts._chunk_fn(5)(ts.ctx, s0))
    assert js.step_path == ts.step_path == "flat3d"
    for f in FLAT_FIELDS:
        r = np.asarray(getattr(ref, f), dtype=np.float64)
        err = np.abs(r - out[f]).max()
        assert err <= 1e-10 * np.abs(r).max() or err == 0.0, (f, err)


def test_fused_gates_refuse_inclined_vbcs(inputs):
    """A raster context that passes a fused gate fails it once its vbcs
    carry an inclined boundary (JAX pallas2d.py:191, pallas3d.py:326)."""
    incl = tdes.Simulation(tdes.param_from_dict(
        exodus_cfg(inputs / "block.exo")), device="cpu").ctx.vbc.incl
    for cfg, gate in ((make_sim_cfg(), fused2d.pallas_step_applicable),
                      (make_sim3d_cfg(), fused3d.pallas3d_step_applicable)):
        ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
        assert gate(ts.param, ts.ctx)
        ctx = dataclasses.replace(
            ts.ctx, vbc=dataclasses.replace(ts.ctx.vbc, incl=incl))
        assert not gate(ts.param, ctx)
