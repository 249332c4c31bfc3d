"""The dispatch of the Delaunay and structured 2D configs against the JAX
package's, and the box meshers of meshing_option 2 and
meshing_elem_shape 2 point for point against the JAX package's.

The helpers are in tests/test_torch_mesh2d.py, beside the rest of its tests.
The suite keeps at most 7 items in a file: pytest-xdist's file scheduler
(--dist loadfile) sends the files with the most items first, and the long
golden file (tests/test_golden_vs_reference.py, 7 items) must start early.
"""

import numpy as np
import pytest

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.mesh import generate as jgen
from dynearthsol_tpu.simulation import _detect_sgrid as jdetect
from dynearthsol_tpu_torch.mesh import generate as tgen
from dynearthsol_tpu_torch.ops import fused2d, grid2d
from test_torch_mesh2d import sims
from torch_cases import flat_cfg


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


@pytest.mark.parametrize("over", [
    {"sim": {"ndims": 3}, "mesh": {"ylength": 4e3, "meshing_option": 2}},
    {"mesh": {"meshing_option": 2}},
    {"mesh": {"meshing_elem_shape": 2}}],
    ids=["3d", "refined_zone", "equilateral"])
def test_other_meshers_stay_refused(over):
    """Once refused by the port, these meshers now place the JAX
    package's points and elements bit for bit: the refined-zone box in
    2D and 3D (option 2 on the Delaunay path) and the equilateral 2D grid
    (shape 2).  The equilateral grid keeps the raster's connectivity with
    its rows shifted, and the JAX package's structure detection reads the
    connectivity alone: both packages take it as a raster, onto the same
    plane step (whose arithmetic reads every node's coordinates)."""
    cfg = flat_cfg(**over)
    want = jgen.create_new_mesh(jdes.param_from_dict(cfg))
    got = tgen.create_new_mesh(tdes.param_from_dict(cfg))
    assert np.array_equal(want.coord, got.coord)
    assert np.array_equal(want.connectivity, got.connectivity)
    assert want.connectivity.dtype == got.connectivity.dtype
    if cfg["mesh"].get("meshing_elem_shape") == 2:
        js = jdes.Simulation(jdes.param_from_dict(cfg))
        ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
        assert ts.ctx.sgrid == jdetect(js.topo) == (17, 9)
        assert not fused2d.pallas_step_applicable(ts.param, ts.ctx)
        assert grid2d.grid_step_applicable(ts.param, ts.ctx)
        js._chunk_fn(1)
        ts._chunk_fn(1)
        assert ts.step_path == js.step_path == "grid2d"
