"""The dispatch of the Delaunay and structured 2D configs against the JAX
package's, and the meshers that stay refused.

The helpers are in tests/test_torch_mesh2d.py, beside the rest of its tests.
The suite keeps at most 7 items in a file: pytest-xdist's file scheduler
(--dist loadfile) sends the files with the most items first, and the long
golden file (tests/test_golden_vs_reference.py, 7 items) must start early.
"""

import pytest

import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu_torch.mesh import generate as tgen
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
    cfg = flat_cfg(**over)
    with pytest.raises(NotImplementedError, match="meshing_option"):
        tgen.create_new_mesh(tdes.param_from_dict(cfg))
