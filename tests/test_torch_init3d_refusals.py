"""The fused 3D step refuses nothing that passes its gate: configs that
once raised, naming what the step lacked, now run on pallas3d.

The helpers are in tests/test_torch_init3d.py, beside the rest of its tests.
The suite keeps at most 7 items in a file: pytest-xdist's file scheduler
(--dist loadfile) sends the files with the most items first, and the long
golden file (tests/test_golden_vs_reference.py, 7 items) must start early.
"""

import pytest

from dynearthsol_tpu_torch.ops import fused3d
from test_torch_init3d import _port
from torch_cases import make_sim3d_cfg


@pytest.mark.parametrize("over", [
    # two materials run (tests/test_torch_multimat3d.py), and so do more
    # than the kernel's MAXMAT (8), on its many-material instances
    # (tests/test_torch_manymat.py).  The Winkler tractions and surface
    # process 1 run too (tests/test_torch_production3d.py)
    {"mat": {"nmat": 9, "rho0": [2800.0 + 50 * m for m in range(9)],
             "bulk_modulus": [50e9] * 9, "shear_modulus": [30e9] * 9},
     "ic": {"num_mattype_layers": 9,
            "mattype_layer_depths": [0.1 * m for m in range(1, 9)],
            "layer_mattypes": list(range(9))}},
    {"bc": {"has_winkler_foundation": True, "winkler_delta_rho": 100.0}},
    {"control": {"surface_process_option": 1, "surface_diffusivity": 1e-6}},
], ids=["multimat", "winkler", "surface1"])
def test_unported_features_raise(over):
    """On the fused 3D gate nothing is unported: each config runs on
    pallas3d."""
    ts = _port(make_sim3d_cfg(**over))
    assert fused3d.pallas3d_step_applicable(ts.param, ts.ctx)
    assert fused3d.unported_features(ts.param, ts.ctx) == []
    ts.run_steps(1)
    assert ts.step_path == "pallas3d"
