"""The column step's gate against the JAX package's on the configs of
GATE_CASES.

The helpers are in tests/test_torch_flat2d.py, beside the rest of its tests.
The suite keeps at most 7 items in a file: pytest-xdist's file scheduler
(--dist loadfile) sends the files with the most items first, and the long
golden file (tests/test_golden_vs_reference.py, 7 items) must start early.
"""

import pytest

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.ops import flat2d as jflat
from dynearthsol_tpu_torch.ops import flat2d as tflat
from test_torch_flat2d import GATE_CASES


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gate_matches_jax(case):
    """flat_step_applicable over the configs of tests/test_flat.py:324-345
    and the edges of its rheology clause."""
    cfg = GATE_CASES[case]
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    want = jflat.flat_step_applicable(js.param, js.ctx)
    assert tflat.flat_step_applicable(ts.param, ts.ctx) == want
    assert want == (case != "ep_not_plane_strain")
