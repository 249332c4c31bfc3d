"""The column step's switches (damping options, NMD, the surface correction,
global velocity scaling, the rheologies) against the JAX flat2d in float64.

The helpers are in tests/test_torch_flat2d.py, beside the rest of its tests.
The suite keeps at most 7 items in a file: pytest-xdist's file scheduler
(--dist loadfile) sends the files with the most items first, and the long
golden file (tests/test_golden_vs_reference.py, 7 items) must start early.
"""

import numpy as np
import pytest

from test_torch_flat2d import assert_fields_close, SWITCH_CASES
from torch_cases import flat_cfg, FLAT_FIELDS, run_both


@pytest.mark.parametrize("case", list(SWITCH_CASES))
def test_f64_switches(case):
    over, n = SWITCH_CASES[case]
    ref, out = run_both(flat_cfg(**over), n)
    fields = FLAT_FIELDS
    if "averaged" in case:
        fields += ("stress_avg", "delta_plstrain_avg", "coord_avg0",
                   "strain_avg0", "time_avg0")
        assert np.abs(out["stress_avg"]).max() > 0
    if "two_materials" in case:
        assert out["emw"].shape[1] == 2 and (out["emw"][:, 1] > 0).any()
    assert_fields_close(ref, out, 1e-10, fields)
