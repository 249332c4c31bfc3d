"""One step of the fused 3D step against the JAX grid3d for the last four cases
of torch_cases.STEP3_CASES (the first five are in
tests/test_torch_fused3d_cases.py).

The body (check_* there) and helpers are in tests/test_torch_fused3d_cases.py.
The suite keeps at most 7 items in a file: pytest-xdist's file scheduler
(--dist loadfile) sends the files with the most items first, and the long
golden file (tests/test_golden_vs_reference.py, 7 items) must start early.
"""

import pytest

from test_torch_fused3d_cases import check_one_step_vs_grid3d, sims
from torch_cases import STEP3_CASES


@pytest.mark.parametrize("case", list(STEP3_CASES)[5:])
def test_one_step_vs_grid3d(case, sims):
    check_one_step_vs_grid3d(case, sims)
