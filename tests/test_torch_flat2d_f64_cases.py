"""The column step's features against the JAX flat2d in float64: the first four
cases of test_torch_flat2d_features.CASES.

The body (check_* there) and helpers are in
tests/test_torch_flat2d_features.py. The suite keeps at most 7 items in a file:
pytest-xdist's file scheduler (--dist loadfile) sends the files with the most
items first, and the long golden file (tests/test_golden_vs_reference.py, 7
items) must start early.
"""

import pytest

from test_torch_flat2d_features import CASES, check_f64_matches_jax


@pytest.mark.parametrize("case", list(CASES)[:4])
def test_f64_matches_jax(case):
    check_f64_matches_jax(case)
