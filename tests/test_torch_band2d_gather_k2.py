"""The gather (cgather's plain version) against indexing and the JAX band
engine at k = 2.

The body (check_* there) and helpers are in tests/test_torch_band2d.py. The
suite keeps at most 7 items in a file: pytest-xdist's file scheduler (--dist
loadfile) sends the files with the most items first, and the long golden file
(tests/test_golden_vs_reference.py, 7 items) must start early.
"""

import pytest

from test_torch_band2d import (check_gather_matches_indexing_and_band_engine, DTYPES, mesh)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("k", [2])
def test_gather_matches_indexing_and_band_engine(mesh, dt, k):
    check_gather_matches_indexing_and_band_engine(mesh, dt, k)
