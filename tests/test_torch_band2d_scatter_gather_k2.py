"""The assembly with its re-gather (asm_gather's plain version) against
node_sum and indexing at k = 2, kg = 1.

The body (check_* there) and helpers are in tests/test_torch_band2d.py. The
suite keeps at most 7 items in a file: pytest-xdist's file scheduler (--dist
loadfile) sends the files with the most items first, and the long golden file
(tests/test_golden_vs_reference.py, 7 items) must start early.
"""

import pytest

from test_torch_band2d import (check_scatter_gather_equals_node_sum_then_indexing, DTYPES, mesh)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("k,kg", [(2, 1)])
def test_scatter_gather_equals_node_sum_then_indexing(mesh, dt, k, kg):
    check_scatter_gather_equals_node_sum_then_indexing(mesh, dt, k, kg)
