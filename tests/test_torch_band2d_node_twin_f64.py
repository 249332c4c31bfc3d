"""The assembly kernel's per-node order (its PyTorch twin) against the plain
version and node_sum, f64.

The body (check_* there) and helpers are in tests/test_torch_band2d.py. The
suite keeps at most 7 items in a file: pytest-xdist's file scheduler (--dist
loadfile) sends the files with the most items first, and the long golden file
(tests/test_golden_vs_reference.py, 7 items) must start early.
"""

import pytest

from test_torch_band2d import (check_node_twin_equals_plain_and_node_sum, ROW_MESHES)


@pytest.mark.parametrize("kind", list(ROW_MESHES))
@pytest.mark.parametrize("dt", ["f64"])
def test_node_twin_equals_plain_and_node_sum(kind, dt):
    check_node_twin_equals_plain_and_node_sum(kind, dt)
