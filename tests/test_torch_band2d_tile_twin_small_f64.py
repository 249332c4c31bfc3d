"""The gather kernel's tile loop (its PyTorch twin) against the plain version,
the small tiling, f64.

The body (check_* there) and helpers are in tests/test_torch_band2d.py. The
suite keeps at most 7 items in a file: pytest-xdist's file scheduler (--dist
loadfile) sends the files with the most items first, and the long golden file
(tests/test_golden_vs_reference.py, 7 items) must start early.
"""

import pytest

from test_torch_band2d import (check_tile_twin_equals_plain, TILE_MESHES, TILINGS)


@pytest.mark.parametrize("tiling", TILINGS[1:], ids=["small"])
@pytest.mark.parametrize("dt", ["f64"])
@pytest.mark.parametrize("kind", list(TILE_MESHES))
def test_tile_twin_equals_plain(kind, dt, tiling):
    check_tile_twin_equals_plain(kind, dt, tiling)
