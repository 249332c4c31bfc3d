"""The 2D rheology cores against the JAX package's, f32.

The body (check_* there) and helpers are in tests/test_torch_rheology.py. The
suite keeps at most 7 items in a file: pytest-xdist's file scheduler (--dist
loadfile) sends the files with the most items first, and the long golden file
(tests/test_golden_vs_reference.py, 7 items) must start early.
"""

import pytest

from test_torch_rheology import check_core_matches_jax


@pytest.mark.parametrize("dt", ["f32"])
@pytest.mark.parametrize("name", ["elastic2", "maxwell2", "viscous2",
                                  "elasto_plastic2d"])
def test_core_matches_jax(name, dt):
    check_core_matches_jax(name, dt)
