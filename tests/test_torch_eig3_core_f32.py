"""The 3D rheology cores (elastic, maxwell, viscous, elasto-plastic with the
eigensolver) against the JAX package's, f32.

The body (check_* there) and helpers are in tests/test_torch_eig3.py. The suite
keeps at most 7 items in a file: pytest-xdist's file scheduler (--dist
loadfile) sends the files with the most items first, and the long golden file
(tests/test_golden_vs_reference.py, 7 items) must start early.
"""

import pytest

from test_torch_eig3 import check_core3_matches_jax


@pytest.mark.parametrize("dt", ["f32"])
@pytest.mark.parametrize("name", ["elastic3", "maxwell3", "viscous3",
                                  "elasto_plastic3"])
def test_core3_matches_jax(name, dt):
    check_core3_matches_jax(name, dt)
