"""The unstructured box mesher with its renumbering, and the Ruppert
refinement's minimum angle, against the JAX package's.

The helpers are in tests/test_torch_mesh2d.py, beside the rest of its tests.
The suite keeps at most 7 items in a file: pytest-xdist's file scheduler
(--dist loadfile) sends the files with the most items first, and the long
golden file (tests/test_golden_vs_reference.py, 7 items) must start early.
"""

import numpy as np
import pytest

from dynearthsol_tpu.mesh import generate as jgen, refine2d as jrefine
from dynearthsol_tpu_torch.mesh import generate as tgen, refine2d as trefine


@pytest.mark.parametrize("res", [1e3, 300.0])
def test_unstructured_box_and_renumbering_equal_jax(res):
    a = jgen.unstructured_box_2d(16e3, 8e3, res, min_angle=32.0)
    b = tgen.unstructured_box_2d(16e3, 8e3, res, min_angle=32.0)
    assert np.array_equal(a.coord, b.coord)
    assert np.array_equal(a.connectivity, b.connectivity)
    assert jrefine.tri_min_angle(b.coord, b.connectivity).min() >= 32.0
    ja = jgen.renumber_mesh(a.coord, a.connectivity)
    tb = tgen.renumber_mesh(b.coord, b.connectivity)
    assert np.array_equal(ja[0], tb[0]) and np.array_equal(ja[1], tb[1])
    assert (np.diff(tb[0][:, 0]) >= 0).all()


def test_refine_min_angle_equals_jax():
    """The Ruppert refinement on a coarse random point set that needs
    several rounds, boundary flags from the box."""
    from dynearthsol_tpu.constants import BOUNDX0, BOUNDX1, BOUNDZ0, BOUNDZ1
    rng = np.random.default_rng(7)
    lx, lz = 10.0, 5.0
    xs, zs = np.linspace(0, lx, 6), np.linspace(-lz, 0, 4)
    pts = [(x, z) for x in xs for z in (-lz, 0.0)] \
        + [(x, z) for z in zs[1:-1] for x in (0.0, lx)]
    coord = np.concatenate([np.asarray(pts),
                            rng.random((12, 2)) * [lx, lz] - [0, lz]])
    flag = np.zeros(len(coord), np.uint32)
    flag[coord[:, 0] == 0] |= BOUNDX0
    flag[coord[:, 0] == lx] |= BOUNDX1
    flag[coord[:, 1] == -lz] |= BOUNDZ0
    flag[coord[:, 1] == 0] |= BOUNDZ1
    surf = lambda x: np.zeros_like(np.asarray(x, dtype=float))
    bot = lambda x: np.full_like(np.asarray(x, dtype=float), -lz)
    jc, jf, _, jconv = jrefine.refine_min_angle(
        coord, flag, jrefine.box_inside_fn(lx, surf, bot), min_angle=30.0)
    tc, tf, tseg, tconv = trefine.refine_min_angle(
        coord, flag, trefine.box_inside_fn(lx, surf, bot), min_angle=30.0)
    assert tseg is None           # box mode: no explicit segments
    assert len(tc) > len(coord)
    assert np.array_equal(jc, tc) and np.array_equal(jf, tf)
    assert jconv == tconv
