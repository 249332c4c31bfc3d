"""The fused 3D step's dt refresh modes and its chunk form's last-only planes,
on the CPU (the plain versions).

The helpers are in tests/test_torch_fused3d.py, beside the rest of its
tests. The suite keeps at most 7 items in a file: pytest-xdist's file
scheduler (--dist loadfile) sends the files with the most items first, and
the long golden file (tests/test_golden_vs_reference.py, 7 items) must start
early.
"""

import pytest
import torch

from dynearthsol_tpu_torch.ops import fused2d, fused3d
from test_torch_fused3d import chunk_setup, evp, maxwell


@pytest.mark.parametrize("every", [False, True], ids=["2d", "3d"])
@pytest.mark.parametrize("refresh", [False, True],
                         ids=["off_cadence", "refresh"])
def test_dt_refresh_modes(maxwell, every, refresh):
    """dt_refresh_plain on given partials: vmax and gdtmin follow them on
    every step in the 3D mode and on refresh steps only in the 2D mode; dt
    changes on refresh steps only; time advances by the old dt."""
    _, ts, s0 = maxwell
    P = fused3d.make_plan(ts.param, ts.ctx, "cpu")
    b = fused3d.make_buffers(P, ts.ctx, s0, 1)
    b.flags[0, 0] = float(refresh)
    b.part[0, :2] = torch.tensor([400.0, 300.0])
    b.part[1, :2] = torch.tensor([0.2, 0.1])
    b.part[2, :2] = torch.tensor([1e-9, 3e-9])
    b.part[3, :2] = torch.tensor([2.0, 5.0])
    before = b.scal.clone()
    fused2d.dt_refresh_plain(P, b.part, b.scal, b.dthist, b.flags, 0,
                             tiled=True, every=every)
    assert float(b.dthist[0]) == float(before[0])
    assert float(b.scal[3]) == float(before[3] + before[0])
    assert float(b.scal[4]) == 7.0
    moved = every or refresh
    vmax = max(3e-9, P.k["max_vbc"])
    assert float(b.scal[1]) == (pytest.approx(vmax, rel=1e-6) if moved
                                else float(before[1]))
    assert float(b.scal[2]) == (pytest.approx(0.1 / 5, rel=1e-6) if moved
                                else float(before[2]))
    assert (float(b.scal[0]) != float(before[0])) == refresh


def test_chunk_stores_last_only_planes_once(evp):
    """Within a chunk the step leaves the planes of last_only_slots
    unwritten: on poisoned output buffers, the first of two steps keeps
    the poison there and nowhere else."""
    _, ts, s0, _ = evp
    P, s = chunk_setup(ts, s0, torch.float32)
    b = fused3d.make_buffers(P, ts.ctx, s, 2)
    b.eout.fill_(float("nan"))
    b.nout.fill_(float("nan"))
    b.tgt = fused3d.vbc_targets(ts.ctx, b.nin, b.scal[3] + b.scal[0])
    fused3d.fused3d_chunk_step(P, b, 0, 2)
    skip_e, skip_n = fused3d.last_only_slots(P)
    for i in range(fused3d.NE):
        assert bool(b.eout[i].isnan().all()) == (i in skip_e), i
    for i in range(fused3d.NN):
        assert bool(b.nout[i].isnan().all()) == (i in skip_n), i
