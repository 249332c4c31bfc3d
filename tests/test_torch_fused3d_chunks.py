"""The fused 3D step's chunk form against complete steps, every plane bit for
bit, on the CPU (the plain versions).

The helpers are in tests/test_torch_fused3d.py, beside the rest of its
tests. The suite keeps at most 7 items in a file: pytest-xdist's file
scheduler (--dist loadfile) sends the files with the most items first, and
the long golden file (tests/test_golden_vs_reference.py, 7 items) must start
early.
"""

import pytest
import torch

from dynearthsol_tpu_torch.ops import fused3d
# maxwell and evp are the fixtures that CHUNK_CASES names
from test_torch_fused3d import (CHUNK_CASES, chunk_setup, complete_steps, evp,
                                maxwell, torch_threads)


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_chunk_equals_complete_steps(case, request):
    cfg, n, dtype, off = CHUNK_CASES[case]
    ts, s0 = request.getfixturevalue(cfg)[1:3]
    P, s = chunk_setup(ts, s0, dtype, off)
    assert P.sw["nmd"] == int(case != "evp_3_no_nmd")
    with torch_threads(1):
        out = fused3d.run_chunk(P, ts.ctx, s, n)
        ein, nin, scal = complete_steps(P, ts.ctx, s, n)
    e, nd = fused3d.state_to_planes(out, P.nx, P.ny, P.nz)
    names = [f"e.{f}" for f in fused3d.E_SLOTS] \
        + [f"e.{t}[{i}]" for t in fused3d.T_SLOTS for i in range(6)]
    for i, nm in enumerate(names):
        assert torch.equal(e[i], ein[i]), nm
    for i, nm in enumerate(fused3d.N_SLOTS):
        assert torch.equal(nd[i], nin[i]), nm
    for i, f in enumerate(("dt", "max_global_vel_mag", "global_dt_min",
                           "time")):
        assert torch.equal(getattr(out, f), scal[i]), f
