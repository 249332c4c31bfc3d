"""One step of the port's fused 3D step (plain version on the CPU) against
the JAX package's grid3d step, for each rheology, damping option and
switch that the EVP and maxwell gates of tests/test_torch_fused3d.py do not
take (tests/torch_cases.STEP3_CASES), at the one-step EVP tolerance of
test_pallas3d.py (1e-4 of each field's max, force 1e-3; scalars 1e-3)."""

import pytest

from dynearthsol_tpu_torch.ops import fused3d
from test_torch_fused3d import SCALARS, _grid_run, _sims, get
from torch_cases import (STEP3_CASES, assert_evp3_one_step_close,
                         make_sim3d_cfg)


@pytest.mark.parametrize("case", list(STEP3_CASES))
def test_one_step_vs_grid3d(case):
    js, ts, s0 = _sims(make_sim3d_cfg(ic={"weakzone_option": 1},
                                      **STEP3_CASES[case]))
    out = fused3d.make_chunk_runner(ts.param, ts.ctx, 1)(ts.ctx, s0)
    ref = _grid_run(js, 1)
    assert_evp3_one_step_close(ref, out, get)
    for f in SCALARS:
        a, b = float(get(ref, f)), float(get(out, f))
        assert abs(a - b) <= 1e-3 * max(abs(a), 1e-300), f
