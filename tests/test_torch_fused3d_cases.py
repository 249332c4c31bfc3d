"""One step of the port's fused 3D step (plain version on the CPU) against
the JAX package's grid3d step, for each rheology, damping option and
switch that the EVP and maxwell gates of tests/test_torch_fused3d.py do not
take (tests/torch_cases.STEP3_CASES), at the one-step EVP tolerance of
test_pallas3d.py (1e-4 of each field's max, force 1e-3; scalars 1e-3).
The cases differ only in the step: one pair of Simulations (the EVP
config with a weak zone) serves them all, each case's param on the shared
mesh and state."""

import pytest

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu_torch.ops import fused3d
from test_torch_fused3d import SCALARS, _grid_run, _sims, get
from torch_cases import (STEP3_CASES, assert_evp3_one_step_close,
                         make_sim3d_cfg, with_param)


@pytest.fixture(scope="module")
def sims():
    return _sims(make_sim3d_cfg(ic={"weakzone_option": 1}))


def check_one_step_vs_grid3d(case, sims):
    js, ts, s0 = sims
    cfg = make_sim3d_cfg(ic={"weakzone_option": 1}, **STEP3_CASES[case])
    param = tdes.param_from_dict(cfg)
    out = fused3d.make_chunk_runner(param, ts.ctx, 0.0, 1)(ts.ctx, s0)
    ref = _grid_run(with_param(js, jdes.param_from_dict(cfg)), 1)
    assert_evp3_one_step_close(ref, out, get)
    for f in SCALARS:
        a, b = float(get(ref, f)), float(get(out, f))
        assert abs(a - b) <= 1e-3 * max(abs(a), 1e-300), f


@pytest.mark.parametrize("case", list(STEP3_CASES)[:5])
def test_one_step_vs_grid3d(case, sims):
    check_one_step_vs_grid3d(case, sims)
