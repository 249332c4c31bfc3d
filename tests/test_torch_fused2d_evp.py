"""One EVP step of the fused 2D step against the JAX pallas2d in interpret
mode, every case of CASES.

The helpers are in tests/test_torch_fused2d.py, beside the rest of its
tests. The suite keeps at most 7 items in a file: pytest-xdist's file
scheduler (--dist loadfile) sends the files with the most items first, and
the long golden file (tests/test_golden_vs_reference.py, 7 items) must start
early.
"""

import pytest

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from test_torch_fused2d import _jax_run, _port_run, _sims, CASES, evp, get
from torch_cases import assert_evp_one_step_close, make_sim_cfg, with_param


@pytest.mark.parametrize("case", list(CASES))
def test_evp_one_step(case, evp):
    """One EVP step per damping option 0-4 and with two materials (the
    const-pack path, whose state is its own), at f32 roundoff: 2e-6 of
    each field's max."""
    cfg = make_sim_cfg(**CASES[case])
    if "mat" in CASES[case]:
        js, ts, s0 = _sims(cfg)
    else:
        js, ts, s0 = evp
        js = with_param(js, jdes.param_from_dict(cfg))
        ts = with_param(ts, tdes.param_from_dict(cfg))
    assert_evp_one_step_close(_jax_run(js, 1), _port_run(ts, s0, 1), get)
