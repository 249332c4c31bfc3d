"""The CLI's driver features before the first step: the isostasy and
body-force pre-relaxations run as the JAX CLI runs them (its "Adjusted
..." line, and frame 0 equal to the JAX CLI's at 1e-10 of each array's
max in float64), and multi-device stepping, which the port does not have,
is refused before anything is written.

The helpers are in tests/test_torch_io.py and tests/torch_cases.py. The
suite keeps at most 7 items in a file: pytest-xdist's file scheduler
(--dist loadfile) sends the files with the most items first, and the long
golden file (tests/test_golden_vs_reference.py, 7 items) must start early.
"""

import os

import pytest

import dynearthsol_tpu_torch as tdes
from test_torch_io import _cfg
from torch_cases import assert_frames_close, flat_cfg, run_both_clis


@pytest.mark.parametrize("over,what", [
    ({"ic": {"isostasy_adjustment_time_in_yr": 0.3}},
     "Adjusted isostasy for 5 steps."),
    ({"ic": {"has_body_force_adjustment": True},
      "control": {"has_PT": True, "PT_max_iter": 30,
                  "PT_relative_tolerance": 1e-3}},
     "Adjusted initial body force for"),
    ({"env": {"DES_N_DEVICES": "2"}}, "DES_N_DEVICES"),
], ids=["over0-isostasy", "over1-body-force", "over2-DES_N_DEVICES"])
def test_cli_refuses_unported_driver_features(tmp_path, monkeypatch, capsys,
                                              over, what):
    from dynearthsol_tpu_torch.__main__ import run

    cfg = _cfg(tmp_path, "refused", flat_cfg(), max_steps=2)
    for sec, kv in over.items():
        if sec == "env":
            for k, v in kv.items():
                monkeypatch.setenv(k, v)
        else:
            cfg.setdefault(sec, {}).update(kv)
    if "env" in over:
        with pytest.raises(NotImplementedError, match=what):
            run(tdes.param_from_dict(cfg), device="cpu")
        assert not os.path.exists(cfg["sim"]["modelname"] + ".info")
        return
    # both CLIs from one .cfg: the pre-relaxation's line, then frame 0
    run_both_clis(tmp_path, cfg)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("Adjusted")]
    assert len(lines) == 2 and lines[0] == lines[1], lines
    assert lines[0].startswith(what)
    assert_frames_close(tmp_path / "jax" / "jax.save.000000",
                        tmp_path / "our" / "our.save.000000")
