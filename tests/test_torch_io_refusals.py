"""The CLI refuses the features it does not port (multi-device
stepping and the two pre-relaxations) before the first step, and writes
nothing.

The helpers are in tests/test_torch_io.py, beside the rest of its tests. The
suite keeps at most 7 items in a file: pytest-xdist's file scheduler (--dist
loadfile) sends the files with the most items first, and the long golden
file (tests/test_golden_vs_reference.py, 7 items) must start early.
"""

import os

import pytest

import dynearthsol_tpu_torch as tdes
from test_torch_io import _cfg
from torch_cases import flat_cfg


@pytest.mark.parametrize("over,what", [
    ({"ic": {"isostasy_adjustment_time_in_yr": 1.0}}, "isostasy"),
    ({"ic": {"has_body_force_adjustment": True},
      "control": {"has_PT": True}}, "body-force"),
    ({"env": {"DES_N_DEVICES": "2"}}, "DES_N_DEVICES"),
])
def test_cli_refuses_unported_driver_features(tmp_path, monkeypatch, over,
                                              what):
    from dynearthsol_tpu_torch.__main__ import run

    cfg = _cfg(tmp_path, "refused", flat_cfg(), max_steps=2)
    for sec, kv in over.items():
        if sec == "env":
            for k, v in kv.items():
                monkeypatch.setenv(k, v)
        else:
            cfg.setdefault(sec, {}).update(kv)
    with pytest.raises(NotImplementedError, match=what):
        run(tdes.param_from_dict(cfg), device="cpu")
    assert not os.path.exists(cfg["sim"]["modelname"] + ".info")
