"""The CLI refuses the driver features it does not port before the first step,
and writes nothing.

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
    ({"monitor": {"enabled": True, "num_points": 1, "points_x": [0.0],
                  "points_z": [0.0]}}, "monitor"),
    ({"ic": {"isostasy_adjustment_time_in_yr": 1.0}}, "isostasy"),
    ({"control": {"use_global_velocity_scaling": True}}, "earthquake"),
    ({"control": {"surface_process_option": 101}}, "custom surface hook"),
])
def test_cli_refuses_unported_driver_features(tmp_path, over, what):
    from dynearthsol_tpu_torch.__main__ import run

    cfg = _cfg(tmp_path, "refused", flat_cfg(), max_steps=2)
    for sec, kv in over.items():
        cfg.setdefault(sec, {}).update(kv)
    with pytest.raises(NotImplementedError, match=what):
        run(tdes.param_from_dict(cfg), device="cpu")
    assert not os.path.exists(cfg["sim"]["modelname"] + ".info")
