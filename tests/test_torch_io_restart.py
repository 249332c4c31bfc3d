"""A fresh restart continues bit for bit, and mesh_from_run reads the
reference's mesh as the JAX package does.

The helpers are in tests/test_torch_io.py, beside the rest of its tests. The
suite keeps at most 7 items in a file: pytest-xdist's file scheduler (--dist
loadfile) sends the files with the most items first, and the long golden
file (tests/test_golden_vs_reference.py, 7 items) must start early.
"""

import os

import numpy as np
import pytest
import torch

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu_torch.state import FIELD_NAMES
from test_torch_io import _restart_case, RUNS
from torch_cases import flagship_cfg, flat_cfg


@pytest.mark.parametrize("case", ["flat2d_f64", "resident_f32"])
def test_fresh_restart_bitexact(tmp_path, case):
    if case == "flat2d_f64":
        cont, rest = _restart_case(
            tmp_path, flat_cfg("maxwell", markers={
                "markers_per_element": 2}), 10, "flat2d")
    else:
        # the flagship's physics (EVP, the weak zone) in 8 x 256 cells:
        # by step 105, between two dt refreshes (every 10), elements that
        # yielded have gone back to the viscoelastic branch, which keeps
        # their delta_plstrain (read back from the frame)
        cont, rest = _restart_case(
            tmp_path, flagship_cfg(nx_cells=8, nz_cells=256), 105,
            "pallas2d_res")
        assert (rest.delta_plstrain != 0).any()
    for f in FIELD_NAMES:
        assert torch.equal(getattr(cont, f), getattr(rest, f)), f


@pytest.mark.parametrize("case", ["maxwell-2d", "maxwell-2mat-3d"])
def test_mesh_from_run_matches_jax(tmp_path, case):
    """load_config takes ndims from the save file; the topology built from
    the reference's arrays is the JAX package's, and so is the marker
    population drawn from the glibc stream."""
    from dynearthsol_tpu.io.restart import load_mesh_from_run as jload
    from dynearthsol_tpu.markers import create_markers as jcreate
    from dynearthsol_tpu_torch.io.restart import load_mesh_from_run
    from dynearthsol_tpu_torch.markers import create_markers

    ref = os.path.join(RUNS, case, "ref")
    text = open(os.path.join(RUNS, case, "case.cfg")).read()
    text += (f"\n[mesh]\nmesh_from_run = {ref}\nmesh_from_run_frame = 0\n"
             "[markers]\nreference_compatible_rng = yes\n"
             "markers_per_element = 2\n")
    (tmp_path / "case.cfg").write_text(text)
    tp = tdes.load_config(str(tmp_path / "case.cfg"))
    jp = jdes.load_config(str(tmp_path / "case.cfg"))
    assert tp.sim.ndims == jp.sim.ndims == (3 if "3d" in case else 2)
    (jm, jt), (tm, tt) = jload(ref, 0), load_mesh_from_run(ref, 0)
    assert np.array_equal(jm.coord, tm.coord)
    assert tt.nseg == jt.nseg
    for f in ("connectivity", "bcflag", "segment", "segflag", "asm_perm",
              "asm_node_ids", "gather_idx", "gather_mask"):
        a, b = getattr(jt, f), getattr(tt, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for a, b in zip(jt.bnodes + jt.bfacets, tt.bnodes + tt.bfacets):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jmk = jcreate(jp, jm.coord, jt.connectivity)
    tmk = create_markers(tp, tm.coord, tt.connectivity)
    assert tmk.cap == jmk.cap and tmk.n == jmk.n
    for nm in ("eta", "elem", "mattype", "id", "time", "z", "distance",
               "slope", "genesis"):
        assert np.array_equal(tmk.live(nm), jmk.live(nm)), nm
    assert np.array_equal(tmk.elem_histogram(tt.nelem, 2),
                          jmk.elem_histogram(jt.nelem, 2))
