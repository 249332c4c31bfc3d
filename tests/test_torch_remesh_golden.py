"""The remesh-crossing goldens through the port's CLI on the CPU, prepared
as tests/test_torch_golden.py prepares a golden (the reference's frame-0
mesh by mesh_from_run, its glibc marker stream):

- ep-remesh-2d (the reference CI's 2d-ep-irregular feature set,
  remeshing_option 11, surface process 1, markers, 40,000 steps of the
  generic step, about 5 minutes), held to the gates of
  tests/test_golden_vs_reference.py:230-283: the reference and the port
  remesh only at frame 16, the accumulated quantities of frames 1-15
  within ACCUM_KINDS' bounds, and frame 16's element count, volume,
  integrated plastic strain, mean stress II and topography;
- evp-remesh-3d (3D EVP, two materials, water loading, surface process 1,
  remeshing_option 13 about every 5-7 steps, 400 steps on flat3d), held
  to the gates of tests/test_golden_vs_reference.py:339-392: frame 0 at
  ACCUM_KINDS, the wall-snap signature, the integral metrics of frames 2,
  4, 6 and 8, and the frame-8 surface profile within its envelope; the
  port's own copies of the metrics (compare.elem_metrics_3d,
  surface_profile_3d, remesh_golden_3d, which chip_smoke.py runs on the
  card) give the same numbers and verdict.

Both take minutes, hence the ``slow`` mark: tier 1 deselects them; run
them with ``-m slow``."""

import os

import numpy as np
import pytest

from dynearthsol_tpu.compare import _frame_quantities, reldiff
from dynearthsol_tpu.postproc import OutputReader
from dynearthsol_tpu_torch.__main__ import main as cli_main
from test_golden_vs_reference import (ACCUM_KINDS, REMESH3D_CASE,
                                      REMESH_CASE, _elem_metrics,
                                      _elem_metrics_3d, _info_rows,
                                      _surface_profile, _surface_profile_3d)
from test_torch_golden import _prepare_case


def _remesh_frames(reader, frames):
    """Frames whose connectivity differs from the frame before."""
    out = []
    prev = reader.read_field(frames[0], "connectivity")
    for f in frames[1:]:
        cur = reader.read_field(f, "connectivity")
        if cur.shape != prev.shape or (cur != prev).any():
            out.append(f)
        prev = cur
    return out


@pytest.mark.slow
def test_ep_remesh_2d_golden_through_the_cli(tmp_path, monkeypatch, capsys):
    _prepare_case(REMESH_CASE, str(tmp_path))
    monkeypatch.chdir(tmp_path)
    assert cli_main(["--device", "cpu", "case.cfg"]) == 0
    printed = capsys.readouterr().out
    assert "Path:     generic" in printed and "Remesh:   " in printed
    ref = OutputReader(os.path.join(REMESH_CASE, "ref"))
    our = OutputReader("our")
    frames = [r[0] for r in _info_rows(os.path.join(REMESH_CASE,
                                                    "ref.info"))]
    assert our.frames == ref.frames == frames
    assert _remesh_frames(ref, frames) == [16]
    assert _remesh_frames(our, frames) == [16]

    failures = []
    for frame in range(1, 16):
        old = _frame_quantities(ref, frame, include_markers=False)
        new = _frame_quantities(our, frame, include_markers=False)
        for kind, thr in ACCUM_KINDS.items():
            if kind not in old:
                continue
            mx, sg = reldiff(old[kind], new[kind])
            print(f"f{frame} {kind}: {mx + sg:.3e} (<= {thr:g})")
            if not (np.isfinite(mx + sg) and mx + sg <= thr):
                failures.append((frame, kind, mx + sg, thr))
    assert not failures, failures

    mr, mo = _elem_metrics(ref, 16), _elem_metrics(our, 16)
    print("frame 16, reference:", mr, "port:", mo)
    assert abs(mo["nelem"] - mr["nelem"]) / mr["nelem"] <= 0.05
    assert abs(mo["vol"] - mr["vol"]) / mr["vol"] <= 1e-3
    assert abs(mo["plsv"] - mr["plsv"]) / mr["plsv"] <= 3e-2
    assert abs(mo["sII_mean"] - mr["sII_mean"]) / mr["sII_mean"] <= 1.5e-1
    xg = np.linspace(0.0, 100e3, 400)
    dz = np.abs(_surface_profile(ref, 16, xg) - _surface_profile(our, 16, xg))
    print(f"frame 16 topography max |dz| {dz.max():.3f} m (<= 10)")
    assert dz.max() <= 10.0


@pytest.mark.slow
def test_evp_remesh_3d_golden_through_the_cli(tmp_path, monkeypatch, capsys):
    from dynearthsol_tpu_torch import compare as tcmp

    _prepare_case(REMESH3D_CASE, str(tmp_path))
    monkeypatch.chdir(tmp_path)
    assert cli_main(["--device", "cpu", "case.cfg"]) == 0
    printed = capsys.readouterr().out
    print("\n".join(ln for ln in printed.splitlines()
                    if ln.startswith(("Compute:", "Remesh:", "Path:"))))
    assert "Path:     flat3d" in printed
    nremesh = printed.count("remeshing (trigger")
    print(f"{nremesh} remeshes")
    assert nremesh >= 40
    ref = OutputReader(os.path.join(REMESH3D_CASE, "ref"))
    our = OutputReader("our")
    assert our.frames[-1] == ref.frames[-1]

    failures = []
    old = _frame_quantities(ref, 0, include_markers=False)
    new = _frame_quantities(our, 0, include_markers=False)
    for kind, thr in ACCUM_KINDS.items():
        if kind not in old:
            continue
        mx, sg = reldiff(old[kind], new[kind])
        print(f"f0 {kind}: {mx + sg:.3e} (<= {thr:g})")
        if not (np.isfinite(mx + sg) and mx + sg <= thr):
            failures.append((0, kind, mx + sg, thr))
    assert not failures, failures

    for rd, tag in ((ref, "ref"), (our, "our")):
        for f in rd.frames[2:]:
            c = rd.read_field(f, "coordinate")
            assert abs(c[:, 0].min()) < 15.0, (tag, f, c[:, 0].min())

    for frame in (2, 4, 6, 8):
        mr, mo = _elem_metrics_3d(ref, frame), _elem_metrics_3d(our, frame)
        print(f"frame {frame}, reference:", mr, "port:", mo)
        assert mo == tcmp.elem_metrics_3d(our, frame)
        assert abs(mo["nelem"] - mr["nelem"]) / mr["nelem"] <= 0.05
        assert abs(mo["vol"] - mr["vol"]) / mr["vol"] <= 1e-3
        assert abs(mo["plsv"] - mr["plsv"]) \
            / max(mr["plsv"], 1e-300) <= 5e-2
        assert abs(mo["sII_mean"] - mr["sII_mean"]) / mr["sII_mean"] \
            <= 1.5e-1
    xg = np.linspace(0.0, 250e3, 51)
    zr = _surface_profile_3d(ref, 8, xg)
    zo = _surface_profile_3d(our, 8, xg)
    assert np.array_equal(zo, tcmp.surface_profile_3d(our, 8, xg))
    relief = max(float(np.ptp(zr)), 1.0)
    print(f"frame 8 relief: reference {relief:.1f} m, port "
          f"{np.ptp(zo):.1f} m, max |dz| {np.abs(zr - zo).max():.1f} m")
    assert np.abs(zr - zo).max() <= 0.7 * relief
    assert 0.3 * relief <= float(np.ptp(zo)) <= 1.7 * relief
    nums, bad = tcmp.remesh_golden_3d(ref, our, 250e3)
    assert not bad, bad
