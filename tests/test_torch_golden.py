"""The port against the C++ reference binary's goldens
(tests/golden/runs/), on the CPU: maxwell-2d, maxwell-2mat-2d,
evp-winkler-2d, ep-3d and maxwell-2mat-3d through the port's CLI (``python -m dynearthsol_tpu_torch
--device cpu``, called in-process) on the reference's own mesh
(mesh_from_run) with its glibc marker stream (reference_compatible_rng),
prepared and gated as tests/test_golden_vs_reference.py gates the JAX
package (:86-133): 1e-8 on accumulated quantities and 1e-7 on rates at
every frame for maxwell-2d, 3e-8 and 1e-7 for maxwell-2mat-2d, and 1e-6
and 1e-5 at frames 0-2 of the 600-step run for evp-winkler-2d (EVP with
gravity amplifies an ulp about tenfold per frame; the JAX package reaches
9.1e-6 of the rate bound at frame 2), and 1e-8 and 1e-7 at every frame
for the 3D cases, which test_golden_vs_reference.py:122-133 gives no rule
of their own.  The frames are read and compared by the JAX package's
compare.py, the reference's contract.  The 2D maxwell cases take flat2d
in float64; evp-winkler-2d (plasticity without is_plane_strain) takes the
generic step in both packages; the 3D cases, on the reference's TetGen
meshes, take flat3d.

Also the CLI itself in a subprocess: without ``--device`` it asks for the
card, and where there is none it exits non-zero with Simulation's
message.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from dynearthsol_tpu.compare import _frame_quantities, reldiff
from dynearthsol_tpu.postproc import OutputReader
from dynearthsol_tpu_torch.__main__ import main as cli_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = os.path.join(REPO, "tests", "golden", "runs")
# rate/instantaneous quantities: the golden test's cross-compiler floor
LOOSE = {"X velocity", "Z velocity", "S. rate I", "S. rate II",
         "Stress I", "Stress II", "Viscosity"}
# case: (accumulated threshold, rate threshold, last gated frame or None,
# frames written, step path)
CASES = {"maxwell-2d": (1e-8, 1e-7, None, 11, "flat2d"),
         "maxwell-2mat-2d": (3e-8, 1e-7, None, 11, "flat2d"),
         "evp-winkler-2d": (1e-6, 1e-5, 2, 7, "generic"),
         "ep-3d": (1e-8, 1e-7, None, 5, "flat3d"),
         "maxwell-2mat-3d": (1e-8, 1e-7, None, 5, "flat3d")}


def _prepare_case(rundir, work):
    """test_golden_vs_reference.py:46-65: the golden's cfg with the model
    renamed, the reference's mesh and its marker stream."""
    with open(os.path.join(rundir, "case.cfg")) as f:
        cfg = f.read()
    assert "modelname = ref" in cfg
    cfg = cfg.replace("modelname = ref", "modelname = our")
    cfg += ("\n[mesh]\n"
            f"mesh_from_run = {os.path.join(rundir, 'ref')}\n"
            "mesh_from_run_frame = 0\n"
            "[markers]\n"
            "reference_compatible_rng = yes\n")
    with open(os.path.join(work, "case.cfg"), "w") as f:
        f.write(cfg)
    for fn in os.listdir(rundir):
        if not fn.startswith("ref.") and fn not in ("case.cfg",
                                                    "PROVENANCE"):
            shutil.copy(os.path.join(rundir, fn), work)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches_reference_golden(case, tmp_path, monkeypatch, capsys):
    rundir = os.path.join(RUNS, case)
    _prepare_case(rundir, str(tmp_path))
    monkeypatch.chdir(tmp_path)
    assert cli_main(["--device", "cpu", "case.cfg"]) == 0
    accum_thr, rate_thr, max_frame, nframes, path = CASES[case]
    printed = capsys.readouterr().out
    assert "dtype: float64" in printed and f"Path:     {path}" in printed
    ref, our = OutputReader(os.path.join(rundir, "ref")), OutputReader("our")
    assert our.frames == ref.frames and len(ref.frames) == nframes
    assert our.steps == ref.steps
    failures = []
    for frame in ref.frames[:None if max_frame is None else max_frame + 1]:
        old = _frame_quantities(ref, frame, include_markers=False)
        new = _frame_quantities(our, frame, include_markers=False)
        for kind in old:
            mx, sg = reldiff(old[kind], new[kind])
            thr = rate_thr if kind in LOOSE else accum_thr
            if not (np.isfinite(mx + sg) and mx + sg <= thr):
                failures.append((frame, kind, mx, sg))
    assert not failures, f"{case}: {failures}"


def test_cli_without_a_card_fails_with_the_message(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would run on it")
    _prepare_case(os.path.join(RUNS, "maxwell-2d"), str(tmp_path))
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "dynearthsol_tpu_torch",
                        "case.cfg"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "runs on the CUDA device by default and none is available" \
        in r.stderr
    assert not os.path.exists(tmp_path / "our.info")
