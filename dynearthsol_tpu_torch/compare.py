"""Golden-run comparator (counterpart of dynearthsol_tpu/compare.py).

The contract of the reference's regression harness
(benchmarks-cores/compare.py): load one output frame of two runs, compare
17 derived quantities (temperature, coordinates, velocity, plastic strain,
stress/strain/strain-rate invariants, viscosity, marker
coordinates/mattype/time), and classify the result as

* ``BIT-EXACT``       -- every field identical,
* ``round-off``       -- differences present but all < 1e-8 relative,
* ``SOMETHING WRONG`` -- at least one field >= 1e-8 relative (or NaN/Inf).

Exit code 0 for the first two, 1 for the last.  Usage::

    python -m dynearthsol_tpu_torch.compare <old-modelname> <new-modelname> <frame>
"""

from __future__ import annotations

import sys

import numpy as np

from .postproc import OutputReader, first_invariant, second_invariant

THRESHOLD = 1e-8


def _frame_quantities(reader: OutputReader, frame: int,
                      markersetname: str = "markerset",
                      include_markers: bool = True) -> dict:
    q = {}
    q["Temperature"] = reader.read_field(frame, "temperature")
    coord = reader.read_field(frame, "coordinate")
    q["X coordinate"] = coord[:, 0]
    q["Z coordinate"] = coord[:, -1]
    vel = reader.read_field(frame, "velocity")
    q["X velocity"] = vel[:, 0]
    q["Z velocity"] = vel[:, -1]
    q["Pl. strain"] = reader.read_field(frame, "plastic strain")
    for label, name in (("Stress", "stress"), ("Strain", "strain"),
                        ("S. rate", "strain-rate")):
        t = reader.read_field(frame, name)
        q[f"{label} I"] = first_invariant(t)
        q[f"{label} II"] = second_invariant(t)
    q["Viscosity"] = reader.read_field(frame, "viscosity")
    if not include_markers:
        return q
    try:
        mk = reader.read_markers(frame, markersetname)
        mc = mk[markersetname + ".coord"]
        q["Marker X"] = mc[:, 0]
        q["Marker Z"] = mc[:, -1]
        q["Marker Mat"] = mk[markersetname + ".mattype"].astype(float)
        q["Marker Time"] = mk[markersetname + ".time"]
    except (KeyError, FileNotFoundError):
        pass  # marker-less runs
    return q


def reldiff(oldf: np.ndarray, newf: np.ndarray):
    """(max, std) of |new-old|, relative to max|old| when nonzero."""
    m = np.abs(oldf).max()
    diff = np.abs(np.asarray(newf, dtype=float)
                  - np.asarray(oldf, dtype=float))
    if m == 0.0:
        return float(diff.max()), float(diff.std())
    return float(diff.max() / m), float(diff.std() / m)


def compare_runs(old_model: str, new_model: str, frame: int,
                 verbose: bool = True, include_markers: bool = True):
    """Compare one frame of two runs.  Returns (n_fail, n_nonzero):
    fields over threshold, and fields with any nonzero difference."""
    old = _frame_quantities(OutputReader(old_model), frame,
                            include_markers=include_markers)
    new = _frame_quantities(OutputReader(new_model), frame,
                            include_markers=include_markers)
    n_fail = n_nonzero = 0
    for kind, a in old.items():
        b = new.get(kind)
        if b is None or a.size != b.size:
            if verbose:
                bs = "missing" if b is None else str(b.size)
                print(f"  {kind}:\t\t{a.size} -> {bs} (size mismatch)")
            n_fail += 1
            n_nonzero += 1
            continue
        mx, sg = reldiff(a, b)
        if not (np.isfinite(mx) and np.isfinite(sg)):
            note, failed = " (NaN/Inf - field corrupt)", True
        elif mx + sg > THRESHOLD:
            note, failed = f" (> {THRESHOLD:g})", True
        else:
            note, failed = "", False
        if verbose:
            print(f"  {kind}:\t\t{mx:.3e} {sg:.3e}{note}")
        n_fail += failed
        n_nonzero += failed or mx + sg > 0.0
    return n_fail, n_nonzero


# the accumulated quantities of a golden's pre-remesh frames and their
# bounds (tests/test_golden_vs_reference.py:194-196)
ACCUM_KINDS = {"X coordinate": 1e-4, "Z coordinate": 1e-4,
               "Temperature": 1e-8, "Stress I": 1e-2, "Stress II": 1e-2,
               "Strain I": 1e-2, "Strain II": 1e-2}


def elem_metrics_3d(reader: OutputReader, frame: int) -> dict:
    """Element count, total volume, volume-integrated plastic strain and
    the volume-weighted mean of stress II of a 3D frame
    (tests/test_golden_vs_reference.py:289-303)."""
    coord = reader.read_field(frame, "coordinate")
    conn = reader.read_field(frame, "connectivity")
    pls = reader.read_field(frame, "plastic strain")
    stress = reader.read_field(frame, "stress")
    v = coord[conn]
    d1 = v[:, 1] - v[:, 0]
    d2 = v[:, 2] - v[:, 0]
    d3 = v[:, 3] - v[:, 0]
    vol = np.abs(np.einsum("ij,ij->i", d1, np.cross(d2, d3))) / 6.0
    s0 = stress[:, :3].mean(axis=1)
    dev = stress[:, :3] - s0[:, None]
    sII = np.sqrt(0.5 * (dev ** 2).sum(axis=1)
                  + (stress[:, 3:] ** 2).sum(axis=1))
    return dict(nelem=len(conn), vol=vol.sum(), plsv=(pls * vol).sum(),
                sII_mean=np.average(sII, weights=vol))


def surface_profile_3d(reader: OutputReader, frame: int,
                       xgrid: np.ndarray) -> np.ndarray:
    """Top-surface z(x) averaged over y in the bins of ``xgrid``
    (tests/test_golden_vs_reference.py:306-318)."""
    coord = reader.read_field(frame, "coordinate")
    bc = reader.read_field(frame, "bcflag").astype(np.int64)
    top = (bc & 32) != 0  # BOUNDZ1
    x, z = coord[top, 0], coord[top, 2]
    idx = np.clip(np.searchsorted(xgrid, x) - 1, 0, len(xgrid) - 2)
    sums = np.bincount(idx, weights=z, minlength=len(xgrid) - 1)
    cnts = np.bincount(idx, minlength=len(xgrid) - 1)
    return sums / np.maximum(cnts, 1)


def remesh_golden_3d(ref: OutputReader, our: OutputReader,
                     xlength: float) -> tuple:
    """The gates of the 3D remesh-crossing golden
    (tests/test_golden_vs_reference.py:339-392) on the reference's frames
    ``ref`` and a run's ``our``: frame 0's accumulated quantities within
    ACCUM_KINDS; the wall-snap signature (|min x| < 15 m from frame 2 on,
    in both); at frames 2, 4, 6 and 8 the element count within 5 %, the
    volume within 1e-3, the integrated plastic strain within 5e-2 and the
    mean stress II within 1.5e-1; the frame-8 surface profile within 0.7
    of the reference's relief and a relief within 0.3-1.7 of it.  Returns
    (numbers, failures): what was measured, and a list of what failed."""
    nums, bad = {"frames": {}}, []
    if our.frames[-1] != ref.frames[-1]:
        bad.append(f"last frame {our.frames[-1]}, the reference's "
                   f"{ref.frames[-1]}")
    old = _frame_quantities(ref, 0, include_markers=False)
    new = _frame_quantities(our, 0, include_markers=False)
    nums["frame0"] = {}
    for kind, thr in ACCUM_KINDS.items():
        if kind not in old:
            continue
        e = sum(reldiff(old[kind], new[kind]))
        nums["frame0"][kind] = e
        if not (np.isfinite(e) and e <= thr):
            bad.append(f"frame 0 {kind}: {e:.3e} > {thr:g}")
    for rd, tag in ((ref, "reference"), (our, "run")):
        for f in rd.frames[2:]:
            xmin = float(rd.read_field(f, "coordinate")[:, 0].min())
            if not abs(xmin) < 15.0:
                bad.append(f"{tag} frame {f}: min x {xmin:.3f} m")
    limits = {"nelem": 0.05, "vol": 1e-3, "plsv": 5e-2, "sII_mean": 1.5e-1}
    for frame in (2, 4, 6, 8):
        mr, mo = elem_metrics_3d(ref, frame), elem_metrics_3d(our, frame)
        rel = {k: abs(mo[k] - mr[k]) / max(abs(mr[k]), 1e-300)
               for k in limits}
        nums["frames"][frame] = {"reference": mr, "run": mo, "rel": rel}
        for k, lim in limits.items():
            if not rel[k] <= lim:
                bad.append(f"frame {frame} {k}: {rel[k]:.3e} > {lim:g}")
    xg = np.linspace(0.0, xlength, 51)
    zr = surface_profile_3d(ref, 8, xg)
    zo = surface_profile_3d(our, 8, xg)
    relief = max(float(np.ptp(zr)), 1.0)
    dz, relief_o = float(np.abs(zr - zo).max()), float(np.ptp(zo))
    nums.update(relief_reference=relief, relief_run=relief_o, dz_max=dz)
    if not dz <= 0.7 * relief:
        bad.append(f"frame 8 surface: max |dz| {dz:.2f} m > 0.7 x relief "
                   f"{relief:.2f} m")
    if not 0.3 * relief <= relief_o <= 1.7 * relief:
        bad.append(f"frame 8 relief {relief_o:.2f} m outside 0.3-1.7 x "
                   f"{relief:.2f} m")
    return nums, bad


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        print("Usage: python -m dynearthsol_tpu_torch.compare "
              "<old-modelname> <new-modelname> <frame>")
        return 1
    n_fail, n_nonzero = compare_runs(argv[0], argv[1], int(argv[2]))
    if n_fail:
        print("Status: SOMETHING WRONG")
        return 1
    print("Status: round-off differences only" if n_nonzero
          else "Status: BIT-EXACT")
    return 0


if __name__ == "__main__":
    sys.exit(main())
