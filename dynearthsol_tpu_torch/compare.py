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
