"""Checkpoint/restart reader (counterpart of dynearthsol_tpu/io/restart.py).

Reference: ``restart()`` (dynearthsol.cxx:227-420): parse ``<model>.info``
for the frame row, open ``.save.NNNNNN`` + ``.chkpt.NNNNNN``, rebuild
topology from the saved mesh (coordinates have deformed: boundary identity
comes from the saved bcflag/segments, not coordinate tests), restore fields
and markers, then re-apply velocity BCs.  With this package's checkpoints
the restart is exact: a restarted run reproduces the continuous run bit
for bit (the reference's fresh-restart-cmp contract,
benchmarks-cores/Makefile:146-160).  Beyond the JAX package's reader, the
state's delta_plstrain is read back from an instantaneous frame's
"plastic strain-rate", since the EVP step carries it; a frame of averaged
fields does not hold it, and neither holds the averaging accumulators, so
a run restarted from such a frame is not bit for bit.
"""

from __future__ import annotations

import numpy as np

from ..markers import MarkerSet
from ..mesh.generate import MeshData
from ..mesh.topology import build_topology_from_arrays
from .tagged import TaggedReader

_SCALARS = ("time info_display_next_step compensation_pressure "
            "bottom_temperature dt max_global_vel_mag reference_frame_time")


def _frame_row(prefix: str, frame: int):
    """(steps, nnode, nelem, nseg) of ``frame`` in ``<prefix>.info``."""
    info = np.loadtxt(prefix + ".info", ndmin=2)
    rows = {int(r[0]): r for r in info}
    if frame not in rows:
        raise FileNotFoundError(
            f"frame {frame} not in {prefix}.info (have {sorted(rows)})")
    row = rows[frame]
    return int(row[1]), int(row[5]), int(row[6]), int(row[7])


def read_frame(prefix: str, frame: int) -> dict:
    """Read one save + checkpoint frame pair into the array dict that
    ``Simulation(param, _restart=...)`` takes."""
    steps, nnode, nelem, nseg = _frame_row(prefix, frame)
    f64, i32 = np.float64, np.int32
    with TaggedReader(f"{prefix}.save.{frame:06d}") as save, \
            TaggedReader(f"{prefix}.chkpt.{frame:06d}") as chk:
        ndims = save.ndims
        npe, nstr = ndims + 1, ndims * (ndims + 1) // 2

        def node(name, k=1):
            a = save.read_array(name, f64, nnode * k)
            return a.reshape(nnode, k) if k > 1 else a

        def elem(name, k=1):
            a = save.read_array(name, f64, nelem * k)
            return a.reshape(nelem, k) if k > 1 else a

        r = {
            "steps": steps,
            "coord": node("coordinate", ndims),
            "conn": save.read_array("connectivity", i32, nelem * npe
                                    ).reshape(nelem, npe),
            "vel": node("velocity", ndims),
            "temperature": node("temperature"),
            "ppressure": node("pore pressure"),
            "plstrain": elem("plastic strain"),
            "strain": elem("strain", nstr),
            "stress": elem("stress", nstr),
            "coord0": node("coord0", ndims),
            "bcflag": save.read_array("bcflag", np.uint32, nnode),
            "scalars": chk.read_array(_SCALARS, f64, 7),
            "segment": chk.read_array("segment", i32, nseg * ndims
                                      ).reshape(nseg, ndims),
            "segflag": chk.read_array("segflag", i32, nseg),
            "volume_old": chk.read_array("volume_old", f64, nelem),
        }
        if not save.has_array("velocity averaged"):
            # an instantaneous frame's plastic strain-rate is the state's
            # delta_plstrain, which the next step reads: the EVP step keeps
            # an element's value where it takes the viscoelastic branch
            # (rheology.cxx:869-879)
            r["delta_plstrain"] = elem("plastic strain-rate")
        # exact-restart extras (written by this package's Output and the
        # JAX package's; absent in the reference's files)
        for nm, cnt in (("volume", nelem), ("volume_n", nnode),
                        ("mass", nnode), ("tmass", nnode),
                        ("hmass", nnode), ("ymass", nnode),
                        ("old_mean_stress", nelem)):
            if chk.has_array(nm):
                r[nm] = chk.read_array(nm, f64, cnt)
        if chk.has_array("stressyy"):
            r["stressyy"] = chk.read_array("stressyy", f64, nelem)
        if chk.has_array("friction state variable"):
            r["state_variable"] = chk.read_array("friction state variable",
                                                 f64, nelem)
        if chk.has_array("dhacc"):
            # variable-length surface arrays: their extent from the offsets
            r["dhacc"] = _read_full(chk, "dhacc", f64)
            r["edvacc_surf"] = _read_full(chk, "dv surface acc", f64)
        if save.has_array("markerset.eta"):
            names = tuple(n.split(" size")[0] for n in chk.offset
                          if n.endswith(" size"))
            msave = {n: _read_full(save, n, _dtype_of(n))
                     for n in save.offset if n.startswith(names)}
            mchk = {n: _read_full(chk, n, _dtype_of(n))
                    for n in chk.offset if n.startswith(names)}
            r["markers"] = MarkerSet.from_arrays(ndims, msave, mchk,
                                                 name="markerset")
    return r


def _dtype_of(name: str) -> np.dtype:
    if name.endswith((" size", ".elem", ".mattype", ".id", ".genesis")):
        return np.int32
    return np.float64


def _read_full(reader: TaggedReader, name: str, dtype) -> np.ndarray:
    """Read an array whose length is implied by the next offset (arrays are
    laid out back to back in file order)."""
    pos = reader.offset[name]
    later = [p for p in reader.offset.values() if p > pos]
    reader.f.seek(0, 2)
    end = min(later) if later else reader.f.tell()
    return reader.read_array(name, dtype,
                             (end - pos) // np.dtype(dtype).itemsize)


def load_mesh_from_run(prefix: str, frame: int):
    """Load only the mesh (coordinates, connectivity, segments, bcflag) of
    a run's output frame and derive the topology from it: ``mesh_from_run``
    runs this package's numerics on the reference binary's own mesh, so
    that fields compare node for node."""
    _, nnode, nelem, nseg = _frame_row(prefix, frame)
    with TaggedReader(f"{prefix}.save.{frame:06d}") as save, \
            TaggedReader(f"{prefix}.chkpt.{frame:06d}") as chk:
        ndims = save.ndims
        coord = save.read_array("coordinate", np.float64, nnode * ndims
                                ).reshape(nnode, ndims)
        conn = save.read_array("connectivity", np.int32,
                               nelem * (ndims + 1)).reshape(nelem, ndims + 1)
        bcflag = save.read_array("bcflag", np.uint32, nnode)
        segment = chk.read_array("segment", np.int32, nseg * ndims
                                 ).reshape(nseg, ndims)
        segflag = chk.read_array("segflag", np.int32, nseg)
    topo = build_topology_from_arrays(ndims, conn, bcflag, segment, segflag)
    return MeshData(ndims, coord, conn), topo


def restart(param, device=None):
    """A restarted Simulation on ``device`` (the card unless the caller
    asks for the CPU) and its frame (dynearthsol.cxx:227-420)."""
    from ..simulation import Simulation

    prefix = param.sim.restarting_from_modelname or param.sim.modelname
    frame = param.sim.restarting_from_frame
    r = read_frame(prefix, frame)
    r["topo"] = build_topology_from_arrays(param.sim.ndims, r["conn"],
                                           r["bcflag"], r["segment"],
                                           r["segflag"])
    return Simulation(param, device=device, _restart=r), frame
