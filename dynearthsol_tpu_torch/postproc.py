"""Output reader (counterpart of dynearthsol_tpu/postproc.py, the binary
format only).

The reference's Dynearthsol.py reads a run's ``.info`` and tagged-binary
frames; so does ``OutputReader`` here, for this package's output and the
reference's.  The VTKHDF branch, the VTK conversion and the derived fields
of 2vtk.py are not ported yet.
"""

from __future__ import annotations

import numpy as np

from .io.tagged import TaggedReader

_NODE_VECTORS = ("coordinate", "velocity", "velocity averaged", "force",
                 "coord0")
_NODE_SCALARS = ("temperature", "pore pressure", "bcflag", "mass", "tmass",
                 "volume_n")
_ELEM_TENSORS = ("strain", "strain-rate", "stress", "stress averaged")
_ELEM_SCALARS = ("density", "material", "mesh quality", "plastic strain",
                 "plastic strain-rate", "viscosity", "edvoldt", "volume",
                 "radiogenic source", "dynamic friction coefficient",
                 "friction state variable")
_MARKER_FIELDS = {".eta": np.float64, ".elem": np.int32,
                  ".mattype": np.int32, ".id": np.int32, ".time": np.float64,
                  ".z": np.float64, ".distance": np.float64,
                  ".slope": np.float64, ".genesis": np.int32}


class OutputReader:
    """Read a run's output (this package's or the reference's): ``.info``
    and the binary frames."""

    def __init__(self, modelname: str):
        self.modelname = modelname
        info = np.loadtxt(modelname + ".info", ndmin=2)
        self.frames = info[:, 0].astype(int).tolist()
        self.steps = info[:, 1].astype(int).tolist()
        self.time = info[:, 2].tolist()
        self.nnode_list = info[:, 5].astype(int)
        self.nelem_list = info[:, 6].astype(int)
        with TaggedReader(self._fn(self.frames[0])) as r:
            self.ndims = r.ndims
        self.nstr = self.ndims * (self.ndims + 1) // 2

    def _fn(self, frame: int) -> str:
        return f"{self.modelname}.save.{frame:06d}"

    def _shape(self, frame, name):
        i = self.frames.index(frame)
        nnode, nelem = self.nnode_list[i], self.nelem_list[i]
        if name in _ELEM_TENSORS:
            return np.float64, (nelem, self.nstr)
        if name in _ELEM_SCALARS:
            return np.float64, (nelem,)
        if name == "connectivity":
            return np.int32, (nelem, self.ndims + 1)
        if name == "bcflag":
            return np.int32, (nnode,)
        if name in _NODE_VECTORS:
            return np.float64, (nnode, self.ndims)
        if name in _NODE_SCALARS:
            return np.float64, (nnode,)
        raise KeyError(f"unknown field {name!r}")

    def read_field(self, frame: int, name: str) -> np.ndarray:
        dtype, shape = self._shape(frame, name)
        with TaggedReader(self._fn(frame)) as r:
            return r.read_array(name, dtype,
                                int(np.prod(shape))).reshape(shape)

    def has_field(self, frame: int, name: str) -> bool:
        with TaggedReader(self._fn(frame)) as r:
            return r.has_array(name)

    def read_markers(self, frame: int, markername: str = "markerset"):
        out = {}
        with TaggedReader(self._fn(frame)) as r:
            n = int(r.read_array(f"{markername} size", np.int32, 1)[0])
            spec = {".coord": (np.float64, (n, self.ndims)),
                    **{suf: (dt, (n, self.ndims + 1) if suf == ".eta"
                             else (n,))
                       for suf, dt in _MARKER_FIELDS.items()}}
            for suf, (dt, shape) in spec.items():
                nm = markername + suf
                if r.has_array(nm):
                    out[nm] = r.read_array(
                        nm, dt, int(np.prod(shape))).reshape(shape)
        out["size"] = n
        return out


def first_invariant(t: np.ndarray) -> np.ndarray:
    """Mean of the diagonal of a flattened symmetric tensor."""
    ndims = 2 if t.shape[1] == 3 else 3
    return t[:, :ndims].sum(axis=1) / ndims


def second_invariant(t: np.ndarray) -> np.ndarray:
    """sqrt(II) of a flattened symmetric tensor (utils.hpp:172-201 /
    2vtk.py derived fields)."""
    if t.shape[1] == 3:
        a = 0.5 * (t[:, 0] + t[:, 1])
        return np.sqrt(0.25 * (t[:, 0] - t[:, 1]) ** 2 + t[:, 2] ** 2
                       + 0.0 * a)
    m = t[:, :3].mean(axis=1)
    dev = t[:, :3] - m[:, None]
    return np.sqrt(0.5 * (dev ** 2).sum(axis=1)
                   + (t[:, 3:] ** 2).sum(axis=1))
