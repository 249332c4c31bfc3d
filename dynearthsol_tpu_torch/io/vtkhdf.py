"""VTKHDF frame writer (ParaView-readable) via h5py (counterpart of
dynearthsol_tpu/io/vtkhdf.py, writing the same tree).

Reference: HDF5Output (binaryio.cxx:344-1116) writes a VTKHDF
UnstructuredGrid tree (`/VTKHDF/grid/{Points,Connectivity,Offsets,Types,
PointData,CellData,FieldData}`) plus root-level legacy-named aliases of
every field so Dynearthsol.py's hdf5 branch (`f[name][:]`) works.  Here the
legacy names are real root datasets and the VTKHDF PointData/CellData
entries are soft links to them; Points/Connectivity are materialized in
VTKHDF layout.  The arrays come to the writer on the host, in numpy; h5py
is imported when a writer is made, never with this module.
"""

from __future__ import annotations

import numpy as np

from ..constants import YEAR2SEC
from .tagged import rename_to_old_backup

VTK_TRIANGLE = 5
VTK_TETRA = 10


class VTKHDFWriter:
    """Same write_array interface as TaggedWriter; the VTKHDF skeleton is
    written on close()."""

    def __init__(self, path: str, ndims: int, nnode: int, nelem: int,
                 compression: int = 4, rename_if_exists: bool = False):
        import h5py

        if rename_if_exists:
            rename_to_old_backup(path)
        self.h5py = h5py
        self.f = h5py.File(path, "w")
        self.ndims = ndims
        self.nnode = nnode
        self.nelem = nelem
        self.compression = compression
        self.f.attrs["ndims"] = ndims
        self.f.attrs["revision"] = 3
        self._grid_done = False

    def _dset(self, name, arr):
        kw = {}
        if arr.size > 64:
            kw = dict(compression="gzip",
                      compression_opts=self.compression, shuffle=True)
        self.f.create_dataset(name, data=arr, **kw)

    def write_array(self, arr: np.ndarray, name: str):
        arr = np.ascontiguousarray(arr)
        self._dset(name, arr)
        # classify into VTKHDF Point/Cell data by leading length
        n = arr.shape[0]
        if name == "coordinate" or name == "connectivity":
            return  # materialized in VTKHDF layout on close
        if "." in name or " " in name:
            return  # marker blocks stay root-level
        if n == self.nnode:
            self.f["/VTKHDF/grid/PointData/" + name] \
                = self.h5py.SoftLink("/" + name)
        elif n == self.nelem:
            self.f["/VTKHDF/grid/CellData/" + name] \
                = self.h5py.SoftLink("/" + name)

    def write_grid(self, coord: np.ndarray, conn: np.ndarray):
        """Materialize the VTKHDF UnstructuredGrid skeleton."""
        f = self.f
        g = f.require_group("VTKHDF")
        g.attrs["Version"] = np.array([2, 0], dtype=np.int64)
        blk = g.require_group("grid")
        blk.attrs["Version"] = np.array([2, 0], dtype=np.int64)
        blk.attrs["Type"] = np.bytes_("UnstructuredGrid")
        blk.require_group("PointData")
        blk.require_group("CellData")
        blk.require_group("FieldData")
        f.require_group("VTKHDF/Assembly")
        f["/VTKHDF/Assembly/grid"] = self.h5py.SoftLink("/VTKHDF/grid")

        pts = np.zeros((coord.shape[0], 3))
        pts[:, : self.ndims] = coord
        if self.ndims == 2:  # ParaView convention: y is up in 2D slices
            pts[:, 2] = 0.0
        self._dset("/VTKHDF/grid/Points", pts)
        npe = conn.shape[1]
        self._dset("/VTKHDF/grid/Connectivity",
                   conn.astype(np.int64).ravel())
        self._dset("/VTKHDF/grid/Offsets",
                   np.arange(conn.shape[0] + 1, dtype=np.int64) * npe)
        ctype = VTK_TRIANGLE if self.ndims == 2 else VTK_TETRA
        self._dset("/VTKHDF/grid/Types",
                   np.full(conn.shape[0], ctype, dtype=np.uint8))
        blk.create_dataset("NumberOfPoints",
                           data=np.array([coord.shape[0]], dtype=np.int64))
        blk.create_dataset("NumberOfCells",
                           data=np.array([conn.shape[0]], dtype=np.int64))
        blk.create_dataset("NumberOfConnectivityIds",
                           data=np.array([conn.size], dtype=np.int64))
        self._grid_done = True

    def write_field_data(self, time: float, steps: int, walltime: float):
        fd = self.f["/VTKHDF/grid/FieldData"]
        fd.create_dataset("time_yr", data=np.array([time / YEAR2SEC]))
        fd.create_dataset("steps", data=np.array([steps], dtype=np.int64))
        fd.create_dataset("walltime_sec", data=np.array([walltime]))
        fd.create_dataset("nnode", data=np.array([self.nnode],
                                                 dtype=np.int64))
        fd.create_dataset("nelem", data=np.array([self.nelem],
                                                 dtype=np.int64))

    def close(self):
        if self.f is not None:
            self.f.close()
            self.f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
