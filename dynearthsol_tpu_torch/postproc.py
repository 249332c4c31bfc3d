"""Post-processing: output reader, derived fields and VTK conversion
(counterpart of dynearthsol_tpu/postproc.py).

The reference's Dynearthsol.py reads a run's ``.info`` and its frames,
tagged-binary or VTKHDF; so does ``OutputReader`` here, for this package's
output and the reference's (h5py is imported only to read a VTKHDF
frame).  2vtk.py converts frames to VTK with derived fields; so do
``to_vtk`` (legacy ASCII ``.vtk``, which ParaView and pyvista read without
extra dependencies) and ``to_vtp`` (markers as ``.vtp`` PolyData), the
JAX package's text line for line.  The derived fields (principal stress,
heat flux, melting) are computed with PyTorch in float64 on ``device``:
the card by default, as ``Simulation`` defaults to it; the invariants and
the text stay numpy on the host.

    python -m dynearthsol_tpu_torch.postproc [-p] [-m] [--melting]
        [--heatflux] [--device cpu|cuda] modelname [start [end [delta]]]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .constants import BOUNDZ1
from .io.tagged import TaggedReader
from .utils import f64, resolve_device

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


EIGH_BLOCK = 30720  # 3x3 matrices per batched eigh call


def _h5py():
    import h5py

    return h5py


class OutputReader:
    """Read a run's output (this package's or the reference's): ``.info``
    and the frames, binary or VTKHDF (``format``: "binary" or "hdf5",
    from the first frame's name)."""

    def __init__(self, modelname: str):
        self.modelname = modelname
        info = np.loadtxt(modelname + ".info", ndmin=2)
        self.frames = info[:, 0].astype(int).tolist()
        self.steps = info[:, 1].astype(int).tolist()
        self.time = info[:, 2].tolist()
        self.nnode_list = info[:, 5].astype(int)
        self.nelem_list = info[:, 6].astype(int)
        fn = self._fn(self.frames[0])
        self.format = "hdf5" if fn.endswith(".vtkhdf") else "binary"
        if self.format == "binary":
            with TaggedReader(fn) as r:
                self.ndims = r.ndims
        else:
            with _h5py().File(fn) as f:
                self.ndims = int(f.attrs["ndims"])
        self.nstr = self.ndims * (self.ndims + 1) // 2

    def _fn(self, frame: int) -> str:
        base = f"{self.modelname}.save.{frame:06d}"
        return base if os.path.exists(base) else base + ".vtkhdf"

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
        fn = self._fn(frame)
        if self.format == "hdf5":
            with _h5py().File(fn) as f:
                return f[name][:]
        dtype, shape = self._shape(frame, name)
        with TaggedReader(fn) as r:
            return r.read_array(name, dtype,
                                int(np.prod(shape))).reshape(shape)

    def has_field(self, frame: int, name: str) -> bool:
        fn = self._fn(frame)
        if self.format == "hdf5":
            with _h5py().File(fn) as f:
                return name in f
        with TaggedReader(fn) as r:
            return r.has_array(name)

    def read_markers(self, frame: int, markername: str = "markerset"):
        fn = self._fn(frame)
        out = {}
        if self.format == "hdf5":
            with _h5py().File(fn) as f:
                for k in f:
                    if k.startswith(markername):
                        out[k] = f[k][:]
                n = out[f"{markername}.elem"].shape[0]
        else:
            with TaggedReader(fn) as r:
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
    """Mean of the diagonal of a flattened symmetric tensor
    (2vtk.py:705-708)."""
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


def compute_principal_stress(stress, device=None):
    """Principal deviatoric stress directions s1/s3 as 3-vectors
    (2vtk.py:726-779), float64 tensors (nelem, 3) on ``device``.  2D:
    closed-form rotation; 3D: batched eigh, whose eigenvector signs (and
    the vectors of a degenerate pair) are arbitrary, as numpy's are."""
    dev = resolve_device(device, stress)
    stress = f64(stress, dev)
    nelem, nstr = stress.shape
    if nstr == 3:  # 2D
        sxx, szz, sxz = stress[:, 0], stress[:, 1], stress[:, 2]
        mag = torch.sqrt(0.25 * (sxx - szz) ** 2 + sxz ** 2)
        theta = 0.5 * torch.atan2(2 * sxz, sxx - szz)
        cost, sint = torch.cos(theta), torch.sin(theta)
        s1 = torch.zeros((nelem, 3), dtype=torch.float64, device=dev)
        s3 = torch.zeros_like(s1)
        s1[:, 0] = mag * sint
        s1[:, 1] = mag * cost
        s3[:, 0] = mag * cost
        s3[:, 1] = -mag * sint
        return s1, s3
    i, j = (torch.tensor(v, device=dev)
            for v in ([0, 1, 2, 0, 1, 0, 2, 1, 2],
                      [0, 1, 2, 1, 0, 2, 0, 2, 1]))
    s = torch.zeros((nelem, 3, 3), dtype=torch.float64, device=dev)
    s[:, i, j] = stress[:, [0, 1, 2, 3, 3, 4, 4, 5, 5]]
    # in blocks: cuSOLVER's batched eigh (cusolverDnXsyevBatched) refuses
    # 32,767 matrices and more in one call with CUSOLVER_STATUS_INVALID_VALUE
    # and takes 30,720, the largest block tried that it takes and the
    # fastest (H100, torch 2.11 with CUDA 12.8; tools/eigh_block_probe.py)
    w = torch.empty((nelem, 3), dtype=torch.float64, device=dev)
    v = torch.empty_like(s)
    for k in range(0, nelem, EIGH_BLOCK):
        w[k:k + EIGH_BLOCK], v[k:k + EIGH_BLOCK] = torch.linalg.eigh(
            s[k:k + EIGH_BLOCK])
    m = w.sum(dim=1) / 3.0
    idx = torch.arange(nelem, device=dev)
    p = w.argmin(dim=1)
    t = w.argmax(dim=1)
    s1 = (w[idx, p] - m)[:, None] * v[idx, :, p]
    s3 = (w[idx, t] - m)[:, None] * v[idx, :, t]
    return s1, s3


def compute_heat_flux(coord, conn, temperature, conductivity=3.3,
                      device=None):
    """Per-element conductive heat flux (Dynearthsol.py:158-179, the
    2vtk.py output_heatflux field; default conductivity 2vtk.py:62).

    The reference builds the (x, z, T) plane normal with cross products;
    that construction reduces algebraically to the P1 temperature
    gradient, so compute it directly (works in 2D and 3D):

      flux   = -1e3 * k * grad(T)   [mW/m^2]
      magnitude = 1e3 * k * |grad(T)|

    Returns float64 tensors on ``device``: (flux (nelem, ndims),
    magnitude (nelem,))."""
    dev = resolve_device(device, coord, temperature)
    coord, temperature = f64(coord, dev), f64(temperature, dev)
    conn = torch.as_tensor(conn, device=dev).long()
    p = coord[conn]                      # (nelem, npe, ndims)
    t = temperature[conn]                # (nelem, npe)
    # edge matrix E rows = x_i - x_last; dT rows = T_i - T_last;
    # grad solves E @ g = dT per element
    E = p[:, :-1, :] - p[:, -1:, :]      # (nelem, ndims, ndims)
    dT = t[:, :-1] - t[:, -1:]           # (nelem, ndims)
    grad = torch.linalg.solve(E, dT[..., None])[..., 0]
    flux = -1.0e3 * conductivity * grad
    mag = 1.0e3 * conductivity * torch.linalg.vector_norm(grad, dim=1)
    return flux, mag


def compute_melting(coord, conn, temperature, material, bcflag,
                    topmask_bit=32, device=None):
    """Peridotite-solidus melting indicator (2vtk.py:173-198): positive
    where the element-mean temperature exceeds the depth-corrected
    solidus; -1000 for non-mantle (material >= 2) elements.  A float64
    tensor on ``device``.  The surface profile is interpolated on the host
    with np.argsort and np.interp over the top nodes, as in the JAX
    package: in 3D the top nodes repeat x values, and which of them
    np.interp reads is numpy's order, kept here."""
    dev = resolve_device(device, coord, temperature)
    coord_h = np.asarray(coord.cpu() if torch.is_tensor(coord) else coord,
                         dtype=np.float64)
    bcflag = np.asarray(bcflag.cpu() if torch.is_tensor(bcflag) else bcflag)
    coord, temperature = f64(coord_h, dev), f64(temperature, dev)
    conn = torch.as_tensor(conn, device=dev).long()
    ecoord = coord[conn].mean(dim=1)
    etemp = temperature[conn].mean(dim=1)
    top = (bcflag.astype(np.int64) & BOUNDZ1) != 0
    sx, sz = coord_h[top, 0], coord_h[top, -1]
    order = np.argsort(sx)
    zi = np.interp(ecoord[:, 0].cpu().numpy(), sx[order], sz[order])
    depth = f64(zi, dev) - ecoord[:, -1]
    pressure = depth * 9.8 * 2900.0
    melt = (etemp - 273.0 + depth * 3.0e-4) \
        - (1120.0 + (680.0 / 7.0e9) * pressure)
    mantle = f64(material, dev) < 2
    return torch.where(mantle, melt, torch.full_like(melt, -1000.0))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _savetxt(f, a, fmt: str = "%.10g"):
    """np.savetxt(f, a, fmt=fmt), the same text: one row of ``fmt``s
    joined by spaces per line (a 1-D array as a column), formatted 65,536
    lines at a time rather than line by line (3-5x faster on the host)."""
    a = np.asarray(a)
    if a.ndim == 1:
        a = a[:, None]
    line = " ".join([fmt] * a.shape[1]) + "\n"
    rows = 1 << 16
    for i in range(0, len(a), rows):
        blk = a[i:i + rows]
        f.write((line * len(blk)) % tuple(blk.ravel().tolist()))


def to_vtk(modelname: str, frame: int, outpath: str | None = None,
           principal: bool = False, melting: bool = False,
           heatflux: bool = False, conductivity: float = 3.3,
           device=None) -> str:
    """Convert one frame to a legacy ASCII .vtk file with derived fields
    (the 2vtk.py role; ``principal``/``melting``/``heatflux`` mirror its
    -p, output_melting, and output_heatflux switches; those fields are
    computed on ``device``, the card by default)."""
    r = OutputReader(modelname)
    coord = r.read_field(frame, "coordinate")
    conn = r.read_field(frame, "connectivity")
    nnode, ndims = coord.shape
    nelem, npe = conn.shape

    outpath = outpath or f"{modelname}.{frame:06d}.vtk"
    with open(outpath, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write(f"DynEarthSol-TPU frame {frame}\nASCII\n")
        f.write("DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {nnode} double\n")
        p3 = np.zeros((nnode, 3))
        p3[:, :ndims] = coord
        _savetxt(f, p3, fmt="%.10g")
        f.write(f"\nCELLS {nelem} {nelem * (npe + 1)}\n")
        cells = np.concatenate(
            [np.full((nelem, 1), npe, dtype=np.int64), conn], axis=1)
        _savetxt(f, cells, fmt="%d")
        ctype = 5 if ndims == 2 else 10
        f.write(f"\nCELL_TYPES {nelem}\n")
        _savetxt(f, np.full(nelem, ctype, dtype=np.int64), fmt="%d")

        f.write(f"\nPOINT_DATA {nnode}\n")
        for name in ("temperature", "pore pressure"):
            if r.has_field(frame, name):
                f.write(f"SCALARS {name.replace(' ', '_')} double 1\n"
                        "LOOKUP_TABLE default\n")
                _savetxt(f, r.read_field(frame, name), fmt="%.10g")
        if r.has_field(frame, "velocity"):
            vel = r.read_field(frame, "velocity")
            v3 = np.zeros((nnode, 3))
            v3[:, :ndims] = vel
            f.write("VECTORS velocity double\n")
            _savetxt(f, v3, fmt="%.10g")
        if r.has_field(frame, "coord0"):
            # total displacement + initial-elevation horizon (2vtk.py:116-124)
            coord0 = r.read_field(frame, "coord0")
            d3 = np.zeros((nnode, 3))
            d3[:, :ndims] = coord - coord0
            f.write("VECTORS total_displacement double\n")
            _savetxt(f, d3, fmt="%.10g")
            f.write("SCALARS horizon double 1\nLOOKUP_TABLE default\n")
            _savetxt(f, coord0[:, -1], fmt="%.10g")

        f.write(f"\nCELL_DATA {nelem}\n")
        for name in ("plastic strain", "viscosity", "density", "material",
                     "mesh quality"):
            if r.has_field(frame, name):
                f.write(f"SCALARS {name.replace(' ', '_')} double 1\n"
                        "LOOKUP_TABLE default\n")
                _savetxt(f, r.read_field(frame, name), fmt="%.10g")
        # derived invariants + effective viscosity (2vtk.py:126-170)
        invariants = {}
        for name in ("stress", "strain-rate", "strain"):
            if r.has_field(frame, name):
                t = r.read_field(frame, name)
                invariants[name] = second_invariant(t)
                f.write(f"SCALARS {name.replace('-', '_')}_II double 1\n"
                        "LOOKUP_TABLE default\n")
                _savetxt(f, invariants[name], fmt="%.10g")
                f.write(f"SCALARS {name.replace('-', '_')}_I double 1\n"
                        "LOOKUP_TABLE default\n")
                _savetxt(f, first_invariant(t), fmt="%.10g")
        if "stress" in invariants and "strain-rate" in invariants:
            effvisc = invariants["stress"] / (invariants["strain-rate"]
                                              + 1e-45)
            f.write("SCALARS effective_viscosity double 1\n"
                    "LOOKUP_TABLE default\n")
            _savetxt(f, effvisc, fmt="%.10g")
        if principal and r.has_field(frame, "stress"):
            s1, s3 = compute_principal_stress(r.read_field(frame, "stress"),
                                              device)
            for nm, v in (("s1", s1), ("s3", s3)):
                f.write(f"VECTORS {nm} double\n")
                _savetxt(f, _host(v), fmt="%.10g")
        if melting and r.has_field(frame, "material") \
                and r.has_field(frame, "temperature") \
                and r.has_field(frame, "bcflag"):
            melt = compute_melting(coord, conn,
                                   r.read_field(frame, "temperature"),
                                   r.read_field(frame, "material"),
                                   r.read_field(frame, "bcflag"),
                                   device=device)
            f.write("SCALARS melting double 1\nLOOKUP_TABLE default\n")
            _savetxt(f, _host(melt), fmt="%.10g")
        if heatflux and r.has_field(frame, "temperature"):
            flux, fmag = compute_heat_flux(
                coord, conn, r.read_field(frame, "temperature"),
                conductivity, device)
            flux, fmag = _host(flux), _host(fmag)
            # per-component scalars + magnitude (2vtk.py:337-344 layout)
            names = ("heat_flux_x", "heat_flux_z") if ndims == 2 else \
                ("heat_flux_x", "heat_flux_y", "heat_flux_z")
            for j, nm in enumerate(names):
                f.write(f"SCALARS {nm} double 1\nLOOKUP_TABLE default\n")
                _savetxt(f, flux[:, j], fmt="%.10g")
            f.write("SCALARS heat_flux_magnitude double 1\n"
                    "LOOKUP_TABLE default\n")
            _savetxt(f, fmag, fmt="%.10g")
    return outpath


def to_vtp(modelname: str, frame: int, outpath: str | None = None,
           markersetname: str = "markerset") -> str | None:
    """Marker set -> ParaView .vtp PolyData (the 2vtk.py -m role,
    2vtk.py:524-600).  Returns None when the frame has no markers."""
    r = OutputReader(modelname)
    md = r.read_markers(frame, markersetname)
    n = int(md.get("size", 0))
    if n <= 0:
        return None
    outpath = outpath or f"{modelname}.{markersetname}.{frame:06d}.vtp"

    def arr(f, data, name, dtype="Float64", ncomp=1):
        f.write(f'  <DataArray type="{dtype}" Name="{name}" '
                f'NumberOfComponents="{ncomp}" format="ascii">\n')
        _savetxt(f, np.asarray(data).reshape(n, -1), fmt="%.10g")
        f.write("  </DataArray>\n")

    with open(outpath, "w") as f:
        f.write('<?xml version="1.0"?>\n'
                '<VTKFile type="PolyData" version="0.1" '
                'byte_order="LittleEndian">\n<PolyData>\n'
                f'<Piece NumberOfPoints="{n}" NumberOfVerts="0" '
                'NumberOfLines="0" NumberOfStrips="0" '
                'NumberOfPolys="0">\n')
        f.write("  <PointData>\n")
        for suffix, dtype in ((".mattype", "Int32"), (".elem", "Int32"),
                              (".id", "Int32"), (".time", "Float64"),
                              (".z", "Float64"), (".distance", "Float64"),
                              (".slope", "Float64")):
            key = markersetname + suffix
            if key in md:
                arr(f, md[key], key, dtype)
        f.write("  </PointData>\n  <Points>\n")
        coord = np.asarray(md[markersetname + ".coord"])
        p3 = np.zeros((n, 3))
        p3[:, :coord.shape[1]] = coord
        arr(f, p3, "coordinate", ncomp=3)
        f.write("  </Points>\n</Piece>\n</PolyData>\n</VTKFile>\n")
    return outpath


def main(argv=None):
    """CLI: convert output frames to legacy VTK (the 2vtk.py workflow,
    2vtk.py:829-889).

    usage: python -m dynearthsol_tpu_torch.postproc [-p] [-m] [--melting]
           [--heatflux] [--device cpu|cuda] modelname [start [end [delta]]]

    -p         save principal deviatoric stress vectors s1/s3 (2vtk -p)
    -m         save marker data as .vtp PolyData (2vtk -m)
    --melting  save the peridotite-solidus melting indicator
    --heatflux save the conductive heat-flux components + magnitude
               (2vtk output_heatflux)
    --device   where the derived fields are computed: the card ("cuda",
               the default; without one the CLI fails) or "cpu"
    """
    import sys as _sys

    argv = list(_sys.argv[1:] if argv is None else argv)
    device = "cuda"
    for i, a in enumerate(argv):
        if a == "--device" and i + 1 < len(argv):
            device = argv[i + 1]
            del argv[i:i + 2]
            break
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
            del argv[i]
            break
    if device not in ("cuda", "cpu"):
        print(f"--device must be cuda or cpu, not {device!r}",
              file=_sys.stderr)
        return 2
    principal = "-p" in argv
    melting = "--melting" in argv
    heatflux = "--heatflux" in argv
    markers = "-m" in argv
    argv = [a for a in argv
            if a not in ("-p", "-m", "--melting", "--heatflux")]
    if not argv or argv[0] in ("-h", "--help"):
        print(main.__doc__)
        return 0 if argv else 1
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the derived fields are computed on the CUDA device by default "
            "and none is available; pass --device cpu")
    modelname = argv[0]
    frames = sorted(OutputReader(modelname).frames)
    start = int(argv[1]) if len(argv) > 1 else 0
    end = int(argv[2]) if len(argv) > 2 else (frames[-1] if frames else -1)
    delta = int(argv[3]) if len(argv) > 3 else 1
    n = 0
    for fr in range(start, end + 1, delta):
        if frames and fr not in frames:
            continue
        path = to_vtk(modelname, fr, principal=principal, melting=melting,
                      heatflux=heatflux, device=device)
        print(f"frame {fr} -> {path}")
        if markers:
            vtp = to_vtp(modelname, fr)
            if vtp:
                print(f"frame {fr} -> {vtp}")
        n += 1
    print(f"{n} frames converted")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
