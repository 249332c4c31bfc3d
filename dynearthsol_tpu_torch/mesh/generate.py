"""Host-side mesh generation for structured box domains (counterpart of
dynearthsol_tpu/mesh/generate.py).

The reference dispatches on ``meshing_option`` (mesh.cxx:3407-3453) and
``meshing_elem_shape``.  This package generates the structured regular grids
(``meshing_option`` 1, ``meshing_elem_shape`` 1) in 2D and 3D; the other
meshers are not ported yet.  Domain convention matches the reference: x in
[0, xlength], y in [0, ylength] (3D), z in [-zlength, 0] with the free
surface at z = 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MeshData:
    """A simplicial mesh: coords (nnode, ndims) f64, connectivity
    (nelem, ndims+1) int32, with positively-oriented elements."""

    ndims: int
    coord: np.ndarray
    connectivity: np.ndarray
    regattr: np.ndarray = None

    @property
    def nnode(self) -> int:
        return self.coord.shape[0]

    @property
    def nelem(self) -> int:
        return self.connectivity.shape[0]


def _orient_2d(coord: np.ndarray, conn: np.ndarray) -> np.ndarray:
    """Flip triangles to counter-clockwise (positive area)."""
    a, b, c = coord[conn[:, 0]], coord[conn[:, 1]], coord[conn[:, 2]]
    area2 = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - \
            (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    flip = area2 < 0
    conn = conn.copy()
    conn[flip, 1], conn[flip, 2] = conn[flip, 2].copy(), conn[flip, 1].copy()
    return conn


def _orient_3d(coord: np.ndarray, conn: np.ndarray) -> np.ndarray:
    """Flip tets to positive volume (same sign convention as
    geometry.cxx:35-106 tetrahedron_volume)."""
    a = coord[conn[:, 0]]
    d1 = coord[conn[:, 1]] - a
    d2 = coord[conn[:, 2]] - a
    d3 = coord[conn[:, 3]] - a
    vol6 = np.einsum("ij,ij->i", d1, np.cross(d2, d3))
    flip = vol6 < 0
    conn = conn.copy()
    conn[flip, 2], conn[flip, 3] = conn[flip, 3].copy(), conn[flip, 2].copy()
    return conn


def regular_grid_2d(xlength: float, zlength: float,
                    resolution: float) -> MeshData:
    """Structured box mesh (meshing_elem_shape 1; cf. mesh.cxx regular grid
    generator at mesh.cxx:120-744).  Cell (i, j) holds two triangles whose
    diagonal alternates with the parity of i + j; the element order is
    cell-major (i, then j, then the triangle)."""
    nx = int(round(xlength / resolution)) + 1
    nz = int(round(zlength / resolution)) + 1
    xs = np.linspace(0.0, xlength, nx)
    zs = np.linspace(-zlength, 0.0, nz)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    coord = np.stack([X.ravel(), Z.ravel()], axis=1)

    i, j = np.meshgrid(np.arange(nx - 1), np.arange(nz - 1), indexing="ij")
    n00 = i * nz + j
    n10 = (i + 1) * nz + j
    n01 = i * nz + (j + 1)
    n11 = (i + 1) * nz + (j + 1)
    even = (i + j) % 2 == 0  # alternate diagonals for isotropy
    t0 = np.stack([n00, n10, np.where(even, n11, n01)], axis=-1)
    t1 = np.stack([np.where(even, n00, n10), n11, n01], axis=-1)
    conn = np.stack([t0, t1], axis=2).reshape(-1, 3).astype(np.int32)
    return MeshData(2, coord, _orient_2d(coord, conn))


# 5-tet decomposition of a cell before orientation, mirrored on the parity
# of i + j + k so that faces match between cells; corner code a*4 + b*2 + d
_TETS_EVEN = ((0, 1, 2, 4), (1, 2, 3, 7), (1, 4, 5, 7), (2, 4, 6, 7),
              (1, 2, 4, 7))
_TETS_ODD = ((0, 1, 3, 5), (0, 2, 3, 6), (0, 4, 5, 6), (3, 5, 6, 7),
             (0, 3, 5, 6))


def regular_grid_3d(xlength: float, ylength: float, zlength: float,
                    resolution: float) -> MeshData:
    """Structured 3D box split into 5 tets per cell (mesh.cxx structured
    path; ELEMS_PER_CELL = 5 in 3D, constants.hpp:21).  The element order
    is cell-major (i, then j, then k, then the tet), as the JAX package
    builds it cell by cell; here the cells are built all at once."""
    nx = int(round(xlength / resolution)) + 1
    ny = int(round(ylength / resolution)) + 1
    nz = int(round(zlength / resolution)) + 1
    xs = np.linspace(0.0, xlength, nx)
    ys = np.linspace(0.0, ylength, ny)
    zs = np.linspace(-zlength, 0.0, nz)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coord = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    i, j, k = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                          np.arange(nz - 1), indexing="ij")
    c = [((i + a) * ny + (j + b)) * nz + (k + d)
         for a in (0, 1) for b in (0, 1) for d in (0, 1)]
    even = (i + j + k) % 2 == 0
    conn = np.empty(even.shape + (5, 4), dtype=np.int32)
    for t in range(5):
        for s in range(4):
            conn[..., t, s] = np.where(even, c[_TETS_EVEN[t][s]],
                                       c[_TETS_ODD[t][s]])
    conn = conn.reshape(-1, 4)
    return MeshData(3, coord, _orient_3d(coord, conn))


def create_new_mesh(param) -> MeshData:
    """Dispatch like mesh.cxx:3407-3453 ``create_new_mesh``, for the
    meshers this package has."""
    m = param.mesh
    if not (m.meshing_option == 1 and m.meshing_elem_shape == 1):
        raise NotImplementedError(
            f"ndims {param.sim.ndims}, meshing_option {m.meshing_option}, "
            f"meshing_elem_shape {m.meshing_elem_shape}: only the "
            "structured box (meshing_option 1, meshing_elem_shape 1) is "
            "ported")
    if param.sim.ndims == 3:
        return regular_grid_3d(m.xlength, m.ylength, m.zlength,
                               m.resolution)
    return regular_grid_2d(m.xlength, m.zlength, m.resolution)
