"""Host-side mesh generation for box domains (counterpart of
dynearthsol_tpu/mesh/generate.py).

The reference dispatches on ``meshing_option`` (mesh.cxx:3407-3453) and
``meshing_elem_shape``.  This package generates, for ``meshing_option`` 1,
the structured regular grids (``meshing_elem_shape`` 1) in 2D and 3D and the
unstructured boxes (``meshing_elem_shape`` 0) in 2D and 3D: a Delaunay
triangulation or tetrahedralization (scipy.spatial, Qhull) of boundary
points plus deterministically jittered interior points, refined to the
minimum angle (2D) or the radius-edge ratio (3D) and renumbered along the
longest axis, point for point as the JAX package builds it.  The other
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


def _drop_degenerate_2d(coord, conn, tol_rel=1e-12):
    a, b, c = coord[conn[:, 0]], coord[conn[:, 1]], coord[conn[:, 2]]
    area2 = np.abs((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) -
                   (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))
    keep = area2 > tol_rel * max(area2.max(), 1.0)
    return conn[keep]


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


def _refine_box_2d(coord: np.ndarray, xlength: float, zlength: float,
                   min_angle: float, area_floor: float = 0.0) -> np.ndarray:
    """Ruppert min-angle refinement of a 2D box point set: the quality
    guarantee Triangle's `q` switch gives the reference at initial
    meshing (mesh.cxx:2577-2621 with mesh.min_angle, default 32).
    Returns the (possibly extended) coordinate array."""
    if min_angle <= 0:
        return coord
    from ..constants import BOUNDX0, BOUNDX1, BOUNDZ0, BOUNDZ1
    from .refine2d import box_inside_fn, refine_min_angle

    tol = 1e-9 * max(xlength, zlength)
    bcflag = np.zeros(coord.shape[0], dtype=np.uint32)
    bcflag[np.abs(coord[:, 0]) < tol] |= BOUNDX0
    bcflag[np.abs(coord[:, 0] - xlength) < tol] |= BOUNDX1
    bcflag[np.abs(coord[:, 1] + zlength) < tol] |= BOUNDZ0
    bcflag[np.abs(coord[:, 1]) < tol] |= BOUNDZ1
    surf = lambda x: np.zeros_like(np.asarray(x, dtype=float))
    bot = lambda x: np.full_like(np.asarray(x, dtype=float), -zlength)
    coord, _, _ = refine_min_angle(
        coord, bcflag, box_inside_fn(xlength, surf, bot),
        min_angle=min_angle, area_floor=area_floor)
    return coord


def unstructured_box_2d(xlength: float, zlength: float, resolution: float,
                        jitter: float = 0.35, seed: int = 12345,
                        min_angle: float = 32.0,
                        smallest_size: float = 0.01) -> MeshData:
    """Quasi-uniform unstructured triangulation of a box (replaces the
    Triangle path of mesh.cxx:1437-1616 ``new_mesh_uniform_resolution``).

    Boundary points lie exactly on the box edges with spacing = resolution;
    interior grid points get a deterministic jitter so that Delaunay gives
    an irregular mesh of good quality.  The generator is drawn from in the
    JAX package's order (x outer, z inner, jx before jz), so both packages
    place the same points.
    """
    rng = np.random.default_rng(seed)
    nx = max(2, int(round(xlength / resolution)) + 1)
    nz = max(2, int(round(zlength / resolution)) + 1)
    xs = np.linspace(0.0, xlength, nx)
    zs = np.linspace(-zlength, 0.0, nz)

    # boundary loop (corners included once)
    bnd = np.empty((2 * nx + 2 * (nz - 2), 2))
    bnd[0:2 * nx:2, 0] = bnd[1:2 * nx:2, 0] = xs
    bnd[0:2 * nx:2, 1] = -zlength
    bnd[1:2 * nx:2, 1] = 0.0
    bnd[2 * nx::2, 0] = 0.0
    bnd[2 * nx + 1::2, 0] = xlength
    bnd[2 * nx::2, 1] = bnd[2 * nx + 1::2, 1] = zs[1:-1]
    # jittered interior
    dx = xs[1] - xs[0]
    dz = zs[1] - zs[0]
    r = rng.random((nx - 2) * (nz - 2) * 2).reshape(nx - 2, nz - 2, 2)
    inner = np.stack([xs[1:-1, None] + jitter * dx * (r[..., 0] - 0.5),
                      zs[None, 1:-1] + jitter * dz * (r[..., 1] - 0.5)],
                     axis=-1).reshape(-1, 2)
    coord = np.concatenate([bnd, inner])
    coord = _refine_box_2d(
        coord, xlength, zlength, min_angle,
        area_floor=smallest_size * (np.sqrt(3.0) / 4.0) * resolution**2)

    from scipy.spatial import Delaunay

    tri = Delaunay(coord, qhull_options="Qbb Qc Qz")
    conn = _drop_degenerate_2d(coord, tri.simplices.astype(np.int32))
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


def _refine_box_3d(coord: np.ndarray, xlength: float, ylength: float,
                   zlength: float, max_ratio: float,
                   vol_floor: float = 0.0) -> np.ndarray:
    """Radius-edge Delaunay refinement of a 3D box point set: the quality
    guarantee TetGen's `q` switch gives the reference (set_3d_quality_str,
    mesh.cxx:745-757; mesh.max_ratio, default 2).  Returns the (possibly
    extended) coordinate array."""
    if max_ratio <= 0:
        return coord
    from .refine3d import (box_inside_fn_3d, box_project_fn_3d,
                           refine_radius_edge)

    surf = lambda x, y: np.zeros_like(np.asarray(x, dtype=float))
    bot = lambda x, y: np.full_like(np.asarray(x, dtype=float), -zlength)
    coord, _ = refine_radius_edge(
        coord, box_inside_fn_3d(xlength, ylength, surf, bot),
        max_ratio=max_ratio, vol_floor=vol_floor,
        project_fn=box_project_fn_3d(xlength, ylength, surf, bot))
    return coord


def unstructured_box_3d(xlength: float, ylength: float, zlength: float,
                        resolution: float, jitter: float = 0.25,
                        seed: int = 12345, max_ratio: float = 2.0,
                        smallest_size: float = 0.01) -> MeshData:
    """Unstructured 3D box (replaces the TetGen path, mesh.cxx:2586): a
    Delaunay tetrahedralization of the grid points at ``resolution``, the
    interior ones jittered by a seeded generator, refined to ``max_ratio``
    (TetGen's q), with the near-degenerate hull slivers dropped."""
    rng = np.random.default_rng(seed)
    nx = max(2, int(round(xlength / resolution)) + 1)
    ny = max(2, int(round(ylength / resolution)) + 1)
    nz = max(2, int(round(zlength / resolution)) + 1)
    xs = np.linspace(0.0, xlength, nx)
    ys = np.linspace(0.0, ylength, ny)
    zs = np.linspace(-zlength, 0.0, nz)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coord = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    interior = ((X > xs[0]) & (X < xs[-1]) & (Y > ys[0]) & (Y < ys[-1]) &
                (Z > zs[0]) & (Z < zs[-1])).ravel()
    d = np.array([xs[1] - xs[0], ys[1] - ys[0], zs[1] - zs[0]])
    coord[interior] += jitter * d * (rng.random((interior.sum(), 3)) - 0.5)
    coord = _refine_box_3d(
        coord, xlength, ylength, zlength, max_ratio,
        vol_floor=smallest_size * (np.sqrt(2.0) / 12.0) * resolution**3)

    from scipy.spatial import Delaunay

    tet = Delaunay(coord, qhull_options="Qbb Qc Qz")
    conn = tet.simplices.astype(np.int32)
    # drop near-degenerate slivers on the hull
    a = coord[conn[:, 0]]
    vol6 = np.abs(np.einsum(
        "ij,ij->i", coord[conn[:, 1]] - a,
        np.cross(coord[conn[:, 2]] - a, coord[conn[:, 3]] - a)))
    conn = conn[vol6 > 1e-12 * vol6.max()]
    return MeshData(3, coord, _orient_3d(coord, conn))


def renumber_mesh(coord: np.ndarray, conn: np.ndarray):
    """Sort nodes, and elements by centroid, along the mesh's longest axis
    for memory locality (renumbering_mesh, mesh.cxx:2675-2795): neighbouring
    threads of the gather and assembly kernels then touch neighbouring
    nodes.  Returns (coord, conn) with the permutations applied."""
    lengths = coord.max(axis=0) - coord.min(axis=0)
    ax = int(np.argmax(lengths))
    perm = np.argsort(coord[:, ax], kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    coord2 = coord[perm]
    conn2 = inv[conn.astype(np.int64)].astype(conn.dtype)
    cent = coord2[conn2].mean(axis=1)[:, ax]
    eperm = np.argsort(cent, kind="stable")
    return coord2, conn2[eperm]


def create_new_mesh(param) -> MeshData:
    """Dispatch like mesh.cxx:3407-3453 ``create_new_mesh``, for the
    meshers this package has."""
    m = param.mesh
    ndims = param.sim.ndims
    if m.meshing_option == 1 and m.meshing_elem_shape == 0:
        if ndims == 2:
            md = unstructured_box_2d(m.xlength, m.zlength, m.resolution,
                                     min_angle=m.min_angle,
                                     smallest_size=m.smallest_size)
        else:
            md = unstructured_box_3d(m.xlength, m.ylength, m.zlength,
                                     m.resolution, max_ratio=m.max_ratio,
                                     smallest_size=m.smallest_size)
        return MeshData(ndims, *renumber_mesh(md.coord, md.connectivity))
    if not (m.meshing_option == 1 and m.meshing_elem_shape == 1):
        raise NotImplementedError(
            f"ndims {ndims}, meshing_option {m.meshing_option}, "
            f"meshing_elem_shape {m.meshing_elem_shape}: only the box "
            "(meshing_option 1), structured (meshing_elem_shape 1) or "
            "unstructured (meshing_elem_shape 0), is ported")
    if ndims == 3:
        return regular_grid_3d(m.xlength, m.ylength, m.zlength,
                               m.resolution)
    return regular_grid_2d(m.xlength, m.zlength, m.resolution)
