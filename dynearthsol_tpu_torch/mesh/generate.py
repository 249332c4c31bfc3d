"""Host-side mesh generation (counterpart of
dynearthsol_tpu/mesh/generate.py).

The reference dispatches on ``meshing_option`` (mesh.cxx:3407-3453): 1 =
uniform-resolution box, 2 = refined-zone box, 90/91 = .poly file
(mesh/poly.py, mesh/poly3.py), 95 = Exodus (mesh/exo.py); and on
``meshing_elem_shape``: 0 = unstructured, 1 = structured regular grid split
into simplices, 2 = structured equilateral grid (2D; the regular grid in
3D).  The unstructured meshes are a Delaunay triangulation or
tetrahedralization (scipy.spatial, Qhull) of boundary points plus
deterministically jittered or thinned interior points, refined to the
minimum angle (2D) or the radius-edge ratio (3D) and renumbered along the
longest axis, point for point as the JAX package builds them.  Domain
convention matches the reference: x in [0, xlength], y in [0, ylength]
(3D), z in [-zlength, 0] with the free surface at z = 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MeshData:
    """A simplicial mesh: coords (nnode, ndims) f64, connectivity
    (nelem, ndims+1) int32, with positively-oriented elements.
    ``regattr`` carries per-element regional mattypes of .poly and Exodus
    meshes (mesh.cxx:2577-2621)."""

    ndims: int
    coord: np.ndarray
    connectivity: np.ndarray
    regattr: np.ndarray = None
    # explicit segments and their flags (Exodus side sets, the 3D .poly
    # facets, the kept internal segments of a 2D .poly); where present the
    # topology is built from them instead of box coordinate tests
    segment: np.ndarray = None
    segflag: np.ndarray = None

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


def regular_grid_2d(xlength: float, zlength: float, resolution: float,
                    equilateral: bool = False) -> MeshData:
    """Structured box mesh (meshing_elem_shape 1, or 2 with
    ``equilateral``; cf. mesh.cxx:120-744).  Cell (i, j) holds two
    triangles whose diagonal alternates with the parity of i + j; the
    element order is cell-major (i, then j, then the triangle).  The
    equilateral grid shifts alternate rows by a quarter spacing each way
    (the side walls stay straight), so it is not a raster."""
    nx = int(round(xlength / resolution)) + 1
    nz = int(round(zlength / resolution)) + 1
    xs = np.linspace(0.0, xlength, nx)
    zs = np.linspace(-zlength, 0.0, nz)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    if equilateral:
        dx = xs[1] - xs[0]
        X = X + 0.25 * dx * (1 - 2 * (np.arange(nz)[None, :] % 2))
        X[0, :] = 0.0
        X[-1, :] = xlength
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
    coord, _, _, _ = refine_min_angle(
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


def _spacing_fn(refined_lo, refined_hi, res, res_max, grade=0.3):
    """Target node spacing h(p): ``res`` inside the refined box, growing
    at slope ``grade`` with the distance to it, capped at ``res_max`` (the
    contract of new_mesh_refined_zone with Triangle's max-area grading,
    mesh.cxx:1618-1846)."""
    lo = np.asarray(refined_lo)
    hi = np.asarray(refined_hi)

    def h(p):
        d = np.maximum(np.maximum(lo - p, p - hi), 0.0)
        dist = np.sqrt((d * d).sum(axis=-1))
        return np.minimum(res + grade * dist, res_max)

    return h


def _graded_points_1d(lo, hi, h, coords_fn):
    """Walk [lo, hi] with spacing h(position); always ends exactly at
    hi."""
    pts = [lo]
    while pts[-1] < hi:
        pts.append(pts[-1] + h(coords_fn(pts[-1])))
    pts = np.asarray(pts)
    return lo + (pts - lo) * (hi - lo) / (pts[-1] - lo)


def refined_zone_box_2d(param) -> MeshData:
    """Refined-zone box (meshing_option 2, mesh.cxx:1618-1846): node
    spacing ``resolution`` inside the refined sub-box, graded up to
    resolution * sqrt(largest_size) outside; a thinned lattice with a
    seeded generator, refined to the minimum angle, then Delaunay."""
    m = param.mesh
    Lx, Lz = m.xlength, m.zlength
    res = m.resolution
    res_max = res * np.sqrt(m.largest_size)
    x0, x1 = (np.clip(v, res / Lx, 1 - res / Lx) for v in m.refined_zonex)
    z0, z1 = (np.clip(v, res / Lz, 1 - res / Lz) for v in m.refined_zonez)
    # refined box in physical coords (z in [-Lz, 0], zone measured from top)
    lo = np.array([x0 * Lx, -z1 * Lz])
    hi = np.array([x1 * Lx, -z0 * Lz])
    h = _spacing_fn(lo, hi, res, res_max)
    rng = np.random.default_rng(12345)

    pts = []
    # boundary: graded 1D walks along the four edges
    for z in (0.0, -Lz):
        xs = _graded_points_1d(0.0, Lx, h, lambda x, z=z: np.array([x, z]))
        pts.extend((x, z) for x in xs)
    for x in (0.0, Lx):
        zs = _graded_points_1d(-Lz, 0.0, h, lambda z, x=x: np.array([x, z]))
        pts.extend((x, z) for z in zs[1:-1])
    # interior: fine lattice thinned by keep-probability (res/h)^2
    nx = int(round(Lx / res)) + 1
    nz = int(round(Lz / res)) + 1
    xs = np.linspace(0.0, Lx, nx)[1:-1]
    zs = np.linspace(-Lz, 0.0, nz)[1:-1]
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    P = np.stack([X.ravel(), Z.ravel()], axis=1)
    keep = rng.random(P.shape[0]) < (res / h(P)) ** 2
    inner = P[keep]
    inner = inner + 0.35 * res * (rng.random(inner.shape) - 0.5)
    # keep interior points away from the graded boundary
    margin = 0.55 * h(inner)
    ok = ((inner[:, 0] > margin) & (inner[:, 0] < Lx - margin)
          & (inner[:, 1] > -Lz + margin) & (inner[:, 1] < -margin))
    coord = np.concatenate([np.asarray(pts, dtype=np.float64),
                            inner[ok]], axis=0)
    coord = _refine_box_2d(
        coord, Lx, Lz, m.min_angle,
        area_floor=m.smallest_size * (np.sqrt(3.0) / 4.0) * res**2)

    from scipy.spatial import Delaunay

    tri = Delaunay(coord, qhull_options="Qbb Qc Qz")
    conn = _drop_degenerate_2d(coord, tri.simplices.astype(np.int32))
    return MeshData(2, coord, _orient_2d(coord, conn))


def refined_zone_box_3d(param) -> MeshData:
    """3D refined-zone box (mesh.cxx:1618-1846, THREED branch): the box
    lattice thinned to the graded spacing (the interior by (res/h)^3, the
    faces by (res/h)^2, the edges kept), radius-edge refined, then
    Delaunay."""
    m = param.mesh
    Lx, Ly, Lz = m.xlength, m.ylength, m.zlength
    res = m.resolution
    res_max = res * m.largest_size ** (1.0 / 3.0)
    x0, x1 = (np.clip(v, res / Lx, 1 - res / Lx) for v in m.refined_zonex)
    y0, y1 = (np.clip(v, res / Ly, 1 - res / Ly) for v in m.refined_zoney)
    z0, z1 = (np.clip(v, res / Lz, 1 - res / Lz) for v in m.refined_zonez)
    lo = np.array([x0 * Lx, y0 * Ly, -z1 * Lz])
    hi = np.array([x1 * Lx, y1 * Ly, -z0 * Lz])
    h = _spacing_fn(lo, hi, res, res_max)
    rng = np.random.default_rng(12345)

    nx = int(round(Lx / res)) + 1
    ny = int(round(Ly / res)) + 1
    nz = int(round(Lz / res)) + 1
    xs = np.linspace(0.0, Lx, nx)
    ys = np.linspace(0.0, Ly, ny)
    zs = np.linspace(-Lz, 0.0, nz)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    P = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    on_bnd = ((P[:, 0] == 0) | (P[:, 0] == Lx) | (P[:, 1] == 0)
              | (P[:, 1] == Ly) | (P[:, 2] == -Lz) | (P[:, 2] == 0))
    keep = rng.random(P.shape[0]) < (res / h(P)) ** 3
    keep_b = rng.random(P.shape[0]) < (res / h(P)) ** 2
    corner = (np.isin(P[:, 0], (0.0, Lx)).astype(int)
              + np.isin(P[:, 1], (0.0, Ly)).astype(int)
              + np.isin(P[:, 2], (-Lz, 0.0)).astype(int)) >= 2
    sel = np.where(on_bnd, keep_b | corner, keep)
    coord = P[sel].copy()
    inner = ~on_bnd[sel]
    coord[inner] += 0.25 * res * (rng.random((inner.sum(), 3)) - 0.5)
    coord = _refine_box_3d(
        coord, Lx, Ly, Lz, m.max_ratio,
        vol_floor=m.smallest_size * (np.sqrt(2.0) / 12.0) * res**3)

    from scipy.spatial import Delaunay

    tet = Delaunay(coord, qhull_options="Qbb Qc Qz")
    conn = tet.simplices.astype(np.int32)
    a = coord[conn[:, 0]]
    vol6 = np.abs(np.einsum(
        "ij,ij->i", coord[conn[:, 1]] - a,
        np.cross(coord[conn[:, 2]] - a, coord[conn[:, 3]] - a)))
    conn = conn[vol6 > 1e-12 * vol6.max()]
    return MeshData(3, coord, _orient_3d(coord, conn))


def _renumber_perms(coord: np.ndarray, conn: np.ndarray):
    """(node order, its inverse, element order) along the mesh's longest
    axis: nodes by coordinate, elements by centroid, both stable."""
    lengths = coord.max(axis=0) - coord.min(axis=0)
    ax = int(np.argmax(lengths))
    perm = np.argsort(coord[:, ax], kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    conn2 = inv[conn.astype(np.int64)].astype(conn.dtype)
    cent = coord[perm][conn2].mean(axis=1)[:, ax]
    return perm, inv, np.argsort(cent, kind="stable")


def renumber_mesh(coord: np.ndarray, conn: np.ndarray,
                  bcflag: np.ndarray = None):
    """Sort nodes, and elements by centroid, along the mesh's longest axis
    for memory locality (renumbering_mesh, mesh.cxx:2675-2795): neighbouring
    threads of the gather and assembly kernels then touch neighbouring
    nodes.  Returns (coord, conn, bcflag) with the permutations applied
    (a None ``bcflag`` passes through)."""
    perm, inv, eperm = _renumber_perms(coord, conn)
    conn2 = inv[conn.astype(np.int64)].astype(conn.dtype)
    return (coord[perm], conn2[eperm],
            None if bcflag is None else bcflag[perm])


def _renumbered(md: MeshData) -> MeshData:
    """``md`` renumbered (renumber_mesh), its regional attributes and
    segments carried along."""
    perm, inv, eperm = _renumber_perms(md.coord, md.connectivity)
    conn = inv[md.connectivity.astype(np.int64)].astype(
        md.connectivity.dtype)[eperm]
    return MeshData(
        md.ndims, md.coord[perm], conn,
        regattr=None if md.regattr is None else md.regattr[eperm],
        segment=(None if md.segment is None
                 else inv[md.segment.astype(np.int64)].astype(np.int32)),
        segflag=md.segflag)


def create_new_mesh(param) -> MeshData:
    """Dispatch like mesh.cxx:3407-3453 ``create_new_mesh``."""
    m = param.mesh
    ndims = param.sim.ndims
    if m.meshing_option in (90, 91):
        if ndims == 3:
            from .poly3 import mesh_from_poly_3d

            return _renumbered(mesh_from_poly_3d(param))
        from .poly import mesh_from_poly_2d

        return _renumbered(mesh_from_poly_2d(param))
    if m.meshing_option == 95:
        from .exo import mesh_from_exofile

        return mesh_from_exofile(param)
    if m.meshing_option not in (1, 2):
        raise NotImplementedError(
            f"meshing_option {m.meshing_option} is not a mesher of the "
            "reference's (1 box, 2 refined-zone box, 90/91 .poly, 95 "
            "Exodus)")
    if m.meshing_option == 2 and m.meshing_elem_shape == 0:
        return _renumbered(refined_zone_box_2d(param) if ndims == 2
                           else refined_zone_box_3d(param))
    if ndims == 2:
        if m.meshing_elem_shape in (1, 2):
            return regular_grid_2d(m.xlength, m.zlength, m.resolution,
                                   equilateral=m.meshing_elem_shape == 2)
        return _renumbered(
            unstructured_box_2d(m.xlength, m.zlength, m.resolution,
                                min_angle=m.min_angle,
                                smallest_size=m.smallest_size))
    if m.meshing_elem_shape in (1, 2):
        return regular_grid_3d(m.xlength, m.ylength, m.zlength, m.resolution)
    return _renumbered(
        unstructured_box_3d(m.xlength, m.ylength, m.zlength,
                            m.resolution, max_ratio=m.max_ratio,
                            smallest_size=m.smallest_size))
