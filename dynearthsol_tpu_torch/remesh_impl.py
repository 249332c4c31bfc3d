"""Remesh pipeline: regenerate the mesh, remap fields and markers, rebuild
the context and state (counterpart of dynearthsol_tpu/remesh_impl.py).

Reference: remesh() (remeshing.cxx:2855-3135) with
  - mesh regeneration on the deformed boundary, bottom/side flattening per
    remeshing_option (remeshing.cxx:110-505, 1109-1363),
  - SPR stress recovery elem->node on the old mesh and node->elem on the new
    (geometry.cxx:629-754) with pressure centering,
  - nearest-centroid element-field remap (nn-interpolation.cxx:16-75),
  - barycentric nodal-field remap (brc-interpolation.cxx:101-404),
  - marker remap + replenishment (markerset.cxx:1738-1863, 1148-1475).

All host-side numpy/scipy, as in the JAX package, from the same float64
host arrays, so both packages regenerate the same mesh and move the same
markers; the finalize (velocity BCs, masses, viscosity) runs on the run's
device.  Every regeneration of the JAX package is ported: in 2D the
unstructured re-triangulation of the kept points, the metric-driven point
sets and the structured columns, in 3D the surface-following 5-tet
columns (``generate_new_mesh_3d``) and the metric-driven Delaunay
(``generate_optimized_mesh_3d``), and remeshing_option 100's structured
regeneration in 2D and 3D; the markers and the hydrous markers of phase
changes are relocated on the new mesh.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay, cKDTree

from . import markers as mk
from .barycentric import bary_to_coord, random_barycentric
from .constants import (BOUNDX0, BOUNDX1, BOUNDY0, BOUNDY1, BOUNDZ0, BOUNDZ1,
                        IBOUNDZ1, dim)
from .ic import ref_pressure
from .mesh.generate import _orient_2d, _orient_3d
from .mesh.locate import ElementLocator
from .mesh.topology import finish_topology

# ---------------------------------------------------------------------------
# mesh regeneration on the deformed boundary
# ---------------------------------------------------------------------------

def _facet_area(coord, facets):
    """Facet measure: segment length (2D) / triangle area (3D)
    (compute_area_facet; used by the edvacc_surf per-area conversions,
    remeshing.cxx:2883-2891, 3050-3069)."""
    p = coord[facets]
    if facets.shape[1] == 2:
        return np.linalg.norm(p[:, 1] - p[:, 0], axis=1)
    return 0.5 * np.linalg.norm(
        np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=1)


def _surface_interp_2d(top_pts):
    order = np.argsort(top_pts[:, 0])
    xs, zs = top_pts[order, 0], top_pts[order, 1]

    def f(x):
        return np.interp(x, xs, zs)

    return f


def _surface_interp_3d(top_pts):
    from scipy.interpolate import LinearNDInterpolator, NearestNDInterpolator

    lin = LinearNDInterpolator(top_pts[:, :2], top_pts[:, 2])
    near = NearestNDInterpolator(top_pts[:, :2], top_pts[:, 2])

    def f(xy):
        z = lin(xy)
        bad = np.isnan(z)
        if bad.any():
            z[bad] = near(xy[bad])
        return z

    return f


def _flatten_bottom(param) -> bool:
    # remeshing options that reset the bottom to -zlength
    # (remeshing.cxx:110-391 new-bottom handling; options 1/2/11/13)
    return param.mesh.remeshing_option in (1, 2, 11, 13)


def reuse_points_2d(param, old_coord, old_topo, bad_quality,
                    old_volume):
    """Reference-parity point set for the uniform 2D regeneration
    (new_mesh, remeshing.cxx:1109-1260): KEEP the old nodes — the
    reference re-triangulates them with max_elem_size=-1 ("We don't want
    to refine large elements during remeshing", remeshing.cxx:1289) so
    refined-zone grading survives remeshing and nelem stays ~constant —
    with these mutations:

    * options 1/11/13: bottom nodes restored to z=-zlength; interior
      nodes within min_dist of the flat bottom deleted
      (flatten_bottom, remeshing.cxx:110-126)
    * option 13: x0/x1 sides likewise (flatten_x0/x1, :128-150)
    * bad_quality==3: interior nodes inside tiny elements deleted
      (find_points_of_tiny_elem, :524-576; we restrict deletion to
      interior nodes — the reference's boundary-point deletion for
      options 10-13 needs its polygon machinery and rarely fires)

    Returns (coord, bcflag) of the kept points."""
    m = param.mesh
    opt = m.remeshing_option
    coord = np.asarray(old_coord, dtype=np.float64).copy()
    bcflag = np.asarray(old_topo.bcflag, dtype=np.uint32).copy()
    from .remeshing import SIZEFACTOR_2D

    smallest_vol = m.smallest_size * SIZEFACTOR_2D * m.resolution ** 2
    min_dist = (m.smallest_size * SIZEFACTOR_2D) ** 0.5 * m.resolution
    bound_any = BOUNDX0 | BOUNDX1 | BOUNDZ0 | BOUNDZ1
    is_boundary = (bcflag & bound_any) != 0
    delete = np.zeros(len(coord), dtype=bool)

    if opt in (1, 2, 11, 13):
        onbot = (bcflag & BOUNDZ0) != 0
        coord[onbot, 1] = -m.zlength
        delete |= (~is_boundary
                   & (np.abs(coord[:, 1] + m.zlength) < min_dist))
    if opt == 13:
        onx0 = (bcflag & BOUNDX0) != 0
        coord[onx0, 0] = 0.0
        delete |= ~is_boundary & (coord[:, 0] < min_dist)
        onx1 = (bcflag & BOUNDX1) != 0
        coord[onx1, 0] = m.xlength
        delete |= ~is_boundary & (coord[:, 0] > m.xlength - min_dist)

    if bad_quality == 3:
        vols = np.asarray(old_volume, dtype=np.float64)
        tiny = np.where(vols < smallest_vol)[0]
        if tiny.size:
            conn = np.asarray(old_topo.connectivity)
            cand = np.where(~is_boundary & ~delete)[0]
            p = coord[cand]                          # (nc, 2)
            for e in tiny:
                a, b, c = coord[conn[e, 0]], coord[conn[e, 1]], \
                    coord[conn[e, 2]]
                d = (b[0] - a[0]) * (c[1] - a[1]) \
                    - (c[0] - a[0]) * (b[1] - a[1])
                if d == 0.0:
                    continue
                l1 = ((b[0] - p[:, 0]) * (c[1] - p[:, 1])
                      - (c[0] - p[:, 0]) * (b[1] - p[:, 1])) / d
                l2 = ((c[0] - p[:, 0]) * (a[1] - p[:, 1])
                      - (a[0] - p[:, 0]) * (c[1] - p[:, 1])) / d
                l3 = 1.0 - l1 - l2
                tol = -1e-8  # barycentric-fn.cxx is_inside tolerance
                inside = (l1 >= tol) & (l2 >= tol) & (l3 >= tol)
                delete[cand[inside]] = True

    keep = ~delete
    return coord[keep], bcflag[keep]


def sediment_refine_points(param, surf, markers, nelem, old_coord,
                           old_conn, old_volume):
    """Interior refinement seeds for oversized sediment-bearing surface
    elements (refine_surface_elem, remeshing.cxx:1028-1092): the
    midpoints between each surface node of the facet and the element's
    sub-surface node, so freshly deposited layers keep resolution
    through a remesh.  The reference only wires this in 2D (its 3D
    branch is 'todo', remeshing.cxx:1250); the same construction is
    dimension-generic, so 3D gets it too via the metric-path seeds."""
    ndims = old_coord.shape[1]
    if int(surf.etop) == 0 or markers is None:
        return np.zeros((0, ndims))
    from .remeshing import SIZEFACTOR_2D, SIZEFACTOR_3D

    sizefactor = SIZEFACTOR_2D if ndims == 2 else SIZEFACTOR_3D
    surface_vol = (param.mesh.sediment_size * sizefactor
                   * param.mesh.resolution ** ndims)
    top_elems = np.asarray(surf.top_elems)
    facet_nodes = np.asarray(surf.facet_nodes)
    hist = markers.elem_histogram(nelem, param.mat.nmat)
    sed = param.mat.mattype_sed
    pts = []
    for i in range(top_elems.shape[0]):
        e = int(top_elems[i])
        if hist[e, sed] == 0 or old_volume[e] < surface_vol:
            continue
        fn = set(int(n) for n in facet_nodes[i])
        sub = [int(n) for n in old_conn[e] if int(n) not in fn]
        if not sub:
            continue
        for nj in fn:
            pts.append(0.5 * (old_coord[nj] + old_coord[sub[0]]))
    return np.asarray(pts) if pts else np.zeros((0, ndims))


def generate_new_mesh_2d(param, old_coord, old_topo, seed: int, h=None,
                         extra_interior=None, reuse_pts=None,
                         min_angle=None):
    """New 2D mesh under the current topography.  Returns
    (coord, conn, bcflag).

    ``h`` (optional): callable mapping points (N,2) -> target node
    spacing, used by the metric-driven mesh-optimization path (the
    MMG-analog, remeshing.cxx:2181-2434); None = uniform resolution.
    ``seed`` seeds the jitter of the synthesized points.
    ``extra_interior``: additional interior seed points (the
    refine_surface_elem sediment refinement).
    ``reuse_pts``: (coord, bcflag) point set to re-triangulate instead
    of synthesizing new points — the reference-parity remeshing mode
    (reuse_points_2d; new_mesh re-triangulates the old nodes with
    max_elem_size=-1, remeshing.cxx:1289).
    ``min_angle``: Ruppert quality bound in degrees for the unstructured
    path (None = param.mesh.min_angle; the remesh retry loop passes a
    relaxed value, mirroring remeshing.cxx:1268-1273)."""
    m = param.mesh
    res = m.resolution
    top = old_coord[(old_topo.bcflag & BOUNDZ1) != 0]
    surf = _surface_interp_2d(top)
    if _flatten_bottom(param):
        def bot(x):
            return np.full_like(np.asarray(x, dtype=float), -m.zlength)
    else:
        bpts = old_coord[(old_topo.bcflag & BOUNDZ0) != 0]
        bot = _surface_interp_2d(bpts)

    nx = max(2, int(round(m.xlength / res)) + 1)
    xs = np.linspace(0.0, m.xlength, nx)

    if m.meshing_elem_shape in (1, 2):
        # structured columns: z linspace from bottom to local surface
        nz = max(2, int(round(m.zlength / res)) + 1)
        zs_t = surf(xs)
        zs_b = bot(xs)
        coord = np.empty((nx * nz, 2))
        for i in range(nx):
            coord[i * nz:(i + 1) * nz, 0] = xs[i]
            coord[i * nz:(i + 1) * nz, 1] = np.linspace(zs_b[i], zs_t[i], nz)
        tris = []
        for i in range(nx - 1):
            for j in range(nz - 1):
                n00, n10 = i * nz + j, (i + 1) * nz + j
                n01, n11 = i * nz + j + 1, (i + 1) * nz + j + 1
                if (i + j) % 2 == 0:
                    tris += [(n00, n10, n11), (n00, n11, n01)]
                else:
                    tris += [(n00, n10, n01), (n10, n11, n01)]
        conn = _orient_2d(coord, np.asarray(tris, dtype=np.int32))
        bcflag = np.zeros(nx * nz, dtype=np.uint32)
        bcflag[0:nz] |= BOUNDX0
        bcflag[(nx - 1) * nz:] |= BOUNDX1
        bcflag[np.arange(nx) * nz] |= BOUNDZ0
        bcflag[np.arange(nx) * nz + nz - 1] |= BOUNDZ1
        return coord, conn, bcflag

    # unstructured: keep exact top nodes, regenerate everything else
    order = np.argsort(top[:, 0])
    top_pts = top[order]
    rng = np.random.default_rng(seed)

    if reuse_pts is not None:
        coord, bcflag = reuse_pts
        coord = np.asarray(coord, dtype=np.float64)
        bcflag = np.asarray(bcflag, dtype=np.uint32)
        if extra_interior is not None and len(extra_interior):
            coord = np.concatenate([coord, np.asarray(extra_interior)])
            bcflag = np.concatenate(
                [bcflag, np.zeros(len(extra_interior), dtype=np.uint32)])
        return _finish_unstructured_2d(param, coord, bcflag, surf, bot,
                                       min_angle=min_angle)

    if h is None:
        bot_x = xs
        bot_pts = np.stack([bot_x, bot(bot_x)], axis=1)
        zl0 = surf(0.0) - bot(0.0)
        zl1 = surf(m.xlength) - bot(m.xlength)
        n0 = max(2, int(round(zl0 / res)) + 1)
        n1 = max(2, int(round(zl1 / res)) + 1)
        left_z = np.linspace(float(bot(0.0)), float(surf(0.0)), n0)[1:-1]
        right_z = np.linspace(float(bot(m.xlength)), float(surf(m.xlength)),
                              n1)[1:-1]
        left_pts = np.stack([np.zeros_like(left_z), left_z], axis=1)
        right_pts = np.stack([np.full_like(right_z, m.xlength), right_z],
                             axis=1)
        ipts = []
        for x in xs[1:-1]:
            zt, zb = float(surf(x)), float(bot(x))
            nz_i = max(2, int(round((zt - zb) / res)) + 1)
            for z in np.linspace(zb, zt, nz_i)[1:-1]:
                jx = 0.3 * res * (rng.random() - 0.5)
                jz = 0.3 * res * (rng.random() - 0.5)
                ipts.append((x + jx, z + jz))
        interior = np.asarray(ipts) if ipts else np.zeros((0, 2))
    else:
        # metric-driven point placement (the MMG-analog optimize_mesh_2d,
        # remeshing.cxx:2436-2694): graded boundary walks + a fine
        # lattice thinned with keep-probability (h_min/h)^2
        def _walk(p0, p1):
            pts_w = [0.0]
            d = p1 - p0
            L = float(np.hypot(*d))
            u = d / L
            while pts_w[-1] < L:
                p = p0 + pts_w[-1] * u
                pts_w.append(pts_w[-1] + float(h(p[None, :])[0]))
            t = np.asarray(pts_w)
            t *= L / t[-1]
            return p0[None, :] + t[:, None] * u[None, :]

        bl = np.array([0.0, float(bot(0.0))])
        br = np.array([m.xlength, float(bot(m.xlength))])
        tl = np.array([0.0, float(surf(0.0))])
        tr = np.array([m.xlength, float(surf(m.xlength))])
        bot_w = _walk(bl, br)
        # follow the (possibly non-flat) bottom
        bot_pts = np.stack([bot_w[:, 0], bot(bot_w[:, 0])], axis=1)
        left_pts = _walk(bl, tl)[1:-1]
        right_pts = _walk(br, tr)[1:-1]

        h_min = max(float(res) * m.mmg_hmin_factor, 1e-30)
        nxf = int(round(m.xlength / h_min)) + 1
        nzf = int(round(m.zlength / h_min)) + 1
        xf = np.linspace(0.0, m.xlength, nxf)[1:-1]
        zf = np.linspace(-m.zlength * 1.05, float(top_pts[:, 1].max()),
                         nzf)
        X, Z = np.meshgrid(xf, zf, indexing="ij")
        P = np.stack([X.ravel(), Z.ravel()], axis=1)
        hP = h(P)
        keep = rng.random(P.shape[0]) < (h_min / hP) ** 2
        P, hP = P[keep], hP[keep]
        P = P + 0.35 * hP[:, None] * (rng.random(P.shape) - 0.5)
        margin = 0.55 * hP
        ok = ((P[:, 0] > margin) & (P[:, 0] < m.xlength - margin)
              & (P[:, 1] > bot(P[:, 0]) + margin)
              & (P[:, 1] < surf(P[:, 0]) - margin))
        interior = P[ok]

    if extra_interior is not None and len(extra_interior):
        interior = np.concatenate([np.asarray(interior).reshape(-1, 2),
                                   np.asarray(extra_interior)])
    sizes = [len(top_pts), len(bot_pts), len(left_pts), len(right_pts),
             len(interior)]
    coord = np.concatenate([top_pts, bot_pts, left_pts, right_pts, interior])
    bcflag = np.zeros(coord.shape[0], dtype=np.uint32)
    o = 0
    bcflag[o:o + sizes[0]] |= BOUNDZ1
    o += sizes[0]
    bcflag[o:o + sizes[1]] |= BOUNDZ0
    o += sizes[1]
    bcflag[o:o + sizes[2]] |= BOUNDX0
    o += sizes[2]
    bcflag[o:o + sizes[3]] |= BOUNDX1
    # corners carry two bits
    tol = 1e-6 * m.xlength
    bcflag[np.abs(coord[:, 0]) < tol] |= BOUNDX0
    bcflag[np.abs(coord[:, 0] - m.xlength) < tol] |= BOUNDX1
    return _finish_unstructured_2d(param, coord, bcflag, surf, bot,
                                   min_angle=min_angle)


def _finish_unstructured_2d(param, coord, bcflag, surf, bot,
                            min_angle=None):
    """Triangulate a 2D boundary-flagged point set: constrained-segment
    recovery, Delaunay, outside/sliver culling, interior-point deletion
    retry, for the reused points of the reference-parity regeneration
    (reuse_points_2d)."""
    m = param.mesh

    from .remeshing import SIZEFACTOR_2D, _elem_quality_np

    smallest_vol = (param.mesh.smallest_size * SIZEFACTOR_2D
                    * param.mesh.resolution ** 2)

    # constrained-segment recovery (the CDT guarantee Triangle provides,
    # mesh.cxx:2577-2621): every consecutive boundary-chain pair must
    # appear as a Delaunay edge.  Unconstrained Delaunay can cut across
    # a concave valley; inserting the midpoint of a missing segment
    # (a Steiner point) locally refines until the chain is recovered.
    def _chains(coord, bcflag):
        out = []
        for bit, axis in ((BOUNDZ1, 0), (BOUNDZ0, 0),
                          (BOUNDX0, 1), (BOUNDX1, 1)):
            ids = np.where((bcflag & bit) != 0)[0]
            out.append(ids[np.argsort(coord[ids, axis])])
        return out

    def _recover_segments(coord, bcflag, max_rounds=4):
        for _ in range(max_rounds):
            tri = Delaunay(coord, qhull_options="Qbb Qc Qz")
            e = tri.simplices[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2)
            e.sort(axis=1)
            n = coord.shape[0]
            ekeys = np.unique(e[:, 0].astype(np.int64) * n + e[:, 1])
            new_pts, new_flags = [], []
            for ids in _chains(coord, bcflag):
                a, b = ids[:-1], ids[1:]
                lo, hi = np.minimum(a, b), np.maximum(a, b)
                miss = ~np.isin(lo.astype(np.int64) * n + hi, ekeys)
                for i in np.where(miss)[0]:
                    new_pts.append(0.5 * (coord[a[i]] + coord[b[i]]))
                    new_flags.append(bcflag[a[i]] & bcflag[b[i]])
            if not new_pts:
                return coord, bcflag
            coord = np.concatenate([coord, np.asarray(new_pts)])
            bcflag = np.concatenate(
                [bcflag, np.asarray(new_flags, dtype=bcflag.dtype)])
        return coord, bcflag

    coord, bcflag = _recover_segments(coord, bcflag)

    # Ruppert refinement: the constructive min-angle guarantee Triangle's
    # `q` switch provides (mesh.cxx:110-118, default mesh.min_angle=32).
    # Also fixes boundary slivers the interior-point deletion below
    # cannot touch (all-boundary-node slivers persist across retries
    # since the reused point set is deterministic).
    ma = param.mesh.min_angle if min_angle is None else min_angle
    if ma > 0:
        from .mesh.refine2d import box_inside_fn, refine_min_angle

        coord, bcflag, _, _ = refine_min_angle(
            coord, bcflag, box_inside_fn(m.xlength, surf, bot),
            min_angle=ma, area_floor=smallest_vol)

    def _triangulate(coord, bcflag):
        tri = Delaunay(coord, qhull_options="Qbb Qc Qz")
        conn = tri.simplices.astype(np.int32)
        # drop elements whose centroid lies outside the (non-convex)
        # domain
        c = coord[conn].mean(axis=1)
        keep = (c[:, 1] <= surf(c[:, 0]) + 1e-9 * m.zlength) \
            & (c[:, 1] >= bot(c[:, 0]) - 1e-9 * m.zlength)
        a, b, cc = coord[conn[:, 0]], coord[conn[:, 1]], coord[conn[:, 2]]
        area2 = np.abs((b[:, 0] - a[:, 0]) * (cc[:, 1] - a[:, 1])
                       - (b[:, 1] - a[:, 1]) * (cc[:, 0] - a[:, 0]))
        keep &= area2 > 1e-10 * np.median(area2)
        # boundary-cap slivers: 3 near-collinear points of ONE boundary
        # face triangulate into a sliver whose centroid passes the
        # containment test; they are outside the true boundary polyline,
        # so dropping them leaves no hole
        vols = 0.5 * area2
        q = _elem_quality_np(coord, conn, vols)
        cap = np.zeros(len(conn), dtype=bool)
        for bit in (BOUNDX0, BOUNDX1, BOUNDZ0, BOUNDZ1):
            cap |= ((bcflag[conn] & bit) != 0).all(axis=1)
        keep &= ~(cap & ((q < m.min_quality) | (vols < smallest_vol)))
        return conn[keep]

    # interior-point deletion retry (delete_points,
    # remeshing.cxx:509-618 analog): a tiny/low-quality element with an
    # interior vertex loses that vertex and the region re-triangulates
    conn = _triangulate(coord, bcflag)
    for _ in range(3):
        v = coord[conn]
        vols = 0.5 * np.abs(
            (v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1])
            - (v[:, 1, 1] - v[:, 0, 1]) * (v[:, 2, 0] - v[:, 0, 0]))
        q = _elem_quality_np(coord, conn, vols)
        bad = (q < m.min_quality) | (vols < smallest_vol)
        if not bad.any():
            break
        bad_nodes = np.unique(conn[bad].ravel())
        interior_bad = bad_nodes[bcflag[bad_nodes] == 0]
        if interior_bad.size == 0:
            break
        mask = np.ones(coord.shape[0], dtype=bool)
        mask[interior_bad] = False
        coord, bcflag = coord[mask], bcflag[mask]
        conn = _triangulate(coord, bcflag)
    coord, conn, bcflag = _drop_unused_nodes(coord, conn, bcflag)
    return coord, _orient_2d(coord, conn), bcflag

def generate_optimized_mesh_3d(param, old_coord, old_topo, seed: int, h,
                               extra_interior=None):
    """Metric-driven unstructured 3D regeneration (the MMG3D-analog
    optimize_mesh, remeshing.cxx:2181-2434): graded edge walks + thinned
    face lattices + thinned interior lattice with keep-probability
    (h_min/h)^3, Delaunay-tetrahedralized.  ``extra_interior``: sediment
    surface-refinement seeds (3D refine_surface_elem analog — the
    reference's own 3D branch is 'todo', remeshing.cxx:1250)."""
    m = param.mesh
    res = m.resolution
    top = old_coord[(old_topo.bcflag & BOUNDZ1) != 0]
    surf = _surface_interp_3d(top)
    if _flatten_bottom(param):
        def botf(xy):
            return np.full(len(xy), -m.zlength)
    else:
        from scipy.interpolate import NearestNDInterpolator
        bpts = old_coord[(old_topo.bcflag & BOUNDZ0) != 0]
        botf = NearestNDInterpolator(bpts[:, :2], bpts[:, 2])

    rng = np.random.default_rng(seed)
    h_min = max(float(res) * m.mmg_hmin_factor, 1e-30)

    def thin(P, hP, frac_pow):
        keep = rng.random(P.shape[0]) < (h_min / hP) ** frac_pow
        return P[keep], hP[keep]

    # top face: keep the exact surface nodes (preserves topography)
    pts = [top]
    # bottom + side faces: fine 2D lattices thinned by (h_min/h)^2,
    # then projected onto the face
    nxf = int(round(m.xlength / h_min)) + 1
    nyf = int(round(m.ylength / h_min)) + 1
    nzf = int(round(m.zlength / h_min)) + 1
    xf = np.linspace(0.0, m.xlength, nxf)
    yf = np.linspace(0.0, m.ylength, nyf)
    zf = np.linspace(-m.zlength * 1.05, 0.0, nzf)

    def face_points(axes_vals, fixed_axis, fixed_val):
        A, B = np.meshgrid(*axes_vals, indexing="ij")
        P = np.empty((A.size, 3))
        free = [a for a in range(3) if a != fixed_axis]
        P[:, free[0]] = A.ravel()
        P[:, free[1]] = B.ravel()
        P[:, fixed_axis] = fixed_val
        return P

    bottomP = face_points((xf, yf), 2, 0.0)
    bottomP[:, 2] = botf(bottomP[:, :2])
    for P in (bottomP,
              face_points((yf, zf), 0, 0.0),
              face_points((yf, zf), 0, m.xlength),
              face_points((xf, zf), 1, 0.0),
              face_points((xf, zf), 1, m.ylength)):
        # clamp side faces under the local surface / above local bottom
        zt_f = surf(P[:, :2])
        zb_f = botf(P[:, :2])
        ok = (P[:, 2] >= zb_f - 1e-9 * m.zlength) \
            & (P[:, 2] <= zt_f + 1e-9 * m.zlength)
        P = P[ok]
        P2, _ = thin(P, h(P), 2)
        pts.append(P2)

    # interior: thinned 3D lattice
    X, Y, Z = np.meshgrid(xf[1:-1], yf[1:-1], zf, indexing="ij")
    P = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    P, hP = thin(P, h(P), 3)
    P = P + 0.3 * hP[:, None] * (rng.random(P.shape) - 0.5)
    margin = 0.55 * hP
    ok = ((P[:, 0] > margin) & (P[:, 0] < m.xlength - margin)
          & (P[:, 1] > margin) & (P[:, 1] < m.ylength - margin)
          & (P[:, 2] > botf(P[:, :2]) + margin)
          & (P[:, 2] < surf(P[:, :2]) - margin))
    pts.append(P[ok])
    if extra_interior is not None and len(extra_interior):
        # sediment refinement seeds (old-element edge midpoints —
        # interior by construction, but clamp just under the surface)
        E = np.asarray(extra_interior, dtype=np.float64)
        zcap = surf(E[:, :2]) - 1e-6 * m.zlength
        E[:, 2] = np.minimum(E[:, 2], zcap)
        pts.append(E)

    coord = np.concatenate(pts, axis=0)
    # dedup near-coincident points (face/edge overlaps)
    key = np.round(coord / (0.25 * h_min)).astype(np.int64)
    _, uniq = np.unique(key, axis=0, return_index=True)
    coord = coord[np.sort(uniq)]

    tet = Delaunay(coord, qhull_options="Qbb Qc Qz")
    conn = tet.simplices.astype(np.int32)
    cen = coord[conn].mean(axis=1)
    keep = (cen[:, 2] <= surf(cen[:, :2]) + 1e-9 * m.zlength) \
        & (cen[:, 2] >= botf(cen[:, :2]) - 1e-9 * m.zlength)
    # sliver removal by volume
    a = coord[conn[:, 0]]
    v = np.abs(np.einsum(
        "ij,ij->i", np.cross(coord[conn[:, 1]] - a, coord[conn[:, 2]] - a),
        coord[conn[:, 3]] - a))
    keep &= v > 1e-9 * np.median(v)
    conn = conn[keep]
    coord, conn, _ = _drop_unused_nodes(
        coord, conn, np.zeros(coord.shape[0], dtype=np.uint32))

    tol = 1e-6 * min(m.xlength, m.zlength)
    bcflag = np.zeros(coord.shape[0], dtype=np.uint32)
    bcflag[np.abs(coord[:, 0]) < tol] |= BOUNDX0
    bcflag[np.abs(coord[:, 0] - m.xlength) < tol] |= BOUNDX1
    bcflag[np.abs(coord[:, 1]) < tol] |= BOUNDY0
    bcflag[np.abs(coord[:, 1] - m.ylength) < tol] |= BOUNDY1
    bcflag[np.abs(coord[:, 2] - botf(coord[:, :2])) < tol] |= BOUNDZ0
    bcflag[np.abs(coord[:, 2] - surf(coord[:, :2])) < tol] |= BOUNDZ1
    return coord, _orient_3d(coord, conn), bcflag


# the 5-tet decompositions of a cell before orientation, by the parity of
# i + j + k; corner code = a*4 + b*2 + d for x/y/z offsets
_TETS_EVEN = ((0, 1, 2, 4), (1, 2, 3, 7), (1, 4, 5, 7), (2, 4, 6, 7),
              (1, 2, 4, 7))
_TETS_ODD = ((0, 1, 3, 5), (0, 2, 3, 6), (0, 4, 5, 6), (3, 5, 6, 7),
             (0, 3, 5, 6))


def generate_new_mesh_3d(param, old_coord, old_topo, seed: int):
    """New 3D mesh under the current topography (structured columns split
    into tets; the TetGen path of remeshing.cxx:1109-1363 is approximated by
    a surface-following structured lattice).  The cells and their tets are
    listed in the JAX function's loop order (i, then j, then k, then the
    parity table's row), built at once with numpy.  ``seed`` is unused:
    the lattice has no random part."""
    m = param.mesh
    res = m.resolution
    top = old_coord[(old_topo.bcflag & BOUNDZ1) != 0]
    surf = _surface_interp_3d(top)
    flat_bot = _flatten_bottom(param)
    if not flat_bot:
        from scipy.interpolate import NearestNDInterpolator
        bpts = old_coord[(old_topo.bcflag & BOUNDZ0) != 0]
        botf = NearestNDInterpolator(bpts[:, :2], bpts[:, 2])

    nx = max(2, int(round(m.xlength / res)) + 1)
    ny = max(2, int(round(m.ylength / res)) + 1)
    nz = max(2, int(round(m.zlength / res)) + 1)
    xs = np.linspace(0.0, m.xlength, nx)
    ys = np.linspace(0.0, m.ylength, ny)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    xy = np.stack([X.ravel(), Y.ravel()], axis=1)
    zt = surf(xy)
    zb = (np.full(len(xy), -m.zlength) if flat_bot else botf(xy))

    coord = np.empty((nx * ny * nz, 3))
    for c_idx in range(nx * ny):
        col = np.linspace(zb[c_idx], zt[c_idx], nz)
        coord[c_idx * nz:(c_idx + 1) * nz, 0] = xy[c_idx, 0]
        coord[c_idx * nz:(c_idx + 1) * nz, 1] = xy[c_idx, 1]
        coord[c_idx * nz:(c_idx + 1) * nz, 2] = col

    i, j, k = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                          np.arange(nz - 1), indexing="ij")
    corners = np.stack([((i + a) * ny + (j + b)) * nz + (k + d)
                        for a in (0, 1) for b in (0, 1) for d in (0, 1)],
                       axis=-1)                     # (..., 8)
    even = ((i + j + k) % 2 == 0)[..., None, None]
    tets = np.where(even, corners[..., np.asarray(_TETS_EVEN)],
                    corners[..., np.asarray(_TETS_ODD)])   # (..., 5, 4)
    conn = _orient_3d(coord, tets.reshape(-1, 4).astype(np.int32))
    bcflag = np.zeros(nx * ny * nz, dtype=np.uint32)
    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    bcflag[I == 0] |= BOUNDX0
    bcflag[I == nx - 1] |= BOUNDX1
    bcflag[J == 0] |= BOUNDY0
    bcflag[J == ny - 1] |= BOUNDY1
    bcflag[K == 0] |= BOUNDZ0
    bcflag[K == nz - 1] |= BOUNDZ1
    return coord, conn, bcflag


# element-size convention: elem_size ≈ (volume / sizefactor)^(1/NDIMS)
# (mesh.cxx:63-65,840-841)
_SIZEFACTOR = {2: 0.433, 3: 0.118}


def compute_init_elem_size_n(coord, conn, volume):
    """Frozen initial nodal element-size field (initialize_elem_size_n,
    remeshing.cxx:2694-2736): volume-weighted nodal average of the
    element size, captured once so refinement zones don't diffuse away
    across remeshes."""
    ndims = coord.shape[1]
    h_e = (volume / _SIZEFACTOR[ndims]) ** (1.0 / ndims)
    etmp = np.repeat(h_e * volume, conn.shape[1])
    vrep = np.repeat(volume, conn.shape[1])
    num = np.zeros(coord.shape[0])
    den = np.zeros(coord.shape[0])
    np.add.at(num, conn.ravel(), etmp)
    np.add.at(den, conn.ravel(), vrep)
    return num / np.maximum(den, 1e-300)


def metric_spacing_interp(param, coord, conn, volume, plstrain,
                          init_size_n):
    """Target node-spacing field for metric-driven remeshing
    (compute_metric_field, remeshing.cxx:2159-2178): the frozen initial
    size shrunk where plastic strain is present, clamped to
    [mmg_hmin_factor, mmg_hmax_factor] * resolution.  Returns a callable
    (N,ndims)->spacing over the old-mesh nodal field."""
    from scipy.interpolate import (LinearNDInterpolator,
                                   NearestNDInterpolator)

    etmp = np.repeat(volume / (1.0 + 5.0 * plstrain), conn.shape[1])
    vrep = np.repeat(volume, conn.shape[1])
    num = np.zeros(coord.shape[0])
    den = np.zeros(coord.shape[0])
    np.add.at(num, conn.ravel(), etmp)
    np.add.at(den, conn.ravel(), vrep)
    metric = num / np.maximum(den, 1e-300) * init_size_n
    res = param.mesh.resolution
    metric = np.clip(metric, res * param.mesh.mmg_hmin_factor,
                     res * param.mesh.mmg_hmax_factor)
    lin = LinearNDInterpolator(coord, metric)
    near = NearestNDInterpolator(coord, metric)

    def h(p):
        v = lin(p)
        bad = np.isnan(v)
        if bad.any():
            v[bad] = near(p[bad])
        return v

    return h


def _drop_unused_nodes(coord, conn, bcflag):
    used = np.zeros(coord.shape[0], dtype=bool)
    used[conn.ravel()] = True
    remap = -np.ones(coord.shape[0], dtype=np.int64)
    remap[used] = np.arange(used.sum())
    return coord[used], remap[conn].astype(np.int32), bcflag[used]


# ---------------------------------------------------------------------------
# SPR stress recovery (geometry.cxx:468-754)
# ---------------------------------------------------------------------------

def _node_elem_patches(conn, nnode):
    """Sorted node->element patch lists: (sorted_elems, starts, counts)."""
    npe = conn.shape[1]
    flat = conn.ravel()
    slot_elem = np.repeat(np.arange(conn.shape[0]), npe)
    order = np.argsort(flat, kind="stable")
    sorted_elems = slot_elem[order]
    counts = np.bincount(flat, minlength=nnode)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return sorted_elems, starts, counts


def _fit_patch(coord_n, es, cent, vals, volume, nb):
    """Weighted linear LSQ of centroid values over patch `es`, evaluated at
    coord_n.  Returns (value, ok)."""
    w = np.sqrt(volume[es])
    C = cent[es] - coord_n
    h = np.abs(C).max()
    h = h if h > 0 else 1.0
    X = np.concatenate([np.ones((es.size, 1)), C / h], axis=1)
    sol, res, rank, sv = np.linalg.lstsq(X * w[:, None], vals[es]
                                         * w[:, None], rcond=1e-10)
    return sol[0], rank >= nb


def spr_elem_to_node(coord, conn, elem_field, volume, p_ref=None):
    """Superconvergent patch recovery: per-node weighted linear
    least-squares fit of element-centroid values over the node's element
    patch (geometry.cxx:629-709), with a 2-ring patch expansion for
    degenerate boundary patches (the reference's degenerate-patch fallback,
    geometry.cxx:346-462) and a volume-weighted mean as last resort.
    ``p_ref`` optionally centers the diagonal components on the lithostatic
    profile to avoid gradient bias.  Returns (nnode, ncomp)."""
    ndims = coord.shape[1]
    nnode = coord.shape[0]
    vals = np.atleast_2d(elem_field.T).T.astype(np.float64).copy()
    ncomp = vals.shape[1]
    cent = coord[conn].mean(axis=1)
    nb = ndims + 1

    if p_ref is not None:
        vals[:, :ndims] += p_ref[:, None]

    sorted_elems, starts, counts = _node_elem_patches(conn, nnode)

    # --- vectorized primary pass over padded 1-ring patches
    max_deg = int(counts.max())
    pad_e = np.zeros((nnode, max_deg), dtype=np.int64)
    mask = np.arange(max_deg)[None, :] < counts[:, None]
    rows = np.repeat(np.arange(nnode), counts)
    cols = (np.arange(conn.size) - starts[rows])
    pad_e[rows, cols] = sorted_elems

    C = (cent[pad_e] - coord[:, None, :]) * mask[..., None]
    h = np.abs(C).max(axis=(1, 2))
    h = np.where(h > 0, h, 1.0)
    X = np.concatenate([mask[..., None].astype(np.float64),
                        C / h[:, None, None]], axis=2)  # (nnode, deg, nb)
    W = volume[pad_e] * mask
    A = np.einsum("ndi,nd,ndj->nij", X, W, X)
    B = np.einsum("ndi,nd,ndc->nic", X, W, vals[pad_e] * mask[..., None])
    det = np.linalg.det(A)
    good = (counts >= nb) & (np.abs(det)
                             > 1e-10 * np.maximum(W.sum(axis=1), 1e-300)
                             ** nb)
    out = np.zeros((nnode, ncomp))
    if good.any():
        sol = np.linalg.solve(A[good], B[good])
        out[good] = sol[:, 0, :]

    # --- fallback: 2-ring expansion for degenerate (boundary) patches
    bad_nodes = np.nonzero(~good)[0]
    for n in bad_nodes:
        es1 = sorted_elems[starts[n]:starts[n] + counts[n]]
        if es1.size == 0:
            continue
        ring2 = np.unique(conn[es1].ravel())
        es2 = np.unique(np.concatenate(
            [sorted_elems[starts[m]:starts[m] + counts[m]] for m in ring2]))
        val, ok = _fit_patch(coord[n], es2, cent, vals, volume, nb)
        if ok:
            out[n] = val
        else:
            w = volume[es1]
            out[n] = (vals[es1] * w[:, None]).sum(axis=0) / w.sum()
    return out


def spr_node_to_elem(new_conn, node_field, p_ref_new=None, ndims=None):
    """Average recovered nodal values back to elements on the NEW mesh
    (geometry.cxx:711-754), removing the pressure centering."""
    out = node_field[new_conn].mean(axis=1)
    if p_ref_new is not None:
        out[:, :ndims] -= p_ref_new[:, None]
    return out


# ---------------------------------------------------------------------------
# the remesh orchestrator
# ---------------------------------------------------------------------------

def structured_regen_2d(param, old_coord, old_topo, dims=None):
    """Boundary-fitted STRUCTURED regeneration (remeshing_option 100 — a
    framework extension with no reference counterpart; the reference's
    options re-triangulate points into unstructured meshes,
    remeshing.cxx:1109-1363).

    It returns grid TOPOLOGY with boundary-fitted node positions, so a
    run stays on the fused structured kernels (ops/fused2d.py) instead of
    dropping to the column step (ops/flat2d.py) after the first remesh:
    the kernels assume regular connectivity, not regular geometry.  The
    dims are frozen after the first remesh, so later remeshes give the
    same shapes.

    Builds a transfinite mesh: nx uniform columns spanning the current
    (moved) side walls, each column's nodes linearly spaced between the
    deformed bottom and top boundary polylines.  Returns
    (coord, conn, bcflag, (nx, nz)) or None when the domain violates
    the column assumptions (non-vertical walls, folded top/bottom) —
    callers then fall back to the standard regeneration.
    """
    m = param.mesh
    bc = old_topo.bcflag
    topn = (bc & BOUNDZ1) != 0
    botn = (bc & BOUNDZ0) != 0
    x0n = (bc & BOUNDX0) != 0
    x1n = (bc & BOUNDX1) != 0
    if not (topn.any() and botn.any() and x0n.any() and x1n.any()):
        return None
    # side walls must have stayed vertical (all wall nodes share one x)
    x0s = old_coord[x0n, 0]
    x1s = old_coord[x1n, 0]
    tol = 1e-6 * m.xlength
    if np.ptp(x0s) > tol or np.ptp(x1s) > tol:
        return None
    x_min = float(x0s.mean())
    x_max = float(x1s.mean())
    if x_max - x_min <= 0:
        return None

    def _polyline(mask):
        ids = np.nonzero(mask)[0]
        order = np.argsort(old_coord[ids, 0], kind="stable")
        xs = old_coord[ids[order], 0]
        zs = old_coord[ids[order], 1]
        # single-valued z(x): reject folded/overhanging boundaries
        if np.any(np.diff(xs) < -tol):
            return None
        return xs, zs

    top_pl = _polyline(topn)
    bot_pl = _polyline(botn)
    if top_pl is None or bot_pl is None:
        return None

    if dims is None:
        res = m.resolution
        nx = max(2, int(round((x_max - x_min) / res)) + 1)
        nz = max(2, int(round(m.zlength / res)) + 1)
    else:
        nx, nz = dims
    xs = np.linspace(x_min, x_max, nx)
    z_top = np.interp(xs, top_pl[0], top_pl[1])
    z_bot = np.interp(xs, bot_pl[0], bot_pl[1])
    if np.any(z_top - z_bot <= 0):
        return None
    # transfinite columns: node (i, j) at raster id i*nz + j
    frac = np.linspace(0.0, 1.0, nz)[None, :]
    Z = z_bot[:, None] + (z_top - z_bot)[:, None] * frac
    X = np.repeat(xs[:, None], nz, axis=1)
    coord = np.stack([X.ravel(), Z.ravel()], axis=1)

    from .ops.structured import structured_conn_2d

    conn = structured_conn_2d(nx, nz)
    bcflag = np.zeros(nx * nz, dtype=np.uint32)
    rid = np.arange(nx * nz)
    i_of = rid // nz
    j_of = rid % nz
    bcflag[i_of == 0] |= BOUNDX0
    bcflag[i_of == nx - 1] |= BOUNDX1
    bcflag[j_of == 0] |= BOUNDZ0
    bcflag[j_of == nz - 1] |= BOUNDZ1
    return coord, conn.astype(np.int32), bcflag, (nx, nz)


def structured_regen_3d(param, old_coord, old_topo, dims=None):
    """3D boundary-fitted structured regeneration (remeshing_option 100;
    see structured_regen_2d): transfinite z-columns over an (x, y) grid
    spanning the current walls, 5-tet cells in the raster pattern the
    fused 3D step (ops/fused3d.py) requires.  Returns
    (coord, conn, bcflag, (nx, ny, nz)) or None."""
    m = param.mesh
    bc = old_topo.bcflag
    masks = {name: (bc & bit) != 0 for name, bit in
             (("top", BOUNDZ1), ("bot", BOUNDZ0), ("x0", BOUNDX0),
              ("x1", BOUNDX1), ("y0", BOUNDY0), ("y1", BOUNDY1))}
    if not all(v.any() for v in masks.values()):
        return None
    tol = 1e-6 * m.xlength
    for wall, axis in (("x0", 0), ("x1", 0), ("y0", 1), ("y1", 1)):
        if np.ptp(old_coord[masks[wall], axis]) > tol:
            return None
    x_min = float(old_coord[masks["x0"], 0].mean())
    x_max = float(old_coord[masks["x1"], 0].mean())
    y_min = float(old_coord[masks["y0"], 1].mean())
    y_max = float(old_coord[masks["y1"], 1].mean())
    if x_max - x_min <= 0 or y_max - y_min <= 0:
        return None

    if dims is None:
        res = m.resolution
        nx = max(2, int(round((x_max - x_min) / res)) + 1)
        ny = max(2, int(round((y_max - y_min) / res)) + 1)
        nz = max(2, int(round(m.zlength / res)) + 1)
    else:
        nx, ny, nz = dims
    xs = np.linspace(x_min, x_max, nx)
    ys = np.linspace(y_min, y_max, ny)
    XY = np.stack(np.meshgrid(xs, ys, indexing="ij"), axis=-1)
    XYf = XY.reshape(-1, 2)

    from scipy.interpolate import LinearNDInterpolator, NearestNDInterpolator

    def _surface_z(mask):
        pts = old_coord[mask, :2]
        zs = old_coord[mask, 2]
        lin = LinearNDInterpolator(pts, zs)
        z = lin(XYf)
        bad = ~np.isfinite(z)
        if bad.any():
            z[bad] = NearestNDInterpolator(pts, zs)(XYf[bad])
        return z.reshape(nx, ny)

    z_top = _surface_z(masks["top"])
    z_bot = _surface_z(masks["bot"])
    if np.any(z_top - z_bot <= 0):
        return None
    frac = np.linspace(0.0, 1.0, nz)[None, None, :]
    Z = z_bot[:, :, None] + (z_top - z_bot)[:, :, None] * frac
    X = np.broadcast_to(xs[:, None, None], (nx, ny, nz))
    Y = np.broadcast_to(ys[None, :, None], (nx, ny, nz))
    coord = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    from .ops.structured import structured_conn_3d

    conn = structured_conn_3d(nx, ny, nz)
    nnode = nx * ny * nz
    rid = np.arange(nnode)
    i_of = rid // (ny * nz)
    j_of = (rid // nz) % ny
    k_of = rid % nz
    bcflag = np.zeros(nnode, dtype=np.uint32)
    bcflag[i_of == 0] |= BOUNDX0
    bcflag[i_of == nx - 1] |= BOUNDX1
    bcflag[j_of == 0] |= BOUNDY0
    bcflag[j_of == ny - 1] |= BOUNDY1
    bcflag[k_of == 0] |= BOUNDZ0
    bcflag[k_of == nz - 1] |= BOUNDZ1
    return coord, conn.astype(np.int32), bcflag, (nx, ny, nz)


# ---------------------------------------------------------------------------
# the remesh orchestrator
# ---------------------------------------------------------------------------

def _signed_volumes(coord, conn):
    v = coord[conn]
    if conn.shape[1] == 3:
        ab = v[:, 1] - v[:, 0]
        ac = v[:, 2] - v[:, 0]
        return 0.5 * (ab[:, 0] * ac[:, 1] - ab[:, 1] * ac[:, 0])
    d1 = v[:, 1] - v[:, 0]
    d2 = v[:, 2] - v[:, 0]
    d3 = v[:, 3] - v[:, 0]
    return np.einsum("ij,ij->i", d1, np.cross(d2, d3)) / 6.0


def remesh_simulation(sim, bad_quality: int):
    """One remesh event of ``sim`` (a Simulation), as JAX
    remesh_impl.remesh_simulation: the state goes to the host in float64,
    the mesh is regenerated and the fields and markers remapped there, and
    the new context and state go to the run's device, where the finalize
    re-applies the velocity BCs and recomputes the masses.  The host
    seconds of each part are left in ``sim.remesh_seconds``."""
    import time

    import torch

    from .mesh.generate import MeshData, renumber_mesh
    from .ops.shapefn import compute_volume
    from .remeshing import SIZEFACTOR_2D, SIZEFACTOR_3D, _elem_quality_np
    from .simulation import make_finalize_fn
    from .state import allocate_state

    param, topo = sim.param, sim.topo
    ndims = param.sim.ndims
    m = param.mesh
    secs = {}
    t0 = time.perf_counter()
    # the state as the JAX package reads it: float64 on the host
    s, _host = sim.state, sim._host
    old_coord = _host(s.coord)
    old_conn = topo.connectivity
    old_volume = _host(s.volume)

    print(f"    remeshing (trigger {bad_quality}): "
          f"{topo.nnode} nodes, {topo.nelem} elems", end="")

    # --- 1. SPR stress to old nodes, with pressure centering
    zc_old = old_coord[old_conn, ndims - 1].mean(axis=1)
    p_ref_old = ref_pressure(param, zc_old) / ndims
    stress_n = spr_elem_to_node(old_coord, old_conn, _host(s.stress),
                                old_volume, p_ref=p_ref_old)
    syy_n = spr_elem_to_node(old_coord, old_conn, _host(s.stressyy)[:, None],
                             old_volume)
    t1 = time.perf_counter()
    secs["spr"] = t1 - t0

    # --- 2. regenerate the mesh, with the reference's retry/quality-
    # relaxation loop (remeshing.cxx:1263-1340): a regeneration that
    # produces tiny elements (bad_quality 3) relaxes the sizing field
    # (the Triangle min_angle*0.9 / max_ratio*1.1 analog is h*1.1 for
    # the Delaunay generator) and the Ruppert bound; one below
    # min_quality retries with the next seed.  5 loops max, then
    # "proceeding with risks".
    sizefactor = SIZEFACTOR_2D if ndims == 2 else SIZEFACTOR_3D
    smallest_vol = m.smallest_size * sizefactor * m.resolution ** ndims
    base_seed = param.markers.random_seed + int(s.steps)
    h_field = None
    if m.meshing_elem_shape == 0 and m.use_mesh_optimizer:
        # metric-driven adaptation (optimize_mesh path); the initial size
        # field is frozen at the first remesh
        if sim.init_elem_size_n is None:
            sim.init_elem_size_n = compute_init_elem_size_n(
                old_coord, old_conn, old_volume)
        h_field = metric_spacing_interp(param, old_coord, old_conn,
                                        old_volume, _host(s.plstrain),
                                        sim.init_elem_size_n)

    extra_interior = None
    if m.meshing_sediment and (ndims == 2 or h_field is not None):
        # 3D seeds ride the metric-path regeneration (the structured 3D
        # lattice cannot take free points); the reference has no 3D
        # surface refinement at all (remeshing.cxx:1250 'todo')
        extra_interior = sediment_refine_points(
            param, sim.ctx.surf, sim.markers, topo.nelem, old_coord,
            old_conn, old_volume)
        if len(extra_interior):
            print(f"\n    sediment refinement: +{len(extra_interior)} "
                  "surface seeds", end="")

    reuse = None
    if ndims == 2 and m.meshing_elem_shape == 0 and h_field is None:
        # reference-parity regeneration: re-triangulate the OLD nodes
        # (new_mesh keeps them with max_elem_size=-1, remeshing.cxx:1289)
        reuse = reuse_points_2d(param, old_coord, topo, bad_quality,
                                old_volume)

    def _regen(seed, h_scale, min_angle):
        hf = None if h_field is None else \
            (lambda p, _h=h_field: _h(p) * h_scale)
        if ndims == 3:
            if hf is not None:
                return generate_optimized_mesh_3d(
                    param, old_coord, topo, seed, hf,
                    extra_interior=extra_interior)
            return generate_new_mesh_3d(param, old_coord, topo, seed)
        # the metric path is the MMG-analog, which controls quality
        # through its size field, not Triangle's angle bound
        # (remeshing.cxx:2436-2694 passes no min_angle)
        c, k, b = generate_new_mesh_2d(
            param, old_coord, topo, seed, h=hf,
            extra_interior=extra_interior, reuse_pts=reuse,
            min_angle=0.0 if hf is not None else min_angle)
        if m.meshing_elem_shape == 0:
            # renumbering_mesh after unstructured regeneration
            # (remeshing.cxx:2970-2974)
            c, k, b = renumber_mesh(c, k, bcflag=b)
        return c, k, b

    # --- remeshing_option 100: boundary-fitted structured regeneration.
    # Falls back to the standard regeneration whenever the domain violates
    # the column assumptions or the fitted grid fails the quality gates.
    new_sgrid = None
    struct_done = False
    if m.remeshing_option == 100:
        dims = sim._struct_regen_dims
        if dims is None and sim.ctx.sgrid is not None:
            dims = tuple(int(v) for v in sim.ctx.sgrid)
        regen = structured_regen_2d if ndims == 2 else structured_regen_3d
        sr = regen(param, old_coord, topo, dims)
        if sr is not None:
            c_s, k_s, b_s, dims_s = sr
            vols_s = _signed_volumes(c_s, k_s)
            q_s = float(_elem_quality_np(c_s, k_s, vols_s).min())
            if ndims == 3:
                q_s = abs(q_s) ** (1.0 / 3.0) * np.sign(q_s)
            if (vols_s > smallest_vol).all() and q_s >= m.min_quality:
                new_coord, new_conn, new_bcflag = c_s, k_s, b_s
                new_sgrid = dims_s
                sim._struct_regen_dims = dims_s
                struct_done = True
                print(f"\n    structured regeneration "
                      f"{'x'.join(str(d) for d in dims_s)} "
                      f"(q={q_s:.3f})", end="")
            else:
                print(f"\n    structured regeneration rejected "
                      f"(q={q_s:.3f}); falling back", end="")
        else:
            print("\n    structured regeneration not applicable; "
                  "falling back", end="")

    h_scale = 1.0
    min_angle = m.min_angle
    for nloops in range(6):
        if struct_done:
            break
        new_coord, new_conn, new_bcflag = _regen(base_seed + nloops,
                                                 h_scale, min_angle)
        vols = _signed_volumes(new_coord, new_conn)
        worst = float(_elem_quality_np(new_coord, new_conn, vols).min())
        if ndims == 3:
            worst = worst ** (1.0 / 3.0)
        if (vols < smallest_vol).any():
            regen_bad = 3
        elif worst < m.min_quality:
            regen_bad = 1
        else:
            regen_bad = 0
        if regen_bad == 0:
            break
        if nloops == 5:
            print("\n    Warning: exceeding loop limit in remeshing. "
                  "Proceeding with risks.", end="")
            break
        if regen_bad == 3:
            # lessen the quality constraint so fewer new points get
            # inserted, hence less chance of tiny elements
            # (remeshing.cxx:1268-1273: min_angle*0.9, max_ratio*1.1)
            h_scale *= 1.1
            min_angle *= 0.9
        print(f"\n    regenerated mesh bad (code {regen_bad}, "
              f"q={worst:.3f}); retrying", end="")
    topo2 = finish_topology(ndims, new_conn, new_bcflag)
    print(f" -> {topo2.nnode} nodes, {topo2.nelem} elems")
    t2 = time.perf_counter()
    secs["regen"] = t2 - t1

    # --- 3. nodal remap: barycentric interpolation on the old mesh
    elem_of, eta_of, _ = ElementLocator(old_coord, old_conn).locate(
        new_coord)

    def interp_nodal(f):
        return np.einsum("nk,nk...->n...", eta_of, f[old_conn[elem_of]])

    vel_new = interp_nodal(_host(s.vel))
    temp_new = interp_nodal(_host(s.temperature))
    pp_new = interp_nodal(_host(s.ppressure))
    dpp_new = interp_nodal(_host(s.dppressure))
    coord0_new = interp_nodal(_host(s.coord0))
    stress_n_new = interp_nodal(stress_n)
    syy_n_new = interp_nodal(syy_n)
    if sim.init_elem_size_n is not None:
        # carry the frozen size field to the new nodes
        # (brc-interpolation.cxx:326-404 remaps init_elem_size_n)
        sim.init_elem_size_n = interp_nodal(sim.init_elem_size_n)
    t3 = time.perf_counter()
    secs["locate"] = t3 - t2

    # --- 4. element remap: nearest-centroid copy + ACM volume-overlap
    # weighting on changed elements (nearest_neighbor_interpolation,
    # nn-interpolation.cxx:16-326)
    from .acm import ACMRemap

    acm = ACMRemap(old_coord, old_conn, new_coord, new_conn)
    plstrain_new = acm.inject(_host(s.plstrain))
    dpls_new = acm.inject(_host(s.delta_plstrain))
    strain_new = acm.inject(_host(s.strain))
    radio_new = acm.inject(_host(s.radiogenic_source))
    dfc_new = acm.inject(_host(s.dyn_fric_coeff))
    sv_new = acm.inject(_host(s.state_variable))
    # volume_old crosses the remesh as dv = volume/volume_old - 1
    # (remeshing.cxx:2896-2899), converted back against the new volumes
    # in the finalize (remeshing.cxx:3072-3080)
    dv_new = acm.inject(old_volume / _host(s.volume_old) - 1.0)

    # surface-facet remap of the deposited-volume accumulator: per-area
    # density before, re-scaled by new facet areas after
    # (remeshing.cxx:2883-2891, 3050-3069; ACM is_surface variant)
    old_facets = np.asarray(sim.ctx.surf.facet_nodes)
    edvacc_new = None
    if old_facets.size:
        edv = _host(s.edvacc_surf)
        if edv.size == old_facets.shape[0] and np.abs(edv).max() > 0:
            old_area = _facet_area(old_coord, old_facets)
            nof = dim(ndims).node_of_facet
            nf = [topo2.connectivity[e, list(nof[f])]
                  for e, f in topo2.bfacets[IBOUNDZ1]]
            if nf:
                new_facets = np.asarray(nf, dtype=np.int64)
                acm_s = ACMRemap(old_coord, old_facets, new_coord,
                                 new_facets, is_surface=True)
                edvacc_new = acm_s.inject(edv / old_area) \
                    * _facet_area(new_coord, new_facets)

    # --- 5. SPR node -> new elements (+ pressure de-centering)
    zc_new = new_coord[new_conn, ndims - 1].mean(axis=1)
    p_ref_new = ref_pressure(param, zc_new) / ndims
    stress_new = spr_node_to_elem(new_conn, stress_n_new,
                                  p_ref_new=p_ref_new, ndims=ndims)
    syy_new = spr_node_to_elem(new_conn, syy_n_new)[:, 0]
    t4 = time.perf_counter()
    secs["acm"] = t4 - t3

    # --- 6. markers: relocate on the new mesh, replenish depleted elements
    if sim.markers is not None:
        remap_markers(sim.markers, old_coord, old_conn, new_coord, new_conn,
                      param, base_seed)
        emw = mk.emw_from_markers(sim.markers, topo2.nelem, param.mat.nmat)
    else:
        emw = np.ones((topo2.nelem, param.mat.nmat))
    hyd = sim.hydrous_markers
    if hyd is not None and hyd.n:
        # the hydrous markers of phase changes, located on the new mesh;
        # those outside it are deleted (JAX remesh_impl.py:1246-1257)
        pts_h = bary_to_coord(old_coord, old_conn, hyd.live("elem"),
                              hyd.live("eta"))
        eh, etah, fh = ElementLocator(new_coord, new_conn).locate(pts_h)
        hyd.elem[: hyd.n] = eh
        hyd.eta[: hyd.n] = etah
        lost_h = np.nonzero(~fh)[0]
        if lost_h.size:
            hyd.remove(lost_h)
    t5 = time.perf_counter()
    secs["markers"] = t5 - t4

    # --- 7. rebuild the context and the state on the run's device
    sim._set_mesh(topo2, MeshData(ndims, new_coord, new_conn), new_sgrid)
    ctx, dev = sim.ctx, sim._dev
    s2 = allocate_state(topo2.nnode, topo2.nelem, ndims, param.mat.nmat,
                        netop=ctx.surf.etop, dtype=sim.dtype,
                        device=sim.device)
    coord = dev(new_coord)
    volume = compute_volume(coord, ctx.conn)
    s2 = s2.replace(
        coord=coord, coord0=dev(coord0_new), vel=dev(vel_new),
        temperature=dev(temp_new), ppressure=dev(pp_new),
        dppressure=dev(dpp_new), volume=volume, volume_old=volume,
        stress=dev(stress_new), stressyy=dev(syy_new),
        strain=dev(strain_new), plstrain=dev(plstrain_new),
        delta_plstrain=dev(dpls_new), radiogenic_source=dev(radio_new),
        dyn_fric_coeff=dev(dfc_new), state_variable=dev(sv_new),
        emw=dev(emw),
        old_mean_stress=dev(stress_new[:, :ndims].sum(axis=1) / ndims),
        time=s.time, dt=s.dt, steps=s.steps,
        max_global_vel_mag=s.max_global_vel_mag,
        global_dt_min=s.global_dt_min, l2_residual=s.l2_residual,
        hydro_diff_max=s.hydro_diff_max)
    if edvacc_new is not None:
        s2 = s2.replace(edvacc_surf=dev(edvacc_new))
    # re-apply vbcs + recompute masses (remeshing.cxx:3048-3080)
    sim.state = make_finalize_fn(param, with_dt=False)(ctx, s2, dev(dv_new))
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)
    secs["finalize"] = time.perf_counter() - t5
    sim.remesh_seconds = secs


def remap_markers(ms, old_coord, old_conn, new_coord, new_conn, param,
                  seed: int):
    """Relocate markers on the new mesh; delete strays; replenish depleted
    elements (markerset.cxx:1738-1863 remap_markers + 1148-1475
    replenishment)."""
    pts = bary_to_coord(old_coord, old_conn, ms.live("elem"), ms.live("eta"))
    elem, eta, found = ElementLocator(new_coord, new_conn).locate(pts)
    # markers that left the domain (e.g. above the new surface) are removed
    lost = np.nonzero(~found)[0]
    ms.elem[: ms.n] = elem
    ms.eta[: ms.n] = eta
    if lost.size:
        ms.remove(lost)

    # replenish elements that fell below the minimum count
    replenish_markers(ms, new_coord, new_conn, param, seed)


def replenish_markers(ms, new_coord, new_conn, param, seed: int,
                      only_elems=None, fill_to=None):
    """Replenish under-populated elements with new markers, material chosen
    by replenishment_option 0/1/2 (markerset.cxx:1148-1475).  ``only_elems``
    restricts the candidate set (e.g. the surface elements of
    correct_surface_marker, markerset.cxx:1692-1720); ``fill_to`` overrides
    the target count (the reference's surface path refills to 3)."""
    nelem = new_conn.shape[0]
    nmat = param.mat.nmat
    hist = ms.elem_histogram(nelem, nmat)
    count = hist.sum(axis=1)
    low = count < param.markers.min_num_markers_in_element
    if only_elems is not None:
        m = np.zeros(nelem, dtype=bool)
        m[np.asarray(only_elems)] = True
        low &= m
    need = np.nonzero(low)[0]
    if need.size:
        target = (param.markers.markers_per_element if fill_to is None
                  else fill_to)
        rng = np.random.default_rng(seed)
        npe = new_conn.shape[1]
        add_elems = []
        add_mattype = []
        for e in need:
            k = target - int(count[e])
            if k <= 0:
                continue
            add_elems += [e] * k
        if add_elems:
            eta_new = random_barycentric(len(add_elems), npe, rng)
            elems = np.asarray(add_elems, dtype=np.int32)
            p_new = bary_to_coord(new_coord, new_conn, elems, eta_new)
            opt = param.markers.replenishment_option
            if opt == 0:
                # always material 0 (replenish_markers_with_mattype_0,
                # markerset.cxx:1148-1174)
                add_mattype = np.zeros(len(add_elems), dtype=np.int32)
            elif opt == 1:
                # sample from the element's marker histogram as a CPDF
                # (replenish_markers_with_mattype_from_cpdf,
                # markerset.cxx:1177-1303); empty elements fall back to
                # the nearest marker's material
                add_mattype = np.zeros(len(add_elems), dtype=np.int32)
                mark_pts = (bary_to_coord(new_coord, new_conn,
                                          ms.live("elem"), ms.live("eta"))
                            if ms.n else None)
                for i, e in enumerate(add_elems):
                    tot = hist[e].sum()
                    if tot > 0:
                        add_mattype[i] = rng.choice(nmat, p=hist[e] / tot)
                    elif ms.n:
                        d2 = ((mark_pts - p_new[i]) ** 2).sum(axis=1)
                        add_mattype[i] = ms.mattype[int(np.argmin(d2))]
            else:
                # nearest existing marker's material
                # (replenish_markers_with_mattype_from_nn,
                # markerset.cxx:1306-1475)
                if ms.n:
                    mark_pts = bary_to_coord(new_coord, new_conn,
                                             ms.live("elem"),
                                             ms.live("eta"))
                    _, nn_i = cKDTree(mark_pts).query(p_new)
                    add_mattype = ms.mattype[: ms.n][nn_i].astype(np.int32)
                else:
                    add_mattype = np.zeros(len(add_elems), dtype=np.int32)
            ms.append(eta_new, elems, np.asarray(add_mattype,
                                                 dtype=np.int32),
                      z=p_new[:, -1], distance=p_new[:, 0], genesis=1)
