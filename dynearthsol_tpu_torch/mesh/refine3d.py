"""Delaunay refinement with a radius-edge bound: the 3D mesh-quality
guarantee (counterpart of dynearthsol_tpu/mesh/refine3d.py, the box
domains of the 3D box mesher).

The reference gets its constructive 3D quality bound from TetGen's
``q<max_ratio>`` switch (set_3d_quality_str, mesh.cxx:745-757; option
``mesh.max_ratio``, default 2.0, input.cxx:182-183).  TetGen's primary
refinement criterion is the circumradius-to-shortest-edge ratio; the
dihedral-angle bounds (``mesh.min_tet_angle``) belong to its mesh
optimizer, not to Delaunay insertion, and are not enforced here.

Batched, as mesh/refine2d.py: each round computes ONE scipy Delaunay over
all points and inserts a batch of Steiner points chosen from an
independent set of bad tets (no two sharing a vertex), each at the tet's
off-centre (Ungor 2004, generalised to 3D): on the ray from the shortest
edge's midpoint to the circumcentre, the first point whose distance to the
shortest edge's endpoints reaches ``max_ratio`` times the edge length.  A
circumradius-scaled separation filter guards the batch.  A volume floor
exempts tets already below the ``smallest_size`` culling threshold, so the
loop terminates.  An off-centre that leaves the box is projected onto its
nearest boundary point (``box_project_fn_3d``).

The numpy and scipy calls are the JAX package's, in its order, so both
packages place the same points bit for bit.
"""

from __future__ import annotations

import numpy as np


def tet_quality_stats(coord: np.ndarray, conn: np.ndarray):
    """(radius_edge_ratio, min_dihedral_deg, volume) per tet, vectorized.

    radius-edge = circumradius / shortest edge length (TetGen q metric);
    min dihedral in degrees (TetGen qq metric, mesh.min_tet_angle).
    """
    p = coord[conn]                                     # (n, 4, 3)
    a = p[:, 0]
    b, c, d = p[:, 1] - a, p[:, 2] - a, p[:, 3] - a
    vol6 = np.einsum("ij,ij->i", b, np.cross(c, d))     # signed 6V
    vol = np.abs(vol6) / 6.0

    # circumcenter: solve 2 [b; c; d] u = [|b|^2; |c|^2; |d|^2]
    b2 = (b * b).sum(1)
    c2 = (c * c).sum(1)
    d2 = (d * d).sum(1)
    cb = np.cross(c, d)
    cc_ = np.cross(d, b)
    cd = np.cross(b, c)
    denom = np.where(np.abs(vol6) < 1e-300, 1e-300, vol6)
    u = (b2[:, None] * cb + c2[:, None] * cc_ + d2[:, None] * cd) \
        / (2.0 * denom)[:, None]
    # near-flat tets put the circumcenter at ~1/denom: clip before the
    # norm squares it past f64 range (the ratio saturates either way)
    R = np.linalg.norm(np.clip(u, -1e150, 1e150), axis=1)

    # all six edges
    pairs = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
    ev = np.stack([p[:, j] - p[:, i] for i, j in pairs], axis=1)  # (n,6,3)
    elen = np.linalg.norm(ev, axis=2)                             # (n, 6)
    lmin = elen.min(axis=1)
    ratio = R / np.where(lmin > 0, lmin, 1e-300)

    # min dihedral: for each of the 6 edges, the angle between the two
    # faces NOT containing the opposite-edge pair.  face normal of
    # (i,j,k) = cross(pj-pi, pk-pi); dihedral along edge (i,j) between
    # faces (i,j,k) and (i,j,l).
    def fnorm(i, j, k):
        n = np.cross(p[:, j] - p[:, i], p[:, k] - p[:, i])
        ln = np.linalg.norm(n, axis=1, keepdims=True)
        return n / np.where(ln > 0, ln, 1.0)

    # edge (i,j) with remaining vertices (k,l): dihedral angle =
    # pi - angle(normal(i,j,k), normal(i,j,l)) with outward-consistent
    # ordering; use the formula via the two face normals sharing the edge
    dihedrals = []
    verts = (0, 1, 2, 3)
    for (i, j) in pairs:
        k, l = [v for v in verts if v not in (i, j)]
        n1 = fnorm(i, j, k)
        n2 = fnorm(i, j, l)
        cosang = np.clip((n1 * n2).sum(1), -1.0, 1.0)
        # both normals are (edge x spoke) vectors rotating about the
        # shared edge, so the angle between them IS the dihedral angle
        dihedrals.append(np.arccos(cosang))
    mindih = np.degrees(np.min(np.stack(dihedrals, axis=1), axis=1))
    return ratio, mindih, vol


def _delaunay3(coord: np.ndarray) -> np.ndarray:
    from scipy.spatial import Delaunay

    return Delaunay(coord, qhull_options="Qbb Qc Qz").simplices \
        .astype(np.int64)


def refine_radius_edge(coord: np.ndarray, inside_fn,
                       max_ratio: float = 2.0,
                       vol_floor: float = 0.0,
                       max_rounds: int = 48,
                       max_growth: float = 4.0,
                       project_fn=None):
    """Insert Steiner points until every kept tet of the Delaunay
    tetrahedralization has circumradius/shortest-edge <= ``max_ratio``.

    ``inside_fn(points) -> bool mask``: true strictly inside the domain
    (used both to ignore outside-domain hull slivers, which the caller
    culls, and to detect escaped insertion points).
    ``vol_floor``: tets at/below this volume are never refined.
    ``project_fn(points) -> points``: maps an escaped candidate to the
    nearest domain-boundary point — the practical analog of Ruppert's
    split-the-encroached-facet rule (an off-center that exits the
    domain means a boundary facet is under-resolved for the local
    feature size; the projected point refines exactly that facet).
    None drops escaped candidates instead (PLC callers, where the
    conformity audit + densify-retry own boundary resolution).

    Returns (coord, converged); ``converged=False`` means bad tets
    remain but no further candidate was insertable (boundary-limited)
    or a safety bound tripped — the caller's retry loop owns that.
    """
    coord = np.asarray(coord, dtype=np.float64)
    if max_ratio <= 0.0:
        return coord, True
    from .refine2d import _dedupe

    n_in = coord.shape[0]
    converged = False
    for _ in range(max_rounds):
        n = coord.shape[0]
        if n > max_growth * n_in:
            break  # safety valve
        conn = _delaunay3(coord)
        cen = coord[conn].mean(axis=1)
        interior = inside_fn(cen)
        ratio, _, vol = tet_quality_stats(coord, conn)
        bad = (ratio > max_ratio) & interior & (vol > vol_floor)
        if not bad.any():
            converged = True
            break

        # independent set, worst first
        bad_ids = np.where(bad)[0]
        bad_ids = bad_ids[np.argsort(-ratio[bad_ids])]
        used = np.zeros(n, dtype=bool)
        sel = []
        for t in bad_ids:
            vs = conn[t]
            if not used[vs].any():
                sel.append(t)
                used[vs] = True
        bconn = conn[np.asarray(sel)]
        k = bconn.shape[0]
        p = coord[bconn]                                 # (k, 4, 3)

        # shortest edge + midpoint
        pairs = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
        ev = np.stack([p[:, j] - p[:, i] for i, j in pairs], axis=1)
        elen = np.linalg.norm(ev, axis=2)                # (k, 6)
        short = np.argmin(elen, axis=1)
        ar = np.arange(k)
        si_ = np.asarray([pr[0] for pr in pairs])[short]
        sj_ = np.asarray([pr[1] for pr in pairs])[short]
        pa = p[ar, si_]
        pb = p[ar, sj_]
        mid = 0.5 * (pa + pb)
        L = elen[ar, short]
        half = 0.5 * L

        # circumcenter (recompute on the selected subset)
        a4 = p[:, 0]
        b4, c4, d4 = p[:, 1] - a4, p[:, 2] - a4, p[:, 3] - a4
        vol6 = np.einsum("ij,ij->i", b4, np.cross(c4, d4))
        denom = np.where(np.abs(vol6) < 1e-300, 1e-300, vol6)
        u = ((b4 * b4).sum(1)[:, None] * np.cross(c4, d4)
             + (c4 * c4).sum(1)[:, None] * np.cross(d4, b4)
             + (d4 * d4).sum(1)[:, None] * np.cross(b4, c4)) \
            / (2.0 * denom)[:, None]
        cc = a4 + u

        # 3D off-center: stop on the mid->cc ray where the distance to
        # the shortest edge's endpoints reaches max_ratio * L, i.e.
        # sqrt(y^2 + half^2) = max_ratio * L  ->  y = half*sqrt(4r^2 - 1)
        # (degenerate near-flat tets put cc at huge distance: clip the
        # ray length before norms to dodge f64 overflow)
        dvec = np.clip(cc - mid, -1e150, 1e150)
        dlen = np.maximum(np.linalg.norm(dvec, axis=1), 1e-300)
        uv = dvec / dlen[:, None]
        y_off = half * np.sqrt(max(4.0 * max_ratio**2 - 1.0, 0.0))
        y = np.minimum(dlen, y_off)
        pts = mid + y[:, None] * uv
        escaped = ~inside_fn(pts)
        if project_fn is not None and escaped.any():
            # Ruppert boundary rule analog: an escaped off-center means
            # an under-resolved boundary facet — refine the facet at
            # the candidate's nearest boundary point
            pts[escaped] = project_fn(pts[escaped])
            ok = np.ones(k, dtype=bool)
        else:
            ok = ~escaped
        # insertion radius: distance to the shortest-edge endpoints
        # (empty by the off-center lens property; projected points
        # rely on the separation filter below instead).  The floor of
        # one full shortest-edge length L guarantees no insertion ever
        # creates an edge shorter than the local feature size — without
        # it, projected boundary points can cascade into ever-shorter
        # edges (each generation ~0.4x) and the ratio diverges.
        y_eff = np.linalg.norm(pts - mid, axis=1)
        ok &= y_eff > 0.5 * half    # degenerate projections are useless
        prad = np.maximum(0.7 * np.sqrt(y_eff**2 + half**2), L)
        pts, prad = pts[ok], prad[ok]
        if pts.shape[0] == 0:
            break                   # boundary-limited: NOT converged
        keep = _dedupe(pts, prad, coord)
        if not keep.any():
            break                   # separation-limited: NOT converged
        coord = np.concatenate([coord, pts[keep]])
    return coord, converged


def box_project_fn_3d(xlength: float, ylength: float, surf, bot):
    """Componentwise clamp of escaped points onto the box-with-
    topography boundary: x/y to the walls, z to the bottom/surface
    sheets — the nearest boundary point for axis-aligned walls.  The
    result lies exactly on a face plane, so downstream positional
    boundary flagging picks it up."""

    def fn(p):
        p = np.asarray(p, dtype=np.float64).reshape(-1, 3).copy()
        p[:, 0] = np.clip(p[:, 0], 0.0, xlength)
        p[:, 1] = np.clip(p[:, 1], 0.0, ylength)
        zs = np.asarray(surf(p[:, 0], p[:, 1]))
        zb = np.asarray(bot(p[:, 0], p[:, 1]))
        p[:, 2] = np.clip(p[:, 2], zb, zs)
        return p

    return fn


def box_inside_fn_3d(xlength: float, ylength: float, surf, bot,
                     pad_rel: float = 1e-9):
    """inside_fn for the box-with-topography 3D domain: x/y within the
    walls, z strictly between the bottom and surface sheets (callables
    of (x, y) -> z, vectorized)."""

    def fn(p):
        p = np.asarray(p, dtype=np.float64).reshape(-1, 3)
        padx = pad_rel * xlength
        pady = pad_rel * ylength
        zs = np.asarray(surf(p[:, 0], p[:, 1]))
        zb = np.asarray(bot(p[:, 0], p[:, 1]))
        padz = pad_rel * max(float(np.max(zs - zb)), 1.0)
        return ((p[:, 0] > padx) & (p[:, 0] < xlength - padx)
                & (p[:, 1] > pady) & (p[:, 1] < ylength - pady)
                & (p[:, 2] > zb + padz) & (p[:, 2] < zs - padz))

    return fn
