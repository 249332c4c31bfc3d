"""Ruppert-style Delaunay refinement: the 2D mesh-quality guarantee
(counterpart of dynearthsol_tpu/mesh/refine2d.py: the box boundary chains
of the box meshers and remeshing, and the explicit segments and size field
of the .poly mesher).

The reference gets its constructive quality bound from Triangle's
``q<min_angle>`` switch (set_2d_quality_str, mesh.cxx:110-118; option
``mesh.min_angle``, default 32 degrees, input.cxx:177-179), applied both
at initial meshing and at every remesh (points_to_new_mesh,
mesh.cxx:2577-2621; new_mesh retry loop, remeshing.cxx:1109-1363).

This module provides the same guarantee for the first-party meshing
path: triangles of the Delaunay triangulation whose minimum angle falls
below the bound are eliminated by inserting their circumcenters; a
circumcenter that encroaches a boundary segment's diametral disk splits
that segment at its midpoint instead (Ruppert 1995).  Segment recovery
(every consecutive boundary-chain pair must be a Delaunay edge) is part
of the same fixed point: a missing or encroached segment is split before
any circumcenter is considered.

Batched variant, tuned for numpy/scipy rather than an incremental DAG:
each round recomputes ONE scipy Delaunay over all points and inserts a
batch of Steiner points chosen from an INDEPENDENT SET of skinny
triangles (no two sharing a vertex), each point placed at the
triangle's OFF-CENTER (Ungor 2004) rather than the circumcenter — the
nearest point on the shortest-edge bisector whose insertion yields the
target angle.  Off-centers insert fewer points and keep batched
insertions from colliding; a circumradius-scaled separation filter
guards the rest.  Rounds are bounded; Ruppert terminates for input
angles >= ~60 degrees (the box corners here are ~90), and the area
floor makes termination unconditional: triangles already smaller than
the ``smallest_size`` culling threshold are never refined (they are
deleted by the tiny-element path instead, matching
remeshing.cxx:509-618).
"""

from __future__ import annotations

import numpy as np

from ..constants import BOUNDX0, BOUNDX1, BOUNDZ0, BOUNDZ1

# each boundary chain is sorted along its running axis (x for top/bottom,
# z for the side walls) — same convention as the .poly boundary assembly
_CHAIN_BITS = ((BOUNDZ1, 0), (BOUNDZ0, 0), (BOUNDX0, 1), (BOUNDX1, 1))


def _chains(coord: np.ndarray, bcflag: np.ndarray):
    out = []
    for bit, axis in _CHAIN_BITS:
        ids = np.where((bcflag & bit) != 0)[0]
        if ids.size >= 2:
            out.append(ids[np.argsort(coord[ids, axis])])
    return out


def _segments(coord: np.ndarray, bcflag: np.ndarray) -> np.ndarray:
    """(nseg, 2) node-id pairs of all boundary sub-segments."""
    segs = [np.stack([ids[:-1], ids[1:]], axis=1)
            for ids in _chains(coord, bcflag)]
    return (np.concatenate(segs) if segs
            else np.zeros((0, 2), dtype=np.int64))


def tri_min_angle(coord: np.ndarray, conn: np.ndarray) -> np.ndarray:
    """Per-triangle minimum interior angle in degrees (vectorized)."""
    p = coord[conn]                                   # (n, 3, 2)
    e = p[:, [1, 2, 0]] - p[:, [2, 0, 1]]             # opposite edges
    L = np.linalg.norm(e, axis=2)                     # (n, 3)
    a, b, c = L[:, 0], L[:, 1], L[:, 2]
    # law of cosines per corner; clip for degenerate rounding
    def ang(opp, s1, s2):
        d = 2.0 * s1 * s2
        cosv = np.where(d > 0, (s1**2 + s2**2 - opp**2)
                        / np.where(d > 0, d, 1.0), 1.0)
        return np.degrees(np.arccos(np.clip(cosv, -1.0, 1.0)))
    return np.minimum(np.minimum(ang(a, b, c), ang(b, c, a)),
                      ang(c, a, b))


def _circumcenters(coord: np.ndarray, conn: np.ndarray) -> np.ndarray:
    a = coord[conn[:, 0]]
    b = coord[conn[:, 1]] - a
    c = coord[conn[:, 2]] - a
    d = 2.0 * (b[:, 0] * c[:, 1] - b[:, 1] * c[:, 0])
    d = np.where(np.abs(d) < 1e-300, 1e-300, d)
    b2 = (b * b).sum(axis=1)
    c2 = (c * c).sum(axis=1)
    ux = (c[:, 1] * b2 - b[:, 1] * c2) / d
    uy = (b[:, 0] * c2 - c[:, 0] * b2) / d
    return a + np.stack([ux, uy], axis=1)


def _delaunay(coord: np.ndarray) -> np.ndarray:
    from scipy.spatial import Delaunay
    return Delaunay(coord, qhull_options="Qbb Qc Qz").simplices \
        .astype(np.int64)


def _edge_keys(conn: np.ndarray, n: int) -> np.ndarray:
    e = conn[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2)
    e.sort(axis=1)
    return np.unique(e[:, 0] * n + e[:, 1])


def _dedupe(points: np.ndarray, radii: np.ndarray,
            existing: np.ndarray) -> np.ndarray:
    """Greedy min-separation filter for one batch of insertions: drop a
    candidate within ``radii`` of an existing point or of an
    already-accepted candidate."""
    if points.shape[0] == 0:
        return np.zeros(0, dtype=bool)
    from scipy.spatial import cKDTree
    keep = np.ones(points.shape[0], dtype=bool)
    if existing.shape[0]:
        d, _ = cKDTree(existing).query(points, k=1)
        keep &= d > radii
    idx = np.where(keep)[0]
    if idx.size > 1:
        t = cKDTree(points[idx])
        rmax = float(radii[idx].max())
        for i, j in sorted(t.query_pairs(rmax)):
            gi, gj = idx[i], idx[j]
            if keep[gi] and keep[gj] and np.linalg.norm(
                    points[gi] - points[gj]) <= max(radii[gi], radii[gj]):
                keep[gj] = False
    return keep


def refine_min_angle(coord: np.ndarray, bcflag: np.ndarray,
                     inside_fn, min_angle: float,
                     area_floor: float = 0.0,
                     max_rounds: int = 64,
                     max_growth: float = 8.0,
                     segments: np.ndarray | None = None,
                     max_area_fn=None):
    """Refine a boundary-flagged point set until every kept triangle of
    its Delaunay triangulation has min angle >= ``min_angle`` degrees.

    ``inside_fn(points) -> bool mask``: true where a point lies strictly
    inside the domain (used both to ignore outside-domain slivers, which
    the caller culls, and to reject escaped circumcenters).
    ``area_floor``: triangles at/below this area are never refined (the
    tiny-element deletion path owns them).
    ``segments``: explicit (nseg, 2) PSLG constraint segments (the .poly
    path); None derives the box boundary chains from ``bcflag`` each
    round.  ``max_area_fn(points) -> max area``: local size field —
    triangles larger than the bound at their centroid are split too
    (Triangle's per-region `-a` area constraint, the mechanism that
    preserves Triangle's fine/coarse grading contrast through the
    quality pass; mesh.cxx:2577-2621 via triangle).  Returns (coord,
    bcflag, segments, converged): in explicit mode segments is the
    split-updated (nseg', 2) array and the (nseg',) index of the input
    segment each row descends from, so that callers can carry per-segment
    flags across splits; None in box mode.
    """
    coord = np.asarray(coord, dtype=np.float64)
    bcflag = np.asarray(bcflag)
    explicit = segments is not None
    seg_origin = None
    if explicit:
        segments = np.asarray(segments, dtype=np.int64).copy()
        seg_origin = np.arange(segments.shape[0], dtype=np.int64)
    if min_angle <= 0.0:
        return coord, bcflag, \
            ((segments, seg_origin) if explicit else None), True
    from scipy.spatial import cKDTree

    converged = False
    n_in = coord.shape[0]
    for _ in range(max_rounds):
        n = coord.shape[0]
        if n > max_growth * n_in:
            break  # safety valve: pathological input, stop refining
        conn = _delaunay(coord)
        segs = segments if explicit else _segments(coord, bcflag)
        new_pts, new_flags, new_rads = [], [], []
        split_cand = {}  # seg row -> candidate index in new_pts

        smid = 0.5 * (coord[segs[:, 0]] + coord[segs[:, 1]])
        srad = 0.5 * np.linalg.norm(coord[segs[:, 0]]
                                    - coord[segs[:, 1]], axis=1)

        def split_seg(si):
            if si in split_cand:
                return
            a, b = segs[si]
            split_cand[si] = len(new_pts)
            new_pts.append(smid[si])
            new_flags.append(bcflag[a] & bcflag[b])
            new_rads.append(0.25 * srad[si])

        # 1. missing chain segments (constrained-edge recovery)
        ekeys = _edge_keys(conn, n)
        lo = np.minimum(segs[:, 0], segs[:, 1])
        hi = np.maximum(segs[:, 0], segs[:, 1])
        missing = ~np.isin(lo * n + hi, ekeys)

        # 2. segments encroached by an existing point (diametral disk);
        #    skip the segment's own endpoints
        encroached = np.zeros(segs.shape[0], dtype=bool)
        if segs.shape[0]:
            tree = cKDTree(coord)
            hits = tree.query_ball_point(smid, srad * (1.0 - 1e-12))
            for si, pts in enumerate(hits):
                if any(pid not in (segs[si, 0], segs[si, 1])
                       for pid in pts):
                    encroached[si] = True
        for si in np.where(missing | encroached)[0]:
            split_seg(si)

        # 3. skinny triangles -> off-center Steiner point (or split the
        #    segment the point encroaches)
        cen = coord[conn].mean(axis=1)
        interior = inside_fn(cen)
        v = coord[conn]
        area = 0.5 * np.abs(
            (v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1])
            - (v[:, 1, 1] - v[:, 0, 1]) * (v[:, 2, 0] - v[:, 0, 0]))
        angles = tri_min_angle(coord, conn)
        bad = (angles < min_angle) & interior & (area > area_floor)
        if max_area_fn is not None:
            # size-field violation: oversized triangles split at their
            # circumcenter like Triangle's area constraint
            bad = bad | (interior & (area > max_area_fn(cen)))
        if not bad.any() and not new_pts:
            converged = True
            break
        if bad.any():
            # independent set, worst first: no two handled triangles
            # share a vertex, so batch insertions cannot interact
            bad_ids = np.where(bad)[0]
            bad_ids = bad_ids[np.argsort(angles[bad_ids])]
            used = np.zeros(n, dtype=bool)
            sel = []
            for t in bad_ids:
                va, vb, vc = conn[t]
                if not (used[va] or used[vb] or used[vc]):
                    sel.append(t)
                    used[va] = used[vb] = used[vc] = True
            bconn = conn[np.asarray(sel)]

            # shortest edge (a,b) and its midpoint per selected triangle
            edges = bconn[:, [[0, 1], [1, 2], [2, 0]]]       # (k, 3, 2)
            ev = coord[edges[..., 1]] - coord[edges[..., 0]]
            elen = np.linalg.norm(ev, axis=2)                # (k, 3)
            short = np.argmin(elen, axis=1)
            k = bconn.shape[0]
            se = edges[np.arange(k), short]                  # (k, 2)
            half = 0.5 * elen[np.arange(k), short]
            mid = 0.5 * (coord[se[:, 0]] + coord[se[:, 1]])

            # off-center (Ungor 2004): walk from the shortest-edge
            # midpoint toward the circumcenter, but stop at the nearest
            # point whose insertion makes the new triangle's angle at
            # the shortest edge exactly the target
            cc = _circumcenters(coord, bconn)
            dvec = cc - mid
            dlen = np.maximum(np.linalg.norm(dvec, axis=1), 1e-300)
            u = dvec / dlen[:, None]
            rt = half / max(np.sin(np.radians(min_angle)), 1e-9)
            y_off = rt + np.sqrt(np.maximum(rt**2 - half**2, 0.0))
            if max_area_fn is not None:
                # the circumcenter, as Triangle's default Ruppert rule:
                # new edges are >= the circumradius, so element size grows
                # away from fine zones (the grading contrast); the
                # off-center would carry the fine length scale across the
                # coarse regions
                y = np.maximum(dlen, 0.0)
            else:
                # off-center (Ungor 2004) for the box/remesh paths:
                # fewer insertions, grading is externally controlled
                y = np.minimum(dlen, y_off)
            pts3 = mid + y[:, None] * u
            # exclusion radius: no other insertion within the new
            # point's distance to its own triangle (keeps new edges
            # from being shorter than the local feature size)
            prad = 0.7 * np.sqrt(y**2 + half**2)

            p_in = inside_fn(pts3)
            enc_split = set()
            if segs.shape[0]:
                tree_s = cKDTree(smid)
                rmax = float(srad.max()) if srad.size else 0.0
                near = tree_s.query_ball_point(pts3, rmax)
                for i in range(pts3.shape[0]):
                    cand = [si for si in near[i]
                            if np.linalg.norm(pts3[i] - smid[si])
                            < srad[si]]
                    if cand:
                        # encroaches: split the nearest such segment
                        si = min(cand, key=lambda s:
                                 np.linalg.norm(pts3[i] - smid[s]))
                        enc_split.add(si)
                    elif p_in[i]:
                        new_pts.append(pts3[i])
                        new_flags.append(np.uint32(0))
                        new_rads.append(prad[i])
            else:
                for i in np.where(p_in)[0]:
                    new_pts.append(pts3[i])
                    new_flags.append(np.uint32(0))
                    new_rads.append(prad[i])
            for si in enc_split:
                split_seg(si)

        if not new_pts:
            converged = True
            break
        pts = np.asarray(new_pts)
        rads = np.asarray(new_rads)
        keep = _dedupe(pts, rads, coord)
        # a segment split must never be lost to the separation filter —
        # segment recovery/conformity is a hard constraint
        for j in split_cand.values():
            keep[j] = True
        if not keep.any():
            converged = True
            break
        if explicit and split_cand:
            new_id = n + np.cumsum(keep) - 1     # id of candidate j
            extra_rows, extra_orig = [], []
            for si, j in split_cand.items():
                nid = int(new_id[j])
                a, b = segments[si]
                segments[si] = (a, nid)
                extra_rows.append((nid, b))
                extra_orig.append(seg_origin[si])
            segments = np.concatenate(
                [segments, np.asarray(extra_rows, dtype=np.int64)])
            seg_origin = np.concatenate(
                [seg_origin, np.asarray(extra_orig, dtype=np.int64)])
        coord = np.concatenate([coord, pts[keep]])
        bcflag = np.concatenate(
            [bcflag, np.asarray(new_flags, dtype=bcflag.dtype)[keep]])
    return coord, bcflag, \
        ((segments, seg_origin) if explicit else None), converged


def box_inside_fn(xlength: float, surf, bot, pad_rel: float = 1e-9):
    """inside_fn for the standard box-with-topography domain: x within
    the box walls, z strictly between the bottom and surface curves."""
    def fn(p):
        p = np.asarray(p, dtype=np.float64).reshape(-1, 2)
        padx = pad_rel * xlength
        zs, zb = np.asarray(surf(p[:, 0])), np.asarray(bot(p[:, 0]))
        padz = pad_rel * max(float(np.max(zs - zb)), 1.0)
        return ((p[:, 0] > padx) & (p[:, 0] < xlength - padx)
                & (p[:, 1] > zb + padz) & (p[:, 1] < zs - padz))
    return fn
