"""Meshing from Triangle-format .poly files (meshing_option 90/91;
counterpart of dynearthsol_tpu/mesh/poly.py, the same numpy and scipy
calls in the same order, so both packages place the same points).

The reference hands the PSLG to Shewchuk's Triangle
(new_mesh_from_polyfile, mesh.cxx:1848-2230; points_to_new_mesh,
mesh.cxx:2577-2621) with regional attributes (mattype) and per-region
max-area constraints.  Here the same contract is met without a native
mesher: segments are sampled at the local target spacing, a graded
thinned lattice fills the interior, scipy/Qhull triangulates, and region
ids (regattr) propagate by flood fill across non-constrained edges from
the region seed points — segments act as barriers exactly like
Triangle's regional attributes.

This module is the 2D path; the TetGen-format 3D .poly path (planar
facets, regions, per-facet boundary markers) lives in mesh/poly3.py.
"""

from __future__ import annotations

import collections

import numpy as np

from .generate import MeshData, _drop_degenerate_2d, _orient_2d


def read_poly_2d(path: str):
    """Parse a 2D Triangle .poly file (format: quake/triangle.poly.html,
    subset accepted by mesh.cxx:1848-2230).  Returns (points, segments,
    segflags, regions) where regions rows are (x, z, mattype, size)."""
    tokens = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                tokens.extend(line.split())
    it = iter(tokens)

    def nxt(cast=float):
        return cast(next(it))

    npoints = nxt(int)
    ndims = nxt(int)
    nattr = nxt(int)
    nbdrym = nxt(int)
    if ndims != 2 or nattr != 0 or nbdrym != 0:
        raise ValueError(f"unsupported .poly header in {path}")
    pts = np.zeros((npoints, 2))
    for i in range(npoints):
        k = nxt(int)
        if k != i:
            raise ValueError(f"{path}: node ids must count from 0")
        pts[i, 0] = nxt()
        pts[i, 1] = nxt()
    nseg = nxt(int)
    has_flag = nxt(int)
    segs = np.zeros((nseg, 2), dtype=np.int64)
    flags = np.zeros(nseg, dtype=np.int64)
    for i in range(nseg):
        k = nxt(int)
        if k != i:
            raise ValueError(f"{path}: segment ids must count from 0")
        segs[i, 0] = nxt(int)
        segs[i, 1] = nxt(int)
        if has_flag:
            flags[i] = nxt(int)
    nholes = nxt(int)
    if nholes != 0:
        raise ValueError(f"{path}: holes not supported (must be 0)")
    nreg = nxt(int)
    regions = np.zeros((nreg, 4))
    for i in range(nreg):
        nxt(int)  # region id: the reference reads exactly nreg rows and
        # ignores the id column (some example files misnumber it)
        regions[i] = [nxt(), nxt(), nxt(), nxt()]
    return pts, segs, flags, regions


def _sample_segments(pts, segs, h_of_seg):
    """Split each segment at its target spacing.  Returns (points,
    sub_edges) where sub_edges index into the returned points."""
    out_pts = [p for p in pts]
    index = {i: i for i in range(len(pts))}
    edges = []
    for si, (a, b) in enumerate(segs):
        pa, pb = pts[a], pts[b]
        length = float(np.hypot(*(pb - pa)))
        nsub = max(1, int(round(length / h_of_seg[si])))
        prev = a
        for k in range(1, nsub):
            p = pa + (pb - pa) * (k / nsub)
            out_pts.append(p)
            cur = len(out_pts) - 1
            edges.append((prev, cur, si))
            prev = cur
        edges.append((prev, b, si))
    return np.asarray(out_pts), edges


def _flood_fill_regions(coord, conn, barrier_edges, seeds):
    """Assign each triangle the region of the seed it can reach without
    crossing a barrier (constrained) edge."""
    from scipy.spatial import Delaunay  # noqa: F401  (doc only)

    edge_tris = collections.defaultdict(list)
    for t, tri in enumerate(conn):
        for i in range(3):
            e = tuple(sorted((tri[i], tri[(i + 1) % 3])))
            edge_tris[e].append(t)
    barrier = set(tuple(sorted(e)) for e in barrier_edges)

    regattr = np.full(conn.shape[0], -1, dtype=np.int32)
    # locate seed triangles
    cen = coord[conn].mean(axis=1)
    for rid, (sx, sz) in enumerate(seeds):
        # barycentric containment test against every triangle (meshes are
        # small at poly-build time; one-off host cost)
        a, b, c = coord[conn[:, 0]], coord[conn[:, 1]], coord[conn[:, 2]]
        det = ((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
               - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))
        w0 = ((b[:, 0] - sx) * (c[:, 1] - sz)
              - (b[:, 1] - sz) * (c[:, 0] - sx)) / det
        w1 = ((c[:, 0] - sx) * (a[:, 1] - sz)
              - (c[:, 1] - sz) * (a[:, 0] - sx)) / det
        w2 = 1.0 - w0 - w1
        inside = (w0 >= -1e-12) & (w1 >= -1e-12) & (w2 >= -1e-12)
        if not inside.any():
            continue
        t0 = int(np.nonzero(inside)[0][0])
        # BFS
        stack = [t0]
        while stack:
            t = stack.pop()
            if regattr[t] != -1:
                continue
            regattr[t] = rid
            for i in range(3):
                e = tuple(sorted((conn[t, i], conn[t, (i + 1) % 3])))
                if e in barrier:
                    continue
                for t2 in edge_tris[e]:
                    if regattr[t2] == -1:
                        stack.append(t2)
    if (regattr == -1).any():
        # unreachable pockets: nearest seed fallback
        for t in np.nonzero(regattr == -1)[0]:
            d = ((np.asarray(seeds) - cen[t]) ** 2).sum(axis=1)
            regattr[t] = int(np.argmin(d))
    return regattr


def mesh_from_poly_2d(param) -> MeshData:
    """Graded triangulation of a 2D .poly PSLG with regional mattypes
    (meshing_option 90: sizes in m^2; 91: in resolution^2 units)."""
    m = param.mesh
    pts, segs, flags, regions = read_poly_2d(m.poly_filename)
    res = m.resolution
    std_size = 1.5 * res * res  # mesh.cxx:1868
    # option 91 sizes are in units of the STANDARD element size, not
    # resolution^2 (mesh.cxx:2110-2115 scales by std_elem_size)
    unit = 1.0 if m.meshing_option == 90 else std_size
    unlimited = regions[:, 3] <= 0
    sizes = np.where(~unlimited, regions[:, 3] * unit,
                     std_size * m.largest_size)
    # unconstrained regions still pre-sample their BOUNDARY segments at
    # the largest_size spacing (well-spaced outer boundaries keep the
    # encroachment cascade from over-splitting), but get no interior
    # seeding and no area bound — size then grows quality-limited away
    # from the constrained zones like Triangle's regional -a behaviour
    h_region = np.sqrt(2.0 * sizes)
    seeds = regions[:, :2]
    rng = np.random.default_rng(12345)

    # probe triangulation (vertices + finest segment sampling) to get a
    # region-membership oracle for grading
    h_min = float(h_region.min())
    probe_pts, probe_edges = _sample_segments(pts, segs,
                                              [h_min] * len(segs))
    from scipy.spatial import Delaunay

    probe = Delaunay(probe_pts, qhull_options="Qbb Qc Qz")
    # NOTE: keep the unfiltered simplices — find_simplex ids index them
    probe_conn = probe.simplices.astype(np.int32)
    probe_reg = _flood_fill_regions(
        probe_pts, probe_conn, [(a, b) for a, b, _ in probe_edges], seeds)

    def h_at(p):
        t = probe.find_simplex(p)
        out = t < 0  # outside the hull: no size constraint there
        t = np.clip(t, 0, len(probe_reg) - 1)
        return np.where(out, np.inf, h_region[probe_reg[t]])

    # final segment sampling at the local spacing (min of both sides).
    # Outside-the-hull / unconstrained sides fall back to the
    # largest_size spacing: leaving outer boundaries unsampled lets the
    # Ruppert encroachment cascade over-refine the coarse interior
    # (the coarse median area halves without this cap)
    h_cap = float(np.sqrt(2.0 * std_size * m.largest_size))
    h_seg = []
    for a, b in segs:
        mid = (pts[a] + pts[b]) / 2.0
        d = pts[b] - pts[a]
        nrm = np.array([-d[1], d[0]])
        nrm /= max(np.hypot(*nrm), 1e-300)
        eps = 0.01 * np.hypot(*d)
        h2 = min(h_at(mid + eps * nrm), h_at(mid - eps * nrm))
        h_seg.append(float(min(h2, h_cap)))
    final_pts, final_edges = _sample_segments(pts, segs, h_seg)

    # graded interior lattice, thinned to the local target density
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    nx = int(np.ceil((hi[0] - lo[0]) / h_min)) + 1
    nz = int(np.ceil((hi[1] - lo[1]) / h_min)) + 1
    X, Z = np.meshgrid(np.linspace(lo[0], hi[0], nx),
                       np.linspace(lo[1], hi[1], nz), indexing="ij")
    P = np.stack([X.ravel(), Z.ravel()], axis=1)
    hP = h_at(P)
    keep = rng.random(P.shape[0]) < (h_min / hP) ** 2
    # regions WITHOUT a size constraint get no interior seeding at all —
    # Triangle only quality-refines there, so element size grows
    # geometrically away from the constrained zones (the grading
    # contrast; mesh.cxx:2577-2621 via triangle)
    if unlimited.any():
        regP = probe_reg[np.clip(probe.find_simplex(P), 0,
                                 len(probe_reg) - 1)]
        keep &= ~unlimited[regP]
    P = P[keep]
    hP = hP[keep]
    # jitter scales with the LOCAL spacing: a fixed h_min jitter leaves
    # coarse-region points nearly on the regular lattice, whose skinny
    # transition triangles then over-refine the coarse side)
    P = P + 0.35 * hP[:, None] * (rng.random(P.shape) - 0.5)
    # drop lattice points crowding any segment
    dmin = np.full(P.shape[0], np.inf)
    for a, b in segs:
        pa, pb = pts[a], pts[b]
        d = pb - pa
        L2 = float(d @ d)
        t = np.clip(((P - pa) @ d) / L2, 0.0, 1.0)
        proj = pa + t[:, None] * d
        dmin = np.minimum(dmin, np.hypot(*(P - proj).T))
    P = P[dmin > 0.55 * hP]

    coord = np.concatenate([final_pts, P], axis=0)

    # Ruppert min-angle refinement: the quality bound the reference gets
    # from Triangle's `q` switch on .poly meshes (new_mesh_from_polyfile
    # -> points_to_new_mesh, mesh.cxx:1848-2230 + 2577-2621).  Constraint
    # segments are the sampled PSLG edges; splits update them in place.
    if m.min_angle > 0:
        from .refine2d import refine_min_angle

        seg_arr = np.asarray([(a, b) for a, b, _ in final_edges],
                             dtype=np.int64)
        flags_in = np.asarray([f for _, _, f in final_edges])
        hull = Delaunay(pts[np.unique(segs)], qhull_options="Qbb Qc Qz")

        def inside(p):
            p = np.asarray(p, dtype=np.float64).reshape(-1, 2)
            return hull.find_simplex(p) >= 0

        area_floor = (m.smallest_size * (np.sqrt(3.0) / 4.0)
                      * res * res)
        bc0 = np.zeros(coord.shape[0], dtype=np.uint32)

        def max_area(p):
            # per-region area bound, exactly Triangle's `-a` semantics:
            # split any triangle above its region's size; unconstrained
            # regions are quality-only (no bound)
            reg = probe_reg[np.clip(probe.find_simplex(p), 0,
                                    len(probe_reg) - 1)]
            return np.where(unlimited[reg], np.inf, sizes[reg])

        coord, _, (seg_new, seg_origin), _ = refine_min_angle(
            coord, bc0, inside, m.min_angle, area_floor=area_floor,
            segments=seg_arr, max_area_fn=max_area)
        final_edges = [(int(a), int(b), int(flags_in[o]))
                       for (a, b), o in zip(seg_new, seg_origin)]

    tri = Delaunay(coord, qhull_options="Qbb Qc Qz")
    conn = _drop_degenerate_2d(coord, tri.simplices.astype(np.int32))
    conn = _orient_2d(coord, conn)
    regattr = _flood_fill_regions(
        coord, conn, [(a, b) for a, b, _ in final_edges], seeds)
    mattype = regions[regattr.astype(int), 2].astype(np.int32)

    # internal (non-boundary-marked) PSLG segments: the reference drops
    # them right after meshing when mesh.is_discarding_internal_segments
    # (the default; discard_internal_segments, mesh.cxx:2651-2672 via
    # :3442) and otherwise keeps them in var.segment so they persist
    # through checkpoints.  Boundary segments are re-derived from node
    # flags by topology.finish_topology, so only the internal ones ride
    # the MeshData (they carry segflag 0 exactly like the reference's
    # unmarked .poly segments).
    if not m.is_discarding_internal_segments:
        from ..constants import BOUND_ANY

        # final_edges' third element is the source-segment index in both
        # the refined and unrefined paths; its .poly boundary marker is
        # flags[si]
        internal = [(a, b) for a, b, si in final_edges
                    if int(flags[int(si)]) & BOUND_ANY == 0]
        if internal:
            md = MeshData(2, coord, conn, regattr=mattype)
            md.segment = np.asarray(internal, dtype=np.int32)
            md.segflag = np.zeros(len(internal), dtype=np.int32)
            return md
    return MeshData(2, coord, conn, regattr=mattype)
