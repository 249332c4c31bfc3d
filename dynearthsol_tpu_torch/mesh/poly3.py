"""Meshing from TetGen-format 3D .poly files (meshing_option 90/91;
counterpart of dynearthsol_tpu/mesh/poly3.py, the same numpy and scipy
calls in the same order).

The reference hands the PLC to TetGen (new_mesh_from_polyfile,
mesh.cxx:1848-2230 THREED branch; tetrahedralize_polyhedron,
mesh.cxx:2586) with per-facet boundary markers, regional attributes
(mattype) and per-region max-volume constraints.  Here the same
contract is met without a native mesher, the way the 2D path does it
(mesh/poly.py): every planar facet is sampled at the local target
spacing (shared edges sampled once so adjacent facets agree), a graded
thinned lattice fills the volume keeping clear of the facets, and
scipy/Qhull tetrahedralizes the union.  Because both sides of every
facet are populated at matching density while the facet plane itself
carries an in-plane lattice, the Delaunay conforms to the planar
facets; a conformity audit counts unrecovered facet area and retries
with denser facet sampling.  Region ids flood-fill across faces that
do not lie on a facet, exactly like TetGen's regional attributes.

Scope (matches every 3D .poly the reference ships,
examples/3d_mesh_gen/*.poly): planar polygonal facets, convex domain,
no holes (the reference reader itself exits on holes), single-bit facet
markers (mesh.cxx:1966-1975).
"""

from __future__ import annotations

import numpy as np

from .generate import MeshData, _orient_3d


def read_poly_3d(path: str):
    """Parse a TetGen 3D .poly file (wias-berlin.de/software/tetgen/
    fformats.poly.html, subset accepted by mesh.cxx:1848-2140).

    Returns (points, facets, regions) where ``facets`` is a list of
    (polygons, flag) with ``polygons`` a list of vertex-index lists,
    and ``regions`` rows are (x, y, z, mattype, size)."""
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
    if ndims != 3 or nattr != 0 or nbdrym != 0:
        raise ValueError(f"unsupported 3D .poly header in {path}")
    pts = np.zeros((npoints, 3))
    for i in range(npoints):
        k = nxt(int)
        if k != i:
            raise ValueError(f"{path}: node ids must count from 0")
        pts[i] = [nxt(), nxt(), nxt()]

    nfacets = nxt(int)
    has_flag = nxt(int)
    if has_flag != 1:
        raise ValueError(f"{path}: facet boundary markers required")
    facets = []
    for i in range(nfacets):
        npoly = nxt(int)
        nholes = nxt(int)
        flag = nxt(int)
        if npoly <= 0 or nholes != 0:
            raise ValueError(f"{path}: facet {i}: unsupported value")
        if flag != 0 and (flag & (flag - 1)) != 0:
            raise ValueError(
                f"{path}: facet {i}: bdry_flag has multiple bits set")
        polys = []
        for _ in range(npoly):
            nv = nxt(int)
            if nv < 3 or nv > 9999:
                raise ValueError(
                    f"{path}: facet {i}: unsupported polygon size {nv}")
            poly = [nxt(int) for _ in range(nv)]
            if min(poly) < 0 or max(poly) >= npoints:
                raise ValueError(
                    f"{path}: facet {i}: out-of-range node id")
            polys.append(poly)
        facets.append((polys, flag))

    nholes = nxt(int)
    if nholes != 0:
        raise ValueError(f"{path}: holes not supported (must be 0)")
    nreg = nxt(int)
    if nreg <= 0:
        raise ValueError(f"{path}: nregions must be > 0")
    regions = np.zeros((nreg, 5))
    for i in range(nreg):
        nxt(int)  # region id column is read and ignored (mesh.cxx:2089)
        regions[i] = [nxt(), nxt(), nxt(), nxt(), nxt()]
    return pts, facets, regions


# ---------------------------------------------------------------- geometry

def _plane_basis(pts, polys):
    """Orthonormal in-plane basis of a planar facet: (origin, u, v, n)."""
    verts = pts[np.unique(np.concatenate([np.asarray(p) for p in polys]))]
    p0 = verts[0]
    d = verts - p0
    # the two most independent directions among the vertices
    u = d[np.argmax(np.einsum("ij,ij->i", d, d))]
    u = u / max(np.linalg.norm(u), 1e-300)
    w = d - np.outer(d @ u, u)
    v = w[np.argmax(np.einsum("ij,ij->i", w, w))]
    nv = np.linalg.norm(v)
    if nv < 1e-12 * max(np.abs(verts).max(), 1.0):
        raise ValueError("degenerate (collinear) facet polygon")
    v = v / nv
    n = np.cross(u, v)
    return p0, u, v, n


def _point_in_poly_2d(q, poly2):
    """Vectorized even-odd point-in-polygon for q (m,2) vs poly2 (k,2)."""
    x, y = q[:, 0], q[:, 1]
    inside = np.zeros(q.shape[0], dtype=bool)
    k = poly2.shape[0]
    for i in range(k):
        x0, y0 = poly2[i]
        x1, y1 = poly2[(i + 1) % k]
        crosses = (y0 > y) != (y1 > y)
        with np.errstate(divide="ignore", invalid="ignore"):
            xi = x0 + (y - y0) * (x1 - x0) / (y1 - y0)
        inside ^= crosses & (x < np.where(crosses, xi, np.inf))
    return inside


def _dist_to_poly_2d(q, poly2):
    """Distance from q (m,2) to the boundary of polygon poly2 (k,2)."""
    d = np.full(q.shape[0], np.inf)
    k = poly2.shape[0]
    for i in range(k):
        a, b = poly2[i], poly2[(i + 1) % k]
        e = b - a
        L2 = max(float(e @ e), 1e-300)
        t = np.clip(((q - a) @ e) / L2, 0.0, 1.0)
        proj = a + t[:, None] * e
        d = np.minimum(d, np.hypot(*(q - proj).T))
    return d


class _Facet:
    """A planar facet: polygons projected onto an orthonormal basis."""

    def __init__(self, pts, polys, flag):
        self.polys = [np.asarray(p, dtype=np.int64) for p in polys]
        self.flag = flag
        self.p0, self.u, self.v, self.n = _plane_basis(pts, polys)
        self.off = float(self.n @ self.p0)
        self.poly2 = [np.stack([(pts[p] - self.p0) @ self.u,
                                (pts[p] - self.p0) @ self.v], axis=1)
                      for p in self.polys]
        diam = max(float(np.abs(p2).max()) for p2 in self.poly2)
        self.tol = 1e-8 * max(diam, 1.0)

    def project(self, x):
        d = x - self.p0
        return np.stack([d @ self.u, d @ self.v], axis=1)

    def plane_dist(self, x):
        return np.abs(x @ self.n - self.off)

    def contains(self, x, tol=None):
        """x (m,3) on the facet plane AND inside one of its polygons."""
        on = self.plane_dist(x) < (self.tol if tol is None else tol)
        if not on.any():
            return on
        q = self.project(x)
        inpoly = np.zeros(x.shape[0], dtype=bool)
        for p2 in self.poly2:
            inpoly |= _point_in_poly_2d(q, p2) | (_dist_to_poly_2d(q, p2)
                                                  < self.tol)
        return on & inpoly

    def dist(self, x):
        """3D distance from x (m,3) to the facet surface (its polygons)."""
        q = self.project(x)
        h = x @ self.n - self.off
        best = np.full(x.shape[0], np.inf)
        for p2 in self.poly2:
            inp = _point_in_poly_2d(q, p2)
            db = _dist_to_poly_2d(q, p2)
            lateral = np.where(inp, 0.0, db)
            best = np.minimum(best, np.hypot(lateral, h))
        return best


# ---------------------------------------------------------------- sampling

def _sample_polygon(facet, poly_i, h, edge_points):
    """In-plane lattice fill of one polygon at spacing h, keeping clear
    of the (separately sampled) boundary edges."""
    p2 = facet.poly2[poly_i]
    lo, hi = p2.min(axis=0), p2.max(axis=0)
    nu = max(2, int(np.ceil((hi[0] - lo[0]) / h)) + 1)
    nv = max(2, int(np.ceil((hi[1] - lo[1]) / h)) + 1)
    U, V = np.meshgrid(np.linspace(lo[0], hi[0], nu),
                       np.linspace(lo[1], hi[1], nv), indexing="ij")
    Q = np.stack([U.ravel(), V.ravel()], axis=1)
    keep = _point_in_poly_2d(Q, p2)
    keep &= _dist_to_poly_2d(Q, p2) > 0.55 * h
    Q = Q[keep]
    if edge_points.shape[0] and Q.shape[0]:
        # also keep clear of shared-edge samples from other facets
        from scipy.spatial import cKDTree

        d, _ = cKDTree(edge_points).query(Q, k=1)
        Q = Q[d > 0.55 * h]
    return facet.p0 + Q[:, :1] * facet.u + Q[:, 1:] * facet.v


def _sample_edges(pts, facets, h_of_facet):
    """Sample every unique polygon edge once, at the min spacing of the
    facets sharing it.  Returns (m, 3) points (vertices excluded)."""
    h_edge = {}
    for fi, f in enumerate(facets):
        for p in f.polys:
            k = len(p)
            for i in range(k):
                e = (min(p[i], p[(i + 1) % k]), max(p[i], p[(i + 1) % k]))
                h_edge[e] = min(h_edge.get(e, np.inf), h_of_facet[fi])
    out = []
    for (a, b), h in h_edge.items():
        pa, pb = pts[a], pts[b]
        length = float(np.linalg.norm(pb - pa))
        nsub = max(1, int(round(length / h)))
        for k in range(1, nsub):
            out.append(pa + (pb - pa) * (k / nsub))
    return (np.asarray(out) if out else np.zeros((0, 3)))


# ---------------------------------------------------------------- regions

def _facet_node_masks(facets, coord, h_scale):
    """(nfacet, nnode) bool: node lies on facet f (plane + polygon)."""
    masks = []
    for f in facets:
        masks.append(f.contains(coord, tol=1e-6 * h_scale))
    return np.asarray(masks)


def _region_fill_3d(coord, conn, facets, seeds, find_simplex, h_scale):
    """Flood-fill region ids across tet faces that are NOT on any facet
    (TetGen -A regional attributes, mesh.cxx:2586)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    nelem = conn.shape[0]
    on_facet = _facet_node_masks(facets, coord, h_scale)  # (nf, nnode)
    faces_loc = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]

    # face -> (elem, opposite-local) incidence via sorted-key matching
    keys = []
    owners = []
    for li, loc in enumerate(faces_loc):
        fn = np.sort(conn[:, list(loc)], axis=1)
        keys.append(fn)
        owners.append(np.stack([np.arange(nelem), np.full(nelem, li)],
                               axis=1))
    keys = np.concatenate(keys)            # (4*nelem, 3)
    owners = np.concatenate(owners)
    order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
    keys = keys[order]
    owners = owners[order]
    same = (keys[1:] == keys[:-1]).all(axis=1)
    ia, ib = owners[:-1][same, 0], owners[1:][same, 0]
    fnodes = keys[:-1][same]               # (npair, 3) shared-face nodes

    # barrier: all 3 face nodes on one common facet
    barrier = np.zeros(ia.shape[0], dtype=bool)
    for m in on_facet:
        barrier |= m[fnodes].all(axis=1)
    keep = ~barrier
    g = sp.coo_matrix((np.ones(keep.sum()), (ia[keep], ib[keep])),
                      shape=(nelem, nelem))
    ncomp, comp = connected_components(g, directed=False)

    regattr = np.full(nelem, -1, dtype=np.int32)
    comp_of_seed = {}
    for rid, s in enumerate(seeds):
        t = int(find_simplex(np.asarray(s, dtype=np.float64)[None, :])[0])
        if t >= 0:
            comp_of_seed.setdefault(int(comp[t]), rid)
    for c, rid in comp_of_seed.items():
        regattr[comp == c] = rid
    if (regattr == -1).any():
        cen = coord[conn].mean(axis=1)
        sd = np.asarray(seeds)
        for t in np.nonzero(regattr == -1)[0]:
            regattr[t] = int(np.argmin(((sd - cen[t]) ** 2).sum(axis=1)))
    return regattr


# ---------------------------------------------------------------- driver

def mesh_from_poly_3d(param) -> MeshData:
    """Graded tetrahedralization of a 3D .poly PLC with regional
    mattypes and per-facet boundary markers (meshing_option 90: sizes
    in m^3; 91: in units of the standard element size 0.7*resolution^3,
    mesh.cxx:1863-1866 + 2110-2115)."""
    from scipy.spatial import Delaunay, cKDTree

    m = param.mesh
    pts, raw_facets, regions = read_poly_3d(m.poly_filename)
    res = m.resolution
    std = 0.7 * res ** 3                       # mesh.cxx:1864
    unit = 1.0 if m.meshing_option == 90 else std
    sizes = np.where(regions[:, 4] > 0, regions[:, 4] * unit,
                     std * m.largest_size)
    # spacing at which meshing_option-1 boxes produce std-size elements:
    # size == std  <=>  h == resolution
    h_region = res * np.cbrt(sizes / std)
    seeds = regions[:, :3]
    mattypes = regions[:, 3].astype(np.int32)
    nmat = len(param.mat.rho0)
    if ((mattypes < 0) | (mattypes >= nmat)).any():
        raise ValueError(
            f"{m.poly_filename}: region mattype out of range [0, {nmat})")

    facets = [_Facet(pts, polys, flag) for polys, flag in raw_facets]
    h_min = float(h_region.min())
    h_scale = h_min
    rng = np.random.default_rng(12345)

    # --- probe triangulation: a region-membership oracle for grading.
    # Facet corners + coarse edge samples keep the probe tiny; barriers
    # are probe faces on a facet, the same rule as the final fill.
    h_coarse = [max(h_min, 0.0) for _ in facets]
    probe_pts = np.concatenate(
        [pts, _sample_edges(pts, facets, h_coarse)], axis=0)
    probe = Delaunay(probe_pts, qhull_options="Qbb Qc Qz")
    probe_conn = probe.simplices.astype(np.int64)
    probe_reg = _region_fill_3d(probe_pts, probe_conn, facets, seeds,
                                probe.find_simplex, h_scale)

    def h_at(p):
        t = probe.find_simplex(np.asarray(p, dtype=np.float64))
        t = np.clip(t, 0, probe_reg.shape[0] - 1)
        return h_region[probe_reg[t]]

    # --- facet spacing: min of the region spacing on either side
    h_of_facet = []
    for f in facets:
        c = np.concatenate([pts[p] for p in f.polys]).mean(axis=0)
        eps = 0.01 * h_min
        h_of_facet.append(float(min(h_at((c + eps * f.n)[None])[0],
                                    h_at((c - eps * f.n)[None])[0])))

    for attempt in range(4):
        # --- surface point set: vertices + unique edges + facet interiors
        edge_pts = _sample_edges(pts, facets, h_of_facet)
        surf = [pts, edge_pts]
        for fi, f in enumerate(facets):
            ep2 = (f.project(edge_pts) if edge_pts.shape[0]
                   else np.zeros((0, 2)))
            # only edge samples on this facet's plane crowd its lattice
            if edge_pts.shape[0]:
                ep2 = ep2[f.plane_dist(edge_pts) < f.tol]
            for pi in range(len(f.polys)):
                surf.append(_sample_polygon(f, pi, h_of_facet[fi], ep2))
        surf = np.concatenate([s for s in surf if s.shape[0]], axis=0)

        # --- graded interior lattice, thinned, jittered, facet-cleared
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        ns = [max(2, int(np.ceil((hi[i] - lo[i]) / h_min)) + 1)
              for i in range(3)]
        X, Y, Z = np.meshgrid(*[np.linspace(lo[i], hi[i], ns[i])
                                for i in range(3)], indexing="ij")
        P = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
        inside = probe.find_simplex(P) >= 0
        P = P[inside]
        hP = h_at(P)
        keep = rng.random(P.shape[0]) < (h_min / hP) ** 3
        P, hP = P[keep], hP[keep]
        P = P + 0.35 * h_min * (rng.random(P.shape) - 0.5)
        dmin = np.full(P.shape[0], np.inf)
        for f in facets:
            dmin = np.minimum(dmin, f.dist(P))
        P = P[dmin > 0.55 * hP]
        # the jitter can push points out of the hull; clamp back
        P = P[probe.find_simplex(P) >= 0]

        coord = np.concatenate([surf, P], axis=0)
        # dedupe (shared edges were sampled once but facet corners repeat)
        tree = cKDTree(coord)
        pairs = tree.query_pairs(1e-6 * h_min, output_type="ndarray")
        drop = np.zeros(coord.shape[0], dtype=bool)
        if pairs.shape[0]:
            drop[np.maximum(pairs[:, 0], pairs[:, 1])] = True
        coord = coord[~drop]

        # radius-edge refinement (TetGen q<max_ratio> parity,
        # set_3d_quality_str mesh.cxx:745-757): Steiner points stay
        # clear of every facet so the conformity audit below still
        # holds; the audit's densify-retry owns any residual breakage
        if m.max_ratio > 0:
            from .refine3d import refine_radius_edge

            def _inside(q):
                q = np.asarray(q, dtype=np.float64).reshape(-1, 3)
                okq = probe.find_simplex(q) >= 0
                dm = np.full(q.shape[0], np.inf)
                for f in facets:
                    dm = np.minimum(dm, f.dist(q))
                return okq & (dm > 0.5 * h_at(q))

            coord, _ = refine_radius_edge(
                coord, _inside, max_ratio=m.max_ratio,
                vol_floor=(m.smallest_size * (np.sqrt(2.0) / 12.0)
                           * h_min**3),
                max_growth=2.0)

        tri = Delaunay(coord, qhull_options="Qbb Qc Qz")
        conn = tri.simplices.astype(np.int32)
        a = coord[conn[:, 0]]
        vol6 = np.einsum("ij,ij->i", coord[conn[:, 1]] - a,
                         np.cross(coord[conn[:, 2]] - a,
                                  coord[conn[:, 3]] - a))
        conn = conn[np.abs(vol6) > 1e-12 * np.abs(vol6).max()]

        # --- conformity audit: every facet must be tiled by element
        # faces (the analog of TetGen's constrained facet recovery).
        # Unrecovered area => densify that facet and retry (the
        # reference's own retry loop, remeshing.cxx:1109-1363 spirit).
        on_facet = _facet_node_masks(facets, coord, h_scale)
        faces_loc = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]
        ok = True
        for fi, f in enumerate(facets):
            tiled = 0.0
            seen = set()
            for loc in faces_loc:
                fn = conn[:, list(loc)]
                onf = on_facet[fi][fn].all(axis=1)
                for row in fn[onf]:
                    key = tuple(sorted(row))
                    if key in seen:
                        continue
                    seen.add(key)
                    q = f.project(coord[list(key)])
                    tiled += 0.5 * abs(
                        (q[1, 0] - q[0, 0]) * (q[2, 1] - q[0, 1])
                        - (q[1, 1] - q[0, 1]) * (q[2, 0] - q[0, 0]))
            area = 0.0
            for p2 in f.poly2:
                x, y = p2[:, 0], p2[:, 1]
                area += 0.5 * abs(np.dot(x, np.roll(y, -1))
                                  - np.dot(y, np.roll(x, -1)))
            if tiled < (1.0 - 1e-6) * area:
                ok = False
                h_of_facet[fi] *= 0.7
        if ok:
            break
    else:
        raise RuntimeError(
            f"{m.poly_filename}: facet recovery failed after retries")

    conn = _orient_3d(coord, conn)
    regattr = _region_fill_3d(coord, conn, facets, seeds,
                              tri.find_simplex, h_scale)
    mattype = mattypes[regattr]

    # --- boundary triangles with the facet markers (the psegment/
    # psegflag output of tetrahedralize_polyhedron, mesh.cxx:2586)
    flagged = [f for f in facets if f.flag != 0]
    segs, segflags = [], []
    faces_loc = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]
    keys = np.concatenate([np.sort(conn[:, list(l)], axis=1)
                           for l in faces_loc])
    raw = np.concatenate([conn[:, list(l)] for l in faces_loc])
    order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
    keys, raw = keys[order], raw[order]
    dup = np.zeros(keys.shape[0], dtype=bool)
    same = (keys[1:] == keys[:-1]).all(axis=1)
    dup[:-1] |= same
    dup[1:] |= same
    hull_faces = raw[~dup]
    on_flagged = _facet_node_masks(flagged, coord, h_scale)
    for fi, f in enumerate(flagged):
        onf = on_flagged[fi][hull_faces].all(axis=1)
        for row in hull_faces[onf]:
            segs.append(tuple(row))
            segflags.append(f.flag)
    segment = (np.asarray(segs, dtype=np.int32) if segs
               else np.zeros((0, 3), dtype=np.int32))
    segflag = np.asarray(segflags, dtype=np.int32)

    return MeshData(3, coord, conn, regattr=mattype,
                    segment=segment, segflag=segflag)
