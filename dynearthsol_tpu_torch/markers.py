"""Lagrangian material markers (host numpy; counterpart of
dynearthsol_tpu/markers.py).

Reference: markerset.cxx / markerset.hpp.  Markers carry material identity;
all element material properties are marker-count-weighted mixtures
(matprops.cxx:115-144).  The device only ever sees the per-element material
histogram ``emw`` (nelem, nmat); the marker population lives on the host in
the JAX package's layout, so that frames and checkpoints carry the same
arrays.  This package places the initial population (``init_marker_option
1``, random, with numpy's generator or the reference's glibc stream, and
``init_marker_option 2``, on a regular grid), builds the histogram, and
appends and removes markers as remeshing (remesh_impl.remap_markers) and
the surface-marker bookkeeping (Simulation.sync_surface_markers) need.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .barycentric import bary_to_coord, random_barycentric

_FIELDS = ("eta", "elem", "mattype", "id", "time", "z", "distance",
           "slope", "genesis")


@dataclass
class MarkerSet:
    """SoA marker storage (markerset.cxx:100-113).  Arrays are
    over-allocated as the JAX package's (its checkpoint records the
    capacity); ``n`` is the live count."""

    ndims: int
    eta: np.ndarray       # (cap, npe) barycentric coords in owner element
    elem: np.ndarray      # (cap,) int32 owner element
    mattype: np.ndarray   # (cap,) int32
    id: np.ndarray        # (cap,) int32 unique id
    time: np.ndarray      # (cap,) creation time
    z: np.ndarray         # (cap,) creation depth
    distance: np.ndarray  # (cap,) horizontal distance at creation
    slope: np.ndarray     # (cap,) surface slope at creation
    genesis: np.ndarray   # (cap,) int32 creation mechanism code
    n: int = 0
    last_id: int = 0
    name: str = "markerset"

    @staticmethod
    def empty(ndims: int, cap: int = 1024, name: str = "markerset"
              ) -> "MarkerSet":
        i32 = np.int32
        return MarkerSet(
            ndims=ndims, eta=np.zeros((cap, ndims + 1)),
            elem=np.zeros(cap, dtype=i32), mattype=np.zeros(cap, dtype=i32),
            id=np.zeros(cap, dtype=i32), time=np.zeros(cap),
            z=np.zeros(cap), distance=np.zeros(cap), slope=np.zeros(cap),
            genesis=np.zeros(cap, dtype=i32), name=name)

    @property
    def cap(self) -> int:
        return self.elem.shape[0]

    def _grow(self, need: int):
        """Amortized growth (markerset.cxx:165-193)."""
        if need <= self.cap:
            return
        new_cap = max(need, int(self.cap * 1.6) + 64)
        for nm in _FIELDS:
            old = getattr(self, nm)
            new = np.zeros((new_cap,) + old.shape[1:], dtype=old.dtype)
            new[:self.n] = old[:self.n]
            setattr(self, nm, new)

    def append(self, eta, elem, mattype, time=0.0, z=0.0, distance=0.0,
               slope=0.0, genesis=0) -> np.ndarray:
        """Append markers with fresh ids; returns their indices
        (markerset.cxx:196-258 append_marker)."""
        eta = np.atleast_2d(eta)
        k = eta.shape[0]
        self._grow(self.n + k)
        sl = slice(self.n, self.n + k)
        self.eta[sl] = eta
        self.elem[sl] = elem
        self.mattype[sl] = mattype
        self.id[sl] = self.last_id + np.arange(k)
        self.time[sl] = time
        self.z[sl] = z
        self.distance[sl] = distance
        self.slope[sl] = slope
        self.genesis[sl] = genesis
        self.last_id += k
        self.n += k
        return np.arange(sl.start, sl.stop)

    def remove(self, idx: np.ndarray):
        """Swap-with-last removal (markerset.cxx:788-815), in descending
        index order, as the reference's repeated single removals."""
        idx = np.unique(np.asarray(idx, dtype=np.int64))
        for i in idx[::-1]:
            last = self.n - 1
            if i != last:
                for nm in _FIELDS:
                    a = getattr(self, nm)
                    a[i] = a[last]
            self.n = last

    def live(self, nm: str) -> np.ndarray:
        return getattr(self, nm)[:self.n]

    def coords(self, coord: np.ndarray, conn: np.ndarray) -> np.ndarray:
        """Physical marker coordinates on the current mesh."""
        return bary_to_coord(coord, conn, self.live("elem"), self.live("eta"))

    def elem_histogram(self, nelem: int, nmat: int) -> np.ndarray:
        """elemmarkers[e][mat] marker-count histogram (mesh.cxx:3379-3394)."""
        h = np.zeros((nelem, nmat), dtype=np.float64)
        np.add.at(h, (self.live("elem"), self.live("mattype")), 1.0)
        return h

    # ---- frame and checkpoint arrays (markerset.cxx:864-950) ----
    def save_arrays(self, coord=None, conn=None) -> dict:
        """Save-file arrays with the reference names (write_save_file):
        "<name> size" int[1], then <name>.{coord,eta,elem,mattype,id,time,
        z,distance,slope,genesis}."""
        pre = self.name
        out = {f"{pre} size": np.array([self.n], dtype=np.int32)}
        if coord is not None:
            out[f"{pre}.coord"] = self.coords(coord, conn)
        out.update({f"{pre}.{nm}": self.live(nm).copy() for nm in _FIELDS})
        return out

    def chkpt_arrays(self) -> dict:
        """Checkpoint extras (write_chkpt_file): "<name> size" int[3] =
        (nmarkers, last_id, reserved), then <name>.genesis."""
        pre = self.name
        return {f"{pre} size": np.array([self.n, self.last_id, self.cap],
                                        dtype=np.int32),
                f"{pre}.genesis": self.live("genesis").copy()}

    @staticmethod
    def from_arrays(ndims: int, save: dict, chkpt: dict,
                    name: str = "markerset") -> "MarkerSet":
        """Rebuild from save + checkpoint arrays (read_chkpt_file,
        markerset.cxx:888-916)."""
        pre = name
        n, last_id, reserved = (int(x) for x in chkpt[f"{pre} size"][:3])
        ms = MarkerSet.empty(ndims, cap=max(reserved, n, 64), name=name)
        ms.n, ms.last_id = n, last_id
        if n:
            ms.eta[:n] = save[f"{pre}.eta"].reshape(n, ndims + 1)
            for nm in _FIELDS[1:-1]:
                getattr(ms, nm)[:n] = save[f"{pre}.{nm}"].ravel()[:n]
            ms.genesis[:n] = chkpt[f"{pre}.genesis"].ravel()[:n]
        return ms


def _mattype_from_depth(param, pts: np.ndarray) -> np.ndarray:
    """Material type by depth layer (ic.cxx:652-713, mattype_option 0):
    layer boundaries are fractions of zlength."""
    ndims = pts.shape[1]
    nmat = param.mat.nmat
    mt = np.zeros(pts.shape[0], dtype=np.int32)
    if nmat == 1:
        return mt
    depth_frac = -pts[:, ndims - 1] / max(param.mesh.zlength, 1e-300)
    depths = list(param.ic.mattype_layer_depths)
    mats = list(param.ic.layer_mattypes)
    bounds = [-np.inf] + depths + [np.inf]
    for i, m in enumerate(mats):
        sel = (depth_frac >= bounds[i]) & (depth_frac < bounds[i + 1])
        mt[sel] = m
    return mt


def create_markers(param, coord: np.ndarray, conn: np.ndarray,
                   regattr: np.ndarray = None) -> MarkerSet:
    """Initial marker population (markerset.cxx:510-649), placed exactly as
    the JAX package places it.

    init_marker_option 1: ``markers_per_element`` random markers per
    element, from a ``np.random.Generator`` seeded with
    ``markers.random_seed``, or with ``reference_compatible_rng`` from the
    reference's own glibc rand() stream (utils/glibc_rand.py).
    init_marker_option 2: regularly spaced markers on a centred grid of
    spacing ``init_marker_spacing * resolution``, located into their
    enclosing elements (regularly_spaced_markers, markerset.cxx:542-649);
    grid points outside the mesh are skipped as the reference skips its
    markers that are not found.
    A marker's mattype is its element's regional attribute ``regattr`` (a
    .poly or Exodus mesh) under ``mattype_option`` 0 (initial_mattype,
    markerset.cxx:652-659), else that of its depth layer."""
    ndims = coord.shape[1]
    nelem = conn.shape[0]
    if param.markers.init_marker_option == 2:
        return _regular_markers(param, coord, conn, regattr)
    mpe = param.markers.markers_per_element
    n = nelem * mpe
    ms = MarkerSet.empty(ndims, cap=n + 64)
    elems = np.repeat(np.arange(nelem, dtype=np.int32), mpe)
    if param.markers.reference_compatible_rng:
        from .utils.glibc_rand import reference_random_eta
        eta = reference_random_eta(param.markers.random_seed, n, ndims)
    else:
        rng = np.random.default_rng(param.markers.random_seed)
        eta = random_barycentric(n, ndims + 1, rng)
    pts = bary_to_coord(coord, conn, elems, eta)
    ms.eta[:n], ms.elem[:n] = eta, elems
    ms.mattype[:n] = _marker_mattype(param, pts, elems, regattr)
    ms.id[:n] = np.arange(n)
    ms.z[:n], ms.distance[:n] = pts[:, ndims - 1], pts[:, 0]
    ms.n = ms.last_id = n
    return ms


def _marker_mattype(param, pts, elems, regattr) -> np.ndarray:
    if param.ic.mattype_option == 0 and regattr is not None:
        return regattr[elems].astype(np.int32)
    return _mattype_from_depth(param, pts)


def _regular_markers(param, coord: np.ndarray, conn: np.ndarray,
                     regattr: np.ndarray = None) -> MarkerSet:
    """init_marker_option 2 (JAX markers.py:226-256)."""
    from .mesh.locate import ElementLocator

    ndims = coord.shape[1]
    # integer spacing, as the reference's `const int d` truncates it
    # (markerset.cxx:544)
    d = int(param.markers.init_marker_spacing * param.mesh.resolution)
    d = max(d, 1)
    lo, hi = coord.min(axis=0), coord.max(axis=0)
    axes = []
    for a in (0,) + ((1,) if ndims == 3 else ()) + (ndims - 1,):
        length = hi[a] - lo[a]
        n = int(length / d) + 1
        a0 = lo[a] + 0.5 * (length - (n - 1) * d)
        axes.append(a0 + d * np.arange(n))
    # marker n -> (ix, iy, iz) with x fastest (markerset.cxx:600-603)
    grids = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([g.reshape(-1, order="F") for g in grids], axis=1)
    elems, eta, found = ElementLocator(
        np.asarray(coord, np.float64), conn).locate(pts, k=20)
    elems = elems[found].astype(np.int32)
    eta = np.clip(eta[found], 0.0, None)
    eta /= eta.sum(axis=1, keepdims=True)
    pts = pts[found]
    ms = MarkerSet.empty(ndims, cap=len(elems) + 64)
    ms.append(eta, elems, _marker_mattype(param, pts, elems, regattr),
              time=0.0,
              z=pts[:, ndims - 1], distance=pts[:, 0], slope=0.0)
    return ms


def emw_from_markers(ms: MarkerSet, nelem: int, nmat: int,
                     min_weight: float = 1e-3) -> np.ndarray:
    """Per-element material weights for MatProps.  Elements that lost all
    markers fall back to a tiny uniform weight so mixtures stay finite."""
    h = ms.elem_histogram(nelem, nmat)
    empty = h.sum(axis=1) == 0
    h[empty] = min_weight
    return h
