"""Lagrangian material markers (host numpy; counterpart of
dynearthsol_tpu/markers.py).

Reference: markerset.cxx / markerset.hpp.  Markers carry material identity;
all element material properties are marker-count-weighted mixtures
(matprops.cxx:115-144).  The device only ever sees the per-element material
histogram ``emw`` (nelem, nmat); the marker population lives on the host in
the JAX package's layout, so that frames and checkpoints carry the same
arrays.  This package places the initial population (``init_marker_option
1``, with numpy's generator or the reference's glibc stream) and builds
the histogram; marker motion, deposition and remapping are not ported yet.
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


def create_markers(param, coord: np.ndarray, conn: np.ndarray) -> MarkerSet:
    """Initial marker population (markerset.cxx:510-538, init_marker_option
    1): ``markers_per_element`` random markers per element, placed exactly
    as the JAX package places them: from a ``np.random.Generator`` seeded
    with ``markers.random_seed``, or with ``reference_compatible_rng`` from
    the reference's own glibc rand() stream (utils/glibc_rand.py)."""
    if param.markers.init_marker_option != 1:
        raise NotImplementedError(
            "only init_marker_option 1 (random markers) is ported")
    ndims = coord.shape[1]
    nelem = conn.shape[0]
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
    # box meshes carry no regional attribute: mattype by depth layer
    ms.mattype[:n] = _mattype_from_depth(param, pts)
    ms.id[:n] = np.arange(n)
    ms.z[:n], ms.distance[:n] = pts[:, ndims - 1], pts[:, 0]
    ms.n = ms.last_id = n
    return ms


def emw_from_markers(ms: MarkerSet, nelem: int, nmat: int,
                     min_weight: float = 1e-3) -> np.ndarray:
    """Per-element material weights for MatProps.  Elements that lost all
    markers fall back to a tiny uniform weight so mixtures stay finite."""
    h = ms.elem_histogram(nelem, nmat)
    empty = h.sum(axis=1) == 0
    h[empty] = min_weight
    return h
