"""Surface topology and the surface-plstrain decay constants (counterpart
of dynearthsol_tpu/ops/surface.py).

Reference: bc.cxx:877-1831.  Surface process option 1 (hillslope
diffusion in 2D, facet-FEM topography diffusion in 3D) runs in the fused
steps only (ops/fused2d.py, ops/fused3d.py); the fused steps
apply the surface-element correction (bc.cxx:1613-1665) and the
plastic-strain decay (bc.cxx:1591-1611) in-kernel with the constants below,
and the column step (ops/flat2d.py) applies them with ``top_elem_mask`` and
``surface_plstrain_decay``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import IBOUNDZ1, YEAR2SEC, dim

LN2 = 0.69314718056
PLSTRAIN_HALF_LIFE = 1.0e2 * YEAR2SEC  # bc.cxx:1599


@dataclass(frozen=True)
class SurfInfo:
    """Static surface topology (SurfaceInfo, parameters.hpp:576-630),
    host numpy."""

    ntop: int
    etop: int
    top_nodes: np.ndarray   # (ntop,) int32
    facet_nodes: np.ndarray  # (etop, ndims) global node ids per top facet
    top_elems: np.ndarray   # (etop,) element of each top facet
    # every element touching any top node via support (create_top_elems,
    # mesh.cxx:2879-2891)
    all_top_elems: np.ndarray  # (ntop_elems,) unique, sorted
    top_elem_mask: np.ndarray  # (nelem,) bool, the same set as a mask


def make_surf_info(topo) -> SurfInfo:
    """Build from topology (create_surface_info, mesh.cxx:2979-3056)."""
    ndims = topo.ndims
    nof = dim(ndims).node_of_facet
    bf = topo.bfacets[IBOUNDZ1]
    facet_nodes = np.zeros((len(bf), ndims), dtype=np.int32)
    top_elems = np.zeros(len(bf), dtype=np.int32)
    for i, (e, f) in enumerate(bf):
        facet_nodes[i] = topo.connectivity[e, list(nof[f])]
        top_elems[i] = e
    top_nodes = topo.bnodes[IBOUNDZ1].astype(np.int32)
    touches = np.isin(topo.connectivity, top_nodes).any(axis=1)
    return SurfInfo(
        ntop=len(top_nodes), etop=len(bf), top_nodes=top_nodes,
        facet_nodes=facet_nodes, top_elems=top_elems,
        all_top_elems=np.flatnonzero(touches).astype(np.int32),
        top_elem_mask=touches)


def surface_plstrain_decay(top, plstrain, emw, dt,
                           mattype_oceanic_crust: int, apply):
    """Exponential decay of surface plastic strain (anti-landslide,
    bc.cxx:1593-1613), skipped for oceanic-crust elements.  ``top`` is the
    top-element mask as a bool tensor, ``apply`` a 0-d bool tensor."""
    lam = LN2 / PLSTRAIN_HALF_LIFE
    dominant = torch.argmax(emw, dim=1)
    dec = torch.where(top & (dominant != mattype_oceanic_crust),
                      plstrain * lam * dt, torch.zeros_like(plstrain))
    return plstrain - torch.where(apply, dec, torch.zeros_like(dec))
