"""Mesh topology derivation: boundary flags/nodes/facets and the
element->node assembly tables (counterpart of
dynearthsol_tpu/mesh/topology.py).

Replaces the reference's create_boundary_flags / create_boundary_nodes /
create_boundary_facets / create_support (mesh.cxx:2811-3281).  The support
becomes a padded per-node table of (element, corner) slots, so that the
assembly is a fixed-order gather-then-sum (ops/assembly.node_sum).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..constants import (BOUNDX0, BOUNDX1, BOUNDY0, BOUNDY1, BOUNDZ0,
                         BOUNDZ1, NBDRYTYPES, dim)
from .generate import MeshData


@dataclass
class Topology:
    """Static (per-mesh) topology arrays, all host numpy.

    bcflag : (nnode,) uint32 boundary membership bits (mesh.cxx:2811).
    bnodes : per-boundary node-id lists (mesh.cxx:2828).
    bfacets : per-boundary (elem, facet) pairs (mesh.cxx:3114-3236).
    gather_idx / gather_mask : padded per-node support table; for node n,
        gather_idx[n, k] indexes the flattened (nelem*npe) corner slots and
        gather_mask[n, k] marks valid entries (CSR support of
        mesh.cxx:3240-3281 padded to the max node degree).
    asm_perm : stable permutation sorting the flattened corner slots by
        global node id; asm_node_ids = conn.ravel()[asm_perm].
    """

    ndims: int
    nnode: int
    nelem: int
    connectivity: np.ndarray  # (nelem, npe) int32
    bcflag: np.ndarray  # (nnode,) uint32
    bnodes: List[np.ndarray]  # NBDRYTYPES lists
    bfacets: List[np.ndarray]  # NBDRYTYPES arrays of (elem, facet) pairs
    asm_perm: np.ndarray  # (nelem*npe,) int32
    asm_node_ids: np.ndarray  # (nelem*npe,) int32, sorted
    gather_idx: np.ndarray  # (nnode, max_degree) int32
    gather_mask: np.ndarray  # (nnode, max_degree) bool
    segment: np.ndarray  # (nseg, ndims) int32 boundary facet nodes
    segflag: np.ndarray  # (nseg,) int32 boundary bit of each segment


def _boundary_facets(conn: np.ndarray, npe: int) -> np.ndarray:
    """Return (nelem, facets_per_elem) bool: facet f of elem e is on the
    domain boundary (its sorted node set occurs once in the mesh).  The
    sorted node ids of a facet are packed into one int64 key, so that the
    count is one 1D ``np.unique`` (a few seconds at 983k tets instead of a
    row-wise unique)."""
    nof = dim(npe - 1).node_of_facet
    fac = np.stack([np.sort(conn[:, list(locs)], axis=1) for locs in nof],
                   axis=1).astype(np.int64)         # (nelem, nfacet, npf)
    base = int(conn.max()) + 1
    if base ** fac.shape[2] < 2 ** 62:
        key = fac[..., 0]
        for c in range(1, fac.shape[2]):
            key = key * base + fac[..., c]
        _, inv, counts = np.unique(key.ravel(), return_inverse=True,
                                   return_counts=True)
    else:
        _, inv, counts = np.unique(fac.reshape(-1, fac.shape[2]), axis=0,
                                   return_inverse=True, return_counts=True)
    return (counts[inv.ravel()] == 1).reshape(fac.shape[:2])


def build_topology(mesh: MeshData, xlength: float, ylength: float,
                   zlength: float, tol_rel: float = 1e-9) -> Topology:
    """Derive node boundary flags from box coordinates, then everything
    else (finish_topology).  Flags persist through the Lagrangian motion
    (they are material labels, mesh.cxx:2811-2854)."""
    ndims = mesh.ndims
    coord, conn = mesh.coord, mesh.connectivity
    tolx = tol_rel * max(xlength, 1.0)
    tolz = tol_rel * max(zlength, 1.0)
    bcflag = np.zeros(mesh.nnode, dtype=np.uint32)
    x = coord[:, 0]
    z = coord[:, ndims - 1]
    bcflag[np.abs(x - 0.0) < tolx] |= BOUNDX0
    bcflag[np.abs(x - xlength) < tolx] |= BOUNDX1
    if ndims == 3:
        toly = tol_rel * max(ylength, 1.0)
        y = coord[:, 1]
        bcflag[np.abs(y - 0.0) < toly] |= BOUNDY0
        bcflag[np.abs(y - ylength) < toly] |= BOUNDY1
    bcflag[np.abs(z + zlength) < tolz] |= BOUNDZ0
    bcflag[np.abs(z - 0.0) < tolz] |= BOUNDZ1
    return finish_topology(mesh.ndims, conn, bcflag)


def finish_topology(ndims: int, conn: np.ndarray,
                    bcflag: np.ndarray) -> Topology:
    """Derive everything downstream of (conn, bcflag): boundary node lists,
    boundary facets, segments, and the assembly gather tables."""
    nnode = bcflag.shape[0]
    nelem = conn.shape[0]
    d = dim(ndims)

    bnodes = [np.nonzero(bcflag & (1 << i))[0].astype(np.int32)
              for i in range(NBDRYTYPES)]

    # boundary facets: all facet nodes carry the boundary bit AND the facet
    # is unshared (mesh.cxx:3114-3236); pairs sorted by (elem, facet)
    onb = _boundary_facets(conn, d.nodes_per_elem)
    nof = d.node_of_facet
    bfacets: List[np.ndarray] = []
    for i in range(NBDRYTYPES):
        es, fs = [], []
        if i < 6:
            bit = 1 << i
            for f, locs in enumerate(nof):
                fnodes = conn[:, list(locs)]
                allb = (bcflag[fnodes] & bit).astype(bool).all(axis=1)
                sel = np.nonzero(allb & onb[:, f])[0]
                es.append(sel)
                fs.append(np.full(sel.size, f))
        e = np.concatenate(es) if es else np.zeros(0, dtype=np.int64)
        f = np.concatenate(fs) if fs else np.zeros(0, dtype=np.int64)
        order = np.lexsort((f, e))
        bfacets.append(np.stack([e[order], f[order]], axis=1)
                       .astype(np.int32).reshape(-1, 2))

    # boundary segments (2D: edges) with flags, the equivalent of the
    # mesher's segment/segflag output (mesh.cxx:2811)
    seen = set()
    segs: List[tuple] = []
    segflags: List[int] = []
    for i in range(NBDRYTYPES):
        for e, f in bfacets[i]:
            nodes = tuple(conn[e, list(nof[f])])
            key = tuple(sorted(nodes))
            if key in seen:
                continue
            seen.add(key)
            segs.append(nodes)
            segflags.append(1 << i)
    segment = (np.asarray(segs, dtype=np.int32) if segs
               else np.zeros((0, ndims), dtype=np.int32))
    segflag = np.asarray(segflags, dtype=np.int32)

    flat = conn.ravel().astype(np.int32)
    asm_perm = np.argsort(flat, kind="stable").astype(np.int32)
    asm_node_ids = flat[asm_perm]

    # padded per-node support table (gather-based assembly)
    counts = np.bincount(flat, minlength=nnode)
    max_deg = int(counts.max())
    gather_idx = np.zeros((nnode, max_deg), dtype=np.int32)
    gather_mask = np.zeros((nnode, max_deg), dtype=bool)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    # position of each sorted slot within its node's run
    pos_in_run = np.arange(flat.size) - starts[asm_node_ids]
    gather_idx[asm_node_ids, pos_in_run] = asm_perm
    gather_mask[asm_node_ids, pos_in_run] = True

    return Topology(ndims=ndims, nnode=nnode, nelem=nelem,
                    connectivity=conn.astype(np.int32), bcflag=bcflag,
                    bnodes=bnodes, bfacets=bfacets,
                    asm_perm=asm_perm, asm_node_ids=asm_node_ids,
                    gather_idx=gather_idx, gather_mask=gather_mask,
                    segment=segment, segflag=segflag)
