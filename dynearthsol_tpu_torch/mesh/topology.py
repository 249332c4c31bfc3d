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

    @property
    def nseg(self) -> int:
        return self.segment.shape[0]


def _facet_keys(nodes: np.ndarray, base: int) -> np.ndarray:
    """One int64 key per facet, its sorted node ids packed in base ``base``
    (..., npf) -> (...), or the rows themselves where the key would
    overflow."""
    fac = np.sort(nodes, axis=-1).astype(np.int64)
    if base ** fac.shape[-1] >= 2 ** 62:
        return fac
    key = fac[..., 0]
    for c in range(1, fac.shape[-1]):
        key = key * base + fac[..., c]
    return key


def _unique_rows(rows: np.ndarray, **kw):
    """np.unique over the rows of a 2D array (1D when it has one column:
    the packed keys)."""
    if rows.shape[1] == 1:
        u, *rest = np.unique(rows[:, 0], **kw)
        return (u[:, None], *rest)
    return np.unique(rows, axis=0, **kw)


def _boundary_facets(conn: np.ndarray, npe: int) -> np.ndarray:
    """Return (nelem, facets_per_elem) bool: facet f of elem e is on the
    domain boundary (its sorted node set occurs once in the mesh).  The
    count is one 1D ``np.unique`` of the packed facet keys (a few seconds
    at 983k tets instead of a row-wise unique)."""
    nof = dim(npe - 1).node_of_facet
    key = _facet_keys(np.stack([conn[:, list(locs)] for locs in nof],
                               axis=1), int(conn.max()) + 1)
    nfac = conn.shape[0] * len(nof)
    _, inv, counts = _unique_rows(key.reshape(nfac, -1), return_inverse=True,
                                  return_counts=True)
    return (counts[inv.ravel()] == 1).reshape(conn.shape[0], len(nof))


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
    # internal segments kept by the mesher (is_discarding_internal_segments
    # off, mesh.cxx:3442) follow the derived boundary segments, so that
    # they persist through checkpoints as the reference's var.segment does
    return finish_topology(mesh.ndims, conn, bcflag,
                           extra_segment=mesh.segment,
                           extra_segflag=mesh.segflag)


def finish_topology(ndims: int, conn: np.ndarray, bcflag: np.ndarray,
                    extra_segment: np.ndarray = None,
                    extra_segflag: np.ndarray = None) -> Topology:
    """Derive everything downstream of (conn, bcflag): boundary node lists,
    boundary facets, segments (the boundary's, then ``extra_segment``
    with its flags, 0 where none are given), and the assembly gather
    tables."""
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
    if extra_segment is not None and len(extra_segment):
        segment = np.concatenate(
            [segment, np.asarray(extra_segment, dtype=np.int32)])
        segflag = np.concatenate(
            [segflag, np.zeros(len(extra_segment), dtype=np.int32)
             if extra_segflag is None
             else np.asarray(extra_segflag, dtype=np.int32)])

    return Topology(ndims=ndims, nnode=nnode, nelem=nelem,
                    connectivity=conn.astype(np.int32), bcflag=bcflag,
                    bnodes=bnodes, bfacets=bfacets,
                    **_support_tables(conn, nnode),
                    segment=segment, segflag=segflag)


def _support_tables(conn: np.ndarray, nnode: int) -> dict:
    """The assembly permutation and the padded per-node support table
    (gather-based assembly)."""
    flat = conn.ravel().astype(np.int32)
    asm_perm = np.argsort(flat, kind="stable").astype(np.int32)
    asm_node_ids = flat[asm_perm]
    counts = np.bincount(flat, minlength=nnode)
    max_deg = int(counts.max())
    gather_idx = np.zeros((nnode, max_deg), dtype=np.int32)
    gather_mask = np.zeros((nnode, max_deg), dtype=bool)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    # position of each sorted slot within its node's run
    pos_in_run = np.arange(flat.size) - starts[asm_node_ids]
    gather_idx[asm_node_ids, pos_in_run] = asm_perm
    gather_mask[asm_node_ids, pos_in_run] = True
    return dict(asm_perm=asm_perm, asm_node_ids=asm_node_ids,
                gather_idx=gather_idx, gather_mask=gather_mask)


def build_topology_from_arrays(ndims: int, conn: np.ndarray,
                               bcflag: np.ndarray, segment: np.ndarray,
                               segflag: np.ndarray) -> Topology:
    """Rebuild topology from a run's saved arrays (restart and
    mesh_from_run, dynearthsol.cxx:284-306): node flags and segments come
    from the files, since the mesh has deformed and coordinate tests would
    mislabel boundaries.  The boundary facets of boundary i are the
    (element, facet) pairs whose node set is a segment flagged 1 << i,
    sorted, as the JAX package's dictionary lookup gives them."""
    nnode, nelem = bcflag.shape[0], conn.shape[0]
    nof = dim(ndims).node_of_facet
    base = int(max(conn.max(), segment.max(initial=0))) + 1
    fkey = _facet_keys(np.stack([conn[:, list(locs)] for locs in nof],
                                axis=1), base).reshape(nelem * len(nof), -1)
    skey = _facet_keys(segment, base).reshape(segment.shape[0], -1)
    # a facet shared by two elements maps to its last (element, facet)
    # in the JAX package's loop order (facet outer, element inner)
    order = np.arange(nelem * len(nof)).reshape(nelem, len(nof)).T.ravel()
    uniq, last = _unique_rows(fkey[order][::-1], return_index=True)
    owner = order[::-1][last]
    pos = _row_lookup(uniq, skey)
    bnodes = [np.nonzero(bcflag & (1 << i))[0].astype(np.int32)
              for i in range(NBDRYTYPES)]
    bfacets: List[np.ndarray] = []
    for i in range(NBDRYTYPES):
        sel = (segflag == (1 << i)) & (pos >= 0)
        slot = np.sort(owner[pos[sel]])
        bfacets.append(np.stack([slot // len(nof), slot % len(nof)], axis=1)
                       .astype(np.int32).reshape(-1, 2))
    return Topology(ndims=ndims, nnode=nnode, nelem=nelem,
                    connectivity=conn.astype(np.int32),
                    bcflag=bcflag.astype(np.uint32),
                    bnodes=bnodes, bfacets=bfacets,
                    **_support_tables(conn, nnode),
                    segment=segment.astype(np.int32),
                    segflag=segflag.astype(np.int32))


def _row_lookup(table: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Index of each row of ``rows`` in the sorted unique rows ``table``,
    -1 where absent."""
    if table.shape[1] == 1:
        t, r = table[:, 0], rows[:, 0]
    else:
        dt = np.dtype([("", table.dtype)] * table.shape[1])
        t = np.ascontiguousarray(table).view(dt).ravel()
        r = np.ascontiguousarray(rows).view(dt).ravel()
    pos = np.searchsorted(t, r)
    pos = np.minimum(pos, len(t) - 1)
    return np.where(t[pos] == r, pos, -1)
