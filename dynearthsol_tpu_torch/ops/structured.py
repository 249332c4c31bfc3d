"""Structured grid bookkeeping (host numpy; counterpart of
dynearthsol_tpu/ops/structured.py).

The flagship meshes are raster-ordered regular grids.  In 2D node id =
i*nz + j, and each cell (i, j) holds two triangles whose diagonal alternates
with the cell parity (mesh/generate.regular_grid_2d).  In 3D node id =
(i*ny + j)*nz + k, and each cell (i, j, k) holds five tetrahedra whose
decomposition mirrors with the parity of i + j + k (regular_grid_3d,
``tet_tables``).  While that connectivity holds, the element<->node
transfers of the fused steps (ops/fused2d.py, ops/fused3d.py, csrc/) run as
stencils over the cells around a node instead of index gathers.  This
module recognises such a mesh and gives its parity.
"""

from __future__ import annotations

import functools

import numpy as np


def structured_conn_2d(nx: int, nz: int) -> np.ndarray:
    """Reconstruct the raster connectivity of generate.regular_grid_2d for
    an (nx, nz) node grid.  Used to VERIFY a mesh is stencil-compatible."""
    i, j = np.meshgrid(np.arange(nx - 1), np.arange(nz - 1), indexing="ij")
    n00 = i * nz + j
    n10 = (i + 1) * nz + j
    n01 = i * nz + (j + 1)
    n11 = (i + 1) * nz + (j + 1)
    even = parity_2d(nx, nz)
    t0 = np.stack([n00, n10, np.where(even, n11, n01)], axis=-1)
    t1 = np.stack([np.where(even, n00, n10), n11, n01], axis=-1)
    conn = np.stack([t0, t1], axis=2)  # (nx-1, nz-1, 2, 3)
    return conn.reshape(-1, 3).astype(np.int32)


def detect_structured_2d(conn: np.ndarray, nnode: int) -> tuple | None:
    """Return (nx, nz) if ``conn`` is exactly the raster structured pattern
    (any orientation fix or reordering disables the stencil path)."""
    nelem = conn.shape[0]
    if conn.shape[1] != 3 or nelem % 2:
        return None
    ncell = nelem // 2
    for nz in range(2, nnode):
        if nnode % nz:
            continue
        nx = nnode // nz
        if (nx - 1) * (nz - 1) == ncell:
            if np.array_equal(conn, structured_conn_2d(nx, nz)):
                return (nx, nz)
    return None


def parity_2d(nx: int, nz: int) -> np.ndarray:
    """(nx-1, nz-1) bool: True where cell (i, j) has i + j even.  Such a
    cell's triangles are (n00, n10, n11) and (n00, n11, n01); the others'
    are (n00, n10, n01) and (n10, n11, n01)."""
    i = np.arange(nx - 1)[:, None]
    j = np.arange(nz - 1)[None, :]
    return (i + j) % 2 == 0


@functools.lru_cache(maxsize=None)
def tet_tables():
    """Post-orientation slot -> cell-corner tables for the two parities of
    the 5-tet cell decomposition (generate.regular_grid_3d + _orient_3d).
    Cell corner code = a*4 + b*2 + d for offsets (a, b, d) in x/y/z.
    Returns (even_table, odd_table), each a tuple of 5 4-tuples."""
    corners = np.array([[a, b, d] for a in (0, 1) for b in (0, 1)
                        for d in (0, 1)], dtype=float)
    even = [(0, 1, 2, 4), (1, 2, 3, 7), (1, 4, 5, 7), (2, 4, 6, 7),
            (1, 2, 4, 7)]
    odd = [(0, 1, 3, 5), (0, 2, 3, 6), (0, 4, 5, 6), (3, 5, 6, 7),
           (0, 3, 5, 6)]
    out = []
    for tets in (even, odd):
        tt = []
        for t in tets:
            t = list(t)
            d1 = corners[t[1]] - corners[t[0]]
            d2 = corners[t[2]] - corners[t[0]]
            d3 = corners[t[3]] - corners[t[0]]
            if np.dot(d1, np.cross(d2, d3)) < 0:
                t[2], t[3] = t[3], t[2]
            tt.append(tuple(t))
        out.append(tuple(tt))
    return tuple(out)


def parity_3d(nx: int, ny: int, nz: int) -> np.ndarray:
    """(nx-1, ny-1, nz-1) bool: True where cell (i, j, k) has i + j + k
    even, i.e. uses the even row of ``tet_tables``."""
    i = np.arange(nx - 1)[:, None, None]
    j = np.arange(ny - 1)[None, :, None]
    k = np.arange(nz - 1)[None, None, :]
    return (i + j + k) % 2 == 0


def _cell_conn_3d(nx: int, ny: int, nz: int, i, j, k) -> np.ndarray:
    """Connectivity of cells (i, j, k) (broadcast arrays): (..., 5, 4)."""
    cn = [((i + a) * ny + (j + b)) * nz + (k + d)
          for a in (0, 1) for b in (0, 1) for d in (0, 1)]
    P = (i + j + k) % 2 == 0
    even_t, odd_t = tet_tables()
    out = np.empty(np.shape(P) + (5, 4), dtype=np.int32)
    for t in range(5):
        for s in range(4):
            out[..., t, s] = np.where(P, cn[even_t[t][s]], cn[odd_t[t][s]])
    return out


def structured_conn_3d(nx: int, ny: int, nz: int) -> np.ndarray:
    """Reconstruct the raster connectivity of generate.regular_grid_3d
    (after orientation) for an (nx, ny, nz) node grid."""
    i, j, k = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                          np.arange(nz - 1), indexing="ij")
    return _cell_conn_3d(nx, ny, nz, i, j, k).reshape(-1, 4)


def detect_structured_3d(conn: np.ndarray, nnode: int) -> tuple | None:
    """Return (nx, ny, nz) if ``conn`` is exactly the raster 5-tet
    structured pattern, else None.  The candidates are the JAX package's
    (node-count factorisations whose cell count matches); each is first
    checked on its first and last cell, which costs nothing, before the
    whole connectivity (983k x 4 at the 3D flagship) is rebuilt and
    compared."""
    nelem = conn.shape[0]
    if conn.ndim != 2 or conn.shape[1] != 4 or nelem % 5:
        return None
    ncell = nelem // 5
    for nx in range(2, int(nnode ** (1 / 3)) + 2):
        if nnode % nx:
            continue
        rem = nnode // nx
        for ny in range(2, rem):
            if rem % ny:
                continue
            nz = rem // ny
            for dims in {(nx, ny, nz), (ny, nz, nx), (nz, nx, ny),
                         (nx, nz, ny), (ny, nx, nz), (nz, ny, nx)}:
                a, b, c = dims
                if (a - 1) * (b - 1) * (c - 1) != ncell:
                    continue
                ends = _cell_conn_3d(a, b, c, np.array([0, a - 2]),
                                     np.array([0, b - 2]),
                                     np.array([0, c - 2]))
                if not (np.array_equal(conn[:5], ends[0])
                        and np.array_equal(conn[-5:], ends[1])):
                    continue
                if np.array_equal(conn, structured_conn_3d(a, b, c)):
                    return dims
    return None
