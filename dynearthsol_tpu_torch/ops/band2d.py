"""Corner gather and nodal assembly for unstructured meshes (counterpart of
dynearthsol_tpu/ops/band2d.py).

The column step (ops/flat2d.py) moves data between nodes and elements six
times per step: nodal fields to the corners of every element, and element
corner contributions into nodal sums.  The JAX package does this with three
Pallas kernels built on supernode rows, block windows and one-hot matmuls,
because the TPU gathers slowly and multiplies fast.  None of that is carried
over: on the card a block stages the node rows of a tile of consecutive
elements in shared memory and its threads read their corners there, or a
thread sums its node's slots.  The three kernels are CUDA C++ in
csrc/band2d.cu:

  cgather      <- band2d.gather_corners_tpu          (band2d.py:550)
  asm_pack     <- band2d.scatter_corners_tpu         (band2d.py:689)
  asm_gather   <- band2d.scatter_gather_corners_tpu  (band2d.py:351)

Each wrapper launches its kernel for CUDA tensors (and counts the launch in
its ``launches`` attribute) and runs the plain PyTorch version beside it
(``gather_corners``, ``scatter_corners``, ``scatter_gather_corners``) for
CPU tensors.  The plain versions index with ``conn`` and sum with the
degree-unrolled masked gather of flat2d.py:160-168.

Layouts.  Nodal packs are ``(nnode, k)`` rows (k <= 8 fields of one node
side by side, as the state keeps coord and vel).  Element packs are
``(k, npe, nelem)``: field-major, then corner-major slots
``slot = corner * nelem + e``, so that ``pack[j, c]`` is one contiguous
element column.  The assembly sums each node's contributions from +0.0 in
the slot order of ops/assembly.node_sum, with no atomics, so its result
equals node_sum's bit for bit, in float32 and float64, and does not change
from run to run.  The gather is an exact selection.

Tables are built on the host once per mesh, for any numbering.  The
gather cuts the elements into tiles of TILE consecutive ids.  A tile whose
corners' node ids span at most W_MAX rows (its window) is staged: the
kernel copies the window's rows into shared memory in one bulk copy and
reads each corner through its id relative to the window's base.  A wider
tile (a mesh numbered at random, or the few tiles that meet a node of the
far end) reads the nodal pack directly.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import numpy as np
import torch

KMAX = 8   # fields per call (csrc/band2d.cu KMAX)
UNROLL = 12  # slots of a row the assembly loads at once (csrc/band2d.cu)
TILE = 1024  # elements of a gather tile (csrc/band2d.cu TILE)
W_MAX = 2048  # rows of the widest window a tile stages (csrc/band2d.cu WMAX)
ALIGN = 4    # window bases are multiples of ALIGN rows: lo * ld * 4 or 8
             # bytes is a multiple of 16, as the bulk copy needs


_TABLE_TYPES = {"conn_cm": torch.int32, "row_ptr": torch.int32,
                "slots": torch.int32, "tile_lo": torch.int32,
                "tile_w": torch.int32, "tile_staged": torch.bool,
                "rel_cm": torch.int16}


@dataclass(frozen=True)
class GatherTables:
    """Static gather/assembly tables of one mesh, on the run's device.

    ``conn_cm``: node of each corner slot, corner-major.  ``row_ptr`` /
    ``slots``: the node -> corner-slot support as CSR, each row in
    node_sum's order (ascending ``e * npe + c``), the slot ids renumbered
    corner-major.  ``g_cols`` / ``m_cols``: the same support padded to the
    maximum degree, one row per degree, for the plain versions.

    The gather's tiles (TILE consecutive elements each): ``tile_lo``, the
    base row of each tile's window (a multiple of ALIGN), ``tile_w`` its
    height (the tile's largest node id + 1 - ``tile_lo``), ``tile_staged``
    whether ``tile_w <= W_MAX``; ``rel_cm``, each slot's node id less its
    tile's ``tile_lo`` for staged tiles (0 elsewhere; below W_MAX, so
    int16 holds it), corner-major like ``conn_cm``; ``win_rows``, the
    largest staged window (0 if none), which sets the kernel's shared
    memory.

    Construction checks every table's type, layout and device once, and
    keeps the gather tables as the C entry points take them
    (``c_tiles``), so that a launch checks the device alone."""

    nelem: int
    nnode: int
    npe: int
    conn_cm: torch.Tensor    # (npe * nelem,) int32
    row_ptr: torch.Tensor    # (nnode + 1,) int32
    slots: torch.Tensor      # (npe * nelem,) int32
    g_cols: torch.Tensor     # (max_degree, nnode) int64
    m_cols: torch.Tensor     # (max_degree, nnode) bool
    tile_lo: torch.Tensor    # (ntiles,) int32
    tile_w: torch.Tensor     # (ntiles,) int32
    tile_staged: torch.Tensor  # (ntiles,) bool
    rel_cm: torch.Tensor     # (npe * nelem,) int16
    win_rows: int

    def __post_init__(self):
        dev = self.conn_cm.device
        for name, dtype in _TABLE_TYPES.items():
            t = getattr(self, name)
            if not (t.device == dev and t.dtype == dtype
                    and t.is_contiguous()):
                raise TypeError(f"{name}: need a contiguous {dtype} tensor "
                                f"on {dev}")
        object.__setattr__(self, "c_tiles", (
            _ptr(self.conn_cm), _ptr(self.rel_cm), _ptr(self.tile_lo),
            _ptr(self.tile_w), _ptr(self.tile_staged), self.win_rows))


def tile_windows(conn_cm: np.ndarray, tile: int = TILE, w_max: int = W_MAX):
    """The gather's tiles of ``conn_cm`` ((npe, nelem) node ids): per tile
    of ``tile`` consecutive elements the window base (rounded down to
    ALIGN rows), height and whether it is staged (height <= ``w_max``),
    and each slot's id relative to its staged tile's base (0 for the slots
    of unstaged tiles), (npe, nelem) int16."""
    nelem = conn_cm.shape[1]
    starts = np.arange(0, nelem, tile)
    lo = np.minimum.reduceat(conn_cm.min(axis=0), starts) // ALIGN * ALIGN
    w = np.maximum.reduceat(conn_cm.max(axis=0), starts) + 1 - lo
    staged = w <= w_max
    t = np.arange(nelem) // tile
    rel = np.where(staged[t], conn_cm - lo[t], 0).astype(np.int16)
    return lo, w, staged, rel


def build_tables(conn: np.ndarray, nnode: int, device="cpu") -> GatherTables:
    """Host-side preprocessing of ``conn`` (nelem, npe): a stable sort of
    the flattened corner slots by node id gives each node its slots in
    ascending order, which is the order of the support table of
    mesh/topology.finish_topology and so of node_sum."""
    conn = np.ascontiguousarray(conn, dtype=np.int64)
    nelem, npe = conn.shape
    if npe * nelem >= 2 ** 31 // KMAX:
        raise ValueError("mesh too large for the kernels' int32 slot ids")
    flat = conn.ravel()
    order = np.argsort(flat, kind="stable")          # slot ids e*npe + c
    counts = np.bincount(flat, minlength=nnode)
    row_ptr = np.concatenate([[0], np.cumsum(counts)])
    slots = (order % npe) * nelem + order // npe      # corner-major
    max_deg = int(counts.max())
    node_of = flat[order]
    pos = np.arange(flat.size) - row_ptr[node_of]
    g_cols = np.zeros((max_deg, nnode), dtype=np.int64)
    m_cols = np.zeros((max_deg, nnode), dtype=bool)
    g_cols[pos, node_of] = slots
    m_cols[pos, node_of] = True

    lo, w, staged, rel = tile_windows(conn.T)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=device) \
            .to(dtype).contiguous()

    return GatherTables(
        nelem=nelem, nnode=nnode, npe=npe,
        conn_cm=dev(conn.T.reshape(-1), torch.int32),
        row_ptr=dev(row_ptr, torch.int32), slots=dev(slots, torch.int32),
        g_cols=dev(g_cols, torch.int64), m_cols=dev(m_cols, torch.bool),
        tile_lo=dev(lo, torch.int32), tile_w=dev(w, torch.int32),
        tile_staged=dev(staged, torch.bool),
        rel_cm=dev(rel.reshape(-1), torch.int16),
        win_rows=int(w[staged].max(initial=0)))


# ------------------------------------------------------- plain versions

def gather_corners(pack, bt: GatherTables):
    """Nodal pack (nnode, k) -> (k, npe, nelem): ``pack[conn[:, c], j]``
    at ``[j, c]``.  Counted in ``gather_corners.calls``, so that a run on
    the card can show that it never took a plain version."""
    gather_corners.calls += 1
    k = pack.shape[1]
    rows = pack[bt.conn_cm.long()]                   # (npe * nelem, k)
    return rows.t().reshape(k, bt.npe, bt.nelem).contiguous()


gather_corners.calls = 0


def scatter_corners(cols, bt: GatherTables):
    """Element pack (k, npe, nelem) -> nodal sums (nnode, k), each node's
    slots added in table order from +0.0.  Counted in
    ``scatter_corners.calls``."""
    scatter_corners.calls += 1
    k = cols.shape[0]
    pack = cols.reshape(k, bt.npe * bt.nelem).t()    # (nslots, k)
    acc = torch.zeros((bt.nnode, k), dtype=cols.dtype, device=cols.device)
    zero = torch.zeros_like(acc)
    for d in range(bt.g_cols.shape[0]):
        vals = pack[bt.g_cols[d]]                    # (nnode, k)
        acc = acc + torch.where(bt.m_cols[d][:, None], vals, zero)
    return acc


scatter_corners.calls = 0


def scatter_gather_corners(cols, bt: GatherTables, kg: int):
    """Assembly, then the first ``kg`` nodal sums back at the corners:
    ((nnode, k) sums, (kg, npe, nelem))."""
    sums = scatter_corners(cols, bt)
    return sums, gather_corners(sums[:, :kg], bt)


# ------------------------------------------------------ kernel wrappers

_CTYPE = {torch.float32: 0, torch.float64: 1}
# the shards of parallel/group.py launch from threads of their own: a
# count is added under this lock, so that none is lost
_COUNT = threading.Lock()


def _count(wrapper):
    with _COUNT:
        wrapper.launches += 1


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check_tables(bt: GatherTables, dev):
    if bt.conn_cm.device != dev:
        raise TypeError(f"conn_cm and the other tables: need them on {dev}, "
                        f"not {bt.conn_cm.device}")


def _check_nodal(pack, bt: GatherTables):
    if pack.dtype not in _CTYPE:
        raise TypeError(f"no gather kernel for {pack.dtype}")
    if pack.ndim != 2 or pack.shape[0] != bt.nnode \
            or not 1 <= pack.shape[1] <= KMAX or not pack.is_contiguous():
        raise ValueError(f"nodal pack: need a contiguous (nnode, k <= "
                         f"{KMAX}) tensor, got {tuple(pack.shape)}")


def _check_elem(cols, bt: GatherTables):
    if cols.dtype not in _CTYPE:
        raise TypeError(f"no assembly kernel for {cols.dtype}")
    if cols.ndim != 3 or tuple(cols.shape[1:]) != (bt.npe, bt.nelem) \
            or not 1 <= cols.shape[0] <= KMAX or not cols.is_contiguous():
        raise ValueError(f"element pack: need a contiguous (k <= {KMAX}, "
                         f"npe, nelem) tensor, got {tuple(cols.shape)}")


def cgather(pack, bt: GatherTables):
    """gather_corners through the CUDA kernel ``des_gather_corners`` for a
    CUDA tensor (counted in ``cgather.launches``), the plain version for a
    CPU tensor."""
    if pack.is_cuda:
        from . import _build

        _check_nodal(pack, bt)
        _check_tables(bt, pack.device)
        k = pack.shape[1]
        out = torch.empty((k, bt.npe, bt.nelem), dtype=pack.dtype,
                          device=pack.device)
        rc = _build.load().des_gather_corners(
            _CTYPE[pack.dtype], _ptr(pack), k, k, *bt.c_tiles,
            bt.npe, bt.nelem, _ptr(out), _stream())
        if rc != 0:
            raise RuntimeError(f"gather_corners launch failed: "
                               f"{_build.err(rc)}")
        _count(cgather)
        return out
    if pack.device.type != "cpu":
        raise TypeError(f"no corner gather for device {pack.device}")
    return gather_corners(pack, bt)


cgather.launches = 0


def asm_pack(cols, bt: GatherTables):
    """scatter_corners through the CUDA kernel ``des_scatter_corners`` for
    a CUDA tensor (counted in ``asm_pack.launches``), the plain version for
    a CPU tensor."""
    if cols.is_cuda:
        from . import _build

        _check_elem(cols, bt)
        _check_tables(bt, cols.device)
        k = cols.shape[0]
        out = torch.empty((bt.nnode, k), dtype=cols.dtype,
                          device=cols.device)
        rc = _build.load().des_scatter_corners(
            _CTYPE[cols.dtype], _ptr(cols), k, _ptr(bt.row_ptr),
            _ptr(bt.slots), bt.nnode, bt.npe, bt.nelem, _ptr(out),
            _stream())
        if rc != 0:
            raise RuntimeError(f"scatter_corners launch failed: "
                               f"{_build.err(rc)}")
        _count(asm_pack)
        return out
    if cols.device.type != "cpu":
        raise TypeError(f"no assembly for device {cols.device}")
    return scatter_corners(cols, bt)


asm_pack.launches = 0


def asm_gather(cols, bt: GatherTables, kg: int):
    """scatter_gather_corners through ``des_scatter_gather_corners`` for a
    CUDA tensor (one C entry point: asm_pack's kernel, then cgather's on
    the first kg sums, staging whole rows of k; counted once in
    ``asm_gather.launches``), the plain version for a CPU tensor."""
    if not 1 <= kg <= cols.shape[0]:
        raise ValueError(f"kg = {kg} outside 1..{cols.shape[0]}")
    if cols.is_cuda:
        from . import _build

        _check_elem(cols, bt)
        _check_tables(bt, cols.device)
        k = cols.shape[0]
        sums = torch.empty((bt.nnode, k), dtype=cols.dtype,
                           device=cols.device)
        gath = torch.empty((kg, bt.npe, bt.nelem), dtype=cols.dtype,
                           device=cols.device)
        rc = _build.load().des_scatter_gather_corners(
            _CTYPE[cols.dtype], _ptr(cols), k, kg, _ptr(bt.row_ptr),
            _ptr(bt.slots), *bt.c_tiles, bt.nnode, bt.npe, bt.nelem,
            _ptr(sums), _ptr(gath), _stream())
        if rc != 0:
            raise RuntimeError(f"scatter_gather_corners launch failed: "
                               f"{_build.err(rc)}")
        _count(asm_gather)
        return sums, gath
    if cols.device.type != "cpu":
        raise TypeError(f"no assembly for device {cols.device}")
    return scatter_gather_corners(cols, bt, kg)


asm_gather.launches = 0
