"""Corner gather and nodal assembly for unstructured meshes (counterpart of
dynearthsol_tpu/ops/band2d.py).

The column step (ops/flat2d.py) moves data between nodes and elements six
times per step: nodal fields to the corners of every element, and element
corner contributions into nodal sums.  The JAX package does this with three
Pallas kernels built on supernode rows, block windows and one-hot matmuls,
because the TPU gathers slowly and multiplies fast.  None of that is carried
over: on the card a thread reads its node or its element directly.  The
three kernels are CUDA C++ in csrc/band2d.cu:

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

Tables are built on the host once per mesh, for any numbering.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

KMAX = 8   # fields per call (csrc/band2d.cu KMAX)


@dataclass(frozen=True)
class GatherTables:
    """Static gather/assembly tables of one mesh, on the run's device.

    ``conn_cm``: node of each corner slot, corner-major.  ``row_ptr`` /
    ``slots``: the node -> corner-slot support as CSR, each row in
    node_sum's order (ascending ``e * npe + c``), the slot ids renumbered
    corner-major.  ``g_cols`` / ``m_cols``: the same support padded to the
    maximum degree, one row per degree, for the plain versions."""

    nelem: int
    nnode: int
    npe: int
    conn_cm: torch.Tensor    # (npe * nelem,) int32
    row_ptr: torch.Tensor    # (nnode + 1,) int32
    slots: torch.Tensor      # (npe * nelem,) int32
    g_cols: torch.Tensor     # (max_degree, nnode) int64
    m_cols: torch.Tensor     # (max_degree, nnode) bool


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

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=device) \
            .to(dtype).contiguous()

    return GatherTables(
        nelem=nelem, nnode=nnode, npe=npe,
        conn_cm=dev(conn.T.reshape(-1), torch.int32),
        row_ptr=dev(row_ptr, torch.int32), slots=dev(slots, torch.int32),
        g_cols=dev(g_cols, torch.int64), m_cols=dev(m_cols, torch.bool))


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


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check_tables(bt: GatherTables, dev):
    for name in ("conn_cm", "row_ptr", "slots"):
        t = getattr(bt, name)
        if not (t.device == dev and t.dtype == torch.int32
                and t.is_contiguous()):
            raise TypeError(f"{name}: need a contiguous int32 tensor on "
                            f"{dev}")


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
            _CTYPE[pack.dtype], _ptr(pack), k, k, _ptr(bt.conn_cm),
            bt.npe, bt.nelem, _ptr(out), _stream())
        if rc != 0:
            raise RuntimeError(f"gather_corners launch failed: "
                               f"{_build.err(rc)}")
        cgather.launches += 1
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
        asm_pack.launches += 1
        return out
    if cols.device.type != "cpu":
        raise TypeError(f"no assembly for device {cols.device}")
    return scatter_corners(cols, bt)


asm_pack.launches = 0


def asm_gather(cols, bt: GatherTables, kg: int):
    """scatter_gather_corners through ``des_scatter_gather_corners`` for a
    CUDA tensor (one C entry point, counted once in
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
            _ptr(bt.slots), _ptr(bt.conn_cm), bt.nnode, bt.npe, bt.nelem,
            _ptr(sums), _ptr(gath), _stream())
        if rc != 0:
            raise RuntimeError(f"scatter_gather_corners launch failed: "
                               f"{_build.err(rc)}")
        asm_gather.launches += 1
        return sums, gath
    if cols.device.type != "cpu":
        raise TypeError(f"no assembly for device {cols.device}")
    return scatter_gather_corners(cols, bt, kg)


asm_gather.launches = 0
