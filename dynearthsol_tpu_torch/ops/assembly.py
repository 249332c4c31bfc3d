"""Element->node assembly as a padded-support gather (counterpart of
dynearthsol_tpu/ops/assembly.py).

The reference avoids scatter races with a two-phase gather: per-element
contributions land in an ``elem_cache`` and a second loop gathers via the
node->element support list (fields.cxx:612-703; geometry.cxx:1020-1154;
CSR support mesh.cxx:3240-3281).  Here each node sums its masked corner
slots in the table's fixed order.  ``index_add_`` is not used: its CUDA
atomics add in an order that changes from run to run, and a bit-exact
restart needs sums that do not (SURVEY §2.3).

Under a group of shards (parallel/group.py) a shard's assembly covers its
own elements only: ``node_sum_halo`` completes a node window's sums with
the neighbours' overlap rows (the node-sharded halo step,
parallel/halo_step.py), ``node_sum_scatter`` sums full-length partials
over the group (the replicated-nodal shard step, parallel/shard_step.py).
Both assemble through ops/band2d.py's ``asm_pack`` (the kernel on the
card), so they take a mesh's gather tables where the JAX package takes
its connectivity.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class HaloSpec:
    """Node-window bookkeeping of one shard of the node-sharded halo step
    (parallel/halo_step.py; JAX ops/assembly.HaloSpec).

    Nodes are split into contiguous blocks of B rows in the renumbered
    order; a shard holds the W = B + 2h rows around its block, ``h`` the
    largest index spread of any element's corners, so every element of
    the shard has its corners in the window.  ``own_mask`` is 1.0 on the
    B owned rows (less the pad tail of the last shard), else 0.0."""

    own_mask: torch.Tensor  # (W,) 1.0 / 0.0, the step's float type
    h: int                  # halo rows on each side
    ndev: int               # shards in the group


def halo_overlap_add(out: torch.Tensor, axis, halo: HaloSpec):
    """Add the neighbours' 2h overlap rows to a shard's nodal partial sums
    (``axis``: the shard's ``parallel.group.ShardAxis``).  Every overlap
    row becomes own + neighbour, a two-term IEEE add, so both owners hold
    its bits.  The element assembly and, as a second exchange, the facet
    sums (tractions, surface diffusion) go through it."""
    return axis.exchange(out, 2 * halo.h)


def _pack_corners(contrib: torch.Tensor) -> torch.Tensor:
    """(nelem, npe) or (nelem, npe, k) -> band2d's (k, npe, nelem)."""
    c = contrib if contrib.ndim == 3 else contrib[..., None]
    return c.permute(2, 1, 0).contiguous()


def _masked(contrib, elem_mask):
    if elem_mask is None:
        return contrib
    return contrib * elem_mask.reshape((-1,) + (1,) * (contrib.ndim - 1))


def node_sum_halo(contrib: torch.Tensor, bt, axis, halo: HaloSpec,
                  elem_mask=None) -> torch.Tensor:
    """Halo assembly: each window row's sum over the shard's elements
    (``bt``: band2d tables of the window-local connectivity), then the
    overlap rows of both neighbours added.  (nelem, npe[, k]) ->
    (W[, k])."""
    from .band2d import asm_pack

    out = halo_overlap_add(asm_pack(_pack_corners(
        _masked(contrib, elem_mask)), bt), axis, halo)
    return out[:, 0] if contrib.ndim == 2 else out


def node_sum_scatter(contrib: torch.Tensor, bt, axis=None,
                     elem_mask=None) -> torch.Tensor:
    """Scatter assembly of the replicated-nodal shard step: the shard's
    elements summed into a full-length nodal array (``bt``: tables of the
    shard's elements on global node ids), then the partials of all shards
    added in shard order.  (nelem, npe[, k]) -> (nnode[, k])."""
    from .band2d import asm_pack

    out = asm_pack(_pack_corners(_masked(contrib, elem_mask)), bt)
    if axis is not None:
        out = axis.psum(out)
    return out[:, 0] if contrib.ndim == 2 else out


def node_sum(contrib: torch.Tensor, gather_idx: torch.Tensor,
             gather_mask: torch.Tensor) -> torch.Tensor:
    """Sum per-(element, corner) contributions onto nodes.

    contrib: (nelem, npe) or (nelem, npe, k)
    gather_idx/gather_mask: (nnode, max_degree) padded support table
    returns: (nnode,) or (nnode, k)
    """
    nslots = contrib.shape[0] * contrib.shape[1]
    flat = contrib.reshape(nslots, -1)
    rows = flat[gather_idx.reshape(-1).long()].reshape(
        gather_idx.shape + (flat.shape[1],))
    rows = torch.where(gather_mask[..., None], rows, torch.zeros_like(rows))
    out = rows[:, 0]
    for k in range(1, rows.shape[1]):
        out = out + rows[:, k]
    return out[:, 0] if contrib.ndim == 2 else out


@dataclass(frozen=True)
class OrderedAdd:
    """Adds a list of updates onto rows of a nodal array in a fixed order,
    with no atomics: the form of ``x.at[targets].add(vals)`` in the JAX
    package, which XLA on the CPU applies one update at a time in the
    order of ``targets``.

    ``build`` makes the tables on the host: the touched rows, and for each
    row the ids of its updates in that order, padded (``mask`` False).
    ``to(device)`` moves them; ``apply`` gathers the touched rows, adds
    their updates left to right (a padded slot keeps the row as it is) and
    writes the rows back."""

    n: int                # number of updates
    rows: object          # (nrows,) touched rows, ascending
    idx: object           # (depth, nrows) update ids, in update order
    mask: object          # (depth, nrows) bool

    @staticmethod
    def build(targets) -> "OrderedAdd":
        targets = np.asarray(targets, dtype=np.int64).reshape(-1)
        rows, inv, counts = np.unique(targets, return_inverse=True,
                                      return_counts=True)
        depth = int(counts.max()) if len(counts) else 0
        idx = np.zeros((depth, len(rows)), dtype=np.int64)
        mask = np.zeros((depth, len(rows)), dtype=bool)
        fill = np.zeros(len(rows), dtype=np.int64)
        for j, r in enumerate(inv):
            idx[fill[r], r] = j
            mask[fill[r], r] = True
            fill[r] += 1
        return OrderedAdd(len(targets), rows, idx, mask)

    def to(self, device) -> "OrderedAdd":
        return OrderedAdd(self.n,
                          *(torch.as_tensor(a, device=device)
                            for a in (self.rows, self.idx, self.mask)))

    def apply(self, base: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        """base (nnode, ...) plus vals (n, ...) at the targets, in order;
        the tables must be on base's device (``to``)."""
        if self.n == 0:
            return base
        acc = base.index_select(0, self.rows)
        extra = (1,) * (base.dim() - 1)
        for d in range(self.idx.shape[0]):
            acc = torch.where(self.mask[d].view(-1, *extra),
                              acc + vals.index_select(0, self.idx[d]), acc)
        return base.index_copy(0, self.rows, acc)
