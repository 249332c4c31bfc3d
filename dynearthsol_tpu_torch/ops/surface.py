"""Surface topology, the surface-plstrain decay and the surface processes
(counterpart of dynearthsol_tpu/ops/surface.py).

Reference: bc.cxx:877-1831.  Surface process option 1 (hillslope
diffusion in 2D, facet-FEM topography diffusion in 3D) runs in the fused
steps (ops/fused2d.py, ops/fused3d.py), which also apply the surface-element
correction (bc.cxx:1613-1665) and the plastic-strain decay
(bc.cxx:1591-1611) in-kernel with the constants below.  The column steps
(ops/flat2d.py, ops/flat3d.py) apply the correction with
``top_elem_mask`` (and in 2D the decay with ``surface_plstrain_decay``),
and the surface processes with ``apply_surface_processes`` on the tensor
tables of ``surf_tables``: in 2D options 1 and 102 (diffusion,
terrigenous basin fill, hemipelagic rain), in 3D the facet diffusion of
option 1.  The nodal sums of the diffusion add in the JAX package's order
(every facet's first node, then every facet's second, then in 3D every
facet's third) with no atomics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..constants import IBOUNDZ1, YEAR2SEC, dim
from .assembly import OrderedAdd

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
    # a shard's tables under the node-sharded step (parallel/halo_step.py):
    # the window's top-node indicator and the 1/0 real-row indicator of
    # its padded facet table; None on one device
    top_mask_f: Optional[np.ndarray] = None  # (nnode,) 1.0 / 0.0
    facet_mask: Optional[np.ndarray] = None  # (etop,) 1 / 0


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


@dataclass(frozen=True)
class SurfTables:
    """The surface-process tables of a SurfInfo as tensors on the run's
    device."""

    top_nodes: torch.Tensor    # (ntop,) int64, as SurfInfo.top_nodes
    top_mask_f: torch.Tensor   # (nnode,) 1.0 on top nodes, else 0.0
    n0: torch.Tensor           # (etop,) each top facet's first node
    n1: torch.Tensor           # (etop,) and its second
    n2: Optional[torch.Tensor]  # (etop,) and its third (3D), else None
    edge_add: OrderedAdd       # over concat(n0, n1[, n2]), in that order
    facet_mask: Optional[torch.Tensor] = None  # (etop,) SurfInfo's


def surf_tables(surf: SurfInfo, nnode: int, dtype, device) -> SurfTables:
    if surf.top_mask_f is not None:
        mask = surf.top_mask_f
    else:
        mask = np.zeros(nnode)
        mask[surf.top_nodes] = 1.0
    fn = surf.facet_nodes.astype(np.int64)

    def t(a):
        return torch.as_tensor(a, device=device)

    return SurfTables(
        top_nodes=t(surf.top_nodes.astype(np.int64)),
        top_mask_f=t(mask).to(dtype), n0=t(fn[:, 0]), n1=t(fn[:, 1]),
        n2=t(fn[:, 2]) if fn.shape[1] == 3 else None,
        edge_add=OrderedAdd.build(fn.T.reshape(-1)).to(device),
        facet_mask=(None if surf.facet_mask is None
                    else t(surf.facet_mask).to(dtype)))


def _div(x, v):
    """x / v for a Python number v, divided truly on the card too (there
    PyTorch multiplies by the reciprocal of a Python divisor); the divisor
    is filled on the device, with no copy from the host."""
    return torch.div(x, torch.full_like(x, v))


def _edge_sums(st: SurfTables, coord, vals, halo_exchange):
    """The facets' (slope, length) terms summed onto their nodes in the
    JAX package's order; under the node-sharded step the window's overlap
    rows are then exchanged (a second exchange, as for the facet
    tractions), so that every row holds the sums of both shards'
    facets."""
    tot = st.edge_add.apply(
        torch.zeros((coord.shape[0], 2), dtype=coord.dtype,
                    device=coord.device), vals)
    if halo_exchange is not None:
        tot = halo_exchange(tot)
    return tot


def surface_dh_2d(coord, st: SurfTables, surf_diff, dt, base_level,
                  ratio_terrig, ratio_marine, halo_exchange=None):
    """1D finite-difference topography diffusion (bc.cxx:990-1073, 2D).
    Returns dh as a full (nnode,) tensor, zero off the surface.  A shard's
    padded facets are zeroed by ``st.facet_mask``."""
    n0, n1 = st.n0, st.n1
    dx = torch.abs(coord[n1, 0] - coord[n0, 0])
    safe_edge = torch.where(dx > 0, dx, torch.ones_like(dx))
    slope = (coord[n1, 1] - coord[n0, 1]) / safe_edge
    if st.facet_mask is not None:
        dx = dx * st.facet_mask
        slope = slope * st.facet_mask
    # per-edge contributions: node 0 gets -slope, node 1 +slope
    tot = _edge_sums(st, coord, torch.stack(
        [torch.cat([-slope, slope]), torch.cat([dx, dx])], dim=1),
        halo_exchange)
    total_slope, total_dx = tot[:, 0], tot[:, 1]
    safe_dx = torch.where(total_dx > 0, total_dx, torch.ones_like(total_dx))
    conv = surf_diff * dt * total_slope / safe_dx
    z = coord[:, 1]
    # terrigenous/marine diffusivity ratios around the base level
    dh = torch.where((z > base_level) & (conv > 0), -ratio_terrig * conv,
                     torch.where((z <= base_level) & (conv < 0),
                                 -ratio_marine * conv, -conv))
    return dh * st.top_mask_f


def surface_dh_3d(coord, st: SurfTables, surf_diff, dt, halo_exchange=None):
    """Facet-FEM topography diffusion (bc.cxx:920-1050, 3D): each top
    facet's linear-triangle slope terms on its horizontal projection,
    summed onto its three nodes.  Returns dh as a full (nnode,) tensor,
    zero off the surface."""
    p0, p1, p2 = coord[st.n0], coord[st.n1], coord[st.n2]
    d01 = p1 - p0
    d02 = p2 - p0
    parea = 0.5 * (d01[:, 0] * d02[:, 1] - d01[:, 1] * d02[:, 0])
    iv = 1.0 / (2.0 * torch.where(parea != 0, parea,
                                  torch.ones_like(parea)))
    sx = (iv * (p1[:, 1] - p2[:, 1]), iv * (p2[:, 1] - p0[:, 1]),
          iv * (p0[:, 1] - p1[:, 1]))
    sy = (iv * (p2[:, 0] - p1[:, 0]), iv * (p0[:, 0] - p2[:, 0]),
          iv * (p1[:, 0] - p0[:, 0]))
    zf = (p0[:, 2], p1[:, 2], p2[:, 2])
    gx = sx[0] * zf[0] + sx[1] * zf[1] + sx[2] * zf[2]
    gy = sy[0] * zf[0] + sy[1] * zf[1] + sy[2] * zf[2]
    # slope_j = sum_k (dx_j dx_k + dy_j dy_k) z_k * parea
    slope = [(sx[j] * gx + sy[j] * gy) * parea for j in range(3)]
    if st.facet_mask is not None:
        slope = [sl * st.facet_mask for sl in slope]
        parea = parea * st.facet_mask
    tot = _edge_sums(st, coord, torch.stack(
        [torch.cat(slope), parea.repeat(3)], dim=1), halo_exchange)
    total_slope, total_dx = tot[:, 0], tot[:, 1]
    safe_dx = torch.where(total_dx > 0, total_dx, torch.ones_like(total_dx))
    conv = surf_diff * dt * total_slope / safe_dx
    return -conv * st.top_mask_f


def _argmax(mask):
    """First index of a True (0 when there is none), as jnp.argmax."""
    return torch.argmax(mask.to(torch.int32))


def _find_basin(depth, side: int):
    """First (side 0) / last (side 1) submerged run bounded by land
    (find_basin, bc.cxx:1389-1436).  depth > 0 is below the base level.
    Returns (b0, b1, found) as 0-d tensors; b0, b1 index the top nodes."""
    n = depth.shape[0]
    bnd = depth[:-1] * depth[1:]
    idx = torch.arange(n - 1, device=depth.device)
    if side == 0:
        start_mask = (bnd <= 0.0) & (depth[:-1] < 0.0)
        b0 = _argmax(start_mask) + 1
        end_mask = (bnd <= 0.0) & (depth[1:] < 0.0) & (idx >= b0)
        b1 = _argmax(end_mask)
        return b0, b1, start_mask.any() & end_mask.any()
    end_mask = (bnd <= 0.0) & (depth[1:] < 0.0)
    b1 = n - 2 - _argmax(torch.flip(end_mask, (0,)))
    start_mask = (bnd <= 0.0) & (depth[:-1] < 0.0) & (idx < b1)
    b0 = n - 2 - _argmax(torch.flip(start_mask, (0,))) + 1
    return b0, b1, start_mask.any() & end_mask.any()


def terrigenous_dh(param, x_top, z_top, dt):
    """Depth-dependent terrigenous basin-fill sedimentation
    (terrigenous_deposition + terrigenous_diffusion, bc.cxx:1341-1589),
    2D.  Sediment comes from both sides; each side fills its nearest basin
    over 10 adaptive sub-cycles, all on the device.  Returns dh over the
    top nodes (ntop,)."""
    ctrl = param.control
    S0 = ctrl.terrig_sediment_area
    C0 = ctrl.terrig_sediment_diffusivity
    C1 = ctrl.terrig_depth_coefficient
    iters = 10
    ntop = x_top.shape[0]
    dev = x_top.device
    ar = torch.arange(ntop, device=dev)
    idxs = torch.arange(ntop - 1, device=dev)
    zero1 = torch.zeros(1, dtype=x_top.dtype, device=dev)
    top_depth = ctrl.surf_base_level - z_top
    # basin_dx at node m (interior only); / 2 is exactly * 0.5
    dxm = torch.abs(torch.roll(x_top, -1) - torch.roll(x_top, 1)) * 0.5
    safe_dxm = torch.where(dxm != 0, dxm, torch.ones_like(dxm))
    no_basin_at_all = top_depth.max() * top_depth.min() >= 0.0
    dt_first = _div(dt, iters)

    def run_side(side, dh_tmp):
        dt_next = torch.zeros((), dtype=x_top.dtype, device=dev)
        for _ in range(iters):
            depth_tmp = top_depth - dh_tmp
            b0, b1, found = _find_basin(depth_tmp, side)
            in_basin = (ar >= b0) & (ar <= b1) & found
            dt_cycle = torch.where(dt_next > 0.0, dt_next, dt_first)
            area = torch.where(in_basin, dxm * (depth_tmp + 1e-2),
                               torch.zeros_like(dxm)).sum()
            area_ref = S0 * dt_cycle
            fill = area <= area_ref
            dt_next = torch.where(found & fill,
                                  dt_cycle * (1.0 - area / area_ref),
                                  torch.zeros_like(dt_cycle))
            # segment slopes with the source-side flux BC
            # (terrigenous_diffusion, bc.cxx:1352-1361)
            seg = -(depth_tmp[1:] - depth_tmp[:-1]) \
                / (x_top[1:] - x_top[:-1])
            if side == 0:
                seg = torch.where(idxs == b0 - 1,
                                  torch.full_like(seg, -S0 / C0), seg)
            else:
                seg = torch.where(idxs == b1, torch.full_like(seg, S0 / C0),
                                  seg)
            dslope = torch.cat([zero1, seg[1:] - seg[:-1], zero1])
            dh_d = dt_cycle * C0 * torch.exp(-C1 * depth_tmp) \
                * dslope / safe_dxm
            # multi-node basin: zero the far-end node (bc.cxx:1367-1372)
            far = b1 if side == 0 else b0
            dh_d = torch.where((ar == far) & (b1 > b0),
                               torch.zeros_like(dh_d), dh_d)
            dh_d = torch.clamp(dh_d, min=0.0)
            dh_d = torch.where(dh_d > depth_tmp, depth_tmp + 1e-2, dh_d)
            dh_b = torch.where(fill, depth_tmp + 1e-2, dh_d)
            dh_tmp = dh_tmp + torch.where(in_basin, dh_b,
                                          torch.zeros_like(dh_b))
        return dh_tmp

    dh = run_side(0, torch.zeros_like(x_top))
    dh = run_side(1, dh)
    return torch.where(no_basin_at_all, torch.zeros_like(dh), dh)


def hemipelagic_dh(param, z_top, dt):
    """Hemipelagic + pelagic sedimentation, Emmerich et al. 2009
    (hemipelagic_deposition, bc.cxx:1438-1474).  Returns dh (ntop,)."""
    ctrl = param.control
    depth = ctrl.surf_base_level - z_top
    q = _div(depth - ctrl.hemipelagic_max_depth, ctrl.hemipelagic_width)
    r = _div(depth, ctrl.pelagic_increasing_width)
    dhi = (ctrl.hemipelagic_sedimentation_rate * dt * torch.exp(-(q * q))
           + ctrl.pelagic_sedimentation_rate * dt
           * (1.0 - torch.exp(-(r * r))))
    return torch.where(depth > 0.0, dhi, torch.zeros_like(dhi))


def apply_surface_processes(param, st: SurfTables, coord, dt, dhacc,
                            edvacc_surf, halo_exchange=None):
    """One step of surface processes (surface_processes,
    bc.cxx:1667-1831) on post-advection coordinates: options 1 and 102 in
    2D, the diffusion of options 1 and 102 in 3D (other options move
    nothing here, as in the JAX package).  ``halo_exchange``: the
    node-sharded step's second exchange of the diffusion's edge sums
    (option 1 only; the halo step refuses option 102).  Returns
    (coord, dhacc, edvacc_surf, dh)."""
    ctrl = param.control
    opt = ctrl.surface_process_option
    ndims = coord.shape[1]
    if opt in (1, 102) and ndims == 3:
        dh = surface_dh_3d(coord, st, ctrl.surface_diffusivity, dt,
                           halo_exchange)
    elif opt in (1, 102):
        dh = surface_dh_2d(coord, st, ctrl.surface_diffusivity, dt,
                           ctrl.surf_base_level, ctrl.surf_diff_ratio_terrig,
                           ctrl.surf_diff_ratio_marine, halo_exchange)
    else:
        dh = torch.zeros_like(coord[:, 0])
    if opt == 102 and ndims == 2:
        # diffusion + terrigenous basin fill + hemi/pelagic rain
        # (bc.cxx:1810-1822), both from the pre-diffusion coordinates
        top = st.top_nodes
        x_top, z_top = coord[top, 0], coord[top, 1]
        dh_top = terrigenous_dh(param, x_top, z_top, dt)
        if (ctrl.hemipelagic_sedimentation_rate > 0.0
                or ctrl.pelagic_sedimentation_rate > 0.0):
            dh_top = dh_top + hemipelagic_dh(param, z_top, dt)
        dh = dh.index_copy(0, top, dh[top] + dh_top)   # top nodes unique

    coord2 = torch.cat([coord[:, :-1], (coord[:, -1] + dh)[:, None]], dim=1)
    # per-facet deposited volume (bc.cxx:1745-1760)
    if ndims == 2:
        dh_e = dh[st.n0] + dh[st.n1]
        base = torch.abs(coord2[st.n1, 0] - coord2[st.n0, 0])
        dv = dh_e * base * 0.5           # / ndims, exactly
    else:
        dh_e = dh[st.n0] + dh[st.n1] + dh[st.n2]
        d01 = coord2[st.n1] - coord2[st.n0]
        d02 = coord2[st.n2] - coord2[st.n0]
        base = 0.5 * (d01[:, 0] * d02[:, 1] - d01[:, 1] * d02[:, 0])
        dv = _div(dh_e * base, 3.0)
    return coord2, dhacc + dh, edvacc_surf + dv, dh
