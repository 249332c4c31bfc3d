"""Node-sharded multi-device step: contiguous node windows and a halo
exchange (counterpart of dynearthsol_tpu/parallel/halo_step.py).

* Nodes are split into ``ndev`` contiguous blocks of B rows in the
  renumbered order (the meshers number along the longest axis, so an
  element's corners span a bounded index range, h = the largest
  ``max(conn) - min(conn)``).
* Shard d owns block d and holds the window of W = B + 2h rows
  [d*B - h, (d+1)*B + h).  Each element belongs to the shard of its
  smallest corner, so all its corners fall inside that shard's window.
* Each element -> node assembly sums into the window (ops/band2d.py's
  ``asm_pack``, the kernel on the card), then adds the 2h overlap rows of
  both neighbours (``ShardGroup.exchange``).  An overlap row is then own
  + neighbour, a two-term IEEE add, the same bits on both owners, so the
  nodal updates that follow stay identical across the overlap with no
  second exchange.
* Facet sums (boundary tractions, surface process 1's edge sums) use
  per-shard facet tables, padded with masked rows, and a second exchange.
* The scalars ride the group's collectives: dt and vmax by min/max, the
  residual by a psum, in shard order, over owned rows only.

The step is the column step's generic mode (ops/flat2d.py,
ops/flat3d.py ``make_flat_step(..., generic=True)``), one copy, given
each shard's context (``StepCtx.axis`` and ``StepCtx.halo``); the shards
run in threads of one process (parallel/group.py).  The host bookkeeping
below (plan, windows, partitioned tables, packing and unpacking the
state) is numpy and equals the JAX package's array for array; its
padded element rows are dropped when a shard's context is made, so that
the band tables and element columns hold real elements only.

Surface process option 102 (a serial scan over the whole x-sorted
surface) and GoSPL (option 11) are refused, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import band2d, flat2d, flat3d
from ..ops import matprops as M
from ..ops.assembly import HaloSpec, OrderedAdd
from ..state import State

# element State fields that default to 1.0 on shard-padding rows (so the
# maxwell dv = volume/volume_old and material mixing stay finite there)
_ELEM_ONE = {"volume", "volume_old", "emw"}
# nodal fields whose dead window rows are set to 1 after each step (the
# masses: the next step divides by them), the rest to 0
_MASSES = ("mass", "tmass", "hmass", "ymass", "volume_n")


def _supported(param, ctx) -> None:
    if param.control.surface_process_option not in (0, 1):
        # option 102's terrigenous basin fill is a serial scan over the
        # x-sorted surface (global coupling); option 11 couples to GoSPL
        # on the host
        raise NotImplementedError(
            "surface process option != 0/1 uses the GSPMD path, not the "
            "halo step")
    mod = flat3d if ctx.ndims == 3 else flat2d
    if not mod.generic_applicable(param, ctx):
        raise NotImplementedError(
            "the halo step runs the generic column step, which does not "
            "take this rheology")


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Host-side partition bookkeeping (numpy, built once per mesh)."""

    ndev: int
    nnode: int
    nelem: int
    h: int                 # halo rows per side
    block: int             # owned rows per device (B)
    width: int             # window rows per device (B + 2H)
    eperm: np.ndarray      # (ndev, E) global element id, -1 = padding
    win_idx: np.ndarray    # (ndev, W) clipped global node row per window
    own_mask: np.ndarray   # (ndev, W) 1.0 where the row is owned & real
    valid: np.ndarray      # (ndev, W) True where the row is a real node
    shard_of_elem: np.ndarray  # (nelem,) owning shard of each element
    eslot: np.ndarray      # (nelem,) slot of each element in its eperm row
    # top-facet partition by owning element's shard (None when etop == 0);
    # also the layout of the sharded edvacc_surf state field
    sperm: np.ndarray | None = None  # (ndev, S) global facet id, -1 = pad

    def n_elems(self, d: int) -> int:
        """Real elements of shard d (its eperm row's padding trails)."""
        return int((self.eperm[d] >= 0).sum())


def _partition(shard_of: np.ndarray, ndev: int) -> np.ndarray:
    """Stable partition of item ids by shard: (ndev, F) global id, -1
    padding, F = max per-shard count (>= 1 so facet tables stay
    non-empty)."""
    counts = np.bincount(shard_of, minlength=ndev)
    fmax = max(int(counts.max()) if counts.size else 0, 1)
    perm = np.full((ndev, fmax), -1, dtype=np.int64)
    order = np.argsort(shard_of, kind="stable")
    off = 0
    for d in range(ndev):
        perm[d, :counts[d]] = order[off:off + counts[d]]
        off += counts[d]
    return perm


def _take_facets(perm: np.ndarray, arr, fill=0) -> np.ndarray:
    """Gather per-facet rows through a partition table; padded rows get
    ``fill``."""
    a = np.asarray(arr)
    out = a[np.where(perm < 0, 0, perm)]
    m = (perm >= 0).reshape(perm.shape + (1,) * (a.ndim - 1))
    return np.where(m, out, np.asarray(fill, dtype=a.dtype))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def build_plan(ctx, ndev: int) -> HaloPlan:
    conn = _np(ctx.conn)
    nnode, nelem = int(ctx.nnode), int(ctx.nelem)
    spread = int((conn.max(axis=1) - conn.min(axis=1)).max())
    h = spread
    block = math.ceil(nnode / ndev)
    if block < 2 * h:
        raise NotImplementedError(
            f"halo step needs block >= 2*halo rows (block={block}, "
            f"h={h}): mesh too small for {ndev} devices or numbering "
            "not local enough")
    width = block + 2 * h

    shard_of_elem = np.clip(conn.min(axis=1) // block, 0, ndev - 1)
    eperm = _partition(shard_of_elem, ndev)
    counts = np.bincount(shard_of_elem, minlength=ndev)
    eslot = np.zeros(nelem, dtype=np.int64)
    for d in range(ndev):
        ids = eperm[d, :counts[d]]
        eslot[ids] = np.arange(ids.size)

    sperm = None
    if int(ctx.surf.etop) > 0:
        sperm = _partition(
            shard_of_elem[np.asarray(ctx.surf.top_elems)], ndev)

    base = np.arange(ndev)[:, None] * block - h            # (ndev, 1)
    idx = base + np.arange(width)[None, :]                 # (ndev, W)
    valid = (idx >= 0) & (idx < nnode)
    own = valid & (idx >= np.arange(ndev)[:, None] * block) \
        & (idx < (np.arange(ndev)[:, None] + 1) * block)
    win_idx = np.clip(idx, 0, nnode - 1)

    # every element's corners must land in its shard's window
    for d in range(ndev):
        ids = eperm[d, :counts[d]]
        if ids.size:
            loc = conn[ids] - (d * block - h)
            assert loc.min() >= 0 and loc.max() < width, \
                "element corners escape the shard window"
    return HaloPlan(ndev=ndev, nnode=nnode, nelem=nelem, h=h,
                    block=block, width=width, eperm=eperm,
                    win_idx=win_idx, own_mask=own.astype(np.float64),
                    valid=valid, shard_of_elem=shard_of_elem,
                    eslot=eslot, sperm=sperm)


def _window_nodal(a, plan: HaloPlan, zero_invalid: bool = False):
    """(nnode, ...) -> stacked windows (ndev, W, ...).

    Non-real rows (window clipped at the array ends) duplicate the edge
    node; for indicator/mask arrays that duplication would re-activate a
    boundary node on the dead rows, so ``zero_invalid`` clears them.  A
    tensor gives a CPU tensor, an array an array."""
    arr = _np(a)
    out = arr[plan.win_idx]
    if zero_invalid:
        v = plan.valid.reshape(plan.valid.shape + (1,) * (arr.ndim - 1))
        out = np.where(v, out, np.zeros((), dtype=arr.dtype))
    return torch.as_tensor(out) if isinstance(a, torch.Tensor) else out


def _shard_elem(a, plan: HaloPlan, name: str = ""):
    """(nelem, ...) -> stacked shards (ndev, E, ...), padded rows
    defaulted (volume-like fields get 1.0)."""
    arr = _np(a)
    out = arr[np.where(plan.eperm < 0, 0, plan.eperm)]
    if name in _ELEM_ONE:
        out = np.where((plan.eperm < 0).reshape(
            plan.eperm.shape + (1,) * (arr.ndim - 1)), 1.0, out)
    out = out.astype(arr.dtype)
    return torch.as_tensor(out) if isinstance(a, torch.Tensor) else out


def _window_fields(obj, plan: HaloPlan, nnode: int, **upd):
    """A dataclass with every tensor or array field of leading size
    ``nnode`` windowed (boolean ones with their dead rows cleared: they
    are node masks), nested dataclasses too; ``upd`` replaces fields."""
    new = {}
    for f in dataclasses.fields(obj):
        if f.name in upd:
            continue
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            new[f.name] = _window_fields(v, plan, nnode)
        elif isinstance(v, (torch.Tensor, np.ndarray)) and v.ndim >= 1 \
                and v.shape[0] == nnode:
            new[f.name] = _window_nodal(
                v, plan, zero_invalid=v.dtype in (torch.bool, np.bool_))
    return dataclasses.replace(obj, **new, **upd)


def build_halo_ctx(sim, plan: HaloPlan):
    """The stacked context: leading ndev axis on the sharded leaves, as
    CPU tensors where the step context keeps tensors and arrays where it
    keeps arrays (the facet tables).

    Facet tables (boundary tractions ctx.sbc, surface facets ctx.surf)
    are PARTITIONED by shard — grav/surface facets by their owning
    element's shard, Neumann facets by their smallest node's block — and
    padded to the max per-shard count with mask rows.  Facet node ids
    translate to window-local rows; facet element ids to local eperm
    slots.  Their scattered contributions go through a second overlap
    exchange inside the step (ops/assembly.halo_overlap_add).  The
    ordered-add tables of the facets are built per shard
    (``shard_ctx``)."""
    ctx = sim.ctx
    nnode = plan.nnode
    fdt = np.dtype(str(sim.dtype).split(".")[-1])  # mask dtype = force's
    off = np.arange(plan.ndev) * plan.block - plan.h  # window starts

    conn = _np(ctx.conn)
    conn_l = conn[np.where(plan.eperm < 0, 0, plan.eperm)] \
        - (np.arange(plan.ndev)[:, None, None] * plan.block - plan.h)
    conn_l = np.where((plan.eperm < 0)[:, :, None], 0, conn_l)
    elem_mask = torch.as_tensor((plan.eperm >= 0).astype(fdt))

    def _local_nodes(perm, facet_nodes):
        m = perm >= 0
        fn = _take_facets(perm, facet_nodes)
        return np.where(m[:, :, None], fn - off[:, None, None],
                        0).astype(np.asarray(facet_nodes).dtype)

    # --- traction facet tables, partitioned per shard -------------------
    sbc = ctx.sbc
    sbc2 = _window_fields(sbc, plan, nnode, grav_add=None, neu_add=None)
    if int(sbc.n_grav) > 0:
        fel = np.asarray(sbc.facet_elem)
        gperm = _partition(plan.shard_of_elem[fel], plan.ndev)
        sbc2 = dataclasses.replace(
            sbc2, n_grav=int(gperm.shape[1]),
            facet_nodes=_local_nodes(gperm, sbc.facet_nodes),
            facet_elem=_take_facets(gperm, plan.eslot[fel]).astype(
                fel.dtype),
            kind=_take_facets(gperm, sbc.kind),
            grav_mask=(gperm >= 0).astype(fdt))
    if int(sbc.n_neu) > 0:
        nfn = np.asarray(sbc.neu_facet_nodes)
        nperm = _partition(
            np.clip(nfn.min(axis=1) // plan.block, 0, plan.ndev - 1),
            plan.ndev)
        sbc2 = dataclasses.replace(
            sbc2, n_neu=int(nperm.shape[1]),
            neu_facet_nodes=_local_nodes(nperm, nfn),
            neu_dir=_take_facets(nperm, sbc.neu_dir),
            neu_val=_take_facets(nperm, sbc.neu_val),
            neu_mask=(nperm >= 0).astype(fdt))

    # --- surface facet tables, partitioned per shard --------------------
    surf = ctx.surf
    top_f = np.zeros(nnode)
    top_f[np.asarray(surf.top_nodes)] = 1.0
    surf2 = dataclasses.replace(
        surf, top_mask_f=_window_nodal(top_f, plan, zero_invalid=True),
        top_elem_mask=_shard_elem(surf.top_elem_mask, plan))
    if plan.sperm is not None:
        tel = np.asarray(surf.top_elems)
        surf2 = dataclasses.replace(
            surf2, etop=int(plan.sperm.shape[1]),
            facet_nodes=_local_nodes(plan.sperm, surf.facet_nodes),
            top_elems=_take_facets(plan.sperm, plan.eslot[tel]).astype(
                tel.dtype),
            facet_mask=(plan.sperm >= 0).astype(fdt))

    own_f = torch.as_tensor(plan.own_mask.astype(fdt))
    return dataclasses.replace(
        ctx,
        nnode=plan.width, nelem=int(plan.eperm.shape[1]),
        conn=torch.as_tensor(conn_l.astype(conn.dtype)),
        gather_idx=torch.zeros((1, 1), dtype=torch.int64),
        gather_mask=torch.zeros((1, 1), dtype=torch.bool),
        elem_mask=elem_mask,
        top_mask=_window_nodal(ctx.top_mask, plan, zero_invalid=True),
        pp_bc_mask=_window_nodal(ctx.pp_bc_mask, plan, zero_invalid=True),
        vbc=_window_fields(ctx.vbc, plan, nnode),
        sbc=sbc2, surf=surf2, sgrid=None, band=None,
        halo=HaloSpec(own_mask=own_f, h=plan.h, ndev=plan.ndev))


def _pick(v, d: int, n=None):
    """Shard d's row of a stacked leaf (its first n rows)."""
    r = v[d]
    return r if n is None else r[:n]


def shard_ctx(ctx2, plan: HaloPlan, d: int, device, axis, mat):
    """Shard d's step context on ``device`` from the stacked one: its
    real elements only (padding dropped), its window's band tables
    (ops/band2d.build_tables on the window-local connectivity), its
    facet tables with their ordered adds, and its place in the group
    (``axis``: the shard's parallel.group.ShardAxis).  ``mat``: the
    material tables on ``device``."""
    ne = plan.n_elems(d)
    if ne == 0:
        raise NotImplementedError(
            f"halo shard {d} holds no element: mesh too small for "
            f"{plan.ndev} devices")
    conn = _pick(ctx2.conn, d, ne)

    def t(v, n=None):
        return _pick(v, d, n).to(device)

    def vbc_shard(v):
        new = {}
        for f in dataclasses.fields(v):
            x = getattr(v, f.name)
            if isinstance(x, torch.Tensor) and x.ndim >= 2 \
                    and x.shape[0] == plan.ndev \
                    and x.shape[1] == plan.width:
                new[f.name] = t(x)
            elif isinstance(x, torch.Tensor):
                new[f.name] = x.to(device)
            elif dataclasses.is_dataclass(x) and not isinstance(x, type):
                new[f.name] = vbc_shard(x)
        return dataclasses.replace(v, **new)

    sbc = ctx2.sbc
    sfn = _pick(sbc.facet_nodes, d) if sbc.n_grav else sbc.facet_nodes
    nfn = _pick(sbc.neu_facet_nodes, d) if sbc.n_neu else \
        sbc.neu_facet_nodes
    sbc_d = dataclasses.replace(
        sbc, z0_mask=_pick(sbc.z0_mask, d), facet_nodes=sfn,
        grav_add=OrderedAdd.build(sfn), neu_facet_nodes=nfn,
        neu_add=OrderedAdd.build(nfn),
        **({} if not sbc.n_grav else dict(
            facet_elem=_pick(sbc.facet_elem, d), kind=_pick(sbc.kind, d),
            grav_mask=_pick(sbc.grav_mask, d))),
        **({} if not sbc.n_neu else dict(
            neu_dir=_pick(sbc.neu_dir, d), neu_val=_pick(sbc.neu_val, d),
            neu_mask=_pick(sbc.neu_mask, d))))
    surf = ctx2.surf
    surf_d = dataclasses.replace(
        surf, top_mask_f=_pick(surf.top_mask_f, d),
        top_elem_mask=_pick(surf.top_elem_mask, d, ne),
        **({} if plan.sperm is None else dict(
            facet_nodes=_pick(surf.facet_nodes, d),
            top_elems=_pick(surf.top_elems, d),
            facet_mask=_pick(surf.facet_mask, d))))
    return dataclasses.replace(
        ctx2, nelem=ne, conn=conn.to(device),
        gather_idx=ctx2.gather_idx.to(device),
        gather_mask=ctx2.gather_mask.to(device),
        elem_mask=t(ctx2.elem_mask, ne), top_mask=t(ctx2.top_mask),
        pp_bc_mask=t(ctx2.pp_bc_mask),
        vbc=dataclasses.replace(vbc_shard(ctx2.vbc), axis=axis),
        sbc=sbc_d, surf=surf_d, mat=mat, axis=axis,
        halo=HaloSpec(own_mask=t(ctx2.halo.own_mask), h=plan.h,
                      ndev=plan.ndev),
        band=band2d.build_tables(conn.numpy(), plan.width, device))


def _field_kind(template: State, name: str, plan: HaloPlan) -> str:
    """'facet' (edvacc_surf under a facet partition), 'nodal', 'elem' or
    'rep' (replicated: scalars and other shapes)."""
    a = getattr(template, name)
    if name == "edvacc_surf":
        return "facet" if plan.sperm is not None else "rep"
    if a.ndim == 0 or a.shape[0] not in (plan.nnode, plan.nelem):
        return "rep"
    return "nodal" if a.shape[0] == plan.nnode else "elem"


def build_halo_state(sim, plan: HaloPlan) -> State:
    """The stacked State (CPU tensors): nodal fields -> windows, element
    fields -> shard blocks, the per-top-facet surface accumulator
    ``edvacc_surf`` -> facet shards (plan.sperm), scalars as they are."""
    s = sim.state
    upd = {}
    for f in dataclasses.fields(s):
        a = getattr(s, f.name).detach().cpu()
        kind = _field_kind(s, f.name, plan)
        if kind == "facet":
            upd[f.name] = torch.as_tensor(_take_facets(plan.sperm,
                                                       a.numpy()))
        elif kind == "nodal":
            upd[f.name] = _window_nodal(a, plan)
        elif kind == "elem":
            upd[f.name] = _shard_elem(a, plan, f.name)
        else:
            upd[f.name] = a
    return State(**upd)


def shard_state(stacked: State, plan: HaloPlan, d: int, device,
                template: State) -> State:
    """Shard d's State on ``device``: its window, its real elements."""
    ne = plan.n_elems(d)
    upd = {}
    for f in dataclasses.fields(stacked):
        a = getattr(stacked, f.name)
        kind = _field_kind(template, f.name, plan)
        if kind in ("facet", "nodal"):
            a = a[d]
        elif kind == "elem":
            a = a[d, :ne]
        upd[f.name] = a.to(device)
    return State(**upd)


def unpack_state(shards, plan: HaloPlan, template: State,
                 device=None) -> State:
    """Sharded State -> flat single-device State on ``device`` (the
    template's by default).  ``shards``: the stacked State
    (build_halo_state's) or the list of per-shard States a run leaves,
    each with its real elements only."""
    device = template.coord.device if device is None else device
    stacked = isinstance(shards, State)

    def part(name, d):
        a = getattr(shards, name)[d] if stacked \
            else getattr(shards[d], name)
        return a.detach().cpu()

    upd = {}
    for f in dataclasses.fields(template):
        t = getattr(template, f.name)
        kind = _field_kind(template, f.name, plan)
        if kind == "rep":
            a = getattr(shards, f.name) if stacked \
                else getattr(shards[0], f.name)
            upd[f.name] = a.to(device)
            continue
        parts = [part(f.name, d) for d in range(plan.ndev)]
        if kind == "nodal":
            owned = torch.cat([p[plan.h:plan.h + plan.block]
                               for p in parts])[:plan.nnode]
            upd[f.name] = owned.to(device)
            continue
        perm = plan.sperm if kind == "facet" else plan.eperm
        out = torch.zeros(t.shape, dtype=t.dtype)
        for d, p in enumerate(parts):
            keep = perm[d] >= 0
            ids = torch.as_tensor(perm[d][keep])
            out[ids] = p[:int(keep.sum())]
        upd[f.name] = out.to(device)
    return State(**upd)


def make_halo_runner(sim, group):
    """(ctx_sh, state_sh, run_chunk, plan) on the shard group ``group``
    (parallel.group.ShardGroup): the per-shard contexts and states, and
    ``run_chunk(ctx_sh, state_sh, n)`` -> the per-shard states after n
    halo steps.  Nodal state stays ~1/ndev (+ halo) per shard throughout.
    Each shard's context, state and step are made in its own thread, on
    its device and stream."""
    _supported(sim.param, sim.ctx)
    param = sim.param
    plan = build_plan(sim.ctx, group.n)
    ctx2 = build_halo_ctx(sim, plan)
    s2 = build_halo_state(sim, plan)
    template = sim.state
    mod = flat3d if sim.ctx.ndims == 3 else flat2d
    nodal = [f.name for f in dataclasses.fields(template)
             if _field_kind(template, f.name, plan) == "nodal"]
    if any(d.type == "cuda" for d in group.devices):
        from ..ops import _build
        _build.load()   # one build and load, before the shards start

    def build(d):
        dev = group.devices[d]
        mat = M.MatTables.from_param(param.mat, dtype=sim.dtype,
                                     device=dev)
        c = shard_ctx(ctx2, plan, d, dev, group.axis(d), mat)
        s = shard_state(s2, plan, d, dev, template)
        step = mod.make_flat_step(param, c, sim.compensation_pressure,
                                  generic=True)
        valid = torch.as_tensor(plan.valid[d], device=dev)
        return c, s, step, (None if bool(plan.valid[d].all()) else valid)

    built = group.run(build)
    ctx_sh = [b[0] for b in built]
    state_sh = [b[1] for b in built]
    steps = [b[2] for b in built]
    valid = [b[3] for b in built]

    def scrub(s, v):
        """The dead window rows (clip-duplicated, no element support)
        assemble 0 mass and would go 0/0 -> NaN on the next step, then
        poison the vbc boundary extents: masses are set to 1, the rest
        of the nodal fields to 0, after each step."""
        upd = {}
        for nm in nodal:
            a = getattr(s, nm)
            m = v.reshape((-1,) + (1,) * (a.dim() - 1))
            fill = torch.full((), 1.0 if nm in _MASSES else 0.0,
                              dtype=a.dtype, device=a.device)
            upd[nm] = torch.where(m, a, fill)
        return s.replace(**upd)

    def run_chunk(ctx_sh, state_sh, n: int):
        def chunk(d):
            g = flat2d.state_to_flat(state_sh[d])
            for _ in range(n):
                g = steps[d](ctx_sh[d], g)
                if valid[d] is not None:
                    g = scrub(g, valid[d])
            return flat2d.flat_to_state(g)

        return group.run(chunk)

    run_chunk.steps = steps
    return ctx_sh, state_sh, run_chunk, plan


def run_halo(sim, group, nsteps: int, chunk: int = 100):
    """Run nsteps on the shard group with node-sharded state; returns the
    final flat state and writes it back to sim.state."""
    ctx_sh, state_sh, run_chunk, plan = make_halo_runner(sim, group)
    done = 0
    while done < nsteps:
        c = min(chunk, nsteps - done)
        state_sh = run_chunk(ctx_sh, state_sh, c)
        done += c
    sim.state = unpack_state(state_sh, plan, sim.state)
    return sim.state
