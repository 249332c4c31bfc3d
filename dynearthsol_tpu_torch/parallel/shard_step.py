"""Replicated-nodal multi-device step: the elements split over a group,
the nodal arrays whole on every shard (counterpart of
dynearthsol_tpu/parallel/shard_step.py).

Each shard holds a contiguous slice of the elements on GLOBAL node ids
and every nodal array in full.  Its assembly sums its own elements into
a full-length nodal buffer (ops/band2d.py's ``asm_pack``, the kernel on
the card, with tables of the shard's elements), and the group adds the
N partials in shard order (``ShardGroup.psum``), so every shard gets the
same bits; the CFL limits ride pmin/pmax.  The step is the column step's
generic mode with the shard's context (``StepCtx.axis`` set,
``StepCtx.halo`` None).  Traffic and nodal memory are O(nnode) per
shard: the node-sharded halo step (halo_step.py) is the one the CLI
takes.

Surface processes and facet tractions are refused, as in the JAX
package (there they take its GSPMD path).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import band2d, flat2d, flat3d
from ..ops import matprops as M
from ..state import State

# State fields with a leading ELEMENT axis (everything else replicates)
ELEM_FIELDS = {
    "volume", "volume_old", "stress", "stressyy", "old_mean_stress",
    "strain", "strain_rate", "plstrain", "delta_plstrain", "viscosity",
    "dpressure", "edvoldt", "radiogenic_source", "dyn_fric_coeff",
    "state_variable", "emw", "stress_avg", "delta_plstrain_avg",
    "strain_avg0",
}


def _supported(param, ctx) -> None:
    if param.control.surface_process_option != 0:
        raise NotImplementedError(
            "surface processes use the GSPMD path, not shard_map")
    if int(ctx.sbc.n_grav) > 0 or int(ctx.sbc.n_neu) > 0:
        raise NotImplementedError(
            "facet traction BCs use the GSPMD path, not shard_map")
    mod = flat3d if ctx.ndims == 3 else flat2d
    if not mod.generic_applicable(param, ctx):
        raise NotImplementedError(
            "the shard step runs the generic column step, which does not "
            "take this rheology")


def _pad_elem(arr, pad):
    if pad == 0:
        return arr
    if isinstance(arr, np.ndarray):
        return np.concatenate([arr, np.zeros((pad,) + arr.shape[1:],
                                             arr.dtype)])
    return torch.cat([arr, arr.new_zeros((pad,) + tuple(arr.shape[1:]))])


def pad_for_mesh(sim, n_devices: int):
    """Pad element arrays to a multiple of n_devices and return
    (ctx, state, pad), as the JAX package's helper does.  Padded elements
    carry volume 1, uniform material weights, degenerate connectivity
    [0...0] and elem_mask 0.  The runner does not pad: it gives each
    shard its slice of the real elements (``_slices``)."""
    ctx, s = sim.ctx, sim.state
    nelem = ctx.nelem
    pad = (-nelem) % n_devices
    dtype = s.volume.dtype

    elem_mask = torch.cat([torch.ones(nelem, dtype=dtype),
                           torch.zeros(pad, dtype=dtype)]).to(
                               ctx.conn.device)
    surf2 = dataclasses.replace(
        ctx.surf, top_elem_mask=_pad_elem(ctx.surf.top_elem_mask, pad))
    ctx2 = dataclasses.replace(
        ctx, conn=_pad_elem(ctx.conn, pad), elem_mask=elem_mask,
        surf=surf2, nelem=nelem + pad, band=None,
        gather_idx=torch.zeros((1, 1), dtype=torch.int64,
                               device=ctx.conn.device),
        gather_mask=torch.zeros((1, 1), dtype=torch.bool,
                                device=ctx.conn.device))

    updates = {}
    for name in ELEM_FIELDS:
        arr = _pad_elem(getattr(s, name), pad)
        if name in ("volume", "volume_old", "emw") and pad:
            arr = arr.clone()
            arr[nelem:] = 1.0
        updates[name] = arr
    return ctx2, s.replace(**updates), pad


def unpad_state(s: State, nelem: int) -> State:
    return s.replace(**{name: getattr(s, name)[:nelem]
                        for name in ELEM_FIELDS})


def _slices(nelem: int, n: int):
    """Shard d's elements [lo, hi): the JAX package's split of the padded
    element axis into n equal slices, the padding left out."""
    per = -(-nelem // n)
    out = []
    for d in range(n):
        lo, hi = d * per, min((d + 1) * per, nelem)
        if hi <= lo:
            raise NotImplementedError(
                f"shard {d} holds no element: mesh too small for {n} "
                "devices")
        out.append((lo, hi))
    return out


def _to(obj, dev):
    """A dataclass with its tensors, nested ones too, on ``dev``."""
    upd = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            upd[f.name] = v.to(dev)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            upd[f.name] = _to(v, dev)
    return dataclasses.replace(obj, **upd)


def make_sharded_runner(sim, group):
    """(ctx_sh, state_sh, run_chunk): per-shard contexts and states on
    the group's devices, and ``run_chunk(ctx_sh, state_sh, n)`` -> the
    per-shard states after n steps."""
    param = sim.param
    _supported(param, sim.ctx)
    ctx, s0 = sim.ctx, sim.state
    sl = _slices(ctx.nelem, group.n)
    mod = flat3d if ctx.ndims == 3 else flat2d
    if any(d.type == "cuda" for d in group.devices):
        from ..ops import _build
        _build.load()

    def build(d):
        dev = group.devices[d]
        lo, hi = sl[d]
        conn = ctx.conn[lo:hi].cpu()
        # the step assembles through ``band``: no node-to-element tables
        c = dataclasses.replace(
            ctx, nelem=hi - lo, conn=conn.to(dev),
            gather_idx=torch.zeros((1, 1), dtype=torch.int64, device=dev),
            gather_mask=torch.zeros((1, 1), dtype=torch.bool, device=dev),
            top_mask=ctx.top_mask.to(dev),
            pp_bc_mask=ctx.pp_bc_mask.to(dev), vbc=_to(ctx.vbc, dev),
            surf=dataclasses.replace(
                ctx.surf, top_elem_mask=ctx.surf.top_elem_mask[lo:hi]),
            mat=M.MatTables.from_param(param.mat, dtype=sim.dtype,
                                       device=dev),
            axis=group.axis(d),
            band=band2d.build_tables(conn.numpy(), ctx.nnode, dev))
        s = s0.replace(**{
            f.name: (getattr(s0, f.name)[lo:hi] if f.name in ELEM_FIELDS
                     else getattr(s0, f.name)).to(dev)
            for f in dataclasses.fields(s0)})
        step = mod.make_flat_step(param, c, sim.compensation_pressure,
                                  generic=True)
        return c, s, step

    built = group.run(build)
    ctx_sh = [b[0] for b in built]
    state_sh = [b[1] for b in built]
    steps = [b[2] for b in built]

    def run_chunk(ctx_sh, state_sh, n_steps: int):
        def chunk(d):
            g = flat2d.state_to_flat(state_sh[d])
            for _ in range(n_steps):
                g = steps[d](ctx_sh[d], g)
            return flat2d.flat_to_state(g)

        return group.run(chunk)

    return ctx_sh, state_sh, run_chunk


def gather_state(state_sh, template: State) -> State:
    """The per-shard states as one flat State on the template's device:
    shard 0's nodal arrays and scalars (every shard holds the same bits),
    the element slices in order."""
    dev = template.coord.device
    upd = {}
    for f in dataclasses.fields(template):
        if f.name in ELEM_FIELDS:
            upd[f.name] = torch.cat([getattr(s, f.name).to(dev)
                                     for s in state_sh])
        else:
            upd[f.name] = getattr(state_sh[0], f.name).to(dev)
    return State(**upd)


def run_sharded(sim, group, nsteps: int, chunk: int = 100):
    """Run nsteps of sim on the shard group; returns the final state and
    writes it back to sim.state."""
    ctx_sh, state_sh, run_chunk = make_sharded_runner(sim, group)
    done = 0
    while done < nsteps:
        c = min(chunk, nsteps - done)
        state_sh = run_chunk(ctx_sh, state_sh, c)
        done += c
    sim.state = gather_state(state_sh, sim.state)
    return sim.state
