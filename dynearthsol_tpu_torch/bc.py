"""Velocity boundary conditions and the stress-BC facet tables
(counterpart of dynearthsol_tpu/bc.py).

Reference: bc.cxx.  ``apply_vbcs`` (bc.cxx:201-630) is a per-node switch
over the vbc type of each boundary; the types are static config, so the
switch unrolls into a few masked ``torch.where`` updates.  Order matters
and is preserved: X faces first, Y faces in 3D, the inclined (BOUNDN)
boundaries, then Z last (bc.cxx:563 "Z, must be dealt last") so corner
nodes get the reference's precedence.  Inclined boundaries come only from
the .poly and Exodus meshers, whose segment flags carry the BOUNDN bits.

vbc type meanings (bc.cxx:206-214):
  0: all components free
  1: normal fixed, shear free
  2: normal free, shear fixed at 0
  3: normal fixed, shear fixed at 0
  4: tangential prescribed, normal 0
  6: normal prescribed + lateral shear prescribed
  100: v_axis = value * own coordinate along axis
Inclined boundaries take types 1 and 3 (the normal velocity, and with 3
the whole velocity along the normal) and 11 and 13 (the same on the
horizontal components, bc.cxx:462-560).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from .constants import (BOUNDX0, BOUNDX1, BOUNDY0, BOUNDY1, BOUNDZ0,
                        BOUNDZ1, IBOUNDN0, IBOUNDN3, IBOUNDZ0, IBOUNDZ1,
                        NBDRYTYPES, YEAR2SEC, dim)
from .ops.assembly import OrderedAdd
from .ops.surface import _div


@dataclass(frozen=True)
class InclinedVBC:
    """Inclined (BOUNDN0-3) velocity BCs: planar boundaries with an
    arbitrary unit normal (bc.cxx:462-560; the normals and the edge
    vectors of boundary pairs from create_boundary_normals,
    bc.cxx:94-198)."""

    bcflag: torch.Tensor         # (nnode,) int64, on the run's device
    normals: tuple               # 4 tuples of ndims floats (n0..n3)
    values: tuple                # 4 floats
    all_types: tuple             # vbc type of each of the 10 boundaries
    edge_vecs: tuple             # ((i, j, (ndims floats)), ...)
    present: tuple               # 4 bools


def compute_boundary_normals(topo, coord: np.ndarray):
    """Unit outward normal of each boundary (from its first facet; an
    inclined boundary is planar by contract) and the edge vectors of the
    boundary pairs (bc.cxx:94-198).  Returns (normals, have, edge_vecs)."""
    ndims = coord.shape[1]
    nof = np.asarray(dim(ndims).node_of_facet)
    normals = np.zeros((NBDRYTYPES, ndims))
    have = np.zeros(NBDRYTYPES, dtype=bool)
    for i in range(NBDRYTYPES):
        bf = topo.bfacets[i]
        if len(bf) == 0:
            continue
        e, f = bf[0]
        fc = coord[topo.connectivity[e][nof[f]]]
        if ndims == 2:
            v01 = fc[1] - fc[0]
            n = np.array([v01[1], -v01[0]])
        else:
            n = 0.5 * np.cross(fc[1] - fc[0], fc[2] - fc[0])
        normals[i] = n / max(np.linalg.norm(n), 1e-300)
        have[i] = True
    edge_vecs = []
    eps = 1e-15
    for i in range(NBDRYTYPES):
        if not have[i]:
            continue
        for j in range(i + 1, NBDRYTYPES):
            if not have[j]:
                continue
            if ndims == 2:
                sv = np.array([0.0, 1.0])
            elif abs(normals[i][-1]) < eps and abs(normals[j][-1]) < eps:
                sv = np.array([0.0, 0.0, 1.0])
            else:
                sv = np.cross(normals[i], normals[j])
            edge_vecs.append((i, j, tuple(float(x) for x in sv)))
    return normals, have, edge_vecs


def _apply_inclined(spec, vel):
    """Inclined-boundary vbcs (bc.cxx:462-560): after the lateral faces
    and before Z, n0 to n3 in turn as the reference applies them.  A node
    on one inclined boundary alone gets its projection; a node shared with
    a lower-numbered boundary of type 0 gets it too, and one shared with a
    boundary of type 1 is projected onto the pair's edge vector."""
    inc = spec.incl
    flags = inc.bcflag
    ndims = spec.ndims
    for ib in range(IBOUNDN0, IBOUNDN3 + 1):
        k = ib - IBOUNDN0
        if not inc.present[k]:
            continue
        ti = inc.all_types[ib]
        if ti not in (1, 3, 11, 13):
            continue
        n = np.asarray(inc.normals[k])
        val = inc.values[k]
        bit = 1 << ib
        on = (flags & bit) != 0
        exact = flags == bit
        if ti == 3:
            nvec = torch.tensor(n, dtype=vel.dtype, device=vel.device)
            vel = torch.where(on[:, None], val * nvec[None, :], vel)
            continue
        if ti == 13:
            fac = 1.0 / np.sqrt(max(1.0 - n[-1] * n[-1], 1e-30))
            tgt = np.zeros(ndims)
            tgt[:ndims - 1] = val * fac * n[:ndims - 1]
            vel = torch.where(on[:, None],
                              torch.tensor(tgt, dtype=vel.dtype,
                                           device=vel.device)[None, :], vel)
            continue
        # types 1 / 11: set the (horizontal) normal velocity component
        if ti == 1:
            nd, fac = ndims, 1.0
        else:
            nd = ndims - 1
            fac = 1.0 / np.sqrt(max(1.0 - n[-1] * n[-1], 1e-30))

        def project(v, n=n, nd=nd, fac=fac, val=val):
            vn = v[:, 0] * float(n[0])
            for dd in range(1, nd):
                vn = vn + v[:, dd] * float(n[dd])
            upd = v.clone()
            for dd in range(nd):
                upd[:, dd] = upd[:, dd] + (val * fac - vn) * float(n[dd])
            return upd

        vel = torch.where((on & exact)[:, None], project(vel), vel)
        # intersections with lower-numbered boundaries (bc.cxx:479-506)
        for ic in range(0, ib):
            tc = inc.all_types[ic]
            m_ic = on & ~exact & ((flags & (1 << ic)) != 0)
            if tc == 0:
                vel = torch.where(m_ic[:, None], project(vel), vel)
            elif tc == 1:
                ev = None
                for (ei, ej, e) in inc.edge_vecs:
                    if ei == ic and ej == ib:
                        ev = np.asarray(e)
                if ev is None:
                    continue
                ve = vel[:, 0] * float(ev[0])
                for dd in range(1, ndims):
                    ve = ve + vel[:, dd] * float(ev[dd])
                proj = torch.stack([ve * float(ev[dd])
                                    for dd in range(ndims)], dim=1)
                vel = torch.where(m_ic[:, None], proj, vel)
    return vel


@dataclass(frozen=True)
class VBCSpec:
    """Static velocity-BC description: types/values from Param.bc, node
    masks (bool, on the run's device) from Topology.bcflag, and the 2D
    X-face profile tables as float64 tensors on the same device."""

    ndims: int
    x0: torch.Tensor
    x1: torch.Tensor
    y0: torch.Tensor
    y1: torch.Tensor
    z0: torch.Tensor
    z1: torch.Tensor
    types: Tuple[int, ...]  # order: x0 x1 y0 y1 z0 z1
    values: Tuple[float, ...]
    values_lateral: Tuple[float, ...]  # x0 x1 y0 y1
    div_frac_x0: torch.Tensor  # (4,)
    div_frac_x1: torch.Tensor
    ratio_x0: torch.Tensor  # (4,)
    ratio_x1: torch.Tensor
    period_time_x0: torch.Tensor
    period_ratio_x0: torch.Tensor
    period_time_x1: torch.Tensor
    period_ratio_x1: torch.Tensor
    bottom_shear_zone_thickness: float
    vbc_val_z1_loading_period: float
    incl: Optional[InclinedVBC] = None  # where BOUNDN boundaries exist
    # the shard's parallel.group.ShardAxis when the node masks are windows
    # of the node-sharded step (parallel/halo_step.py): the boundary
    # extents are then taken over the group
    axis: object = None

    @staticmethod
    def from_param(param, bcflag: np.ndarray, device="cpu", topo=None,
                   coord: np.ndarray = None) -> "VBCSpec":
        """The spec of ``bcflag``; with BOUNDN bits in it, the inclined
        boundaries' normals come from ``topo``'s facets on ``coord``."""
        bc = param.bc
        flags = np.asarray(bcflag)
        n_bits = sum(1 << ib for ib in range(IBOUNDN0, IBOUNDN3 + 1))
        incl = None
        if topo is not None and coord is not None \
                and (flags & np.uint32(n_bits)).any():
            normals, have, edge_vecs = compute_boundary_normals(topo, coord)
            incl = InclinedVBC(
                bcflag=torch.as_tensor(flags.astype(np.int64),
                                       device=device),
                normals=tuple(tuple(float(x)
                                    for x in normals[IBOUNDN0 + k])
                              for k in range(4)),
                values=(bc.vbc_val_n0, bc.vbc_val_n1, bc.vbc_val_n2,
                        bc.vbc_val_n3),
                all_types=(bc.vbc_x0, bc.vbc_x1, bc.vbc_y0, bc.vbc_y1,
                           bc.vbc_z0, bc.vbc_z1, bc.vbc_n0, bc.vbc_n1,
                           bc.vbc_n2, bc.vbc_n3),
                edge_vecs=tuple(edge_vecs),
                present=tuple(bool(have[IBOUNDN0 + k]) for k in range(4)))

        def mask(bit):
            return torch.as_tensor((flags & bit) != 0, device=device)

        def f64(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64),
                                   device=device)

        return VBCSpec(
            ndims=param.sim.ndims,
            x0=mask(BOUNDX0), x1=mask(BOUNDX1),
            y0=mask(BOUNDY0), y1=mask(BOUNDY1),
            z0=mask(BOUNDZ0), z1=mask(BOUNDZ1),
            types=(bc.vbc_x0, bc.vbc_x1, bc.vbc_y0, bc.vbc_y1,
                   bc.vbc_z0, bc.vbc_z1),
            values=(bc.vbc_val_x0, bc.vbc_val_x1, bc.vbc_val_y0,
                    bc.vbc_val_y1, bc.vbc_val_z0, bc.vbc_val_z1),
            values_lateral=(bc.vbc_val_x0_l, bc.vbc_val_x1_l,
                            bc.vbc_val_y0_l, bc.vbc_val_y1_l),
            div_frac_x0=f64([0.0, bc.vbc_val_division_x0_min,
                             bc.vbc_val_division_x0_max, 1.0]),
            div_frac_x1=f64([0.0, bc.vbc_val_division_x1_min,
                             bc.vbc_val_division_x1_max, 1.0]),
            ratio_x0=f64([bc.vbc_val_x0_ratio0, bc.vbc_val_x0_ratio1,
                          bc.vbc_val_x0_ratio2, bc.vbc_val_x0_ratio3]),
            ratio_x1=f64([bc.vbc_val_x1_ratio0, bc.vbc_val_x1_ratio1,
                          bc.vbc_val_x1_ratio2, bc.vbc_val_x1_ratio3]),
            period_time_x0=f64(bc.vbc_period_x0_time_in_yr),
            period_ratio_x0=f64(bc.vbc_period_x0_ratio),
            period_time_x1=f64(bc.vbc_period_x1_time_in_yr),
            period_ratio_x1=f64(bc.vbc_period_x1_ratio),
            bottom_shear_zone_thickness=bc.bottom_shear_zone_thickness,
            vbc_val_z1_loading_period=bc.vbc_val_z1_loading_period,
            incl=incl,
        )


def find_max_vbc(bc, ndims: int) -> float:
    """Max |boundary velocity| over faces with active normal values
    (bc.cxx:66-92)."""
    m = 1e-12  # 0.03 mm/yr floor
    pairs = [(bc.vbc_x0, bc.vbc_val_x0), (bc.vbc_x1, bc.vbc_val_x1),
             (bc.vbc_y0, bc.vbc_val_y0), (bc.vbc_y1, bc.vbc_val_y1),
             (bc.vbc_z0, bc.vbc_val_z0), (bc.vbc_z1, bc.vbc_val_z1)]
    for t, v in pairs:
        if t % 2 == 1 or t == 4:
            m = max(m, abs(v))
    for t, v in [(bc.vbc_n0, bc.vbc_val_n0), (bc.vbc_n1, bc.vbc_val_n1),
                 (bc.vbc_n2, bc.vbc_val_n2), (bc.vbc_n3, bc.vbc_val_n3)]:
        if t % 2 == 1:
            m = max(m, abs(v))
    return m


def _interp1(xp, fp, q):
    """Piecewise-linear interp with constant extrapolation, in float64:
    y = f0 + sum_k slope_k * clip(q - x_k, 0, dx_k)."""
    if fp.shape[0] == 1:
        return fp[0].expand(q.shape)
    dx = xp[1:] - xp[:-1]
    slope = torch.where(dx != 0, (fp[1:] - fp[:-1])
                        / torch.where(dx == 0, torch.ones_like(dx), dx),
                        torch.zeros_like(dx))
    seg = torch.minimum(torch.clamp(q[..., None] - xp[:-1], min=0.0), dx)
    return fp[0] + (slope * seg).sum(dim=-1)


def _masked_minmax(values, mask, axis=None):
    big = torch.finfo(values.dtype).max
    vmax = torch.where(mask, values, torch.full_like(values, -big)).max()
    vmin = torch.where(mask, values, torch.full_like(values, big)).min()
    if axis is not None:
        vmin, vmax = axis.pminmax(vmin, vmax)
    return vmin, vmax


def _set(vel, mask, comp, value):
    """vel[mask, comp] = value (value scalar or per-node array).  A Python
    number is taken in float64 and rounded once to vel's dtype (not
    through torch's default float32); it is filled on the device, so no
    copy from the host waits for the stream."""
    if not isinstance(value, torch.Tensor):
        value = torch.full((), value, dtype=torch.float64,
                           device=vel.device)
    value = value.to(vel.device, vel.dtype)
    out = vel.clone()
    out[:, comp] = torch.where(mask, value, vel[:, comp])
    return out


def apply_vbcs(spec: VBCSpec, vel, coord, time):
    """Apply velocity BCs in the reference's order (bc.cxx:201-630).
    ``time`` is a 0-d tensor on the device; nothing is read back to the
    host.  The 2D profile arithmetic runs in float64 and the result is
    rounded to ``vel.dtype``, as in the JAX package."""
    if spec.ndims == 3:
        return _apply_vbcs_3d(spec, vel, coord, time)
    t_now = torch.div(time, torch.full_like(time, YEAR2SEC)).double()
    applied_x0 = spec.values[0] * _interp1(spec.period_time_x0,
                                           spec.period_ratio_x0, t_now)
    applied_x1 = spec.values[1] * _interp1(spec.period_time_x1,
                                           spec.period_ratio_x1, t_now)

    z = coord[:, 1]
    x = coord[:, 0]
    # vertical profile divisions from current boundary extent (bc.cxx:229-278)
    bx0min, bx0max = _masked_minmax(z, spec.x0, spec.axis)
    w0 = (bx0max - bx0min).double()
    # NOTE: the reference computes BOTH faces' divisions from the X0 extent
    # (bc.cxx:275-277); replicated faithfully.
    div0 = spec.div_frac_x0 * w0 - bx0max.double()
    div1 = spec.div_frac_x1 * w0 - bx0max.double()
    mz = (-z).double()
    exact_x0 = applied_x0 * _interp1(div0, spec.ratio_x0, mz)
    exact_x1 = applied_x1 * _interp1(div1, spec.ratio_x1, mz)

    tx0, tx1, _, _, tz0, tz1 = spec.types
    vx0, vx1, _, _, vz0, vz1 = spec.values
    vx0_l, vx1_l = spec.values_lateral[0], spec.values_lateral[1]

    # --- X0 (bc.cxx:405-434) ---
    m = spec.x0
    if tx0 == 1:
        vel = _set(vel, m, 0, exact_x0)
    elif tx0 == 2:
        vel = _set(vel, m, 1, 0.0)
    elif tx0 == 3:
        v0 = exact_x0
        if spec.bottom_shear_zone_thickness > 0:
            zmin = torch.clamp(z.min(), max=0.0)
            if spec.axis is not None:
                zmin = spec.axis.pmin(zmin)
            dz = z - zmin
            scale = torch.clamp(dz / spec.bottom_shear_zone_thickness,
                                0.0, 1.0)
            v0 = v0 * scale
        vel = _set(vel, m, 0, v0)
        vel = _set(vel, m, 1, 0.0)
    elif tx0 == 4:
        vel = _set(vel, m, 0, 0.0)
        vel = _set(vel, m, 1, vx0)
    elif tx0 == 6:
        vel = _set(vel, m, 0, exact_x0)
        vel = _set(vel, m, 1, vx0_l)
    elif tx0 == 100:
        vel = _set(vel, m, 0, vx0 * x)

    # --- X1 (bc.cxx:436-462) ---
    m = spec.x1
    if tx1 == 1:
        vel = _set(vel, m, 0, exact_x1)
    elif tx1 == 2:
        vel = _set(vel, m, 1, 0.0)
    elif tx1 == 3:
        vel = _set(vel, m, 0, exact_x1)
        vel = _set(vel, m, 1, 0.0)
    elif tx1 == 4:
        vel = _set(vel, m, 0, 0.0)
        vel = _set(vel, m, 1, vx1)
    elif tx1 == 6:
        vel = _set(vel, m, 0, exact_x1)
        vel = _set(vel, m, 1, vx1_l)
    elif tx1 == 100:
        vel = _set(vel, m, 0, vx1 * x)

    # --- inclined N boundaries (bc.cxx:462-560) ---
    if spec.incl is not None:
        vel = _apply_inclined(spec, vel)

    # --- Z last (bc.cxx:563-629) ---
    m = spec.z0
    if tz0 == 1:
        vel = _set(vel, m, 1, vz0)
    elif tz0 == 2:
        vel = _set(vel, m, 0, 0.0)
    elif tz0 == 3:
        vel = _set(vel, m, 0, 0.0)
        vel = _set(vel, m, 1, vz0)
    elif tz0 == 4:
        vel = _set(vel, m, 0, vz0)
        vel = _set(vel, m, 1, 0.0)
    elif tz0 == 100:
        vel = _set(vel, m, 1, vz0 * z)

    # z1 deactivates after the loading period (bc.cxx:316)
    m = spec.z1 & (time <= spec.vbc_val_z1_loading_period)
    if tz1 == 1:
        vel = _set(vel, m, 1, vz1)
    elif tz1 == 2:
        vel = _set(vel, m, 0, 0.0)
    elif tz1 == 3:
        vel = _set(vel, m, 0, 0.0)
        vel = _set(vel, m, 1, vz1)
    elif tz1 == 4:
        vel = _set(vel, m, 0, vz1)
        vel = _set(vel, m, 1, 0.0)
    elif tz1 == 100:
        vel = _set(vel, m, 1, vz1 * z)

    return vel


def _apply_vbcs_3d(spec: VBCSpec, vel, coord, time):
    """3D lateral faces through the unified handler (bc.cxx:383-403), then
    Z (bc.cxx:563-629)."""
    tx0, tx1, ty0, ty1, tz0, tz1 = spec.types
    vx0, vx1, vy0, vy1, vz0, vz1 = spec.values
    lx0, lx1, ly0, ly1 = spec.values_lateral

    faces = [(spec.x0, 0, 1, tx0, vx0, lx0), (spec.x1, 0, 1, tx1, vx1, lx1),
             (spec.y0, 1, 0, ty0, vy0, ly0), (spec.y1, 1, 0, ty1, vy1, ly1)]
    for m, ni, li, typ, val, val_l in faces:
        if typ == 1:
            vel = _set(vel, m, ni, val)
        elif typ == 2:
            vel = _set(vel, m, li, 0.0)
            vel = _set(vel, m, 2, 0.0)
        elif typ == 3:
            vel = _set(vel, m, ni, val)
            vel = _set(vel, m, li, 0.0)
            vel = _set(vel, m, 2, 0.0)
        elif typ == 4:
            vel = _set(vel, m, li, val)
            vel = _set(vel, m, 2, 0.0)
        elif typ == 5:
            vel = _set(vel, m, ni, 0.0)
            vel = _set(vel, m, li, val)
            vel = _set(vel, m, 2, 0.0)
        elif typ == 6:
            vel = _set(vel, m, ni, val)
            vel = _set(vel, m, li, val_l)
        elif typ == 7:
            vel = _set(vel, m, ni, val)
            vel = _set(vel, m, li, 0.0)
        elif typ == 100:
            vel = _set(vel, m, ni, val * coord[:, ni])

    # inclined N boundaries before Z (bc.cxx:462-563 ordering)
    if spec.incl is not None:
        vel = _apply_inclined(spec, vel)

    z = coord[:, 2]
    m = spec.z0
    if tz0 == 1:
        vel = _set(vel, m, 2, vz0)
    elif tz0 == 2:
        vel = _set(vel, m, 0, 0.0)
        vel = _set(vel, m, 1, 0.0)
    elif tz0 == 3:
        vel = _set(vel, m, 0, 0.0)
        vel = _set(vel, m, 1, 0.0)
        vel = _set(vel, m, 2, vz0)
    elif tz0 == 100:
        vel = _set(vel, m, 2, vz0 * z)

    # z1 deactivates after the loading period (bc.cxx:316)
    m = spec.z1 & (time <= spec.vbc_val_z1_loading_period)
    if tz1 == 1:
        vel = _set(vel, m, 2, vz1)
    elif tz1 == 2:
        vel = _set(vel, m, 0, 0.0)
        vel = _set(vel, m, 1, 0.0)
    elif tz1 == 3:
        vel = _set(vel, m, 0, 0.0)
        vel = _set(vel, m, 1, 0.0)
        vel = _set(vel, m, 2, vz1)
    elif tz1 == 4:
        vel = _set(vel, m, 0, vz1)
        vel = _set(vel, m, 1, 0.0)
        vel = _set(vel, m, 2, 0.0)
    elif tz1 == 100:
        vel = _set(vel, m, 2, vz1 * z)

    return vel


def pp_bc_mask(bc, bcflag: np.ndarray) -> np.ndarray:
    """Pore-pressure Dirichlet mask: node on boundary i with hbc type 1
    (is_boundary_node_for_pp, fields.cxx:286-294)."""
    from .constants import BOUNDY0, BOUNDY1

    bits = (BOUNDX0, BOUNDX1, BOUNDY0, BOUNDY1, BOUNDZ0, BOUNDZ1)
    types = (bc.hbc_x0, bc.hbc_x1, bc.hbc_y0, bc.hbc_y1, bc.hbc_z0,
             bc.hbc_z1)
    mask = np.zeros(bcflag.shape[0], dtype=bool)
    for bit, t in zip(bits, types):
        if t == 1:
            mask |= (bcflag & bit) != 0
    return mask


@dataclass(frozen=True)
class StressBCSpec:
    """Static facet tables for traction boundary conditions
    (apply_stress_bcs / apply_stress_bcs_neumann, bc.cxx:632-875), host
    numpy, in 2D and 3D.  The fused steps compute the gravity-facet
    tractions (Winkler, water loading) in-kernel (ops/fused2d.py,
    ops/fused3d.py) and refuse Neumann tractions and the elastic
    foundation; the column steps (ops/flat2d.py, ops/flat3d.py) compute
    all of them through ``apply_stress_bcs`` and
    ``apply_stress_bcs_neumann`` on the tensor form that ``on(device)``
    returns.

    kind: 0 = Winkler foundation (bottom), 1 = hydrostatic water loading
    (top), 2 = lithostatic sidewall.  ``grav_add`` and ``neu_add`` are the
    fixed-order sums of the facets' corner contributions onto their nodes,
    in the JAX package's update order (facet, then corner).
    """

    n_grav: int
    n_neu: int
    facet_nodes: np.ndarray   # (n_grav, npf) int32
    facet_elem: np.ndarray    # (n_grav,) int32
    kind: np.ndarray          # (n_grav,) int32
    neu_facet_nodes: np.ndarray  # (n_neu, npf) int32
    neu_dir: np.ndarray       # (n_neu,) int32 force component
    neu_val: np.ndarray       # (n_neu,) traction value
    z0_mask: np.ndarray       # (nnode,) bool, elastic-foundation nodes
    grav_add: OrderedAdd      # over facet_nodes.reshape(-1)
    neu_add: OrderedAdd       # over neu_facet_nodes.reshape(-1)
    # 1/0 real-row indicators of a shard's padded facet tables (the
    # node-sharded step, parallel/halo_step.py); None on one device
    grav_mask: Optional[np.ndarray] = None   # (n_grav,)
    neu_mask: Optional[np.ndarray] = None    # (n_neu,)

    @staticmethod
    def from_topo(param, topo) -> "StressBCSpec":
        ndims = topo.ndims
        d = dim(ndims)
        nof = d.node_of_facet
        npf = d.nodes_per_facet
        bc = param.bc
        vbc_types = [bc.vbc_x0, bc.vbc_x1, bc.vbc_y0, bc.vbc_y1,
                     bc.vbc_z0, bc.vbc_z1]
        sbc_types = [bc.stress_bc_x0, bc.stress_bc_x1, bc.stress_bc_y0,
                     bc.stress_bc_y1, bc.stress_bc_z0, bc.stress_bc_z1]
        sbc_vals = [bc.stress_val_x0, bc.stress_val_x1, bc.stress_val_y0,
                    bc.stress_val_y1, bc.stress_val_z0, bc.stress_val_z1]

        fnodes, felem, kind = [], [], []
        for i in range(6):
            # gravity-induced tractions on free/shear boundaries
            # (bc.cxx:653-657)
            if vbc_types[i] not in (0, 2, 4):
                continue
            if i == IBOUNDZ0 and not bc.has_winkler_foundation:
                continue
            if i == IBOUNDZ1 and not bc.has_water_loading:
                continue
            k = 0 if i == IBOUNDZ0 else (1 if i == IBOUNDZ1 else 2)
            for e, f in topo.bfacets[i]:
                fnodes.append(topo.connectivity[e, list(nof[f])])
                felem.append(e)
                kind.append(k)

        nnodes, ndir, nval = [], [], []
        for i in range(6):
            t = sbc_types[i]
            if t == 0:
                continue
            comp = {1: 0, 3: 1}.get(t) if ndims == 2 \
                else {1: 0, 2: 1, 3: 2}.get(t)
            if comp is None:
                continue
            for e, f in topo.bfacets[i]:
                nnodes.append(topo.connectivity[e, list(nof[f])])
                ndir.append(comp)
                nval.append(sbc_vals[i])

        def arr(a, dtype, shape):
            return (np.asarray(a, dtype=dtype) if a
                    else np.zeros(shape, dtype=dtype))

        z0_mask = np.zeros(topo.nnode, dtype=bool)
        if bc.has_elastic_foundation:
            z0_mask[topo.bnodes[IBOUNDZ0]] = True

        facet_nodes = arr(fnodes, np.int32, (0, npf))
        neu_facet_nodes = arr(nnodes, np.int32, (0, npf))
        return StressBCSpec(
            n_grav=len(felem), n_neu=len(ndir),
            facet_nodes=facet_nodes,
            facet_elem=arr(felem, np.int32, (0,)),
            kind=arr(kind, np.int32, (0,)),
            neu_facet_nodes=neu_facet_nodes,
            neu_dir=arr(ndir, np.int32, (0,)),
            neu_val=arr(nval, np.float64, (0,)),
            z0_mask=z0_mask,
            grav_add=OrderedAdd.build(facet_nodes),
            neu_add=OrderedAdd.build(neu_facet_nodes))

    def on(self, device) -> "StressBCSpec":
        """The same spec with its tables as tensors on ``device``: the form
        apply_stress_bcs and apply_stress_bcs_neumann take."""
        def t(a):
            return torch.as_tensor(a, device=device)

        def m(a):
            return None if a is None else t(a)

        return replace(
            self, grav_mask=m(self.grav_mask), neu_mask=m(self.neu_mask),
            facet_nodes=t(self.facet_nodes).long(),
            facet_elem=t(self.facet_elem).long(), kind=t(self.kind),
            neu_facet_nodes=t(self.neu_facet_nodes).long(),
            neu_dir=t(self.neu_dir).long(), neu_val=t(self.neu_val),
            z0_mask=t(self.z0_mask), grav_add=self.grav_add.to(device),
            neu_add=self.neu_add.to(device))


def _facet_normal(fc):
    """Outward normal scaled by the facet area, and the facet's z centre
    (normal_vector_of_facet, bc.cxx:24-54), of 2D facets (nf, 2, 2) or
    3D facets (nf, 3, 3)."""
    v01 = fc[:, 1] - fc[:, 0]
    if fc.shape[-1] == 2:
        normal = torch.stack([v01[:, 1], -v01[:, 0]], dim=1)
        zc = (fc[:, 0, 1] + fc[:, 1, 1]) * 0.5
        return normal, zc
    v02 = fc[:, 2] - fc[:, 0]
    normal = 0.5 * torch.stack([v01[:, 1] * v02[:, 2] - v01[:, 2] * v02[:, 1],
                                v01[:, 2] * v02[:, 0] - v01[:, 0] * v02[:, 2],
                                v01[:, 0] * v02[:, 1] - v01[:, 1] * v02[:, 0]],
                               dim=1)
    zc = _div(fc[:, 0, 2] + fc[:, 1, 2] + fc[:, 2, 2], 3.0)
    return normal, zc


def apply_stress_bcs(param, spec: StressBCSpec, coord, force, rho_eff,
                     compensation_pressure: float, coord0,
                     halo_exchange=None):
    """Gravity-induced boundary tractions of a 2D or 3D mesh: Winkler
    foundation, water loading, lithostatic sidewalls, elastic foundation
    (bc.cxx:632-790).  ``spec`` is the tensor form (``spec.on(device)``);
    each facet's corner contributions, its traction over its ndims nodes,
    are added onto the force in the JAX package's order, with no atomics
    (``OrderedAdd``).

    Under the node-sharded step (``halo_exchange`` set) the facet table is
    the shard's, its padded rows zeroed by ``spec.grav_mask``: the
    contributions are summed into a zero buffer whose overlap rows are
    exchanged before it is added, so that an overlap row gets both
    shards' facets and keeps the same bits on both.  The elastic
    foundation is nodal and adds directly."""
    ctrl = param.control
    if ctrl.gravity == 0:
        return force
    ndims = coord.shape[1]
    if spec.n_grav > 0:
        normal, zc = _facet_normal(coord[spec.facet_nodes])
        rho_f = rho_eff[spec.facet_elem]
        p_wink = (compensation_pressure
                  - (rho_f + param.bc.winkler_delta_rho) * ctrl.gravity
                  * (zc + param.mesh.zlength))
        p_water = torch.where(
            zc < ctrl.surf_base_level,
            1030.0 * ctrl.gravity * (ctrl.surf_base_level - zc),
            torch.zeros_like(zc))
        # sidewalls: reference lithostatic pressure (matprops.cxx:148-169)
        mat = param.mat
        if ctrl.has_hydraulic_diffusion:
            rho_ref = (mat.rho0[mat.mattype_ref]
                       * (1 - mat.porosity[mat.mattype_ref])
                       + 1000.0 * mat.porosity[mat.mattype_ref])
        else:
            rho_ref = mat.rho0[mat.mattype_ref]
        p_side = rho_ref * ctrl.gravity * torch.clamp(-zc, min=0.0)
        p = torch.where(spec.kind == 0, p_wink,
                        torch.where(spec.kind == 1, p_water, p_side))
        contrib = _div(-(p[:, None, None] * normal[:, None, :]),
                       float(ndims))
        if spec.grav_mask is not None:
            contrib = contrib * spec.grav_mask.to(contrib.dtype)[:, None,
                                                                 None]
        vals = contrib.expand(-1, ndims, -1).reshape(-1, ndims)
        if halo_exchange is None:
            force = spec.grav_add.apply(force, vals)
        else:
            force = force + halo_exchange(
                spec.grav_add.apply(torch.zeros_like(force), vals))

    if param.bc.has_elastic_foundation:
        dz = coord[:, -1] - coord0[:, -1]
        add = torch.where(spec.z0_mask,
                          -param.bc.elastic_foundation_constant * dz,
                          torch.zeros_like(dz))
        force = torch.cat([force[:, :-1], (force[:, -1] + add)[:, None]],
                          dim=1)
    return force


def apply_stress_bcs_neumann(spec: StressBCSpec, coord, force,
                             halo_exchange=None):
    """General traction (Neumann) BCs of a 2D or 3D mesh (bc.cxx:792-875):
    each facet adds value * normal[dir] / ndims to component ``dir`` of
    its ndims nodes, in the JAX package's order.  The traction is formed
    in float64 (the table's type) and rounded once to the force's type, as
    the JAX package's scatter rounds it.  ``halo_exchange``: as in
    apply_stress_bcs, with ``spec.neu_mask``."""
    if spec.n_neu == 0:
        return force
    ndims = coord.shape[1]
    normal, _ = _facet_normal(coord[spec.neu_facet_nodes])
    nd = normal.gather(1, spec.neu_dir[:, None])[:, 0].double()
    add = _div(spec.neu_val * nd, float(ndims)).to(force.dtype)
    onehot = (spec.neu_dir[:, None]
              == torch.arange(ndims, device=nd.device)).to(force.dtype)
    contrib = (add[:, None] * onehot)[:, None, :].expand(-1, ndims, -1)
    if spec.neu_mask is not None:
        contrib = contrib * spec.neu_mask.to(force.dtype)[:, None, None]
    vals = contrib.reshape(-1, ndims)
    if halo_exchange is None:
        return spec.neu_add.apply(force, vals)
    return force + halo_exchange(
        spec.neu_add.apply(torch.zeros_like(force), vals))
