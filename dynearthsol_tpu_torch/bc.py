"""Velocity boundary conditions and the stress-BC facet tables
(counterpart of dynearthsol_tpu/bc.py).

Reference: bc.cxx.  ``apply_vbcs`` (bc.cxx:201-630) is a per-node switch
over the vbc type of each boundary; the types are static config, so the
switch unrolls into a few masked ``torch.where`` updates.  Order matters
and is preserved: X faces first, Y faces in 3D, then Z last (bc.cxx:563
"Z, must be dealt last") so corner nodes get the reference's precedence.
The box boundaries of 2D and 3D are ported; inclined (BOUNDN) boundaries
are not.

vbc type meanings (bc.cxx:206-214):
  0: all components free
  1: normal fixed, shear free
  2: normal free, shear fixed at 0
  3: normal fixed, shear fixed at 0
  4: tangential prescribed, normal 0
  6: normal prescribed + lateral shear prescribed
  100: v_axis = value * own coordinate along axis
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .constants import (BOUNDX0, BOUNDX1, BOUNDY0, BOUNDY1, BOUNDZ0,
                        BOUNDZ1, IBOUNDN0, IBOUNDN3, IBOUNDZ0, IBOUNDZ1,
                        YEAR2SEC, dim)


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

    @staticmethod
    def from_param(param, bcflag: np.ndarray, device="cpu") -> "VBCSpec":
        bc = param.bc
        flags = np.asarray(bcflag)
        n_bits = sum(1 << ib for ib in range(IBOUNDN0, IBOUNDN3 + 1))
        if (flags & np.uint32(n_bits)).any():
            raise NotImplementedError(
                "only box velocity BCs are ported (no inclined "
                "boundaries)")

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


def _masked_minmax(values, mask):
    big = torch.finfo(values.dtype).max
    vmax = torch.where(mask, values, torch.full_like(values, -big)).max()
    vmin = torch.where(mask, values, torch.full_like(values, big)).min()
    return vmin, vmax


def _set(vel, mask, comp, value):
    """vel[mask, comp] = value (value scalar or per-node array)."""
    value = torch.as_tensor(value, device=vel.device).to(vel.dtype)
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
    bx0min, bx0max = _masked_minmax(z, spec.x0)
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
    numpy, in 2D and 3D.  The fused 2D step computes the gravity-facet
    tractions (Winkler, water loading; ops/fused2d.py); the fused 3D step
    and the column step refuse ``n_grav > 0``, and every step refuses
    ``n_neu > 0``.

    kind: 0 = Winkler foundation (bottom), 1 = hydrostatic water loading
    (top), 2 = lithostatic sidewall.
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

        return StressBCSpec(
            n_grav=len(felem), n_neu=len(ndir),
            facet_nodes=arr(fnodes, np.int32, (0, npf)),
            facet_elem=arr(felem, np.int32, (0,)),
            kind=arr(kind, np.int32, (0,)),
            neu_facet_nodes=arr(nnodes, np.int32, (0, npf)),
            neu_dir=arr(ndir, np.int32, (0,)),
            neu_val=arr(nval, np.float64, (0,)),
            z0_mask=z0_mask)
