"""Nodal field updates of the time step (counterpart of the part of
dynearthsol_tpu/ops/fields.py that the column step calls): damping,
velocity, coordinates, the force residual and the pore-pressure update.

Reference: fields.cxx.  Plain PyTorch on whole nodal arrays; the fused
structured steps do the same arithmetic in-kernel.
"""

from __future__ import annotations

import torch


def apply_damping(force, vel, mass, ymass, damping_option: int,
                  damping_factor: float):
    """FLAC-style velocity-proportional damping, options 0-4
    (fields.cxx:486-582)."""
    small_vel = 1e-13
    zero = torch.zeros_like(force)
    if damping_option == 0:
        return force
    if damping_option == 1:
        # damp when |v| above threshold: f -= factor * |f| * sign(v)
        moving = torch.abs(vel) > small_vel
        return force - torch.where(
            moving, damping_factor * torch.abs(force) * torch.sign(vel),
            zero)
    if damping_option == 2:
        return force * (1.0 - damping_factor)
    if damping_option == 3:
        parallel = (force < 0) == (vel < 0)
        return torch.where(parallel,
                           force * (1.0 - damping_factor),
                           force * (2.0 - damping_factor))
    if damping_option == 4:
        critical = 2.0 * torch.sqrt(mass * ymass)
        moving = torch.abs(vel) > small_vel
        f_C = damping_factor * torch.abs(force) * torch.sign(vel)
        f_V = critical[:, None] * vel
        f_damp = torch.where(torch.abs(f_C) < torch.abs(f_V), f_V, f_C)
        return force - torch.where(moving, f_damp, zero)
    raise ValueError(f"unknown damping_option {damping_option}")


def update_velocity(vel, force, mass, dt):
    """v += dt * f / m (fields.cxx:730-747)."""
    return vel + dt * force / mass[:, None]


def update_coordinate(coord, vel, dt):
    """x += v * dt (fields.cxx:766-789)."""
    return coord + vel * dt


def residual_l2(force_residual, own_mask=None, axis=None):
    """RMS of the nodal residual force (fields.cxx:705-727), a 0-d tensor
    on the force's device.  A shard of the node-sharded step sums its
    owned rows only (``own_mask``; the overlap rows are on both
    neighbours), and the sum and the count are added over the group
    (``axis``) in one psum, as the JAX package's residual_l2."""
    if own_mask is None:
        ss = torch.sum(force_residual * force_residual)
        num = torch.full_like(ss, float(force_residual.numel()))
    else:
        m = own_mask.reshape((-1,) + (1,) * (force_residual.dim() - 1))
        ss = torch.sum(force_residual * force_residual * m)
        num = torch.sum(own_mask) * float(force_residual.numel()
                                          // force_residual.shape[0])
    if axis is not None:
        ss, num = axis.psum(torch.stack([ss, num.to(ss.dtype)]))
    return torch.sqrt(ss / num)


def update_pore_pressure(ppressure, dppressure, coord, conn, dnd, volume,
                         stress, old_mean_stress, hmass, dt, gravity,
                         perm_e, mu_e, alpha_b, phi_e, beta_f, bulkm,
                         shearm, pp_bc_mask, asm, axis=None):
    """Explicit Darcy pore-pressure diffusion with the poroelastic source
    (fields.cxx:297-406).  Hydraulic head = p / gamma_w + z; the Biot
    source comes from the mean-stress change over the step.  ``dnd`` is
    (nelem, npe, ndims), ``stress`` (nelem, nstr), ``asm`` maps
    (nelem, npe) corner contributions to (nnode,) sums.  Under a group of
    shards (``axis``) the diffusivity maximum is taken over the group.

    Returns (ppressure, dppressure, hydro_diff_max)."""
    ndims = coord.shape[1]
    npe = ndims + 1

    def c(v):
        # a divisor filled on the device (a Python divisor would be a
        # product with its reciprocal on the card)
        return torch.full((), float(v), dtype=volume.dtype,
                          device=volume.device)

    tr = stress[:, 0]
    for i in range(1, ndims):
        tr = tr + stress[:, i]
    mean_change = tr / c(ndims) - old_mean_stress
    matrix_comp = 1.0 / (bulkm + 4.0 * shearm / c(3.0))
    if ndims == 2:
        bulk_comp = 1.0 / (bulkm + shearm / c(3.0))
    else:
        bulk_comp = 1.0 / bulkm
    gamma_w = c(1000.0 * gravity)  # fields.cxx:330 hard-codes water
    hydraulic_conductivity = perm_e * gamma_w / mu_e
    kv = hydraulic_conductivity * volume
    diff_e = hydraulic_conductivity / (phi_e * beta_f
                                       + alpha_b * matrix_comp) / gamma_w
    hydro_diff_max = torch.clamp(diff_e.max(), min=1e-38)
    if axis is not None:
        hydro_diff_max = axis.pmax(hydro_diff_max)

    # poroelastic volume source (fields.cxx:342)
    pe = alpha_b * mean_change * bulk_comp * volume / c(npe) / dt

    head = ppressure[conn] / gamma_w + coord[conn, ndims - 1]
    grad = head[:, 0, None] * dnd[:, 0]
    for j in range(1, npe):
        grad = grad + head[:, j, None] * dnd[:, j]
    diffusion = dnd[:, :, 0] * grad[:, None, 0]
    for d in range(1, ndims):
        diffusion = diffusion + dnd[:, :, d] * grad[:, None, d]
    tdot = asm(kv[:, None] * diffusion + pe[:, None])

    positive = hmass > 0.0
    upd = torch.where(positive,
                      tdot * dt / torch.where(positive, hmass,
                                              torch.ones_like(hmass)),
                      torch.zeros_like(hmass))
    pp_new = torch.where(pp_bc_mask, ppressure, ppressure - upd)
    dpp_new = torch.where(pp_bc_mask, dppressure, upd)
    return pp_new, dpp_new, hydro_diff_max
