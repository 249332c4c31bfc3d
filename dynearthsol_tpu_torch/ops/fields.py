"""Nodal field updates of the time step (counterpart of the part of
dynearthsol_tpu/ops/fields.py that the column step calls): damping,
velocity, coordinates and the force residual.

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


def residual_l2(force_residual):
    """RMS of the nodal residual force (fields.cxx:705-727), a 0-d tensor
    on the force's device."""
    ss = torch.sum(force_residual * force_residual)
    num = torch.full_like(ss, float(force_residual.numel()))
    return torch.sqrt(ss / num)
