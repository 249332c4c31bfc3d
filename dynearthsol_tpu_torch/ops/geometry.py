"""Geometry: CFL time step, (pseudo-)mass matrices, element heights
(counterpart of dynearthsol_tpu/ops/geometry.py).

Reference: geometry.cxx.  These forms run once, at initialisation; inside
the time loop the fused step computes the same quantities in-kernel.
"""

from __future__ import annotations

import math

import torch


def _rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """c / t rounded once, like JAX.  PyTorch computes ``float / tensor``
    as ``reciprocal(t) * c``, which rounds twice."""
    return torch.div(torch.full_like(t, c), t)


def elem_min_height(coord, conn, volume):
    """Min altitude of each element (geometry.cxx:830-852): 2D 2*A / longest
    edge; 3D 3*V / largest facet area."""
    x = coord[conn]
    if x.shape[2] == 3:
        return tet_min_height([x[:, c, 0] for c in range(4)],
                              [x[:, c, 1] for c in range(4)],
                              [x[:, c, 2] for c in range(4)], volume)
    d01 = ((x[:, 0] - x[:, 1]) ** 2).sum(dim=1)
    d12 = ((x[:, 1] - x[:, 2]) ** 2).sum(dim=1)
    d02 = ((x[:, 0] - x[:, 2]) ** 2).sum(dim=1)
    maxl = torch.sqrt(torch.maximum(torch.maximum(d01, d12), d02))
    return 2.0 * volume / maxl


def elem_quality(coord, conn, volume):
    """Element quality in (0, 1], 1 for an equilateral element
    (geometry.cxx:1157-1195): the mesh-quality output field."""
    x = coord[conn]
    if x.shape[2] == 2:
        d01 = ((x[:, 0] - x[:, 1]) ** 2).sum(dim=1)
        d12 = ((x[:, 1] - x[:, 2]) ** 2).sum(dim=1)
        d02 = ((x[:, 0] - x[:, 2]) ** 2).sum(dim=1)
        return 4.0 * math.sqrt(3.0) * volume / (d01 + d12 + d02)

    def tri_area(a, b, c):
        u, v = x[:, b] - x[:, a], x[:, c] - x[:, a]
        cr = torch.stack([u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
                          u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                          u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]], dim=1)
        return 0.5 * torch.sqrt((cr * cr).sum(dim=1))

    area_sum = (tri_area(0, 1, 2) + tri_area(0, 1, 3) + tri_area(2, 3, 0)
                + tri_area(2, 3, 1))
    return 216.0 * math.sqrt(3.0) * volume * volume / area_sum ** 3


def tet_min_height(xs, ys, zs, vol):
    """3*V / largest facet area of tetrahedra given by corner coordinate
    lists (the operation order of pallas3d.py:761-774)."""
    def tri_area(i, j, k):
        ux, uy, uz = xs[j] - xs[i], ys[j] - ys[i], zs[j] - zs[i]
        vx, vy, vz = xs[k] - xs[i], ys[k] - ys[i], zs[k] - zs[i]
        cx = uy * vz - uz * vy
        cy = uz * vx - ux * vz
        cz = ux * vy - uy * vx
        return 0.5 * torch.sqrt(cx * cx + cy * cy + cz * cz)

    maxa = torch.maximum(
        torch.maximum(tri_area(0, 1, 2), tri_area(0, 1, 3)),
        torch.maximum(tri_area(2, 3, 0), tri_area(2, 3, 1)))
    return 3.0 * vol / maxa


def compute_dt(coord, conn, volume, vel, shearm_e, rho_e, visc_min,
               therm_diff_max, max_vbc_val,
               *, fixed_dt: float, dt_fraction: float,
               inertial_scaling: float, is_quasi_static: bool,
               has_thermal_diffusion: bool,
               use_global_velocity_scaling: bool,
               bulk_modulus_ref: float, rho0_ref: float,
               hydro_diff_max=None):
    """CFL time step (geometry.cxx:756-923).

    Returns (dt, max_global_vel_mag, global_dt_min), 0-d tensors on the
    device of ``volume``; nothing is read back to the host.  With
    ``hydro_diff_max`` (a 0-d tensor; hydraulic diffusion on) the
    hydraulic diffusion limit joins the minimum."""
    big = torch.finfo(volume.dtype).max
    v_slots = vel[conn]
    npe = v_slots.shape[1]
    v_el = v_slots[:, 0]
    for c in range(1, npe):
        v_el = v_el + v_slots[:, c]
    v_el = v_el / float(npe)
    vmag = torch.sqrt((v_el ** 2).sum(dim=1))
    if fixed_dt != 0.0:
        vmax = torch.clamp(vmag.max(), min=max_vbc_val)
        fixed = torch.full((), fixed_dt, dtype=volume.dtype,
                           device=volume.device)
        return fixed, vmax, fixed.clone()

    minh = elem_min_height(coord, conn, volume)
    minl = minh.min()
    global_max_vem = torch.clamp(vmag.max(), min=max_vbc_val)

    dt_maxwell = _rdiv(0.5 * visc_min, 1e-40 + shearm_e).min()
    if has_thermal_diffusion:
        dt_diffusion = (0.5 * minh * minh / therm_diff_max).min()
    else:
        dt_diffusion = torch.full_like(minl, big)
    swave = torch.sqrt(shearm_e / rho_e)
    global_dt_min = (minl / swave / 5.0).min()

    swave_ref = math.sqrt(bulk_modulus_ref / rho0_ref)
    if use_global_velocity_scaling:
        dt_advection = 0.5 * minl / global_max_vem
        if is_quasi_static:
            dt_elastic = 0.5 * minl / (global_max_vem * inertial_scaling)
        else:
            dt_elastic = 0.5 * minl / swave_ref
        dt_elastic = torch.maximum(dt_elastic, global_dt_min)
    else:
        dt_advection = 0.5 * minl / max_vbc_val
        if is_quasi_static:
            dt_elastic = 0.5 * minl / (max_vbc_val * inertial_scaling)
        else:
            dt_elastic = 0.5 * minl / swave_ref

    dt = torch.minimum(torch.minimum(dt_elastic, dt_maxwell),
                       torch.minimum(dt_advection, dt_diffusion))
    if hydro_diff_max is not None:
        dt = torch.minimum(dt, torch.where(
            hydro_diff_max > 0, (0.5 * minh * minh).min() / hydro_diff_max,
            torch.full_like(minl, big)))
    return dt * dt_fraction, global_max_vem, global_dt_min


def compute_mass(volume, bulkm_e, shearm_e, rho_e, cp_e, phi_e,
                 alpha_biot_e, beta_fluid_e, asm,
                 *, pseudo_speed, pseudo_speed_atp, is_quasi_static: bool,
                 use_global_velocity_scaling: bool, ndims: int = 2,
                 has_hydraulic_diffusion: bool = False):
    """(Pseudo-)mass matrices (geometry.cxx:1020-1154).  Quasi-static runs
    use a pseudo-density bulkm/speed^2; dynamic runs the true density (of
    the fluid-filled rock with hydraulic diffusion).  Also lumps nodal
    volume, thermal mass, hydraulic mass and a Young's-modulus mass for
    Rayleigh damping.  Returns (volume_n, mass, tmass, hmass, ymass)."""
    npe = ndims + 1
    if use_global_velocity_scaling:
        apparent = torch.minimum(pseudo_speed_atp,
                                 torch.sqrt(shearm_e / rho_e))
        rho_q = bulkm_e / (apparent * apparent)
    else:
        rho_q = bulkm_e / (pseudo_speed * pseudo_speed)
    rho_m = rho_q if is_quasi_static else rho_e
    if has_hydraulic_diffusion and not is_quasi_static:
        rho_m = rho_e * (1.0 - phi_e) + 1000.0 * phi_e

    if ndims == 2:
        bulk_comp = 1.0 / (bulkm_e + shearm_e / 3.0)  # lambda + G
    else:
        bulk_comp = 1.0 / bulkm_e  # geometry.cxx:1098
    hm_coeff = alpha_biot_e + phi_e - alpha_biot_e * phi_e

    m = rho_m * volume / npe
    tm = rho_e * cp_e * volume / npe
    hm = (hm_coeff * bulk_comp + phi_e * beta_fluid_e) * volume / npe
    ym = 9.0 * bulkm_e * shearm_e / (3.0 * bulkm_e + shearm_e) / npe

    contrib = torch.stack([volume, m, tm, hm, ym], dim=1)  # (nelem, 5)
    sums = asm(contrib[:, None, :].expand(-1, npe, -1))
    return tuple(sums[:, i] for i in range(5))
