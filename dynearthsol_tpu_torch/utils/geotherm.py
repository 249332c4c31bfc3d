"""Analytic geotherm helpers (counterpart of dynearthsol_tpu/utils/
geotherm.py; utils/geotherm.py in the reference).

Used to cross-check the initial-temperature options of ic.py
(half-space cooling, layered radiogenic conduction) and for
post-processing.  Float64 tensors on ``device`` (see utils/__init__.py).
"""

from __future__ import annotations

import math

import torch

from . import f64, resolve_device

MYRS2SEC = 86400 * 365.2425e6


def half_space_cooling_T(z, T0, Tm, age_in_myrs, alpha, device=None):
    """T(z) of a cooling half space (utils/geotherm.py:8-13)."""
    z = f64(z, resolve_device(device, z))
    return T0 + (Tm - T0) * torch.special.erf(
        z / math.sqrt(4 * alpha * age_in_myrs * MYRS2SEC))


def _h_integral(z, hr, rhoH0):
    return rhoH0 * hr ** 2 * (1.0 - torch.exp(-z / hr))


def continental_radiogenic_T(z, T0, hr, k, qm, rhoH0, device=None):
    """Single-layer conductive geotherm with exponentially folded
    radiogenic heating (utils/geotherm.py:15-17)."""
    z = f64(z, resolve_device(device, z))
    return T0 + qm / k * z + _h_integral(z, hr, rhoH0) / k


def layered_radiogenic_T(z, T0, Tm, bdy, k, rhoH0, hr, device=None):
    """Multi-layer conductive geotherm, the analytic counterpart of
    ic.cxx:907-1010 / ic._layered_radiogenic_geotherm.  ``z`` is depth
    (positive down); returns (T, qm), qm a 0-d tensor."""
    dev = resolve_device(device, z, bdy, k, rhoH0)
    bdy, k, rhoH0, z = (f64(v, dev) for v in (bdy, k, rhoH0, z))
    thick = bdy[1:] - bdy[:-1]
    dTh = _h_integral(thick, hr, rhoH0) / k
    qm = (Tm - T0 - dTh.sum()) / thick.sum() \
        * (thick.sum() / (thick / k).sum())
    dt_layer = torch.cat([torch.zeros(1, dtype=torch.float64, device=dev),
                          torch.cumsum(dTh + thick * qm / k, 0)])
    T = torch.full_like(z, Tm)
    for j in range(len(k)):
        sel = (z >= bdy[j]) & (z <= bdy[j + 1])
        d = z[sel] - bdy[j]
        T[sel] = (T0 + dt_layer[j] + qm * d / k[j]
                  + _h_integral(d, hr, rhoH0[j]) / k[j])
    T[z <= bdy[0]] = T0
    return T, qm
