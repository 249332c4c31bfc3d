"""Free-air / Bouguer gravity from 2D model output (counterpart of
dynearthsol_tpu/utils/gravity.py; utils/gravity.py in the reference).

The JAX package forms every (point, element) pair at once, (npoints,
nelem, 2) values: 4.2 GB in float64 for 1,000 points over 262,144
elements.  Here the points go in blocks whose pairs stay under
``BLOCK_PAIRS``, so memory is bounded whatever the point count; the sums
over elements are PyTorch's, so they agree with the JAX package's to
rounding, not bit for bit.  Float64 tensors on ``device`` (see
utils/__init__.py).
"""

from __future__ import annotations

import torch

from . import f64, resolve_device

G = 6.67e-11
BLOCK_PAIRS = 1 << 24  # (point, element) pairs per block: 128 MiB a plane


def elem_area(ecoord):
    """(nelem, 3, 2) corner coords -> triangle areas."""
    ab = ecoord[:, 1, :] - ecoord[:, 0, :]
    ac = ecoord[:, 2, :] - ecoord[:, 0, :]
    return 0.5 * (ab[:, 0] * ac[:, 1] - ab[:, 1] * ac[:, 0]).abs()


def _line_mass_sum(points, cen, a, rho, block):
    """sum_e (dz a_e / r^2) rho_e from each point to the centres ``cen``
    (``rho`` None: 1), the points in blocks of ``block``."""
    out = torch.empty(points.shape[0], dtype=torch.float64,
                      device=points.device)
    for i in range(0, points.shape[0], block):
        dv = points[i:i + block, None, :] - cen[None, :, :]
        dr = (dv ** 2).sum(dim=2)
        t = dv[:, :, 1] * a / dr
        out[i:i + block] = (t if rho is None else t * rho).sum(dim=1)
    return out


def _setup(points, coord, conn, device):
    """(device, points, element corners, centres, points per block)."""
    dev = resolve_device(device, points, coord, conn)
    points, coord = f64(points, dev), f64(coord, dev)
    conn = torch.as_tensor(conn, device=dev).long()
    ecoord = coord[conn]
    block = max(1, BLOCK_PAIRS // max(conn.shape[0], 1))
    return dev, points, ecoord, ecoord.mean(dim=1), block


def freeair(points, coord, conn, rho, device=None):
    """Vertical gravity at ``points`` (n, 2) from element densities
    (line-mass approximation per element, utils/gravity.py:24-36)."""
    dev, points, ecoord, cen, block = _setup(points, coord, conn, device)
    return 2.0 * G * _line_mass_sum(points, cen, elem_area(ecoord),
                                    f64(rho, dev), block)


def bouguer(points, coord, conn, rho, rho_ref=2670.0, height=3000.0,
            device=None):
    """Bouguer anomaly: free-air minus the slab effect of topography
    above sea level (utils/gravity.py:38-60)."""
    dev, points, ecoord, cen, block = _setup(points, coord, conn, device)
    g = 2.0 * G * _line_mass_sum(points, cen, elem_area(ecoord),
                                 f64(rho, dev), block)
    above = cen[:, 1] > 0.0
    if bool(above.any()):
        g = g - 2.0 * G * rho_ref * _line_mass_sum(
            points, cen[above], elem_area(ecoord[above]), None, block)
    return g
