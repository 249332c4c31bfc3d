"""Standalone terrigenous-sedimentation preview (counterpart of
dynearthsol_tpu/utils/terrigenous.py).

Same physics as the reference's utility of the same name
(utils/terrigenous.py:5-31): one increment of depth-dependent diffusive
sedimentation over a surface profile, used to preview the [control]
terrig_* parameters before a full run.  The in-step implementation lives
in ops/surface.py (terrigenous_dh).  Float64 tensors on ``device`` (see
utils/__init__.py).
"""

from __future__ import annotations

import torch

from . import f64, resolve_device


def _index_gradient(x):
    """np.gradient(x) at unit spacing: central differences inside, one-sided
    at the ends."""
    g = torch.empty_like(x)
    g[1:-1] = (x[2:] - x[:-2]) / 2.0
    g[0] = x[1] - x[0]
    g[-1] = x[-1] - x[-2]
    return g


def terrig(xi, zi, S0, C0, C1, is_strip=False, device=None):
    """Sedimentation-rate profile dh/dt over surface nodes.

    Only submerged nodes (z < 0) receive sediment.  The rate is the
    divergence of a depth-amplified diffusive flux C0*exp(-C1*z) acting on
    the surface slope, with a source flux S0 entering from the left edge
    (encoded as a slope jump S0/C0 at the first submerged node).

    ``is_strip`` restricts deposition to the contiguous strip attached to
    the source: rates are clamped to be non-increasing along the strip
    (running minimum) and cut to zero past the first non-positive rate.
    """
    dev = resolve_device(device, xi, zi)
    xi, zi = f64(xi, dev), f64(zi, dev)
    wet = zi < 0
    x, z = xi[wet], zi[wet]
    out = torch.zeros_like(xi)
    if x.numel() < 2:
        return out

    # node-centred slope divergence: pad the segment slopes with ghost
    # values (left ghost carries the source flux, right ghost mirrors)
    slope = torch.empty(x.numel() + 1, dtype=torch.float64, device=dev)
    slope[1:-1] = torch.diff(z) / torch.diff(x)
    slope[0] = slope[1] - S0 / C0
    slope[-1] = slope[-2]
    rate = C0 * torch.exp(-C1 * z) * torch.diff(slope) / _index_gradient(x)

    if is_strip:
        # strip mode: non-increasing along the strip, zero past the first
        # non-positive rate (the strip detaches from the source there)
        nonpos = (rate <= 0).nonzero()
        cut = int(nonpos[0]) if nonpos.numel() else rate.numel()
        keep = torch.arange(rate.numel(), device=dev) <= cut
        rate = torch.where(keep, torch.cummin(rate, 0).values,
                           torch.zeros_like(rate))

    out[wet] = rate
    return out
