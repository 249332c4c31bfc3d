"""Flattened symmetric tensor helpers (counterpart of
dynearthsol_tpu/ops/tensor.py).

Component order matches the reference (fields.cxx:408-483):
  2D: [xx, zz, xz]          (NSTR = 3)
  3D: [xx, yy, zz, xy, xz, yz]  (NSTR = 6)
Reference: trace / second_invariant2 / second_invariant (utils.hpp:172-201).
"""

from __future__ import annotations

import torch


def trace(t: torch.Tensor) -> torch.Tensor:
    """Trace of flattened symmetric tensors, shape (..., NSTR)."""
    if t.shape[-1] == 3:
        return t[..., 0] + t[..., 1]
    return t[..., 0] + t[..., 1] + t[..., 2]


def second_invariant2(t: torch.Tensor) -> torch.Tensor:
    """Squared second invariant of the deviatoric part (utils.hpp:183-193)."""
    if t.shape[-1] == 3:
        d = t[..., 0] - t[..., 1]
        return 0.25 * (d * d) + t[..., 2] * t[..., 2]
    return inv2_6(tuple(t[..., i] for i in range(6)))


def inv2_6(t):
    """Squared deviatoric second invariant of a 3D tensor given as six
    same-shape components (xx, yy, zz, xy, xz, yz), in the operation order
    of the fused 3D step (pallas3d.py ``inv2_6``)."""
    a = (t[0] + t[1] + t[2]) / 3.0
    d0, d1, d2 = t[0] - a, t[1] - a, t[2] - a
    return (0.5 * (d0 * d0 + d1 * d1 + d2 * d2)
            + t[3] * t[3] + t[4] * t[4] + t[5] * t[5])


def second_invariant(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(second_invariant2(t))
