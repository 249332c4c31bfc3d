"""Element volumes (counterpart of dynearthsol_tpu/ops/shapefn.py).

Reference: triangle_area / tetrahedron_volume / compute_volume
(geometry.cxx:35-200).
"""

from __future__ import annotations

import torch


def compute_volume(coord: torch.Tensor, conn: torch.Tensor) -> torch.Tensor:
    """Triangle area (2D) / tetrahedron volume (3D), positive for valid
    orientation (geometry.cxx:35-200).

    The operation order is the one of the fused steps' post-move volume
    (``volume_of`` in csrc/fused2d.cu and csrc/fused3d.cu, and in
    ops/fused2d.py and ops/fused3d.py; in 3D the scalar triple product
    over 6 of pallas3d.py:733-739), and the CUDA sources are built without
    FMA contraction, so the initial volume equals the volume the step
    recomputes from unchanged coordinates bit for bit: the maxwell
    ``dv = V/V_old - 1`` multiplies any 1-ulp difference by the bulk
    modulus every step."""
    x = coord[conn]  # (nelem, npe, ndims)
    if coord.shape[1] == 2:
        ab = x[:, 1] - x[:, 0]
        ac = x[:, 2] - x[:, 0]
        return 0.5 * (ab[:, 0] * ac[:, 1] - ab[:, 1] * ac[:, 0])
    return tet_volume([x[:, c, 0] for c in range(4)],
                      [x[:, c, 1] for c in range(4)],
                      [x[:, c, 2] for c in range(4)])


def tet_volume(xs, ys, zs):
    """Volume of the tetrahedra with corner coordinates xs, ys, zs (four
    same-shape tensors each), pallas3d.py:733-739."""
    d1 = (xs[1] - xs[0], ys[1] - ys[0], zs[1] - zs[0])
    d2 = (xs[2] - xs[0], ys[2] - ys[0], zs[2] - zs[0])
    d3 = (xs[3] - xs[0], ys[3] - ys[0], zs[3] - zs[0])
    return (d1[0] * (d2[1] * d3[2] - d2[2] * d3[1])
            + d1[1] * (d2[2] * d3[0] - d2[0] * d3[2])
            + d1[2] * (d2[0] * d3[1] - d2[1] * d3[0])) / 6.0
