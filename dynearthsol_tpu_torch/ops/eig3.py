"""Branch-free closed-form symmetric 3x3 eigensolver (counterpart of
dynearthsol_tpu/ops/eig3.py).

The reference computes principal stresses with Kopp's dsyevh3 (3x3-C/,
called from rheology.cxx:13-70).  This is the JAX package's analytic
solver, ported operation for operation: trigonometric Cardano eigenvalues,
cross-product eigenvectors, degenerate cases chosen with ``torch.where``.
``acos`` is the A&S 4.4.46 polynomial of the JAX package, not
``torch.acos``: a one-ulp difference in the angle moves the eigenvalues by
an ulp, and that flips the Mohr-Coulomb branch of an element near the
yield surface.  The same functions exist as ``__device__`` code in
csrc/eig3.cuh for the fused 3D CUDA step.

On the CPU, ``cos`` and ``sqrt`` run in the calling thread (``_serial``).
PyTorch splits a vectorised unary op over more than 2,048 elements among
its intra-op worker threads, and in one long test process a worker's
``torch.cos`` gave values off by up to 1.4e-11 of the scale on the rows of
its chunk, while the calling thread and a fresh process gave the JAX
package's values to the bit.  Cut into pieces below that grain, the op
runs where the caller runs, whatever the worker threads' state.

All functions are componentwise: inputs are the six unique components
(xx, yy, zz, xy, xz, yz) as same-shape tensors.
"""

from __future__ import annotations

import math

import torch

_TINY = 1e-30

# Abramowitz & Stegun 4.4.46 acos minimax coefficients, |err| <= 2e-8
_ACOS_C = (1.5707963050, -0.2145988016, 0.0889789874, -0.0501743046,
           0.0308918810, -0.0170881256, 0.0066700901, -0.0012624911)

# 2*pi/3 formed in float64, as the JAX package's Python constant
_TWO_PI_3 = 2.0 * math.pi / 3.0

# the intra-op grain of PyTorch's vectorised unary ops on the CPU
# (aten/src/ATen/native/cpu/UnaryOpsKernel.cpp): an op over fewer
# elements runs in the calling thread
_UNARY_GRAIN = 2048


def _serial(fn, x):
    """fn(x) for a unary torch op ``fn``, computed in the calling thread
    when x is a CPU tensor (in pieces below the intra-op grain); on the
    card fn(x) as it is."""
    if x.device.type != "cpu" or x.numel() < _UNARY_GRAIN:
        return fn(x)
    flat = x.reshape(-1)
    return torch.cat([fn(c) for c in flat.split(_UNARY_GRAIN - 1)]) \
        .view(x.shape)


def _acos(x):
    """acos(x) for x in [-1, 1] via sqrt(1-x)*poly(x) (A&S 4.4.46)."""
    ax = torch.abs(x)
    p = torch.full_like(x, _ACOS_C[-1])
    for c in _ACOS_C[-2::-1]:
        p = p * ax + c
    y = _serial(torch.sqrt, torch.clamp(1.0 - ax, min=0.0)) * p
    return torch.where(x < 0, math.pi - y, y)


def eigvals3_c(axx, ayy, azz, axy, axz, ayz):
    """Eigenvalues (ascending) of symmetric 3x3 via trigonometric Cardano
    (dsyevc3, 3x3-C/dsyevc3.c).  Returns (l0, l1, l2) with l0<=l1<=l2."""
    q = (axx + ayy + azz) / 3.0
    bxx, byy, bzz = axx - q, ayy - q, azz - q
    p2 = (bxx * bxx + byy * byy + bzz * bzz
          + 2.0 * (axy * axy + axz * axz + ayz * ayz)) / 6.0
    p = _serial(torch.sqrt, torch.clamp(p2, min=_TINY))
    # det(B)/2 with B = (A - qI)/p
    ip = 1.0 / p
    cxx, cyy, czz = bxx * ip, byy * ip, bzz * ip
    cxy, cxz, cyz = axy * ip, axz * ip, ayz * ip
    half_det = 0.5 * (cxx * (cyy * czz - cyz * cyz)
                      - cxy * (cxy * czz - cyz * cxz)
                      + cxz * (cxy * cyz - cyy * cxz))
    r = torch.clamp(half_det, -1.0, 1.0)
    phi = _acos(r) / 3.0
    # l2 >= l1 >= l0 by the cosine ordering
    l2 = q + 2.0 * p * _serial(torch.cos, phi)
    l0 = q + 2.0 * p * _serial(torch.cos, phi + _TWO_PI_3)
    l1 = 3.0 * q - l0 - l2
    iso = p2 <= (1e-28 * torch.clamp(q * q, min=1.0))  # (near-)isotropic
    return (torch.where(iso, q, l0), torch.where(iso, q, l1),
            torch.where(iso, q, l2))


def _cross(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _normalize(x, y, z):
    n2 = x * x + y * y + z * z
    inv = 1.0 / _serial(torch.sqrt, torch.clamp(n2, min=_TINY))
    return x * inv, y * inv, z * inv, n2


def _sq3(c):
    return c[0] * c[0] + c[1] * c[1] + c[2] * c[2]


def _eigvec_for(axx, ayy, azz, axy, axz, ayz, lam):
    """Eigenvector of the MOST separated eigenvalue lam: largest-norm cross
    product of two rows of (A - lam I), selected branch-free."""
    r0 = (axx - lam, axy, axz)
    r1 = (axy, ayy - lam, ayz)
    r2 = (axz, ayz, azz - lam)
    c01 = _cross(*r0, *r1)
    c02 = _cross(*r0, *r2)
    c12 = _cross(*r1, *r2)
    n01, n02, n12 = _sq3(c01), _sq3(c02), _sq3(c12)
    use01 = (n01 >= n02) & (n01 >= n12)
    use02 = (~use01) & (n02 >= n12)
    vx = torch.where(use01, c01[0], torch.where(use02, c02[0], c12[0]))
    vy = torch.where(use01, c01[1], torch.where(use02, c02[1], c12[1]))
    vz = torch.where(use01, c01[2], torch.where(use02, c02[2], c12[2]))
    nmax = torch.maximum(torch.maximum(n01, n02), n12)
    # rank-deficient (degenerate eigenvalue): fall back to +x; corrected by
    # the caller's orthogonalization
    bad = nmax <= _TINY
    vx = torch.where(bad, 1.0, vx)
    vy = torch.where(bad, 0.0, vy)
    vz = torch.where(bad, 0.0, vz)
    x, y, z, _ = _normalize(vx, vy, vz)
    return x, y, z


def eigh3_c(axx, ayy, azz, axy, axz, ayz):
    """Full eigendecomposition: returns ((l0, l1, l2), V) with ascending
    eigenvalues and V = ((v0x, v0y, v0z), (v1x, ...), (v2x, ...)) an
    orthonormal eigenbasis (dsyevv3 equivalent, branch-free)."""
    l0, l1, l2 = eigvals3_c(axx, ayy, azz, axy, axz, ayz)

    # anchor on the most separated extreme eigenvalue for stability
    use_l0 = (l1 - l0) >= (l2 - l1)
    lam_a = torch.where(use_l0, l0, l2)
    wa = _eigvec_for(axx, ayy, azz, axy, axz, ayz, lam_a)

    # orthonormal complement {u, v} of wa, branch-free
    zero = torch.zeros_like(wa[0])
    ux_a, uy_a, uz_a, _ = _normalize(-wa[1], wa[0], zero)
    ux_b, uy_b, uz_b, _ = _normalize(zero, -wa[2], wa[1])
    pick = torch.abs(wa[2]) <= torch.abs(wa[0])
    ux = torch.where(pick, ux_a, ux_b)
    uy = torch.where(pick, uy_a, uy_b)
    uz = torch.where(pick, uz_a, uz_b)
    vx, vy, vz = _cross(*wa, ux, uy, uz)

    # middle eigenvector from the 2x2 projection of A onto span{u, v}
    def amul(x, y, z):
        return (axx * x + axy * y + axz * z,
                axy * x + ayy * y + ayz * z,
                axz * x + ayz * y + azz * z)

    au = amul(ux, uy, uz)
    av = amul(vx, vy, vz)
    muu = ux * au[0] + uy * au[1] + uz * au[2] - l1
    mvv = vx * av[0] + vy * av[1] + vz * av[2] - l1
    muv = ux * av[0] + uy * av[1] + uz * av[2]
    # null vector of [[muu, muv], [muv, mvv]]: use the larger row
    row0 = (muu * muu + muv * muv) >= (mvv * mvv + muv * muv)
    ct = torch.where(row0, -muv, -mvv)
    st = torch.where(row0, muu, muv)
    nrm = _serial(torch.sqrt, torch.clamp(ct * ct + st * st, min=_TINY))
    degenerate = (ct * ct + st * st) <= _TINY
    ct = torch.where(degenerate, 1.0, ct / nrm)
    st = torch.where(degenerate, 0.0, st / nrm)
    w1 = (ct * ux + st * vx, ct * uy + st * vy, ct * uz + st * vz)

    wb = _cross(*wa, *w1)
    # order back: wa belongs to l0 (if use_l0) else l2; wb to the other end
    v0 = tuple(torch.where(use_l0, a, b) for a, b in zip(wa, wb))
    v2 = tuple(torch.where(use_l0, a, b) for a, b in zip(wb, wa))
    return (l0, l1, l2), (v0, w1, v2)
