"""Constitutive cores, componentwise (counterpart of the ``*2_c`` and
``*3_c`` functions of dynearthsol_tpu/ops/rheology.py).

Reference: rheology.cxx: elastic (235), maxwell (264), viscous (284), the
Mohr-Coulomb return map in principal axes ``elasto_plastic`` (298-457, 3D)
and the geoFLAC plane-strain variant ``elasto_plastic2d`` (459-674).
Element-level control flow becomes ``torch.where`` masks.  Each function
takes tuples of same-shape tensors, (xx, zz, xz) in 2D and (xx, yy, zz,
xy, xz, yz) in 3D, and keeps the JAX package's operation order, so that
f32 results agree to the last bit wherever both round the same
operations.  The same functions exist as ``__device__`` code in
csrc/rheology2d.cuh and csrc/rheology3d.cuh for the fused CUDA steps.
"""

from __future__ import annotations

import math

import torch

from .eig3 import eigh3_c

_EPS = 1e-15


def elastic2_c(bulkm, shearm, de, s, dpp=None):
    """Componentwise 2D incremental elasticity (rheology.cxx:235-261), with
    the Biot pore-pressure increment ``dpp`` on the diagonal when given
    (rheology.cxx:250-261)."""
    lam = bulkm - 2.0 / 3.0 * shearm
    diag_inc = lam * (de[0] + de[1]) + (0.0 if dpp is None else dpp)
    return (s[0] + 2.0 * shearm * de[0] + diag_inc,
            s[1] + 2.0 * shearm * de[1] + diag_inc,
            s[2] + 2.0 * shearm * de[2])


def maxwell2_c(bulkm, shearm, viscosity, dt, dv, de, s):
    """Componentwise 2D Maxwell viscoelasticity (rheology.cxx:264-281)."""
    tmp = 0.5 * dt * shearm / viscosity
    f1 = 1.0 - tmp
    f2 = 1.0 / (1.0 + tmp)
    dev = (de[0] + de[1]) / 2.0
    s0 = (s[0] + s[1]) / 2.0
    bdv = bulkm * dv
    return (((s[0] - s0) * f1 + 2.0 * shearm * (de[0] - dev)) * f2 + s0
            + bdv,
            ((s[1] - s0) * f1 + 2.0 * shearm * (de[1] - dev)) * f2 + s0
            + bdv,
            (s[2] * f1 + 2.0 * shearm * de[2]) * f2)


def viscous2_c(bulkm, viscosity, total_dv, edot):
    """Componentwise 2D viscous flow (rheology.cxx:284-296)."""
    dev = (edot[0] + edot[1]) / 2.0
    return (2.0 * viscosity * (edot[0] - dev) + bulkm * total_dv,
            2.0 * viscosity * (edot[1] - dev) + bulkm * total_dv,
            2.0 * viscosity * edot[2])


def _full(like, v):
    return torch.full_like(like, v)


def elasto_plastic2d_c(bulkm, shearm, amc, anphi, anpsi, hardn, ten_max,
                       de, s, syy, dpp=None):
    """Componentwise geoFLAC plane-strain Mohr-Coulomb return map
    (rheology.cxx:459-674), with the Biot pore-pressure increment ``dpp``
    added to the three normal trial stresses when given
    (rheology.cxx:696-755).  Returns ((sxx, szz, sxz), syy_new, depls,
    failure_mode)."""
    a1 = bulkm + 4.0 / 3.0 * shearm
    a2 = bulkm - 2.0 / 3.0 * shearm
    sxx = s[0] + de[1] * a2 + de[0] * a1
    szz = s[1] + de[0] * a2 + de[1] * a1
    sxz = s[2] + de[2] * 2.0 * shearm
    syy_t = syy + (de[0] + de[1]) * a2
    if dpp is not None:
        sxx = sxx + dpp
        syy_t = syy_t + dpp
        szz = szz + dpp

    s0 = 0.5 * (sxx + szz)
    dd = sxx - szz
    rad = 0.5 * torch.sqrt(dd * dd + 4.0 * sxz * sxz)
    si = s0 - rad
    sii = s0 + rad
    ok = rad > _EPS
    one = _full(rad, 1.0)
    safe_rad = torch.where(ok, rad, one)
    cos2t = torch.where(ok, 0.5 * (szz - sxx) / safe_rad, one)
    sin2t = torch.where(ok, -sxz / safe_rad, _full(rad, 0.0))

    # sort syy into the (si, sii) pair (rheology.cxx:537-568)
    caseA = syy_t > sii  # syy is largest
    caseB = syy_t < si   # syy is smallest
    p0 = torch.where(caseA, si, torch.where(caseB, syy_t, si))
    p1 = torch.where(caseA, sii, torch.where(caseB, si, syy_t))
    p2 = torch.where(caseA, syy_t, torch.where(caseB, sii, sii))
    zi = torch.zeros_like(sxx, dtype=torch.int32)
    idx_si = torch.where(caseA, 0, torch.where(caseB, 1, 0)) + zi
    idx_sii = torch.where(caseA, 1, torch.where(caseB, 2, 2)) + zi
    idx_syy = torch.where(caseA, 2, torch.where(caseB, 0, 1)) + zi

    # tensile scenario 1: p0 >= ten_max -> everything capped
    # (rheology.cxx:587-592); scenarios 2/3 (rheology.cxx:597-608)
    t1 = p0 >= ten_max
    t2 = (~t1) & (p1 >= ten_max)
    t3 = (~t1) & (~t2) & (p2 >= ten_max)
    tm = ten_max + torch.zeros_like(p1)
    p1 = torch.where(t2, tm, p1)
    p2 = torch.where(t2 | t3, tm, p2)
    fmode = zi + t1.int() + 2 * t2.int() + 3 * t3.int()

    # shear yield (rheology.cxx:611-631)
    fs = p0 - p2 * anphi + amc
    elastic_out = (~t1) & (fs >= 0.0)
    shear = (~t1) & (fs < 0.0)
    alams = fs / (a1 - a2 * anpsi + a1 * anphi * anpsi - a2 * anphi + hardn)
    p0s = p0 - alams * (a1 - a2 * anpsi)
    p1s = p1 - alams * (a2 - a2 * anpsi)
    p2s = p2 - alams * (a2 - a1 * anpsi)
    depls = torch.where(shear, 0.5 * torch.abs(alams + alams * anpsi),
                        _full(alams, 0.0))
    fmode = fmode + 10 * shear.int()

    # post-shear tensile recheck (rheology.cxx:640-661)
    u1 = shear & (p0s >= ten_max)
    u2 = shear & (~u1) & (p1s >= ten_max)
    u3 = shear & (~u1) & (~u2) & (p2s >= ten_max)
    p1s = torch.where(u2, tm, p1s)
    p2s = torch.where(u2 | u3, tm, p2s)
    fmode = fmode + 20 * (u1 | u2 | u3).int()

    # rotate principal stresses back (rheology.cxx:665-673)
    def pick(idx):
        return torch.where(idx == 0, p0s, torch.where(idx == 1, p1s, p2s))

    pn1 = pick(idx_si)
    pn2 = pick(idx_sii)
    pn3 = pick(idx_syy)
    dc2 = (pn1 - pn2) * cos2t
    dss = pn1 + pn2
    sxx_r = 0.5 * (dss + dc2)
    szz_r = 0.5 * (dss - dc2)
    sxz_r = 0.5 * (pn1 - pn2) * sin2t
    syy_r = pn3

    # full-cap outcome (t1 before shear, u1 after)
    cap = t1 | u1
    sxx_n = torch.where(cap, tm, torch.where(elastic_out, sxx, sxx_r))
    szz_n = torch.where(cap, tm, torch.where(elastic_out, szz, szz_r))
    sxz_n = torch.where(cap, _full(sxz, 0.0),
                        torch.where(elastic_out, sxz, sxz_r))
    syy_n = torch.where(cap, tm, torch.where(elastic_out, syy_t, syy_r))
    depls = torch.where(cap & t1, _full(depls, 0.0), depls)
    return (sxx_n, szz_n, sxz_n), syy_n, depls, fmode


def elasto_plastic2_c(bulkm, shearm, amc, anphi, anpsi, hardn, ten_max,
                      de, s, dpp=None):
    """Componentwise 2D Mohr-Coulomb return map in principal axes, the
    form of the plastic rheologies without ``is_plane_strain``
    (rheology.cxx:298-457 on the two in-plane principal stresses; the JAX
    package's ``elasto_plastic`` with NSTR = 3).  The out-of-plane stress
    is not touched.  Returns (s_new 3-tuple, depls, failure_mode)."""
    st = elastic2_c(bulkm, shearm, de, s, dpp)

    a1 = bulkm + 4.0 / 3.0 * shearm
    a2 = bulkm - 2.0 / 3.0 * shearm

    # principal stresses from the Mohr circle (rheology.cxx:72-105)
    d = st[0] - st[1]
    s0 = 0.5 * (st[0] + st[1])
    rad = torch.sqrt(0.25 * (d * d) + st[2] * st[2])
    pmin = s0 - rad
    pmax = s0 + rad
    b = -rad
    ok = b < -_EPS
    one = torch.ones_like(b)
    safe_b = torch.where(ok, b, one)
    cos2t = torch.where(ok, 0.5 * d / safe_b, one)
    sin2t = torch.where(ok, st[2] / safe_b, torch.zeros_like(b))

    fs = pmin - pmax * anphi + amc
    ft = pmax - ten_max
    no_fail = (fs > 0.0) & (ft < 0.0)

    pa = torch.sqrt(1.0 + anphi * anphi) + anphi
    ps = ten_max * anphi - amc
    h = pmax - ten_max + pa * (pmin - ps)
    shear_fail = h < 0.0

    alam_s = fs / (a1 - a2 * anpsi + a1 * anphi * anpsi - a2 * anphi
                   + 2.0 * torch.sqrt(anphi) * hardn)
    alam_t = ft / a1
    alam = torch.where(shear_fail, alam_s, alam_t)

    dpls_shear = torch.abs(alam) * torch.sqrt(
        (3.0 + 2.0 * anpsi + 3.0 * anpsi * anpsi) * 0.125)   # / 8
    dpls_tens = torch.abs(alam) * math.sqrt(3.0 / 8.0)
    depls = torch.where(no_fail, torch.zeros_like(alam),
                        torch.where(shear_fail, dpls_shear, dpls_tens))

    d_min = torch.where(shear_fail, alam * (a1 - a2 * anpsi), alam * a2)
    d_max = torch.where(shear_fail, alam * (a2 - a1 * anpsi), alam * a1)
    pmin_new = pmin - d_min
    pmax_new = pmax - d_max

    dc2 = (pmin_new - pmax_new) * cos2t
    dss = pmin_new + pmax_new
    ret = (0.5 * (dss + dc2), 0.5 * (dss - dc2),
           0.5 * (pmin_new - pmax_new) * sin2t)
    s_new = tuple(torch.where(no_fail, t, r) for t, r in zip(st, ret))
    zi = torch.zeros_like(fs, dtype=torch.int32)
    failure_mode = torch.where(no_fail, zi,
                               torch.where(shear_fail, zi + 10, zi + 1))
    return s_new, depls, failure_mode


def elastic3_c(bulkm, shearm, de, s, dpp=None):
    """Componentwise 3D incremental elasticity (rheology.cxx:235-261), with
    the Biot pore-pressure increment ``dpp`` on the diagonal when given
    (rheology.cxx:250-261)."""
    lam = bulkm - 2.0 / 3.0 * shearm
    diag_inc = lam * (de[0] + de[1] + de[2]) \
        + (0.0 if dpp is None else dpp)
    return (s[0] + 2.0 * shearm * de[0] + diag_inc,
            s[1] + 2.0 * shearm * de[1] + diag_inc,
            s[2] + 2.0 * shearm * de[2] + diag_inc,
            s[3] + 2.0 * shearm * de[3],
            s[4] + 2.0 * shearm * de[4],
            s[5] + 2.0 * shearm * de[5])


def maxwell3_c(bulkm, shearm, viscosity, dt, dv, de, s):
    """Componentwise 3D Maxwell viscoelasticity (rheology.cxx:264-281)."""
    tmp = 0.5 * dt * shearm / viscosity
    f1 = 1.0 - tmp
    f2 = 1.0 / (1.0 + tmp)
    dev = (de[0] + de[1] + de[2]) / 3.0
    s0 = (s[0] + s[1] + s[2]) / 3.0
    bdv = bulkm * dv
    iso = tuple(((s[i] - s0) * f1 + 2.0 * shearm * (de[i] - dev)) * f2
                + s0 + bdv for i in range(3))
    dev_c = tuple((s[i] * f1 + 2.0 * shearm * de[i]) * f2
                  for i in range(3, 6))
    return iso + dev_c


def viscous3_c(bulkm, viscosity, total_dv, edot):
    """Componentwise 3D viscous flow (rheology.cxx:284-296)."""
    dev = (edot[0] + edot[1] + edot[2]) / 3.0
    return tuple(2.0 * viscosity * (edot[i] - dev) + bulkm * total_dv
                 for i in range(3)) \
        + tuple(2.0 * viscosity * edot[i] for i in range(3, 6))


def elasto_plastic3_c(bulkm, shearm, amc, anphi, anpsi, hardn, ten_max,
                      de, s, dpp=None):
    """Componentwise 3D Mohr-Coulomb return map in principal axes
    (rheology.cxx:298-457) with the analytic eigensolver of ops/eig3.py
    (the reference uses dsyevh3).  Returns (s_new 6-tuple, depls,
    failure_mode); ``dpp`` as in elastic3_c."""
    st = elastic3_c(bulkm, shearm, de, s, dpp)
    (pmin, pmid, pmax), (v0, v1, v2) = eigh3_c(*st)

    a1 = bulkm + 4.0 / 3.0 * shearm
    a2 = bulkm - 2.0 / 3.0 * shearm

    fs = pmin - pmax * anphi + amc
    ft = pmax - ten_max
    no_fail = (fs > 0.0) & (ft < 0.0)

    pa = torch.sqrt(1.0 + anphi * anphi) + anphi
    ps = ten_max * anphi - amc
    h = pmax - ten_max + pa * (pmin - ps)
    shear_fail = h < 0.0

    alam_s = fs / (a1 - a2 * anpsi + a1 * anphi * anpsi - a2 * anphi
                   + 2.0 * torch.sqrt(anphi) * hardn)
    alam_t = ft / a1
    alam = torch.where(shear_fail, alam_s, alam_t)

    dpls_shear = torch.abs(alam) * torch.sqrt(
        (7.0 + 4.0 * anpsi + 7.0 * anpsi * anpsi) / 18.0)
    dpls_tens = torch.abs(alam) * math.sqrt(7.0 / 18.0)
    depls = torch.where(no_fail, 0.0,
                        torch.where(shear_fail, dpls_shear, dpls_tens))

    d_min = torch.where(shear_fail, alam * (a1 - a2 * anpsi), alam * a2)
    d_mid = torch.where(shear_fail, alam * (a2 - a2 * anpsi), alam * a2)
    d_max = torch.where(shear_fail, alam * (a2 - a1 * anpsi), alam * a1)
    p_new = (pmin - d_min, pmid - d_mid, pmax - d_max)

    # rotate back: s_ab = sum_k p_k v_k[a] v_k[b]
    vs = (v0, v1, v2)

    def rec(a, b):
        return (p_new[0] * vs[0][a] * vs[0][b] + p_new[1] * vs[1][a]
                * vs[1][b] + p_new[2] * vs[2][a] * vs[2][b])

    ret = (rec(0, 0), rec(1, 1), rec(2, 2), rec(0, 1), rec(0, 2),
           rec(1, 2))
    s_new = tuple(torch.where(no_fail, t, r) for t, r in zip(st, ret))
    zi = torch.zeros_like(fs, dtype=torch.int32)
    failure_mode = torch.where(no_fail, zi,
                               torch.where(shear_fail, zi + 10, zi + 1))
    return s_new, depls, failure_mode


def slip_rate3_c(s, vmean):
    """Slip rate of rate-and-state friction in 3D (rheology.cxx:151-194,
    the JAX package's ``slip_rate3``): the element-mean velocity
    ``vmean`` (3 columns) projected onto the two principal directions
    other than the one across the plane of maximum shear, from the
    principal frame of the stress ``s`` (6 columns)."""
    (p0, p1, p2), vs = eigh3_c(*s)
    tau1 = 0.5 * torch.abs(p2 - p1)
    tau2 = 0.5 * torch.abs(p2 - p0)
    tau3 = 0.5 * torch.abs(p1 - p0)
    # the JAX package's index of the largest tau (0, 1, 2 for tau1-3),
    # then its eigenvectors idx + 1 and idx + 2 (mod 3)
    pick1 = (tau2 >= tau1) & (tau2 >= tau3)
    pick2 = (~pick1) & (tau3 >= tau1) & (tau3 >= tau2)

    def sel(a, b, c):
        return torch.where(pick1, a, torch.where(pick2, b, c))

    d1 = tuple(sel(vs[2][k], vs[0][k], vs[1][k]) for k in range(3))
    d2 = tuple(sel(vs[0][k], vs[1][k], vs[2][k]) for k in range(3))
    m1 = vmean[0] * d1[0] + vmean[1] * d1[1] + vmean[2] * d1[2]
    m2 = vmean[0] * d2[0] + vmean[1] * d2[1] + vmean[2] * d2[2]
    return torch.sqrt(m1 * m1 + m2 * m2)
