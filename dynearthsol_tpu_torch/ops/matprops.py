"""Marker-weighted material property evaluation (counterpart of
dynearthsol_tpu/ops/matprops.py).

Reference: MatProps (matprops.cxx).  Material properties are mixtures of
per-material constants weighted by the per-element marker histogram
``emw`` (nelem, nmat): harmonic means for moduli (matprops.cxx:246-255),
arithmetic means for rho/cp/k (matprops.cxx:565-599) and harmonic mixing of
dislocation-creep viscosities (matprops.cxx:258-300).  The fused step mixes
in-kernel (ops/fused_common.py, csrc/rheology2d.cuh); these are the
host-called forms used at initialisation and for the per-chunk constants.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import numpy as np
import torch

from .tensor import second_invariant, trace

GAS_CONSTANT = 8.3144
MIN_STRAIN_RATE = 1e-30
CELSIUS0 = 273.0
DEG2RAD = math.pi / 180.0

_SCALARS = ("visc_min", "visc_max", "tension_max", "therm_diff_max")


@dataclass(frozen=True)
class MatTables:
    """Static per-material constant tables, shape (nmat,) each, in the
    run's float dtype on the run's device; the four bounds stay Python
    floats."""

    rho0: torch.Tensor
    alpha: torch.Tensor
    bulk_modulus: torch.Tensor
    shear_modulus: torch.Tensor
    visc_exponent: torch.Tensor
    visc_coefficient: torch.Tensor
    visc_activation_energy: torch.Tensor
    visc_activation_volume: torch.Tensor
    heat_capacity: torch.Tensor
    therm_cond: torch.Tensor
    pls0: torch.Tensor
    pls1: torch.Tensor
    cohesion0: torch.Tensor
    cohesion1: torch.Tensor
    friction_angle0: torch.Tensor
    friction_angle1: torch.Tensor
    dilation_angle0: torch.Tensor
    dilation_angle1: torch.Tensor
    porosity: torch.Tensor
    fluid_bulk_modulus: torch.Tensor
    biot_coeff: torch.Tensor
    visc_min: float
    visc_max: float
    tension_max: float
    therm_diff_max: float

    @staticmethod
    def from_param(mat, dtype=torch.float64, device="cpu") -> "MatTables":
        kw = {}
        for f in fields(MatTables):
            v = getattr(mat, f.name)
            if f.name in _SCALARS:
                kw[f.name] = float(v)
            else:
                kw[f.name] = torch.as_tensor(
                    np.asarray(v, dtype=np.float64), dtype=dtype,
                    device=device)
        return MatTables(**kw)

    def host(self) -> dict:
        """Tables as host numpy arrays in the run's dtype (the values the
        kernels embed as constants), bounds as floats."""
        return {f.name: (getattr(self, f.name) if f.name in _SCALARS
                         else getattr(self, f.name).cpu().numpy())
                for f in fields(self)}


def harmonic_mean(values: torch.Tensor, emw: torch.Tensor) -> torch.Tensor:
    """(nmat,), (..., nmat) -> (...,).  matprops.cxx:131-144."""
    if values.shape[0] == 1:
        return values[0].expand(emw.shape[:-1])
    n = emw.sum(dim=-1)
    return n / (emw / values).sum(dim=-1)


def arithmetic_mean(values: torch.Tensor, emw: torch.Tensor) -> torch.Tensor:
    """matprops.cxx:115-129."""
    if values.shape[0] == 1:
        return values[0].expand(emw.shape[:-1])
    return (emw * values).sum(dim=-1) / emw.sum(dim=-1)


def bulkm(tab: MatTables, emw) -> torch.Tensor:
    return harmonic_mean(tab.bulk_modulus, emw)


def shearm(tab: MatTables, emw) -> torch.Tensor:
    return harmonic_mean(tab.shear_modulus, emw)


def elem_temperature(temperature, conn) -> torch.Tensor:
    """Element-average temperature (matprops.cxx:566-575)."""
    T = temperature[conn]
    acc = T[:, 0]
    for c in range(1, T.shape[1]):
        acc = acc + T[:, c]
    return acc / float(T.shape[1])


def rho(tab: MatTables, emw, temperature, conn) -> torch.Tensor:
    """rho0 * (1 - alpha*(T - 273C)) mixture (matprops.cxx:565-587)."""
    return rho_from_T(tab, emw, elem_temperature(temperature, conn))


def rho_from_T(tab: MatTables, emw, T) -> torch.Tensor:
    """rho mixture from element-mean temperature; emw (..., nmat), T (...)."""
    TinC = T - CELSIUS0
    per_mat = tab.rho0 * (1.0 - tab.alpha * TinC[..., None])
    return (per_mat * emw).sum(dim=-1) / emw.sum(dim=-1)


def cp(tab: MatTables, emw) -> torch.Tensor:
    return arithmetic_mean(tab.heat_capacity, emw)


def therm_cond(tab: MatTables, emw) -> torch.Tensor:
    return arithmetic_mean(tab.therm_cond, emw)


def phi_porosity(tab: MatTables, emw) -> torch.Tensor:
    return arithmetic_mean(tab.porosity, emw)


def alpha_biot(tab: MatTables, emw) -> torch.Tensor:
    return arithmetic_mean(tab.biot_coeff, emw)


def beta_fluid(tab: MatTables, emw) -> torch.Tensor:
    return harmonic_mean(1.0 / tab.fluid_bulk_modulus, emw)


def visc(tab: MatTables, emw, temperature, conn, stress, strain_rate
         ) -> torch.Tensor:
    """Dislocation-creep viscosity, Chen & Morgan JGR 1990
    (matprops.cxx:258-300), harmonic mixture, clamped to
    [visc_min, visc_max]."""
    T = elem_temperature(temperature, conn)
    s0 = trace(stress) / (2.0 if stress.shape[-1] == 3 else 3.0)
    edot = torch.clamp(second_invariant(strain_rate), min=MIN_STRAIN_RATE)
    return visc_core(tab, emw, T, s0, edot)


def visc_core(tab: MatTables, emw, T, s0, edot) -> torch.Tensor:
    """Creep viscosity from element-mean T, mean stress s0 and strain-rate
    invariant edot; all (...) shaped, emw (..., nmat)."""
    pw = 1.0 / tab.visc_exponent - 1.0  # (nmat,)
    pw1 = -1.0 / tab.visc_exponent
    log_edot = torch.log(edot)
    log_coef = torch.log(0.75 * tab.visc_coefficient)
    expo = ((tab.visc_activation_energy
             + tab.visc_activation_volume * s0[..., None])
            / (tab.visc_exponent * GAS_CONSTANT * T[..., None]))
    log_visc0 = (math.log(0.25) + pw * log_edot[..., None]
                 + pw1 * log_coef + expo + math.log(1e6))
    inv_visc0 = torch.exp(-log_visc0)
    v = emw.sum(dim=-1) / (emw * inv_visc0).sum(dim=-1)
    return torch.clamp(v, tab.visc_min, tab.visc_max)


def plastic_weakening(tab: MatTables, emw, pls):
    """Weight-averaged cohesion/friction/dilation/hardening with linear
    strain softening between pls0 and pls1 (matprops.cxx:303-341).

    pls: (...) accumulated plastic strain; emw (..., nmat).
    Returns (cohesion, friction_angle, dilation_angle, hardening), each (...).
    """
    pls_m = pls[..., None]
    span = torch.clamp(tab.pls1 - tab.pls0, min=1e-300)
    p = torch.clamp((pls_m - tab.pls0) / span, 0.0, 1.0)
    c_m = tab.cohesion0 + p * (tab.cohesion1 - tab.cohesion0)
    f_m = tab.friction_angle0 + p * (tab.friction_angle1
                                     - tab.friction_angle0)
    d_m = tab.dilation_angle0 + p * (tab.dilation_angle1
                                     - tab.dilation_angle0)
    in_weakening = (pls_m >= tab.pls0) & (pls_m < tab.pls1)
    h_m = torch.where(in_weakening,
                      ((tab.cohesion1 - tab.cohesion0) / span).expand_as(p),
                      torch.zeros_like(p))
    n = emw.sum(dim=-1)
    cohesion = (c_m * emw).sum(dim=-1) / n
    friction = (f_m * emw).sum(dim=-1) / n
    dilation = (d_m * emw).sum(dim=-1) / n
    hardening = (h_m * emw).sum(dim=-1) / n
    return cohesion, friction, dilation, hardening


def plastic_props(tab: MatTables, emw, pls):
    """Mohr-Coulomb derived quantities (matprops.cxx:512-530):
    amc = 2 c sqrt(anphi); anphi/anpsi from friction/dilation angles;
    ten_max = min(tension_max, c/tan(phi)) (or tension_max at phi=0)."""
    cohesion, phi, psi, hardn = plastic_weakening(tab, emw, pls)
    sphi = torch.sin(phi * DEG2RAD)
    spsi = torch.sin(psi * DEG2RAD)
    anphi = (1.0 + sphi) / (1.0 - sphi)
    anpsi = (1.0 + spsi) / (1.0 - spsi)
    amc = 2.0 * cohesion * torch.sqrt(anphi)
    tanphi = torch.tan(phi * DEG2RAD)
    safe_tan = torch.where(tanphi == 0.0, torch.ones_like(tanphi), tanphi)
    ten_max = torch.where(phi == 0.0,
                          torch.full_like(phi, tab.tension_max),
                          torch.clamp(cohesion / safe_tan,
                                      max=tab.tension_max))
    return amc, anphi, anpsi, hardn, ten_max
