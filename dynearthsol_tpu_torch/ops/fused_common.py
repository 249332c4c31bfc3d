"""Material mixers of the fused step (counterpart of
dynearthsol_tpu/ops/pallas_common.py).

The matprops.cxx:115-144 histogram mixing with the material axis as a
Python loop over per-material constants.  The constants are taken from the
run-dtype material tables and combined in float64 exactly as the JAX
package combines them, then each enters the f32 arithmetic once; the CUDA
kernel receives the same float64 values and rounds them the same way
(csrc/rheology2d.cuh ``MatConst``), so the plain and CUDA mixers see
identical constants.
"""

from __future__ import annotations

import numpy as np
import torch

from .matprops import GAS_CONSTANT

DEG2RAD = np.pi / 180.0
LOG_QUARTER = float(np.log(0.25))
LOG_1E6 = float(np.log(1e6))

# order of the per-material constants (MatConst in csrc/rheology2d.cuh)
MAT_FIELDS = ("pw", "pw1_logc", "ea", "va", "nr", "pls0", "pls1", "span",
              "c0", "dc", "f0", "df", "d0", "dd", "hslope")


# dt_refresh parameters shared by the 2D and 3D plans (csrc/fused2d.cu
# RefreshParams): integer switches, then float64 constants
RIP_FIELDS = ("thermal", "use_gvs", "quasi_static", "fixed_on")
RFP_FIELDS = ("big", "max_vbc", "fixed_dt", "tdmax", "inertial", "swave_ref",
              "ps", "frac")


def refresh_params(sw: dict, k: dict):
    """(rip int32, rfp float64) host arrays of the dt_refresh kernel from a
    plan's switches and constants."""
    return (np.array([sw[f] for f in RIP_FIELDS], dtype=np.int32),
            np.array([k[f] for f in RFP_FIELDS], dtype=np.float64))


def mat_consts(tabn: dict) -> list:
    """Per-material float64 constants from host tables (MatTables.host())."""
    out = []
    for m in range(int(np.asarray(tabn["rho0"]).shape[0])):
        n = float(tabn["visc_exponent"][m])
        log_coef = float(np.log(0.75 * tabn["visc_coefficient"][m]))
        pls0 = float(tabn["pls0"][m])
        pls1 = float(tabn["pls1"][m])
        span = max(pls1 - pls0, 1e-300)
        c0 = float(tabn["cohesion0"][m])
        c1 = float(tabn["cohesion1"][m])
        f0 = float(tabn["friction_angle0"][m])
        d0 = float(tabn["dilation_angle0"][m])
        out.append({
            "pw": 1.0 / n - 1.0, "pw1_logc": (-1.0 / n) * log_coef,
            "ea": float(tabn["visc_activation_energy"][m]),
            "va": float(tabn["visc_activation_volume"][m]),
            "nr": n * GAS_CONSTANT,
            "pls0": pls0, "pls1": pls1, "span": span,
            "c0": c0, "dc": c1 - c0,
            "f0": f0, "df": float(tabn["friction_angle1"][m]) - f0,
            "d0": d0, "dd": float(tabn["dilation_angle1"][m]) - d0,
            "hslope": (c1 - c0) / span})
    return out


def visc_core_local(mc: list, w, Tm, s0, edot, visc_min: float,
                    visc_max: float):
    """visc_core (matprops.cxx:40-77) with the material axis unrolled;
    ``w`` is a list of per-material weights (tensors, or [1.0])."""
    log_edot = torch.log(edot)
    acc = torch.zeros_like(Tm)
    wsum = torch.zeros_like(Tm)
    for m, c in enumerate(mc):
        expo = (c["ea"] + c["va"] * s0) / (c["nr"] * Tm)
        log_v0 = (LOG_QUARTER + c["pw"] * log_edot + c["pw1_logc"] + expo
                  + LOG_1E6)
        acc = acc + w[m] * torch.exp(-log_v0)
        wsum = wsum + w[m]
    return torch.clamp(wsum / acc, visc_min, visc_max)


def plastic_props_local(mc: list, w, pls, tension_max: float):
    """plastic_props / plastic_weakening (matprops.cxx:432-530), material
    axis unrolled; returns (amc, anphi, anpsi, hardening, ten_max)."""
    c = f = d = h = wsum = None
    zero = torch.zeros_like(pls)
    for m, k in enumerate(mc):
        p = torch.clamp((pls - k["pls0"]) / k["span"], 0.0, 1.0)
        c_m = k["c0"] + p * k["dc"]
        f_m = k["f0"] + p * k["df"]
        d_m = k["d0"] + p * k["dd"]
        in_w = (pls >= k["pls0"]) & (pls < k["pls1"])
        h_m = torch.where(in_w, torch.full_like(pls, k["hslope"]), zero)
        if c is None:
            c, f, d, h = w[m] * c_m, w[m] * f_m, w[m] * d_m, w[m] * h_m
            wsum = w[m] + 0.0 * c_m
        else:
            c = c + w[m] * c_m
            f = f + w[m] * f_m
            d = d + w[m] * d_m
            h = h + w[m] * h_m
            wsum = wsum + w[m]
    c, f, d, h = c / wsum, f / wsum, d / wsum, h / wsum
    sphi = torch.sin(f * DEG2RAD)
    spsi = torch.sin(d * DEG2RAD)
    anphi = (1.0 + sphi) / (1.0 - sphi)
    anpsi = (1.0 + spsi) / (1.0 - spsi)
    amc = 2.0 * c * torch.sqrt(anphi)
    tanphi = torch.tan(f * DEG2RAD)
    safe_tan = torch.where(tanphi == 0.0, torch.ones_like(tanphi), tanphi)
    ten_max = torch.where(f == 0.0, torch.full_like(f, tension_max),
                          torch.clamp(c / safe_tan, max=tension_max))
    return amc, anphi, anpsi, h, ten_max
