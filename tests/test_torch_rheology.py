"""The port's plain 2D constitutive cores and material mixers against the
JAX package's (ops/rheology.py *2_c, ops/pallas_common.py), on 4096 seeded
samples.  Tolerances relative to each output's max: 1e-12 in f64, 1e-6 in
f32 (association and libm differences); viscosity is compared in log space
because the creep law exponentiates an O(50) argument."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.ops import matprops as JM
from dynearthsol_tpu.ops import pallas_common as JPC
from dynearthsol_tpu.ops import rheology as JR
from dynearthsol_tpu_torch.ops import fused_common as FC
from dynearthsol_tpu_torch.ops import matprops as TM
from dynearthsol_tpu_torch.ops import rheology as TR
from torch_cases import make_sim_cfg, rel_err

N = 4096
DTYPES = {"f64": (np.float64, torch.float64, 1e-12),
          "f32": (np.float32, torch.float32, 1e-6)}


def _inputs(np_dtype):
    r = np.random.default_rng(1234)

    def u(lo, hi):
        return r.uniform(lo, hi, N).astype(np_dtype)

    return {
        "bulkm": u(30e9, 80e9), "shearm": u(20e9, 50e9),
        "visc": 10.0 ** u(19, 24), "dt": np_dtype(3e10), "dv": u(-1e-5, 1e-5),
        "de": [r.normal(0, 1e-4, N).astype(np_dtype) for _ in range(3)],
        "s": [r.normal(0, 1e8, N).astype(np_dtype) for _ in range(3)],
        "syy": r.normal(0, 1e8, N).astype(np_dtype),
        "amc": u(1e6, 1e8), "anphi": u(1.5, 4.0), "anpsi": u(1.0, 1.5),
        "hardn": u(-1e7, 0.0), "ten_max": u(1e6, 1e7),
    }


def _run_core(name, mod, arr, x):
    k, g = arr(x["bulkm"]), arr(x["shearm"])
    de, s = tuple(map(arr, x["de"])), tuple(map(arr, x["s"]))
    if name == "elastic2":
        return mod.elastic2_c(k, g, de, s)
    if name == "maxwell2":
        return mod.maxwell2_c(k, g, arr(x["visc"]), x["dt"], arr(x["dv"]),
                              de, s)
    if name == "viscous2":
        return mod.viscous2_c(k, arr(x["visc"]), arr(x["dv"]), de)
    out, syy, depls, _ = mod.elasto_plastic2d_c(
        k, g, arr(x["amc"]), arr(x["anphi"]), arr(x["anpsi"]),
        arr(x["hardn"]), arr(x["ten_max"]), de, s, arr(x["syy"]))
    return (*out, syy, depls)


def _tables(np_dtype, t_dtype):
    cfg = make_sim_cfg(mat={
        "nmat": 2, "rho0": [2800.0, 3300.0],
        "bulk_modulus": [50e9, 80e9], "shear_modulus": [30e9, 48e9],
        "visc_exponent": [3.05, 3.5], "visc_coefficient": [1.25e-1, 7e4],
        "visc_activation_energy": [3.76e5, 5.3e5],
        "visc_activation_volume": [0.0, 1e-5],
        "pls0": [0.0, 0.1], "pls1": [0.1, 0.5],
        "cohesion0": [4e7, 3e7], "cohesion1": [4e6, 1e6],
        "friction_angle0": [30.0, 25.0], "friction_angle1": [15.0, 5.0],
        "dilation_angle0": [0.0, 5.0], "dilation_angle1": [0.0, 0.0]})
    param = jdes.param_from_dict(cfg)
    jtab = JM.MatTables.from_param(param.mat, dtype=jnp.dtype(np_dtype))
    ttab = TM.MatTables.from_param(tdes.param_from_dict(cfg).mat,
                                   dtype=t_dtype)
    return JPC.np_tab(jtab), ttab


@pytest.mark.parametrize("dt", list(DTYPES))
def test_mixers_match_jax(dt):
    np_dtype, t_dtype, tol = DTYPES[dt]
    tabn, ttab = _tables(np_dtype, t_dtype)
    r = np.random.default_rng(99)
    w = [r.integers(0, 5, N).astype(np_dtype) for _ in range(2)]
    w[0][w[0] + w[1] == 0] = 1
    Tm = r.uniform(300.0, 1600.0, N).astype(np_dtype)
    s0 = r.normal(0, 1e8, N).astype(np_dtype)
    ed = (10.0 ** r.uniform(-18, -12, N)).astype(np_dtype)
    pls = r.uniform(0.0, 0.6, N).astype(np_dtype)
    jdt = jnp.dtype(np_dtype)
    visc_j = JPC.make_visc_core_local(tabn, 2, jdt, tabn.visc_min,
                                      tabn.visc_max)(
        [jnp.asarray(a) for a in w], jnp.asarray(Tm), jnp.asarray(s0),
        jnp.asarray(ed))
    pp_j = JPC.make_plastic_props_local(tabn, 2, jdt, tabn.tension_max)(
        [jnp.asarray(a) for a in w], jnp.asarray(pls))

    mc = FC.mat_consts(ttab.host())
    tw = [torch.as_tensor(a) for a in w]
    visc_t = FC.visc_core_local(mc, tw, torch.as_tensor(Tm),
                                torch.as_tensor(s0), torch.as_tensor(ed),
                                ttab.visc_min, ttab.visc_max)
    pp_t = FC.plastic_props_local(mc, tw, torch.as_tensor(pls),
                                  ttab.tension_max)
    assert visc_t.dtype == t_dtype
    lv_j = np.log(np.asarray(visc_j, np.float64))
    lv_t = np.log(visc_t.numpy().astype(np.float64))
    assert np.abs(lv_j - lv_t).max() <= tol * np.abs(lv_j).max()
    for a, b in zip(pp_j, pp_t):
        assert rel_err(a, b.numpy()) <= tol


def check_core_matches_jax(name, dt):
    np_dtype, t_dtype, tol = DTYPES[dt]
    x = _inputs(np_dtype)
    ref = _run_core(name, JR, jnp.asarray, x)
    out = _run_core(name, TR, lambda a: torch.as_tensor(a), x)
    for a, b in zip(ref, out):
        assert b.dtype == t_dtype
        assert rel_err(a, b.numpy()) <= tol
