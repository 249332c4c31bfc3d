"""The port's 2D generic step (ops/flat2d.py in its generic mode) against
the JAX package's generic step (simulation.make_step_fn), on the CPU, in
float64, each from the JAX initial state.

The JAX package takes its generic step in 2D for the plastic rheologies
without ``is_plane_strain`` (the principal-axes return map) and under
DES_NO_FLAT.  The port computes it as the column step with the generic
step's choices where the two JAX steps differ: the cases below cover each
of them (the return map, the pseudo-mass scaled by this step's velocity
maximum, the fluid-filled density of the hydraulic mass and facet loads,
the pore-pressure update after the force assembly, the pseudo-transient
loop).  Tolerance 1e-10 of each field's max, as the flat cases.
"""

import jax
import numpy as np
import pytest

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.simulation import make_step_fn
from dynearthsol_tpu_torch.ops import rheology as tR
from dynearthsol_tpu_torch.state import (FIELD_NAMES, state_from_numpy,
                                         state_to_numpy)
from torch_cases import FLAT_FIELDS, flat_cfg, rel_err

HYD = {"porosity": [0.1], "hydraulic_perm": [1e-15],
       "fluid_bulk_modulus": [2.2e9], "biot_coeff": [0.8]}

# (config, steps, DES_NO_FLAT, extra fields)
CASES = {
    # the evp-winkler-2d golden's feature set on the Delaunay box
    "evp_principal_axes_winkler_surface1": (flat_cfg(
        mat={"is_plane_strain": False},
        bc={"has_winkler_foundation": True, "winkler_delta_rho": 100.0},
        control={"surface_process_option": 1,
                 "surface_diffusivity": 1e-6}), 10, False,
        ("dhacc", "edvacc_surf")),
    "ep_principal_axes_hydraulic_dynamic_winkler": (flat_cfg(
        "elasto-plastic", mat={"is_plane_strain": False, **HYD},
        control={"has_hydraulic_diffusion": True,
                 "is_quasi_static": False},
        bc={"has_winkler_foundation": True, "winkler_delta_rho": 100.0}),
        5, False, ("ppressure", "dppressure", "old_mean_stress",
                   "hydro_diff_max")),
    "maxwell_no_flat_hydraulic_global_velocity_scaling": (flat_cfg(
        "maxwell", mat=HYD,
        control={"has_hydraulic_diffusion": True,
                 "use_global_velocity_scaling": True}), 3, True,
        ("ppressure", "old_mean_stress", "hydro_diff_max")),
    "evp_principal_axes_pseudo_transient": (flat_cfg(
        mat={"is_plane_strain": False},
        control={"has_PT": True, "PT_max_iter": 8,
                 "PT_relative_tolerance": 1e-12}), 4, False, ()),
}


@pytest.mark.parametrize("case", list(CASES))
def test_f64_matches_jax_generic(case, monkeypatch):
    cfg, n, no_flat, extra = CASES[case]
    if no_flat:
        monkeypatch.setenv("DES_NO_FLAT", "1")
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    js._chunk_fn(n)
    assert js.step_path == "generic"
    step = jax.jit(make_step_fn(js.param, js.compensation_pressure))
    ref = js.state
    for _ in range(n):
        ref = step(js.ctx, ref)
    s0 = state_from_numpy({f: np.asarray(getattr(js.state, f))
                           for f in FIELD_NAMES}, dtype=ts.dtype)
    out = state_to_numpy(ts._chunk_fn(n)(ts.ctx, s0))
    assert ts.step_path == "generic"
    for f in FLAT_FIELDS + extra:
        err = rel_err(np.asarray(getattr(ref, f)), out[f])
        assert err < 1e-10, (f, err)
    if "dppressure" not in extra and "ppressure" in extra:
        d = np.abs(np.asarray(ref.dppressure) - out["dppressure"]).max()
        assert d <= 1e-10 * np.abs(out["ppressure"]).max()


def test_principal_axes_return_map_on_one_input():
    """elasto_plastic2_c against the JAX package's elasto_plastic (NSTR
    3) on trial stresses that take every branch: elastic, shear and
    tensile failure, with and without the Biot increment."""
    import jax.numpy as jnp
    import torch

    from dynearthsol_tpu.ops import rheology as jR

    rng = np.random.default_rng(2)
    n = 4000
    bulkm = rng.uniform(2e10, 6e10, n)
    shearm = rng.uniform(1e10, 4e10, n)
    amc = rng.uniform(0.0, 1e8, n)
    anphi = rng.uniform(1.0, 4.0, n)
    anpsi = rng.uniform(1.0, 1.5, n)
    hardn = rng.uniform(-1e8, 0.0, n)
    ten_max = rng.uniform(0.0, 1e7, n)
    de = rng.normal(0.0, 1e-3, (n, 3))
    s = rng.normal(0.0, 1e8, (n, 3))
    dpp = rng.normal(0.0, 1e6, n)
    t = torch.as_tensor
    for d in (None, dpp):
        want = jR.elasto_plastic(bulkm, shearm, amc, anphi, anpsi, hardn,
                                 ten_max, jnp.asarray(de), jnp.asarray(s),
                                 d)
        got = tR.elasto_plastic2_c(
            t(bulkm), t(shearm), t(amc), t(anphi), t(anpsi), t(hardn),
            t(ten_max), tuple(t(de[:, i]) for i in range(3)),
            tuple(t(s[:, i]) for i in range(3)),
            None if d is None else t(d))
        modes = np.asarray(want[2])
        assert set(modes.tolist()) == {0, 1, 10}
        np.testing.assert_array_equal(modes, got[2].numpy())
        ws = np.asarray(want[0])
        gs = torch.stack(got[0], dim=1).numpy()
        assert np.abs(ws - gs).max() <= 1e-13 * np.abs(ws).max()
        assert np.abs(np.asarray(want[1]) - got[1].numpy()).max() \
            <= 1e-13 * np.abs(np.asarray(want[1])).max()
