"""The port's 3D column step (ops/flat3d.py) against the JAX package's
flat3d, each package's chunk runner from the JAX initial state
(torch_cases.run_both), on the CPU at float64, on the Delaunay box of
tests/test_flat.py:97-118 (886 tets); then the 3D boundary functions
behind it on one input each, with no step built.

The configs are grouped to save JAX compiles and Simulations:
  maxwell over 15 steps with every boundary term at once: the Winkler
    foundation, water loading (base level raised to 10 m), a free y1
    wall (lithostatic side tractions), the elastic foundation, a Neumann
    traction on the top, surface process 1 with the surface correction;
  EVP over 3 steps with the same terms, from the maxwell run's state, on
    its Simulations;
  EP with Biot hydraulic diffusion over 10 steps;
  EP with rate-and-state friction (tests/test_flat.py:283-324);
  the pseudo-transient loop with hydraulic diffusion;
  maxwell in float32 over 15 steps.

Tolerances, each of a field's max:
  f64 trajectories: 1e-10 (torch and XLA differ in exp/log/cos by ulps).
    Fields that are zero but for roundoff are judged at the scale of the
    field they are a part of, as tests/test_flat.py:158-163 judges them:
    dpressure (a difference of traces) at the stress's, dppressure (a
    per-step increment) at the pore pressure's, and in the RSF shear
    edvoldt at the strain rate's.
  EVP starts from the maxwell run's deformed state.  From rest, the
    elements whose corners have not moved tie exactly in the min-select
    of rheology.cxx:869-879 (both trial stresses isotropic, both
    invariants the rounding of their mean: 1 of the 886 at step 1), and
    XLA and PyTorch round them to different branches, each correct.  The
    cohesion (3e4 Pa, no friction) makes a few elements yield (7 in 3
    steps): with a quarter of them yielding (1e4 Pa), near-degenerate
    principal stresses carry the eigensolver's ulps to 3.7e-9 in one step.
    Under hydraulic diffusion the step is too short for the viscous
    relaxation to part the two trial stresses by more than their rounding
    (1e-7 after 3 steps), so EVP runs without it.
  f32: the maxwell gate of tests/test_pallas.py:91-106 (2e-4; see
    test_flat3d_float32_maxwell for the velocity maximum).
  The functions on one input: 1e-13.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu import bc as jbc
from dynearthsol_tpu.ops import flat3d as jflat3d
from dynearthsol_tpu.ops import surface as jSP
from dynearthsol_tpu_torch import bc as tbc
from dynearthsol_tpu_torch.ops import flat3d as tflat3d
from dynearthsol_tpu_torch.ops import surface as tSP
from dynearthsol_tpu_torch.state import (FIELD_NAMES, state_from_numpy,
                                         state_to_numpy)
from torch_cases import assert_maxwell_close, flat3d_cfg, rel_err, run_both

# tests/test_flat.py:147-165: the Biot material; a cohesion that lets a
# few elements yield under EVP (the module docstring)
HYD = {"porosity": [0.1], "hydraulic_perm": [1e-15],
       "fluid_bulk_modulus": [2.2e9], "biot_coeff": [0.8]}
WEAK = {"cohesion0": [3e4], "cohesion1": [3e4], "friction_angle0": [0.0],
        "friction_angle1": [0.0]}
HYD_FIELDS = ("ppressure", "dppressure", "old_mean_stress",
              "hydro_diff_max")
SURF_FIELDS = ("dhacc", "edvacc_surf")


def boundaries_cfg(rheology="maxwell"):
    """Every boundary term of the 3D column step in one config."""
    return flat3d_cfg(
        rheology,
        control={"surf_base_level": 10.0, "surface_process_option": 1,
                 "surface_diffusivity": 1e-6},
        bc={"has_winkler_foundation": True, "has_water_loading": True,
            "winkler_delta_rho": 100.0, "vbc_y1": 0,
            "has_elastic_foundation": True, "stress_bc_z1": 3,
            "stress_val_z1": -1e5},
        mat=dict(WEAK))


def rsf3d_cfg():
    """tests/test_flat.py:283-324: shear of a 1 m cube, no gravity, fixed
    dt, global velocity scaling."""
    return {
        "sim": {"ndims": 3, "float_dtype": "float64",
                "is_outputting_averaged_fields": False},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 0,
                 "xlength": 1.0, "ylength": 1.0, "zlength": 1.0,
                 "resolution": 1.0, "quality_check_step_interval": 10**8},
        "control": {"gravity": 0.0, "fixed_dt": 1.0,
                    "inertial_scaling": 1e5,
                    "use_global_velocity_scaling": True,
                    "damping_option": 1, "has_thermal_diffusion": False},
        "ic": {"weakzone_option": 0},
        "bc": {"vbc_x0": 1, "vbc_val_x0": 0.0, "vbc_x1": 1,
               "vbc_val_x1": 0.0, "vbc_y0": 1, "vbc_val_y0": 0.0,
               "vbc_y1": 1, "vbc_val_y1": 0.0, "vbc_z0": 1,
               "vbc_val_z0": 0.0, "vbc_z1": 4, "vbc_val_z1": 1e-5},
        "mat": {"rheology_type": "elasto-plastic-rate-state-friction",
                "is_plane_strain": False, "rho0": [1.0], "alpha": [0.0],
                "bulk_modulus": [2e8], "shear_modulus": [2e8],
                "cohesion0": [1e6], "cohesion1": [1e6],
                "friction_angle0": [30.0], "friction_angle1": [30.0],
                "direct_a": [0.2], "evolution_b": [0.1],
                "characteristic_distance": [1e-3],
                "characteristic_velocity": [1e-6], "state_var_model": 0},
    }


# (config, steps, extra fields, fields judged at another field's scale)
CASES = {
    "maxwell_boundaries": (boundaries_cfg(), 15, SURF_FIELDS, {}),
    "ep_hydraulic": (flat3d_cfg("elasto-plastic",
                                control={"has_hydraulic_diffusion": True},
                                mat=dict(HYD)), 10, HYD_FIELDS, {}),
    "ep_rsf": (rsf3d_cfg(), 20, ("dyn_fric_coeff", "state_variable"),
               {"edvoldt": "strain_rate"}),
    "pseudo_transient_hydraulic": (flat3d_cfg(
        control={"has_PT": True, "PT_max_iter": 6,
                 "PT_relative_tolerance": 1e-12,
                 "has_hydraulic_diffusion": True}, mat=dict(HYD)), 4,
        HYD_FIELDS, {}),
}
FIELDS = ("coord", "vel", "temperature", "stress", "strain", "strain_rate",
          "plstrain", "delta_plstrain", "viscosity", "volume",
          "volume_old", "volume_n", "mass", "tmass", "hmass", "ymass",
          "force", "edvoldt", "dpressure", "dt", "time",
          "max_global_vel_mag", "global_dt_min", "l2_residual")


def assert_match(ref, out, fields, scale_of=None, tol=1e-10):
    """Each field within tol of its max, or of the max of the field
    ``scale_of`` names for it: dpressure (a difference of traces) at the
    stress's, dppressure (a per-step increment) at the pore pressure's."""
    scale_of = {"dpressure": "stress", "dppressure": "ppressure",
                **(scale_of or {})}
    for f in fields:
        scale = np.abs(ref[scale_of.get(f, f)].astype(np.float64)).max()
        err = np.abs(ref[f].astype(np.float64)
                     - out[f].astype(np.float64)).max()
        assert err <= tol * max(scale, 1e-300), (f, err / scale)


@pytest.fixture(scope="module")
def runs():
    """Each case's (jax, torch) field dicts and Simulations, computed
    once."""
    return {}


def _run(runs, case):
    if case not in runs:
        cfg, n = CASES[case][:2]
        sims = {}
        runs[case] = run_both(cfg, n, sims=sims) + (sims,)
    return runs[case]


@pytest.mark.parametrize("case", list(CASES))
def test_flat3d_matches_jax(case, runs):
    ref, out, _ = _run(runs, case)
    _, _, extra, scale_of = CASES[case]
    assert_match(ref, out, FIELDS + extra, scale_of)
    if case == "maxwell_boundaries":
        assert np.abs(out["dhacc"]).max() > 0


def test_flat3d_evp_from_the_maxwell_state(runs):
    """EVP with every boundary term over 3 steps from the maxwell case's
    state, on its Simulations (the two configs differ in the rheology
    alone; see the module docstring): a few elements yield, and the
    min-select meets no tie of rounding."""
    mref, _, sims = _run(runs, "maxwell_boundaries")
    js, ts = sims["jax"], sims["torch"]
    cfg = boundaries_cfg("elasto-visco-plastic")
    s0 = dataclasses.replace(js.state, **{f: jnp.asarray(mref[f])
                                          for f in FIELD_NAMES})
    ref = jflat3d.make_chunk_runner(jdes.param_from_dict(cfg), js.ctx,
                                    js.compensation_pressure, 3)(js.ctx, s0)
    ref = {f: np.asarray(getattr(ref, f)) for f in FIELD_NAMES}
    run = tflat3d.make_chunk_runner(tdes.param_from_dict(cfg), ts.ctx,
                                    ts.compensation_pressure, 3)
    out = state_to_numpy(run(ts.ctx, state_from_numpy(mref,
                                                      dtype=torch.float64)))
    assert (out["delta_plstrain"] > 0).sum() >= 3
    assert_match(ref, out, FIELDS + SURF_FIELDS)


def test_flat3d_float32_maxwell():
    """The maxwell gate, but for the velocity maximum, a max over the
    velocity field, which takes the fields' 2e-4: over these 15 steps the
    JAX package's own float32 and float64 runs part by 2.4e-5 in it, and
    the two packages' float32 runs by 3.7e-5."""
    ref, out = run_both(flat3d_cfg(dtype="float32"), 15)
    assert out["stress"].dtype == np.float32
    assert_maxwell_close(ref, out, lambda d, f: d[f], vmax_tol=2e-4)


@pytest.fixture(scope="module")
def boundary_inputs(runs):
    """The boundary case's JAX Simulation, its coordinates moved by a
    seeded jitter of 50 m, a force and a density field."""
    js = _run(runs, "maxwell_boundaries")[2]["jax"]
    r = np.random.default_rng(5)
    coord0 = np.asarray(js.state.coord)
    coord = coord0 + r.uniform(-50.0, 50.0, coord0.shape)
    force = r.normal(0.0, 1e9, coord0.shape)
    rho = r.uniform(2700.0, 2900.0, js.topo.nelem)
    return js, coord, coord0, force, rho


def test_boundary_functions_3d_match_jax(boundary_inputs):
    """apply_stress_bcs (the three facet kinds and the elastic
    foundation) and apply_stress_bcs_neumann on triangle facets, then
    surface_dh_3d and the 3D branch of apply_surface_processes (the moved
    top and the facets' deposited volume)."""
    js, coord, coord0, force, rho = boundary_inputs
    spec = js.ctx.sbc
    kinds = set(np.asarray(spec.kind).tolist())
    assert kinds == {0, 1, 2} and spec.n_neu > 0
    tspec = tbc.StressBCSpec.from_topo(js.param, js.topo).on("cpu")
    t = torch.as_tensor
    ref = jax.jit(lambda *a: jbc.apply_stress_bcs(js.param, spec, *a))(
        jnp.asarray(coord), jnp.asarray(force), jnp.asarray(rho), 3e7,
        jnp.asarray(coord0))
    out = tbc.apply_stress_bcs(js.param, tspec, t(coord), t(force), t(rho),
                               3e7, t(coord0))
    assert rel_err(np.asarray(ref) - force, out.numpy() - force) <= 1e-13
    ref = jax.jit(lambda *a: jbc.apply_stress_bcs_neumann(spec, *a))(
        jnp.asarray(coord), jnp.asarray(force))
    out = tbc.apply_stress_bcs_neumann(tspec, t(coord), t(force))
    assert rel_err(np.asarray(ref) - force, out.numpy() - force) <= 1e-13

    ts = tSP.surf_tables(tSP.make_surf_info(js.topo), js.topo.nnode,
                         torch.float64, "cpu")
    dt = 3e10
    ref = jax.jit(lambda c: jSP.surface_dh_3d(c, js.ctx.surf, 1e-6, dt))(
        jnp.asarray(coord))
    out = tSP.surface_dh_3d(torch.as_tensor(coord), ts, 1e-6, dt)
    assert np.abs(np.asarray(ref)).max() > 0
    assert rel_err(ref, out.numpy()) <= 1e-13
    nn, ne = js.topo.nnode, js.ctx.surf.etop
    ref = jax.jit(lambda c: jSP.apply_surface_processes(
        js.param, js.ctx.surf, c, dt, jnp.zeros(nn), jnp.zeros(ne)))(
        jnp.asarray(coord))
    out = tSP.apply_surface_processes(js.param, ts, torch.as_tensor(coord),
                                      dt, torch.zeros(nn, dtype=torch.float64),
                                      torch.zeros(ne, dtype=torch.float64))
    for a, b in zip(ref, out):
        assert rel_err(a, b.numpy()) <= 1e-13
