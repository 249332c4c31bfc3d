"""The port's analytic utilities (dynearthsol_tpu_torch/utils/geotherm.py,
gravity.py, terrigenous.py) against the JAX package's on the CPU, in
float64, on inputs drawn from a numpy seed.

Tolerances: 1e-12 of each result's max |value|.  The functions are the
same arithmetic in PyTorch; erf, exp and the sums over elements (gravity,
summed in blocks of points here) round apart from numpy's by a few ulps.
The layered geotherm is also held against the port's own initial
temperature (ic.initial_temperature, temperature_option 2) at 1e-9 K, as
tests/test_config.py holds the JAX pair, on a config written here: the
reference's test-geotherm.cfg is not in the repository.
"""

import numpy as np
import pytest
import torch

import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.utils import geotherm as jgeo
from dynearthsol_tpu.utils import gravity as jgrav
from dynearthsol_tpu.utils import terrigenous as jterr
from dynearthsol_tpu_torch import ic
from dynearthsol_tpu_torch.mesh.generate import create_new_mesh
from dynearthsol_tpu_torch.utils import geotherm, gravity, terrigenous
from torch_cases import rel_err, write_cfg

TOL = 1e-12


def _np(t):
    assert t.dtype == torch.float64 and t.device.type == "cpu"
    return t.numpy()


@pytest.fixture(scope="module")
def topo_mesh():
    """A 2D box mesh (12 x 6 cells of 1 km) whose nodes are moved by up to
    a third of a cell, the top lifted above sea level in places; element
    densities, and 41 observation points 1 km above the surface."""
    rng = np.random.default_rng(17)
    p = tdes.param_from_dict({
        "sim": {"ndims": 2},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": 12e3, "zlength": 6e3, "resolution": 1e3}})
    m = create_new_mesh(p)
    coord = m.coord + rng.uniform(-330.0, 330.0, m.coord.shape)
    coord[:, 1] += 800.0 * np.sin(coord[:, 0] / 2e3)
    rho = rng.uniform(2400.0, 3300.0, m.connectivity.shape[0])
    pts = np.column_stack([np.linspace(-3e3, 15e3, 41), np.full(41, 2e3)])
    return pts, coord, m.connectivity, rho


def test_geotherm_against_jax():
    rng = np.random.default_rng(3)
    z = rng.uniform(0.0, 120e3, 2000)
    a = jgeo.half_space_cooling_T(z, 273.0, 1600.0, 30.0, 1e-6)
    assert rel_err(a, _np(geotherm.half_space_cooling_T(
        z, 273.0, 1600.0, 30.0, 1e-6, device="cpu"))) < TOL
    a = jgeo.continental_radiogenic_T(z, 273.0, 1e4, 2.5, 0.03, 2e-6)
    assert rel_err(a, _np(geotherm.continental_radiogenic_T(
        z, 273.0, 1e4, 2.5, 0.03, 2e-6, device="cpu"))) < TOL
    args = (273.0, 1600.0, [0.0, 15e3, 35e3, 100e3], [2.5, 2.9, 3.3],
            [2.6e-6, 1e-6, 1e-8], 1e4)
    ta, qa = jgeo.layered_radiogenic_T(z, *args)
    tb, qb = geotherm.layered_radiogenic_T(torch.as_tensor(z), *args)
    assert rel_err(ta, _np(tb)) < TOL
    assert abs(qa - float(qb)) <= TOL * abs(qa)


def test_gravity_against_jax(topo_mesh):
    pts, coord, conn, rho = topo_mesh
    assert rel_err(jgrav.elem_area(coord[conn]), _np(gravity.elem_area(
        torch.as_tensor(coord[conn])))) < TOL
    cen = coord[conn].mean(axis=1)
    assert (cen[:, 1] > 0).any()  # the Bouguer slab term is exercised
    for name in ("freeair", "bouguer"):
        a = getattr(jgrav, name)(pts, coord, conn, rho)
        b = getattr(gravity, name)(pts, coord, conn, rho, device="cpu")
        assert rel_err(a, _np(b)) < TOL, name


def test_freeair_over_more_points_than_one_block(topo_mesh, monkeypatch):
    """41 points in blocks of 6 and of 2 (pair budgets of six and two
    points' pairs): the same sums as one block, and the JAX package's."""
    pts, coord, conn, rho = topo_mesh
    whole = _np(gravity.freeair(pts, coord, conn, rho, device="cpu"))
    assert gravity.BLOCK_PAIRS // conn.shape[0] >= len(pts)
    monkeypatch.setattr(gravity, "BLOCK_PAIRS", 6 * conn.shape[0] + 1)
    b = _np(gravity.freeair(pts, coord, conn, rho, device="cpu"))
    monkeypatch.setattr(gravity, "BLOCK_PAIRS", 2 * conn.shape[0] + 1)
    c = _np(gravity.bouguer(pts, coord, conn, rho, device="cpu"))
    assert np.array_equal(b, whole)
    assert rel_err(jgrav.freeair(pts, coord, conn, rho), b) < TOL
    assert rel_err(jgrav.bouguer(pts, coord, conn, rho), c) < TOL


@pytest.mark.parametrize("is_strip", [False, True])
def test_terrig_against_jax(is_strip):
    """A profile that dips below sea level, rises above it and dips again:
    both the wet nodes' divergence and the strip's running minimum and
    cut."""
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(0.0, 60e3, 300))
    z = 900.0 * np.sin(x / 7e3) - 400.0 + rng.normal(0.0, 20.0, x.size)
    a = jterr.terrig(x, z, 2e-3, 5e-3, 4e-4, is_strip)
    b = terrigenous.terrig(x, z, 2e-3, 5e-3, 4e-4, is_strip, device="cpu")
    assert (a != 0).any() and (a == 0).any()
    assert rel_err(a, _np(b)) < TOL


def test_layered_geotherm_against_initial_temperature(tmp_path):
    """temperature_option 2 with three radiogenic layers of two materials:
    the port's initial temperature equals its analytic layered geotherm
    (tests/test_config.py:100-128 for the JAX package)."""
    cfg = {
        "sim": {"ndims": 2, "modelname": "geotherm"},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": 20e3, "zlength": 60e3, "resolution": 2e3},
        "bc": {"surface_temperature": 273.0, "mantle_temperature": 1600.0},
        "ic": {"temperature_option": 2, "num_radiogenic_heat_layer": 3,
               "radiogenic_heat_boundry": [0.0, 12e3, 30e3, 60e3],
               "radiogenic_heat_mat_in_layer": [0, 0, 1],
               "radiogenic_folding_depth": 8e3},
        "mat": {"rheology_type": "maxwell", "num_materials": 2,
                "rho0": [2700.0, 3300.0], "therm_cond": [2.4, 3.3],
                "radiogenic_heat_prod": [9e-10, 2e-12],
                "bulk_modulus": [50e9, 80e9], "shear_modulus": [30e9, 48e9],
                "visc_max": 1e24, "visc_min": 1e19},
    }
    write_cfg(tmp_path / "geotherm.cfg", cfg)
    p = tdes.load_config(str(tmp_path / "geotherm.cfg"))
    coord = create_new_mesh(p).coord
    t = ic.initial_temperature(p, coord)
    mats = p.ic.radiogenic_heat_mat_in_layer
    k = [p.mat.therm_cond[m] for m in mats]
    rh = [p.mat.radiogenic_heat_prod[m] * p.mat.rho0[m] for m in mats]
    ta, _ = geotherm.layered_radiogenic_T(
        -coord[:, 1], p.bc.surface_temperature, p.bc.mantle_temperature,
        p.ic.radiogenic_heat_boundry, k, rh, p.ic.radiogenic_folding_depth,
        device="cpu")
    assert np.ptp(t) > 1000.0
    assert np.abs(t - _np(ta)).max() < 1e-9


def test_default_device_is_the_card():
    """Without ``device`` and without a tensor argument, the card: on a
    machine without one the helpers raise, as Simulation does."""
    z = np.linspace(0.0, 1e4, 5)
    if torch.cuda.is_available():
        t = geotherm.half_space_cooling_T(z, 273.0, 1600.0, 30.0, 1e-6)
        assert t.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            geotherm.half_space_cooling_T(z, 273.0, 1600.0, 30.0, 1e-6)
    # a tensor argument keeps its device
    t = terrigenous.terrig(torch.as_tensor(z), torch.as_tensor(-z), 1e-3,
                           1e-2, 1e-3)
    assert t.device.type == "cpu"
