"""The dome geotherm's marker flip and regularly spaced markers against the
JAX package's Simulation, on the CPU, bit for bit.

- temperature_option 3 (tests/test_poly.py test_dome_geotherm's config, in
  2D and in 3D): the markers inside the adiabatic region become
  asthenosphere (ic.cxx:820-830; JAX simulation.py:783-795); the same
  markers, temperature and material weights;
- init_marker_option 2 (tests/test_markers.py's regular grid, on a raster
  box, a Delaunay box and a tet box): the same markers.
"""

import numpy as np
import pytest

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from torch_cases import assert_same_markers, flat3d_cfg, flat_cfg


def _dome_cfg(ndims):
    d = {"sim": {"ndims": ndims, "float_dtype": "float64"},
         "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                  "xlength": 100e3, "ylength": 0.0, "zlength": 100e3,
                  "resolution": 5e3},
         "control": {"gravity": 10.0, "has_thermal_diffusion": True},
         "ic": {"temperature_option": 3, "num_radiogenic_heat_layer": 2,
                "radiogenic_heat_boundry": [0.0, 30e3, 100e3],
                "radiogenic_heat_mat_in_layer": [0, 1],
                "surface_heat_flux": 70e-3,
                "radiogenic_heat_dome_amplitude": 20.0,
                "radiogenic_heat_dome_width": 20e3,
                "radiogenic_heat_dome_center_x": 0.5,
                "mattype_layer_depths": [0.99]},
         "bc": {"surface_temperature": 273.0, "mantle_temperature": 1600.0},
         "mat": {"rheology_type": "elasto-plastic", "num_materials": 2,
                 "mattype_asthenosphere": 1,
                 "rho0": [2800.0, 3300.0], "bulk_modulus": [50e9],
                 "shear_modulus": [30e9], "therm_cond": [3.0, 3.3],
                 "radiogenic_heat_prod": [1e-9, 0.0]},
         "markers": {"markers_per_element": 4}}
    if ndims == 3:
        d["mesh"].update(xlength=60e3, ylength=20e3, zlength=60e3,
                         resolution=10e3)
    return d


@pytest.mark.parametrize("ndims", [2, 3])
def test_dome_geotherm_flip_matches_jax(ndims):
    cfg = _dome_cfg(ndims)
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    assert_same_markers(js.markers, ts.markers)
    mt = ts.markers.live("mattype")
    assert (mt == 1).any() and (mt == 0).any()
    for f in ("temperature", "emw"):
        assert np.array_equal(np.asarray(getattr(js.state, f)),
                              getattr(ts.state, f).numpy()), f


@pytest.mark.parametrize("cfg", [
    {"sim": {"ndims": 2, "max_steps": 1},
     "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
              "xlength": 10.0, "zlength": 10.0, "resolution": 1.0},
     "markers": {"init_marker_option": 2, "init_marker_spacing": 0.5,
                 "markers_per_element": 4},
     "mat": {"rheology_type": "elastic"}},
    flat_cfg(markers={"init_marker_option": 2, "init_marker_spacing": 0.7,
                      "markers_per_element": 4}),
    flat3d_cfg(markers={"init_marker_option": 2, "init_marker_spacing": 0.6,
                        "markers_per_element": 4})],
    ids=["raster", "delaunay", "tets"])
def test_regular_markers_match_jax(cfg):
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    assert ts.markers.n > ts.topo.nelem / 4
    assert_same_markers(js.markers, ts.markers)
    assert np.array_equal(np.asarray(js.state.emw), ts.state.emw.numpy())
