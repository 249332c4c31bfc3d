"""Predefined model families (counterpart of dynearthsol_tpu/models/: the
reference's examples/ and benchmarks/ configs as Python constructors).

Each function returns a validated Param; pass it to
``dynearthsol_tpu_torch.Simulation``.  The corresponding reference cfg is
noted per model so runs are comparable; reference cfgs themselves also
load unchanged via ``load_config``.  The constructors, names, defaults and
docstrings are the JAX package's.  Four of them load a cfg of the
reference checkout, at the JAX package's path (``REFERENCE``), and raise
its FileNotFoundError where that checkout is absent.

The four structured models run with averaged output
(``is_outputting_averaged_fields``, on by default), which the fused gates
refuse: they step on ``grid2d`` / ``grid3d``, as in the JAX package.
"""

from __future__ import annotations

import os

from ..config import Param, load_config, param_from_dict

# the reference checkout, where the JAX package's constructors read its cfgs
REFERENCE = os.path.join(os.sep, "root", "reference")


def rifting_2d(nx_cells: int = 512, nz_cells: int = 256) -> Param:
    """2D EVP rifting box with a central weak zone — the flagship
    throughput model (cf. examples/rifting-2d.cfg; structured-grid variant
    so the grid2d fast path applies)."""
    xlength, zlength = 100e3, 50e3
    return param_from_dict({
        "sim": {"max_steps": 10**9, "ndims": 2, "float_dtype": "float32"},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": xlength, "ylength": 0.0, "zlength": zlength,
                 "resolution": xlength / nx_cells,
                 "quality_check_step_interval": 10**8},
        "control": {"gravity": 10.0, "inertial_scaling": 1e5,
                    "has_thermal_diffusion": True, "damping_option": 1},
        "bc": {"vbc_x0": 1, "vbc_val_x0": -1e-9,
               "vbc_x1": 1, "vbc_val_x1": 1e-9,
               "vbc_z0": 0, "vbc_z1": 0,
               "surface_temperature": 273.0,
               "mantle_temperature": 1600.0},
        "ic": {"weakzone_option": 2, "weakzone_plstrain": 0.5,
               "weakzone_xcenter": 0.5, "weakzone_zcenter": 0.2,
               "weakzone_xsemi_axis": 3e3, "weakzone_zsemi_axis": 3e3},
        "mat": {"rheology_type": "elasto-visco-plastic",
                "is_plane_strain": True,
                "rho0": [2800.0], "bulk_modulus": [50e9],
                "shear_modulus": [30e9],
                "visc_max": 1e24, "visc_min": 1e19},
    })


def rifting_2d_layered() -> Param:
    """The reference's layered .poly rift model (examples/rifting-2d.cfg):
    refined 2-material crust/mantle PSLG mesh with remeshing."""
    return load_config(os.path.join(REFERENCE, "examples",
                                    "rifting-2d.cfg"))


def oblique_rift_3d(nx_cells: int = 96, ny_cells: int = 64,
                    nz_cells: int = 32, resolution: float = 1e3) -> Param:
    """3D EVP rift box (cf. examples/oblique-rift-3d.cfg); structured
    5-tet mesh so the grid3d fast path applies."""
    return param_from_dict({
        "sim": {"ndims": 3, "float_dtype": "float32"},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": nx_cells * resolution,
                 "ylength": ny_cells * resolution,
                 "zlength": nz_cells * resolution,
                 "resolution": resolution,
                 "quality_check_step_interval": 10**8},
        "control": {"gravity": 10.0, "inertial_scaling": 1e5,
                    "has_thermal_diffusion": True, "damping_option": 1},
        "bc": {"vbc_x0": 1, "vbc_val_x0": -1e-9,
               "vbc_x1": 1, "vbc_val_x1": 1e-9},
        "ic": {"weakzone_option": 2, "weakzone_plstrain": 0.5,
               "weakzone_xcenter": 0.5, "weakzone_zcenter": 0.2},
        "mat": {"rheology_type": "elasto-visco-plastic",
                "is_plane_strain": False,
                "rho0": [2800.0], "bulk_modulus": [50e9],
                "shear_modulus": [30e9],
                "visc_max": 1e24, "visc_min": 1e19},
    })


def production_rifting_2d(nx_cells: int = 512,
                          nz_cells: int = 256) -> Param:
    """2D rifting with the full production feature set: surface
    diffusion + surface element correction + Winkler foundation + water
    loading + crust/mantle marker layering, EVP (the examples/
    rifting-2d.cfg feature composition on a structured grid; rides the
    fused Pallas production path — bench.py `production` case)."""
    return param_from_dict({
        "sim": {"max_steps": 10**9, "ndims": 2, "float_dtype": "float32"},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": 100e3, "ylength": 0.0, "zlength": 50e3,
                 "resolution": 100e3 / nx_cells,
                 "quality_check_step_interval": 10**8},
        "markers": {"markers_per_element": 4, "init_marker_option": 1},
        "control": {"gravity": 10.0, "inertial_scaling": 1e5,
                    "has_thermal_diffusion": True, "damping_option": 1,
                    "surface_process_option": 1,
                    "surface_diffusivity": 1e-6,
                    "has_surface_correction": True},
        "bc": {"vbc_x0": 1, "vbc_val_x0": -1e-9,
               "vbc_x1": 1, "vbc_val_x1": 1e-9,
               "vbc_z0": 0, "vbc_z1": 0,
               "has_winkler_foundation": True, "has_water_loading": True,
               "winkler_delta_rho": 100.0,
               "surface_temperature": 273.0,
               "mantle_temperature": 1600.0},
        "ic": {"weakzone_option": 2, "weakzone_plstrain": 0.5,
               "weakzone_xcenter": 0.5, "weakzone_zcenter": 0.2,
               "weakzone_xsemi_axis": 3e3, "weakzone_zsemi_axis": 3e3,
               "mattype_layer_depths": [0.3],
               "layer_mattypes": [0, 1]},
        "mat": {"rheology_type": "elasto-visco-plastic",
                "is_plane_strain": True, "nmat": 2,
                "rho0": [2800.0, 3300.0],
                "bulk_modulus": [50e9, 80e9],
                "shear_modulus": [30e9, 48e9],
                "visc_max": 1e24, "visc_min": 1e19},
    })


def production_rifting_3d(nx_cells: int = 256, ny_cells: int = 48,
                          nz_cells: int = 16,
                          resolution: float = 1e3) -> Param:
    """3D rifting with the full production feature set (surface
    diffusion + correction + Winkler + water + 2-material markers, EVP)
    — rides the grid3d plane step (bench.py `production3d` case)."""
    return param_from_dict({
        "sim": {"ndims": 3, "float_dtype": "float32"},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": nx_cells * resolution,
                 "ylength": ny_cells * resolution,
                 "zlength": nz_cells * resolution,
                 "resolution": resolution,
                 "quality_check_step_interval": 10**8},
        "markers": {"markers_per_element": 4, "init_marker_option": 1},
        "control": {"gravity": 10.0, "inertial_scaling": 1e5,
                    "has_thermal_diffusion": True, "damping_option": 1,
                    "surface_process_option": 1,
                    "surface_diffusivity": 1e-6,
                    "has_surface_correction": True},
        "bc": {"vbc_x0": 1, "vbc_val_x0": -1e-9,
               "vbc_x1": 1, "vbc_val_x1": 1e-9,
               "vbc_y0": 1, "vbc_val_y0": 0.0,
               "vbc_y1": 1, "vbc_val_y1": 0.0,
               "vbc_z0": 0, "vbc_z1": 0,
               "has_winkler_foundation": True, "has_water_loading": True,
               "winkler_delta_rho": 100.0,
               "surface_temperature": 273.0,
               "mantle_temperature": 1600.0},
        "ic": {"weakzone_option": 2, "weakzone_plstrain": 0.5,
               "weakzone_xcenter": 0.5, "weakzone_zcenter": 0.2,
               "mattype_layer_depths": [0.4],
               "layer_mattypes": [0, 1]},
        "mat": {"rheology_type": "elasto-visco-plastic",
                "is_plane_strain": False, "nmat": 2,
                "rho0": [2800.0, 3300.0],
                "bulk_modulus": [50e9, 80e9],
                "shear_modulus": [30e9, 48e9],
                "visc_max": 1e24, "visc_min": 1e19},
    })


def maxwell_relaxation() -> Param:
    """Analytic Maxwell viscoelastic relaxation benchmark
    (benchmarks/maxwell.cfg)."""
    return load_config(os.path.join(REFERENCE, "benchmarks",
                                    "maxwell.cfg"))


def oedometer_2d() -> Param:
    """Mohr-Coulomb oedometer loading vs closed-form yield
    (benchmarks/oedometer-2d.cfg)."""
    return load_config(os.path.join(REFERENCE, "benchmarks",
                                    "oedometer-2d.cfg"))


def consolidation_2d() -> Param:
    """Poroelastic consolidation (benchmarks/2d-consolidation.cfg)."""
    return load_config(os.path.join(REFERENCE, "benchmarks",
                                    "2d-consolidation.cfg"))


REGISTRY = {
    "rifting-2d": rifting_2d,
    "rifting-2d-layered": rifting_2d_layered,
    "production-rifting-2d": production_rifting_2d,
    "production-rifting-3d": production_rifting_3d,
    "oblique-rift-3d": oblique_rift_3d,
    "maxwell": maxwell_relaxation,
    "oedometer-2d": oedometer_2d,
    "2d-consolidation": consolidation_2d,
}
