"""Config system: DES-compatible ``.cfg`` parser mapped onto typed dataclasses.

The dialect matches the reference (input.cxx:16-901 declares the options;
examples/defaults.cfg documents them): INI-style ``[section]`` headers,
``key = value`` lines, ``#`` comments, booleans as yes/no/on/off/1/0/true/false,
per-material vectors quoted as ``[a, b, c]`` which broadcast from length 1 to
``num_materials`` (input.cxx:941-967, ``get_numbers``).  Repeated sections
merge.  This lets the reference's ``benchmarks/*.cfg`` and ``examples/*.cfg``
files run unchanged.

Cross-option validation follows input.cxx:969-1474 (``validate_parameters``):
rheology string -> bit flags, RSF implies global velocity scaling, etc.
"""

from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass, field
from typing import List

INF = float("inf")
INT_MAX = 2**31 - 1

# Rheology bit flags (matprops.hpp:84-93)
RH_ELASTIC = 1 << 0
RH_VISCOUS = 1 << 1
RH_PLASTIC = 1 << 2
RH_PLASTIC2D = RH_PLASTIC | 1 << 3
RH_RSF = 1 << 4
RH_MAXWELL = RH_ELASTIC | RH_VISCOUS
RH_EP = RH_ELASTIC | RH_PLASTIC
RH_EVP = RH_ELASTIC | RH_VISCOUS | RH_PLASTIC
RH_EP_RSF = RH_ELASTIC | RH_PLASTIC | RH_RSF
RH_EVP_RSF = RH_ELASTIC | RH_VISCOUS | RH_PLASTIC | RH_RSF

# rheology string -> bits (input.cxx:1343-1364)
RHEOLOGY_NAMES = {
    "elastic": RH_ELASTIC,
    "viscous": RH_VISCOUS,
    "maxwell": RH_MAXWELL,
    "elasto-plastic": RH_EP,
    "elasto-visco-plastic": RH_EVP,
    "elasto-plastic-rsf": RH_EP_RSF,
    "elasto-visco-plastic-rsf": RH_EVP_RSF,
    # long names accepted by the reference (input.cxx:1354-1359)
    "elasto-plastic-rate-state-friction": RH_EP_RSF,
    "elasto-visco-plastic-rate-state-friction": RH_EVP_RSF,
}


def _dlist(*vals):
    return field(default_factory=lambda: list(vals))


@dataclass
class Sim:
    """[sim] section (input.cxx:33-100)."""

    modelname: str = "result"
    max_steps: int = INT_MAX
    max_time_in_yr: float = INF
    output_step_interval: int = INT_MAX
    output_time_interval_in_yr: float = INF
    checkpoint_frame_interval: int = 10
    is_restarting: bool = False
    restarting_from_modelname: str = ""
    restarting_from_frame: int = 0
    has_initial_checkpoint: bool = True
    has_marker_output: bool = True
    has_output_during_remeshing: bool = False
    is_outputting_averaged_fields: bool = True
    info_display_step_interval: int = 0  # 0 -> resolved to output interval
    earthquake_output_step_interval: int = 50
    earthquake_start_factor: float = 5.0
    earthquake_end_factor: float = 2.0
    seismic_moment_calculate_output: bool = False
    output_format: str = "binary"  # binary | vtkhdf
    hdf5_compression_level: int = 4
    # --- new-framework options (not in the reference) ---
    ndims: int = 2  # replaces the compile-time -DTHREED switch
    float_dtype: str = "float64"  # float64 | float32 compute precision
    scan_chunk_steps: int = 0  # 0 -> auto; steps fused per device scan


@dataclass
class Mesh:
    """[mesh] section (input.cxx:102-233)."""

    meshing_option: int = 1
    meshing_elem_shape: int = 0
    meshing_verbosity: int = -1
    meshing_sediment: bool = False
    tetgen_optlevel: int = 3
    xlength: float = 0.0
    ylength: float = 0.0
    zlength: float = 0.0
    resolution: float = 0.0
    smallest_size: float = 0.01
    largest_size: float = 30.0
    sediment_size: float = 1.0
    min_angle: float = 32.0
    min_tet_angle: float = 22.0
    max_ratio: float = 2.0
    refined_zonex: List[float] = _dlist(0.4, 0.6)
    refined_zoney: List[float] = _dlist(0.4, 0.6)
    refined_zonez: List[float] = _dlist(0.8, 1.0)
    poly_filename: str = "mesh.poly"
    exo_filename: str = "mesh.exo"
    quality_check_step_interval: int = 100
    min_quality: float = 0.4
    max_boundary_distortion: float = 0.25
    remeshing_option: int = 0
    is_discarding_internal_segments: bool = True
    mmg_debug: int = 0
    mmg_verbose: int = 0
    mmg_hmax_factor: float = 2.0
    mmg_hmin_factor: float = 0.2
    mmg_hausd_factor: float = 0.01
    mmg_init_coarsening_factor: float = 10.0
    use_mmg_init: bool = False
    # runtime stand-in for the reference's compile-time USEMMG flag
    # (remeshing.cxx:2922-2953): metric-driven adaptive remeshing that
    # refines where plastic strain localizes (compute_metric_field,
    # remeshing.cxx:2159-2178)
    use_mesh_optimizer: bool = False
    # framework extension (no reference counterpart): take the initial mesh
    # verbatim from another run's output frame (<prefix>.save.NNNNNN +
    # .chkpt.NNNNNN).  Used by the golden-vs-reference gates to run our
    # numerics on the reference binary's exact mesh, isolating field
    # parity from mesh-generation differences.
    mesh_from_run: str = ""
    mesh_from_run_frame: int = 0


@dataclass
class Markers:
    """[markers] section (input.cxx:236-262)."""

    init_marker_option: int = 1
    markers_per_element: int = 4
    init_marker_spacing: float = 0.3
    min_num_markers_in_element: int = 3
    replenishment_option: int = 2
    random_seed: int = 1
    # repo extension: seed the initial marker placement with a replica of
    # glibc rand() so marker streams MATCH the reference binary run on
    # the same mesh (markerset.cxx:116-133, 521-524) — unlocks
    # cross-code golden gates on marker-histogram-mixed fields
    reference_compatible_rng: bool = False


@dataclass
class Control:
    """[control] section (input.cxx:265-430)."""

    gravity: float = 10.0
    characteristic_speed: float = 0.0
    is_quasi_static: bool = True
    dt_fraction: float = 1.0
    fixed_dt: float = 0.0
    inertial_scaling: float = 1e5
    damping_option: int = 1
    damping_factor: float = 0.8
    ref_pressure_option: int = 0
    surface_pressure_correction: bool = False
    is_using_mixed_stress: bool = True
    surface_process_option: int = 0
    # framework extension (no reference counterpart): the reference runs
    # correct_surface_element (bc.cxx:1613-1665) every step even with no
    # surface process, zeroing the volumetric dv of every element touching
    # the free surface.  Default yes = reference-faithful; the pure
    # analytic benchmarks switch it off to recover textbook homogeneity.
    has_surface_correction: bool = True
    surface_diffusivity: float = 1e-6
    surf_diff_ratio_terrig: float = 1.0
    surf_diff_ratio_marine: float = 1.0
    surf_depo_universal: float = 0.0
    surf_base_level: float = 0.0
    terrig_sediment_diffusivity: float = 3.17e-6
    terrig_sediment_area: float = 3.17e-7  # m^2/s continental source flux
    terrig_sediment_volume: float = 1.0    # m^3/s (3D source, input.cxx:365)
    terrig_depth_coefficient: float = 5e-4
    is_reporting_terrigenous_info: bool = False
    hemipelagic_sedimentation_rate: float = 3.17e-11
    hemipelagic_width: float = 90.0
    hemipelagic_max_depth: float = 40.0
    pelagic_sedimentation_rate: float = 1.585e-12
    pelagic_increasing_width: float = 30.0
    surface_plstrain_diffusion: float = 1.0
    mesh_smoothing_factor: float = 3.17e-7
    has_thermal_diffusion: bool = True
    has_hydraulic_diffusion: bool = False
    has_hydration_processes: bool = False
    hydration_migration_speed: float = 3e-9
    has_PT: bool = False
    PT_jump: bool = False
    PT_max_iter: int = 5000
    PT_relative_tolerance: float = 1e-6
    has_moving_mesh: bool = True
    use_global_velocity_scaling: bool = False
    # gospl coupling
    surface_process_gospl_config_file: str = ""
    gospl_coupling_frequency: int = 1
    gospl_coupling_interval_in_yr: float = 1000.0
    gospl_coupling_mode: str = "steps"
    gospl_velocity_coupling: bool = True
    gospl_mesh_resolution: float = -1.0
    gospl_mesh_perturbation: float = 0.3
    gospl_mesh_padding: float = 0.1


@dataclass
class BC:
    """[bc] section (input.cxx:433-735)."""

    surface_temperature: float = 273.0
    mantle_temperature: float = 1600.0
    has_winkler_foundation: bool = True
    winkler_delta_rho: float = 0.0
    has_elastic_foundation: bool = False
    elastic_foundation_constant: float = 1e11
    has_water_loading: bool = True
    # hydraulic bc types
    hbc_x0: int = 0
    hbc_x1: int = 0
    hbc_y0: int = 0
    hbc_y1: int = 0
    hbc_z0: int = 0
    hbc_z1: int = 0
    # stress (Neumann) bcs
    stress_bc_x0: int = 0
    stress_bc_x1: int = 0
    stress_bc_y0: int = 0
    stress_bc_y1: int = 0
    stress_bc_z0: int = 0
    stress_bc_z1: int = 0
    stress_val_x0: float = 0.0
    stress_val_x1: float = 0.0
    stress_val_y0: float = 0.0
    stress_val_y1: float = 0.0
    stress_val_z0: float = 0.0
    stress_val_z1: float = 0.0
    # velocity bcs
    vbc_x0: int = 1
    vbc_x1: int = 1
    vbc_val_x0: float = -1e-9
    vbc_val_x1: float = 1e-9
    vbc_val_x0_l: float = 0.0
    vbc_val_x1_l: float = 0.0
    vbc_val_division_x0_min: float = 1.0
    vbc_val_division_x0_max: float = 1.0
    vbc_val_division_x1_min: float = 1.0
    vbc_val_division_x1_max: float = 1.0
    vbc_val_x0_ratio0: float = 1.0
    vbc_val_x0_ratio1: float = 1.0
    vbc_val_x0_ratio2: float = 1.0
    vbc_val_x0_ratio3: float = 1.0
    vbc_val_x1_ratio0: float = 1.0
    vbc_val_x1_ratio1: float = 1.0
    vbc_val_x1_ratio2: float = 1.0
    vbc_val_x1_ratio3: float = 1.0
    num_vbc_period_x0: int = 1
    num_vbc_period_x1: int = 1
    vbc_period_x0_time_in_yr: List[float] = _dlist(1.0e6)
    vbc_period_x1_time_in_yr: List[float] = _dlist(1.0e6)
    vbc_period_x0_ratio: List[float] = _dlist(1.0)
    vbc_period_x1_ratio: List[float] = _dlist(1.0)
    vbc_y0: int = 0
    vbc_y1: int = 0
    vbc_val_y0: float = 0.0
    vbc_val_y1: float = 0.0
    vbc_val_y0_l: float = 0.0
    vbc_val_y1_l: float = 0.0
    vbc_z0: int = 0
    vbc_z1: int = 0
    vbc_val_z0: float = 0.0
    vbc_val_z1: float = 0.0
    vbc_val_z1_loading_period: float = INF
    vbc_n0: int = 1
    vbc_n1: int = 1
    vbc_n2: int = 1
    vbc_n3: int = 1
    vbc_val_n0: float = 0.0
    vbc_val_n1: float = 0.0
    vbc_val_n2: float = 0.0
    vbc_val_n3: float = 0.0
    bottom_shear_zone_thickness: float = 0.0


@dataclass
class IC:
    """[ic] section (input.cxx:737-...)."""

    mattype_option: int = 0
    num_mattype_layers: int = 2
    layer_mattypes: List[int] = _dlist(0, 1)
    mattype_layer_depths: List[float] = _dlist(0.5)
    weakzone_option: int = 1
    is_restarting_weakzone: bool = False
    weakzone_plstrain: float = 0.1
    weakzone_azimuth: float = 0.0
    weakzone_inclination: float = 90.0
    weakzone_halfwidth: float = 1.5
    weakzone_y_min: float = 0.0
    weakzone_y_max: float = 1.0
    weakzone_depth_min: float = 0.0
    weakzone_depth_max: float = 1.0
    weakzone_xcenter: float = 0.5
    weakzone_ycenter: float = 0.5
    weakzone_zcenter: float = 0.5
    weakzone_xsemi_axis: float = 1e3
    weakzone_ysemi_axis: float = 1e3
    weakzone_zsemi_axis: float = 1e3
    weakzone_standard_deviation: float = 1e3
    weakzone_gaussian_amplitude: float = 0.0
    weakzone_num_segments: int = 1
    weakzone_segments_xcenter: List[float] = _dlist(0.5)
    weakzone_segments_ycenter: List[float] = _dlist(0.5)
    weakzone_segments_zcenter: List[float] = _dlist(0.5)
    weakzone_segments_azimuth: List[float] = _dlist(0.0)
    weakzone_segments_inclination: List[float] = _dlist(90.0)
    weakzone_segments_halfwidth: List[float] = _dlist(1.5)
    weakzone_segments_x_min: List[float] = _dlist(0.0)
    weakzone_segments_x_max: List[float] = _dlist(1.0)
    weakzone_segments_y_min: List[float] = _dlist(0.0)
    weakzone_segments_y_max: List[float] = _dlist(1.0)
    weakzone_segments_depth_min: List[float] = _dlist(0.0)
    weakzone_segments_depth_max: List[float] = _dlist(1.0)
    continental_plate_age_in_yr: float = 1e8
    temperature_option: int = 0
    oceanic_plate_age_in_yr: float = 60e6
    radiogenic_crustal_thickness: float = 3e4
    radiogenic_folding_depth: float = 1e4
    radiogenic_heating_of_crust: float = 2e-10
    # layered radiogenic geotherm (temperature_option 2, ic.cxx:907-1010)
    nhlayer: int = 1  # cfg key: num_radiogenic_heat_layer
    radiogenic_heat_boundry: List[float] = _dlist(-1.0, -1.0)
    radiogenic_heat_mat_in_layer: List[int] = _dlist(0)
    # heat-flux dome geotherm (temperature_option 3, input.cxx:693-709)
    radiogenic_heat_dome_center_x: float = 0.5
    radiogenic_heat_dome_center_y: float = 0.5
    surface_heat_flux: float = 70e-3
    radiogenic_heat_dome_amplitude: float = 0.0
    radiogenic_heat_dome_width: float = 0.0
    radiogenic_heat_dome_width_y: float = 0.0
    radiogenic_heat_dome_azimuth: float = 0.0
    lithospheric_thickness: float = 1e5
    isostasy_adjustment_time_in_yr: float = 0.0
    has_body_force_adjustment: bool = False
    excess_pore_pressure: float = 0.0
    temperature_filename: str = ""


@dataclass
class Mat:
    """[mat] section (input.cxx:737-852).  Per-material vectors broadcast
    from length 1 to nmat (input.cxx:941-967)."""

    rheology_type: str = ""
    rheol_type: int = 0  # resolved bit flags
    is_plane_strain: bool = False
    phase_change_option: int = 0
    nmat: int = 1
    mattype_ref: int = 0
    mattype_mantle: int = 0
    mattype_depleted_mantle: int = 0
    mattype_partial_melting_mantle: int = 0
    mattype_crust: int = 0
    mattype_oceanic_crust: int = 0
    mattype_sed: int = 0
    mattype_mor_extrusion: int = 0
    mattype_asthenosphere: int = 0
    visc_max: float = 1e24
    visc_min: float = 1e18
    tension_max: float = 1e9
    therm_diff_max: float = 5e-6
    convert_rate_oceanic_crust: float = 1e-13
    rho0: List[float] = _dlist(3210.0)
    alpha: List[float] = _dlist(3e-5)
    bulk_modulus: List[float] = _dlist(128.2e9)
    shear_modulus: List[float] = _dlist(80.5e9)
    visc_exponent: List[float] = _dlist(3.05)
    visc_coefficient: List[float] = _dlist(1.25e-1)
    visc_activation_energy: List[float] = _dlist(3.76e5)
    visc_activation_volume: List[float] = _dlist(0.0)
    heat_capacity: List[float] = _dlist(1e3)
    therm_cond: List[float] = _dlist(3.0)
    radiogenic_heat_prod: List[float] = _dlist(0.0)
    pls0: List[float] = _dlist(0.0)
    pls1: List[float] = _dlist(0.1)
    cohesion0: List[float] = _dlist(4e7)
    cohesion1: List[float] = _dlist(4e6)
    friction_angle0: List[float] = _dlist(30.0)
    friction_angle1: List[float] = _dlist(5.0)
    dilation_angle0: List[float] = _dlist(0.0)
    dilation_angle1: List[float] = _dlist(0.0)
    porosity: List[float] = _dlist(0.0)
    hydraulic_perm: List[float] = _dlist(1e-14)
    fluid_rho0: List[float] = _dlist(1000.0)
    fluid_alpha: List[float] = _dlist(2.07e-4)
    fluid_bulk_modulus: List[float] = _dlist(2.17e9)
    fluid_visc: List[float] = _dlist(1.002e-3)
    biot_coeff: List[float] = _dlist(1.0)
    bulk_modulus_s: List[float] = _dlist(37e9)
    direct_a: List[float] = _dlist(0.020)
    evolution_b: List[float] = _dlist(0.025)
    characteristic_velocity: List[float] = _dlist(1e-6)
    characteristic_distance: List[float] = _dlist(4e-3)
    static_friction_coefficient: List[float] = _dlist(0.6)
    state_var_model: int = 0


@dataclass
class Monitor:
    """[monitor] section."""

    enabled: bool = False
    step_interval: int = 10
    num_points: int = 0
    points_x: List[float] = _dlist()
    points_y: List[float] = _dlist()
    points_z: List[float] = _dlist()
    points_unit: str = "m"
    remesh_rebind: str = "pre_remesh_coord"
    output_prefix: str = "monitor"
    write_header: bool = True
    output_coord: bool = True
    output_velocity: bool = True
    output_force: bool = False
    output_temperature: bool = False
    output_pore_pressure: bool = False
    output_bcflag: bool = False
    output_stress: bool = False
    output_strain: bool = False
    output_strain_rate: bool = False
    output_plastic_strain: bool = False
    output_plastic_strain_rate: bool = False
    output_radiogenic_source: bool = False
    output_density: bool = False
    output_mesh_quality: bool = False
    output_viscosity: bool = False
    output_material: bool = False
    output_dynamic_friction: bool = False
    output_state_variable: bool = False


@dataclass
class Debug:
    """[debug] section."""

    dt: bool = False


@dataclass
class Param:
    sim: Sim = field(default_factory=Sim)
    mesh: Mesh = field(default_factory=Mesh)
    markers: Markers = field(default_factory=Markers)
    control: Control = field(default_factory=Control)
    bc: BC = field(default_factory=BC)
    ic: IC = field(default_factory=IC)
    mat: Mat = field(default_factory=Mat)
    monitor: Monitor = field(default_factory=Monitor)
    debug: Debug = field(default_factory=Debug)


_BOOL_WORDS = {
    "yes": True, "no": False, "on": True, "off": False,
    "true": True, "false": False, "1": True, "0": False,
}

# Per-material vector fields broadcast to nmat (input.cxx:941-967).
_MAT_VECTOR_FIELDS = {
    f.name for f in dataclasses.fields(Mat)
    if f.default_factory is not dataclasses.MISSING  # list-valued
}


def _parse_scalar(text: str, pytype):
    text = text.strip().strip('"').strip("'")
    if pytype is bool:
        key = text.lower()
        if key not in _BOOL_WORDS:
            raise ValueError(f"cannot parse boolean from {text!r}")
        return _BOOL_WORDS[key]
    if pytype is int:
        # accept "1e6"-style ints used in some cfg files
        val = float(text)
        if not val.is_integer() and abs(val) < 2**53:
            raise ValueError(f"expected integer, got {text!r}")
        return min(int(val), INT_MAX)
    if pytype is float:
        return float(text)
    return text


def _parse_list(text: str, elem_type=float):
    """Parse '[a, b, c]' (input.cxx read_numbers semantics)."""
    text = text.strip().strip('"').strip("'").strip()
    if text.startswith("["):
        text = text[1:]
    if text.endswith("]"):
        text = text[:-1]
    items = [t for t in re.split(r"[,\s]+", text.strip()) if t]
    return [_parse_scalar(t, elem_type) for t in items]


def _read_cfg_text(text: str):
    """Return {(section, key): raw_value} in file order."""
    entries = {}
    section = None
    for raw_line in text.splitlines():
        line = raw_line.split("#", 1)[0].strip()
        if not line:
            continue
        m = re.match(r"^\[([a-zA-Z0-9_]+)\]$", line)
        if m:
            section = m.group(1)
            continue
        if "=" not in line:
            raise ValueError(f"cannot parse config line: {raw_line!r}")
        key, val = line.split("=", 1)
        key = key.strip()
        if "." in key:  # allow fully-qualified "sim.modelname = x"
            section, key = key.split(".", 1)
        if section is None:
            raise ValueError(f"option {key!r} appears before any [section]")
        entries[(section, key)] = val.strip()
    return entries


def _apply_entries(param: Param, entries):
    unknowns = []
    for (section, key), raw in entries.items():
        sec_obj = getattr(param, section, None)
        if sec_obj is None:
            unknowns.append(f"[{section}] {key}")
            continue
        fields = {f.name: f for f in dataclasses.fields(sec_obj)}
        # Map DES names that differ from our field names.
        if section == "mat" and key == "num_materials":
            key = "nmat"
        if section == "mat" and key in ("max_viscosity", "min_viscosity",
                                        "max_tension", "max_thermal_diffusivity"):
            key = {"max_viscosity": "visc_max", "min_viscosity": "visc_min",
                   "max_tension": "tension_max",
                   "max_thermal_diffusivity": "therm_diff_max"}[key]
        if section == "monitor" and key == "remesh_rebind_mode":
            key = "remesh_rebind"
        if section == "ic" and key == "num_radiogenic_heat_layer":
            key = "nhlayer"
        if key not in fields:
            unknowns.append(f"[{section}] {key}")
            continue
        f = fields[key]
        current = getattr(sec_obj, key)
        if isinstance(current, list):
            elem_type = int if (key in ("layer_mattypes",
                                        "radiogenic_heat_mat_in_layer")) \
                else float
            setattr(sec_obj, key, _parse_list(raw, elem_type))
        else:
            setattr(sec_obj, key, _parse_scalar(raw, type(current)))
    return unknowns


def validate(param: Param) -> Param:
    """Cross-option validation, following input.cxx:969-1474."""
    mat, ctrl, sim, bc = param.mat, param.control, param.sim, param.bc

    # list-length contracts enforced by the reference's get_numbers()
    # (input.cxx:1314-1315, 1400-1403): the num_* options ARE the
    # expected lengths of their list options
    def _require_len(name, lst, n, also_ok=()):
        if len(lst) != n and len(lst) not in also_ok:
            raise ValueError(f"{name} must have {n} entries, got {len(lst)}")

    _require_len("ic.layer_mattypes", param.ic.layer_mattypes,
                 param.ic.num_mattype_layers)
    # num-1 depths; a single-layer model keeps the (unused) default
    _require_len("ic.mattype_layer_depths", param.ic.mattype_layer_depths,
                 param.ic.num_mattype_layers - 1,
                 also_ok=(1,) if param.ic.num_mattype_layers == 1 else ())
    # periodic-vbc lists: num entries, or 1 (get_numbers optional_size=1)
    _require_len("bc.vbc_period_x0_time_in_yr", bc.vbc_period_x0_time_in_yr,
                 bc.num_vbc_period_x0, also_ok=(1,))
    _require_len("bc.vbc_period_x0_ratio", bc.vbc_period_x0_ratio,
                 bc.num_vbc_period_x0, also_ok=(1,))
    _require_len("bc.vbc_period_x1_time_in_yr", bc.vbc_period_x1_time_in_yr,
                 bc.num_vbc_period_x1, also_ok=(1,))
    _require_len("bc.vbc_period_x1_ratio", bc.vbc_period_x1_ratio,
                 bc.num_vbc_period_x1, also_ok=(1,))

    # MMG initial-mesh adaptation is not implemented here; behave like
    # the reference's non-USEMMG build, which warns and turns the option
    # off (input.cxx:1212-1214) instead of silently running at a
    # different resolution
    if param.mesh.use_mmg_init:
        import warnings

        param.mesh.use_mmg_init = False
        warnings.warn("mesh.use_mmg_init: initial-mesh MMG adaptation is "
                      "not implemented; option turned off (matches the "
                      "reference's non-MMG build, input.cxx:1212-1214)")

    # Exodus meshes are tetrahedral: the reference only supports them in
    # the 3D binary (mesh.cxx:2234); ndims is compile-time there, so cfgs
    # don't set it — infer it
    if param.mesh.meshing_option == 95:
        sim_ndims = param.sim.ndims = 3

    # -1 sentinels in the radiogenic layer boundaries (input.cxx:1405-1409)
    rb = param.ic.radiogenic_heat_boundry
    if rb and rb[0] == -1:
        rb[0] = 0.0
    if len(rb) > param.ic.nhlayer and rb[param.ic.nhlayer] == -1:
        rb[param.ic.nhlayer] = param.mesh.zlength

    if mat.rheology_type:
        name = mat.rheology_type.strip().lower()
        if name not in RHEOLOGY_NAMES:
            raise ValueError(f"unknown rheology_type: {mat.rheology_type!r}")
        mat.rheol_type = RHEOLOGY_NAMES[name]

    # RSF requires global velocity scaling (input.cxx:1365-1369)
    if mat.rheol_type & RH_RSF and not ctrl.use_global_velocity_scaling:
        ctrl.use_global_velocity_scaling = True

    # broadcast per-material vectors of length 1 -> nmat (input.cxx:941)
    for name in _MAT_VECTOR_FIELDS:
        vals = getattr(mat, name)
        if len(vals) == 1 and mat.nmat > 1:
            setattr(mat, name, vals * mat.nmat)
        elif len(vals) not in (0, mat.nmat):
            raise ValueError(
                f"mat.{name} has {len(vals)} entries, expected 1 or {mat.nmat}")

    # info display cadence resolution (input.cxx: sim block)
    if sim.info_display_step_interval <= 0:
        sim.info_display_step_interval = (
            sim.output_step_interval if sim.output_step_interval != INT_MAX
            else max(1, param.mesh.quality_check_step_interval))

    if sim.ndims not in (2, 3):
        raise ValueError("sim.ndims must be 2 or 3")
    if sim.ndims == 2:
        # 2D uses (x, z); the reference ignores ylength in 2D
        if param.mesh.zlength <= 0 and param.mesh.ylength > 0:
            pass
    if param.mesh.resolution <= 0 and param.mesh.meshing_option in (1, 2):
        raise ValueError("mesh.resolution must be positive")

    # 2D Mohr-Coulomb always runs the geoFLAC plane-strain return map
    # (rheology.cxx dispatch uses mat->is_plane_strain; in practice all 2D
    # DES configs set is_plane_strain).  Keep user's setting.
    return param


def load_config(path: str) -> Param:
    import os

    with open(path) as fh:
        text = fh.read()
    param = Param()
    unknowns = _apply_entries(param, _read_cfg_text(text))
    if unknowns:
        import warnings
        warnings.warn(f"ignoring unknown config options: {', '.join(unknowns)}")
    # auxiliary input files are referenced relative to the config file
    # (the reference is run from the cfg's directory)
    cfg_dir = os.path.dirname(os.path.abspath(path))
    for attr_obj, attr in ((param.mesh, "poly_filename"),
                           (param.mesh, "exo_filename"),
                           (param.ic, "temperature_filename")):
        fn = getattr(attr_obj, attr, "")
        if fn and not os.path.isabs(fn) and not os.path.exists(fn):
            cand = os.path.join(cfg_dir, fn)
            if os.path.exists(cand):
                setattr(attr_obj, attr, cand)
    # mesh_from_run is a run prefix, not a file: resolve via its .info
    mfr = param.mesh.mesh_from_run
    if mfr and not os.path.isabs(mfr) and not os.path.exists(mfr + ".info"):
        cand = os.path.join(cfg_dir, mfr)
        if os.path.exists(cand + ".info"):
            param.mesh.mesh_from_run = cand
    if param.mesh.mesh_from_run:
        # the save-file header is authoritative for the dimensionality
        # (the reference selects 2D/3D by binary, not by config option:
        # constants.hpp:12-16 -DTHREED)
        from .io.tagged import TaggedReader

        frame = param.mesh.mesh_from_run_frame
        with TaggedReader(f"{param.mesh.mesh_from_run}.save.{frame:06d}"
                          ) as r:
            param.sim.ndims = r.ndims
    return validate(param)


def param_from_dict(d: dict) -> Param:
    """Build Param from a nested dict {'sim': {...}, 'mesh': {...}, ...}."""
    param = Param()
    for section, kv in d.items():
        sec_obj = getattr(param, section)
        for key, val in kv.items():
            if section == "mat":
                key = {"num_materials": "nmat", "max_viscosity": "visc_max",
                       "min_viscosity": "visc_min",
                       "max_tension": "tension_max",
                       "max_thermal_diffusivity": "therm_diff_max",
                       }.get(key, key)
            if section == "ic" and key == "num_radiogenic_heat_layer":
                key = "nhlayer"
            if section == "monitor" and key == "remesh_rebind_mode":
                key = "remesh_rebind"
            if not hasattr(sec_obj, key):
                raise KeyError(f"unknown option [{section}] {key}")
            setattr(sec_obj, key, val)
    return validate(param)
