"""Initial conditions: temperature, stress state, weak zones, material
layout.

Reference: ic.cxx.  These run once on the host at init (and after restart),
so they are plain numpy.
"""

from __future__ import annotations

import numpy as np
from scipy.special import erf

from .constants import YEAR2SEC


# isotropic PREM pressure profile; depths (m) and pressures (Pa)
# (matprops.cxx:12-45; table values from Dziewonski & Anderson 1981)
_PREM_DEPTH = np.array([
    0e3, 3e3, 15e3, 24.4e3, 40e3, 60e3, 80e3, 115e3, 150e3, 185e3,
    220e3, 265e3, 310e3, 355e3, 400e3, 450e3, 500e3, 550e3, 600e3, 635e3,
    670e3, 721e3, 771e3, 871e3, 971e3, 1071e3, 1171e3, 1271e3, 1371e3,
    1471e3, 1571e3, 1671e3, 1771e3, 1871e3, 1971e3, 2071e3, 2171e3,
    2271e3, 2371e3, 2471e3, 2571e3, 2671e3, 2741e3, 2771e3, 2871e3,
    2891e3])
_PREM_P = np.array([
    0, 0.3, 3.3, 6.0, 11.2, 17.8, 24.5, 36.1, 47.8, 59.4,
    71.1, 86.4, 102.0, 117.7, 133.5, 152.2, 171.3, 190.7, 210.4, 224.3,
    238.3, 260.7, 282.9, 327.6, 372.8, 418.6, 464.8, 511.6, 558.9, 606.8,
    655.2, 704.1, 753.5, 803.6, 854.3, 905.6, 957.6, 1010.3, 1063.8,
    1118.2, 1173.4, 1229.7, 1269.7, 1287.0, 1345.6, 1357.5]) * 1e8
# modified for average continental crust (matprops.cxx:58-92): only the
# shallow entries differ
_PREM_P_MOD = _PREM_P.copy()
_PREM_P_MOD[1] = 0.82e8
_PREM_P_MOD[2] = 4.1e8
_PREM_P_MOD[3] = 6.7e8


def ref_pressure(param, z: np.ndarray | float):
    """Reference lithostatic pressure at depth (matprops.cxx:146-169):
    option 0 constant-density column, 1 PREM, 2 PREM with continental
    crust."""
    depth = -np.asarray(z)
    mat = param.mat
    ctrl = param.control
    if ctrl.ref_pressure_option == 0:
        if ctrl.has_hydraulic_diffusion:
            rho = (mat.rho0[mat.mattype_ref]
                   * (1 - mat.porosity[mat.mattype_ref])
                   + 1000.0 * mat.porosity[mat.mattype_ref])
        else:
            rho = mat.rho0[mat.mattype_ref]
        return rho * ctrl.gravity * depth
    table = _PREM_P if ctrl.ref_pressure_option == 1 else _PREM_P_MOD
    return np.interp(np.maximum(depth, 0.0), _PREM_DEPTH, table)


def _elem0_mix(vals, emw0, harmonic=False):
    """Element 0's marker-histogram property mixture (the reference's
    mat.<prop>(0)); emw0 None falls back to material 0's table value."""
    v = np.asarray(vals, dtype=np.float64)
    if emw0 is None or v.size == 0:
        return float(v[0])
    w = np.asarray(emw0, dtype=np.float64)
    v = v[: len(w)] if len(v) >= len(w) else np.resize(v, len(w))
    if v.max() == v.min():
        # uniform property (incl. every single-material case): return it
        # exactly — (w*v).sum()/w.sum() would add one ulp of mix noise,
        # which the K-amplified golden gates can see
        return float(v[0])
    if harmonic:
        return float(w.sum() / (w / v).sum())
    return float((w * v).sum() / w.sum())


def initial_temperature(param, coord: np.ndarray,
                        emw0: np.ndarray | None = None) -> np.ndarray:
    """Temperature options (ic.cxx:836-1025).  Implemented: 0 (half-space
    cooling), 1 reserved, 90 (file import) reserved.

    ``emw0``: element 0's material weights — the reference's option-0
    diffusivity is ELEMENT 0's mixed k/rho/cp (ic.cxx:845), which on
    multi-material configs is whatever material the renumbered element 0
    carries (the bottom corner element after the longest-axis sort)."""
    ic, bc = param.ic, param.bc
    ndims = coord.shape[1]
    z = coord[:, ndims - 1]
    if ic.temperature_option == 0:
        # half-space cooling (ic.cxx:841-853).  The reference computes the
        # diffusivity from mat.rho(0) — the T-dependent density evaluated
        # while the temperature array is still zero-initialized, i.e.
        # rho0 * (1 + 273*alpha) (matprops.cxx:565-587 with T = 0 K).
        # Replicated exactly: the golden field gates (0.25% T difference
        # at depth otherwise) depend on it.
        age = ic.oceanic_plate_age_in_yr * YEAR2SEC
        k0 = _elem0_mix(param.mat.therm_cond, emw0)
        rho0 = _elem0_mix(
            np.asarray(param.mat.rho0)
            * (1.0 + 273.0 * np.asarray(param.mat.alpha)), emw0)
        cp0 = _elem0_mix(param.mat.heat_capacity, emw0)
        diffusivity = k0 / rho0 / cp0
        w = -z / np.sqrt(4 * diffusivity * age)
        return bc.surface_temperature + (
            bc.mantle_temperature - bc.surface_temperature) * erf(w)
    if ic.temperature_option == 1:
        # continental geotherm, Hasterok & Chapman 2011 (ic.cxx:855-906)
        mat = param.mat
        dens_c = mat.rho0[mat.mattype_crust]
        dens_m = mat.rho0[mat.mattype_mantle]
        cond_c = mat.therm_cond[min(len(mat.therm_cond) - 1,
                                    mat.mattype_crust)]
        cond_m = mat.therm_cond[min(len(mat.therm_cond) - 1,
                                    mat.mattype_mantle)]
        diff_m = cond_m / 1000.0 / dens_m
        age = ic.continental_plate_age_in_yr * YEAR2SEC
        hs = ic.radiogenic_heating_of_crust
        hr = ic.radiogenic_folding_depth
        hc = ic.radiogenic_crustal_thickness
        hl = ic.lithospheric_thickness
        t_top, t_bot = bc.surface_temperature, bc.mantle_temperature
        tr = dens_c * hs * hr * hr / cond_c * np.exp(1.0 - np.exp(-hc / hr))
        q_m = (t_bot - t_top - tr) / (hc / cond_c + (hl - hc) / cond_m)
        tm = t_top + (q_m / cond_c) * hc + tr
        tau_d = hl * hl / (np.pi * np.pi * diff_m)
        y = -z
        tss = np.where(
            y <= hc,
            t_top + (q_m / cond_c) * y
            + (dens_c * hs * hr * hr / cond_c)
            * np.exp(1.0 - np.exp(-y / hr)),
            tm + (q_m / cond_m) * (y - hc))
        tt = np.zeros_like(y)
        pp = -1.0
        for k in range(1, 101):
            pp = -pp
            tt = tt + pp / k * np.exp(-k * k * age / tau_d) \
                * np.sin(np.pi * k * (hl - y) / hl)
        T = tss + 2.0 / np.pi * (t_bot - t_top) * tt
        T = np.where((T > t_bot) | (y >= hl), t_bot, T)
        T = np.where(y == 0.0, t_top, T)
        return T
    if ic.temperature_option == 2:
        return _layered_radiogenic_geotherm(param, coord)[0]
    if ic.temperature_option == 3:
        return dome_geotherm(param, coord)[0]
    if ic.temperature_option == 90:
        return read_external_temperature(param, coord)
    raise NotImplementedError(
        f"temperature_option {ic.temperature_option} not yet implemented")


def _layered_geotherm_coeffs(param):
    """Per-layer conductive coefficients for the layered radiogenic
    geotherm (ic.cxx:907-1010; Turcotte & Schubert, H = H0 exp(-z/hr))."""
    ic, mat = param.ic, param.mat
    nlayer = ic.nhlayer
    t_top = param.bc.surface_temperature
    t_bot = param.bc.mantle_temperature
    hr = ic.radiogenic_folding_depth
    bdy = np.asarray(ic.radiogenic_heat_boundry, dtype=float)

    def mat_val(vec, m):
        return vec[0] if len(vec) == 1 else vec[m]

    cond = np.zeros(nlayer)
    rho = np.zeros(nlayer)
    hp = np.zeros(nlayer)
    for i in range(nlayer):
        m = ic.radiogenic_heat_mat_in_layer[i]
        cond[i] = mat_val(mat.therm_cond, m)
        rho[i] = mat_val(mat.rho0, m)
        hp[i] = mat_val(mat.radiogenic_heat_prod, m)
    rhohp = hp * rho
    thickness = bdy[1:nlayer + 1] - bdy[:nlayer]
    total = bdy[nlayer] - bdy[0]
    dT_layer = np.zeros(nlayer)
    dTh_sum = 0.0
    avg_cond = 0.0
    for i in range(nlayer):
        dT_layer[i] = dTh_sum
        dTh_sum += rhohp[i] * hr * hr * (1 - np.exp(-thickness[i] / hr)) \
            / cond[i]
        avg_cond += thickness[i] / cond[i]
    avg_cond = total / avg_cond
    qm = (t_bot - t_top - dTh_sum) / total * avg_cond
    dTc = 0.0
    for i in range(nlayer):
        dT_layer[i] += dTc
        dTc += thickness[i] * qm / cond[i]
    return bdy, cond, rhohp, hp, dT_layer, qm, hr, t_top, t_bot


def _layered_radiogenic_geotherm(param, coord: np.ndarray):
    """Nodal temperature for temperature_option 2 (ic.cxx:907-1010).
    Returns (temperature, (coeffs tuple for the element source))."""
    ic = param.ic
    nlayer = ic.nhlayer
    ndims = coord.shape[1]
    bdy, cond, rhohp, hp, dT_layer, qm, hr, t_top, t_bot = \
        _layered_geotherm_coeffs(param)
    y = -coord[:, ndims - 1]
    T = np.where(y >= bdy[nlayer], t_bot, t_top)
    for j in range(nlayer):
        in_l = (y >= bdy[j]) & (y < bdy[j + 1])
        dTr = rhohp[j] * hr * hr * (1 - np.exp(-(y - bdy[j]) / hr)) \
            / cond[j]
        T = np.where(in_l,
                     t_top + dT_layer[j] + qm * (y - bdy[j]) / cond[j]
                     + dTr, T)
    return T, (bdy, hp, hr, nlayer)


def dome_geotherm(param, coord: np.ndarray):
    """Heat-flux dome geotherm with mantle adiabat cap
    (temperature_option 3; ic.cxx:727-830, after Hasterok & Chapman 2011).

    A laterally-varying surface heat flux (background + Gaussian dome)
    is conducted down through the radiogenic layers of the option-2
    layer stack; where the conductive temperature exceeds the mantle
    adiabat T_m * exp(g z 4e-8) the node is flagged asthenospheric and
    clamped to the adiabat.  Returns (temperature, in_asth nodal bool,
    rs nodal radiogenic heat production [W/kg])."""
    ic, bc_p = param.ic, param.bc
    ndims = coord.shape[1]
    nlayer = ic.nhlayer
    bdy = np.asarray(ic.radiogenic_heat_boundry, dtype=float)
    F = 0.74  # partition coefficient (ic.cxx:732)

    def mat_val(vec, m):
        return vec[0] if len(vec) == 1 else vec[m]

    cond = np.zeros(nlayer)
    rho = np.zeros(nlayer)
    hp = np.zeros(nlayer)
    for i in range(nlayer):
        m = ic.radiogenic_heat_mat_in_layer[i]
        cond[i] = mat_val(param.mat.therm_cond, m)
        rho[i] = mat_val(param.mat.rho0, m)
        hp[i] = mat_val(param.mat.radiogenic_heat_prod, m)
    thickness = bdy[1:nlayer + 1] - bdy[:nlayer]

    z = -coord[:, ndims - 1]
    zPotT = bc_p.mantle_temperature * np.exp(
        param.control.gravity * z * 4e-8)

    # Gaussian dome surface heat flux (ic.cxx:751-784)
    wx_r = 1.0 / ic.radiogenic_heat_dome_width \
        if ic.radiogenic_heat_dome_width != 0 else 0.0
    dx = coord[:, 0] - ic.radiogenic_heat_dome_center_x * param.mesh.xlength
    if ndims == 3:
        az = np.deg2rad(ic.radiogenic_heat_dome_azimuth)
        wy = ic.radiogenic_heat_dome_width_y
        if wy == 0:
            wy_r = wx_r
        elif wy < 0:
            wy_r = 0.0
        else:
            wy_r = 1.0 / wy
        dy = coord[:, 1] \
            - ic.radiogenic_heat_dome_center_y * param.mesh.ylength
        dx_rot = dx * np.cos(az) - dy * np.sin(az)
        dy_rot = dx * np.sin(az) + dy * np.cos(az)
        radius_sq = (dx_rot * wx_r) ** 2 + (dy_rot * wy_r) ** 2
    else:
        radius_sq = (dx * wx_r) ** 2
    xsfh = ic.surface_heat_flux \
        + ic.radiogenic_heat_dome_amplitude / 1e6 * np.exp(-radius_sq)
    # layer-0 heat production balances the local surface flux
    # (ic.cxx:785: hp[0] = (1-F) xsfh / rho0 / bdy[1])
    hp0_n = (1.0 - F) * xsfh / rho[0] / bdy[1]

    t = np.full_like(z, bc_p.surface_temperature)
    q = xsfh.copy()
    in_asth = np.zeros(z.shape, dtype=bool)
    for i in range(nlayer):
        hp_i = hp0_n if i == 0 else np.full_like(z, hp[i])
        upd = (~in_asth) & (z >= bdy[i])
        dd = np.minimum(z - bdy[i], thickness[i])
        t = np.where(upd,
                     t + q * dd / cond[i]
                     - (rho[i] * hp_i) / (2.0 * cond[i]) * dd * dd, t)
        q = np.where(upd, q - rho[i] * hp_i * dd, q)
        in_asth |= (~in_asth) & (t > zPotT)
    t = np.where(in_asth, zPotT, t)

    # nodal radiogenic heat production = hp of the deepest layer the node
    # is in (ic.cxx:806-812); asthenospheric nodes contribute nothing
    rs = np.zeros_like(z)
    for i in range(nlayer):
        hp_i = hp0_n if i == 0 else hp[i]
        rs = np.where(z >= bdy[i], hp_i, rs)
    rs = np.where(in_asth, 0.0, rs)
    return t, in_asth, rs


def initial_radiogenic_source(param, coord: np.ndarray, conn: np.ndarray
                              ) -> np.ndarray:
    """Per-element radiogenic heat source for temperature_option 2
    (ic.cxx:980-1008) and 3 (ic.cxx:806-812, nodal scatter of the layer
    heat production over each node's support elements / NODES_PER_ELEM
    == corner-mean of the nodal value); zero otherwise (matching
    allocate_state)."""
    nelem = conn.shape[0]
    if param.ic.temperature_option == 3:
        rs = dome_geotherm(param, coord)[2]
        return rs[conn].mean(axis=1)
    if param.ic.temperature_option != 2:
        return np.zeros(nelem)
    ndims = coord.shape[1]
    bdy, hp, hr, nlayer = _layered_radiogenic_geotherm(
        param, coord[:1])[1]
    y = -coord[conn, ndims - 1].mean(axis=1)
    src = np.where(y <= bdy[0], hp[0], 0.0)
    for k in range(nlayer):
        in_l = (y >= bdy[k]) & (y < bdy[k + 1])
        src = np.where(in_l, hp[k] * np.exp(-(y - bdy[k]) / hr), src)
    return src


def read_external_temperature(param, coord: np.ndarray) -> np.ndarray:
    """Import temperature from a COMSOL-style text export: rows of
    coordinates + temperature, interpolated onto the mesh nodes
    (ic-read-temp.cxx:14-144)."""
    from scipy.interpolate import (LinearNDInterpolator,
                                   NearestNDInterpolator)

    ndims = coord.shape[1]
    data = np.loadtxt(param.ic.temperature_filename, comments="%")
    pts, temps = data[:, :ndims], data[:, ndims]
    lin = LinearNDInterpolator(pts, temps)
    near = NearestNDInterpolator(pts, temps)
    T = lin(coord)
    bad = np.isnan(T)
    if bad.any():
        T[bad] = near(coord[bad])
    return T


def initial_stress_state(param, coord: np.ndarray, conn: np.ndarray,
                         emw: np.ndarray | None = None):
    """Lithostatic stress/strain init (ic.cxx:322-362).

    ``emw``: per-element material weights.  The reference's ks is
    ELEMENT 0's harmonic bulk-modulus mixture (mat.bulkm(0),
    ic.cxx:333) for ref_pressure_option 0, and the PER-ELEMENT mixture
    for options 1/2 (ic.cxx:346-349).

    Returns (stress, stressyy, old_mean_stress, strain, compensation_pressure).
    """
    ndims = coord.shape[1]
    nstr = ndims * (ndims + 1) // 2
    nelem = conn.shape[0]
    stress = np.zeros((nelem, nstr))
    strain = np.zeros((nelem, nstr))
    stressyy = np.zeros(nelem)
    old_mean = np.zeros(nelem)
    if param.control.gravity == 0:
        return stress, stressyy, old_mean, strain, 0.0

    zcenter = coord[conn, ndims - 1].mean(axis=1)
    p = ref_pressure(param, zcenter)
    if param.control.ref_pressure_option in (1, 2) and emw is not None:
        w = np.asarray(emw, dtype=np.float64)
        km = np.asarray(param.mat.bulk_modulus,
                        dtype=np.float64)[: w.shape[1]]
        ks = w.sum(axis=1) / (w / km[None, :]).sum(axis=1)
    else:
        ks = _elem0_mix(param.mat.bulk_modulus,
                        None if emw is None else emw[0], harmonic=True)
    stress[:, :ndims] = -p[:, None]
    strain[:, :ndims] = (-p / ks / ndims)[:, None]
    old_mean = stress[:, :ndims].sum(axis=1) / ndims
    if param.mat.is_plane_strain:
        stressyy = -p
    compensation_pressure = float(ref_pressure(param, -param.mesh.zlength))
    return stress, stressyy, old_mean, strain, compensation_pressure


def initial_weak_zone(param, coord: np.ndarray, conn: np.ndarray
                      ) -> np.ndarray:
    """Initial plastic strain in a weak zone (ic.cxx:500-657).

    Implemented options: 0 (none), 1 (inclined plane band), 2 (ellipsoid).
    """
    ic = param.ic
    ndims = coord.shape[1]
    nelem = conn.shape[0]
    plstrain = np.zeros(nelem)
    opt = ic.weakzone_option
    if opt == 0:
        return plstrain
    center = conn  # element centroids
    c = coord[conn].mean(axis=1)
    if opt == 1:
        # plane of weakness with azimuth/inclination through
        # (xcenter, [ycenter,] zcenter), half-width in resolution units
        x0 = ic.weakzone_xcenter * param.mesh.xlength
        z0 = -ic.weakzone_zcenter * param.mesh.zlength
        halfwidth = ic.weakzone_halfwidth * param.mesh.resolution
        # Planar_zone containment (ic.cxx:54-94): the plane satisfies
        # dx - tan(az)*dy + cot(incl)*dz = 0 and the band half-width is
        # measured ALONG X, not perpendicular to the plane
        cot_i = 1.0 / np.tan(np.deg2rad(ic.weakzone_inclination))
        dx = c[:, 0] - x0
        dz = c[:, ndims - 1] - z0
        t = dx + cot_i * dz
        if ndims == 3:
            y0 = ic.weakzone_ycenter * param.mesh.ylength
            t = t - np.tan(np.deg2rad(ic.weakzone_azimuth)) * (c[:, 1] - y0)
        zmin = -ic.weakzone_depth_max * param.mesh.zlength
        zmax = -ic.weakzone_depth_min * param.mesh.zlength
        sel = (np.abs(t) < halfwidth) \
            & (c[:, ndims - 1] > zmin) & (c[:, ndims - 1] < zmax)
        if ndims == 3:
            ymin = ic.weakzone_y_min * param.mesh.ylength
            ymax = ic.weakzone_y_max * param.mesh.ylength
            sel &= (c[:, 1] > ymin) & (c[:, 1] < ymax)
        plstrain[sel] = ic.weakzone_plstrain
        return plstrain
    if opt == 2:
        x0 = ic.weakzone_xcenter * param.mesh.xlength
        z0 = -ic.weakzone_zcenter * param.mesh.zlength
        r2 = ((c[:, 0] - x0) / ic.weakzone_xsemi_axis) ** 2 \
            + ((c[:, ndims - 1] - z0) / ic.weakzone_zsemi_axis) ** 2
        if ndims == 3:
            y0 = ic.weakzone_ycenter * param.mesh.ylength
            r2 += ((c[:, 1] - y0) / ic.weakzone_ysemi_axis) ** 2
        plstrain[r2 <= 1.0] = ic.weakzone_plstrain
        return plstrain
    if opt == 3:
        # Gaussian point zone: plstrain decays with distance from the
        # center (ic.cxx:547-556)
        x0 = ic.weakzone_xcenter * param.mesh.xlength
        z0 = -ic.weakzone_zcenter * param.mesh.zlength
        sig = ic.weakzone_standard_deviation
        r2 = (c[:, 0] - x0) ** 2 + (c[:, ndims - 1] - z0) ** 2
        if ndims == 3:
            y0 = ic.weakzone_ycenter * param.mesh.ylength
            r2 += (c[:, 1] - y0) ** 2
        return ic.weakzone_plstrain * np.exp(-r2 / (2.0 * sig * sig))
    if opt == 4:
        # planar zone whose map-view x position is shifted by a Gaussian
        # bulge along strike (ic.cxx:557-581); reduces to option 1 in 2D
        x0 = ic.weakzone_xcenter * param.mesh.xlength
        z0 = -ic.weakzone_zcenter * param.mesh.zlength
        halfwidth = ic.weakzone_halfwidth * param.mesh.resolution
        shift = np.zeros(c.shape[0])
        if ndims == 3:
            y0 = ic.weakzone_ycenter * param.mesh.ylength
            sig = ic.weakzone_standard_deviation
            shift = ic.weakzone_gaussian_amplitude * np.exp(
                -((c[:, 1] - y0) ** 2) / (2.0 * sig * sig))
        # Gaussian_planar_zone containment (ic.cxx:196-241): same x-measured
        # band as option 1; the map-view shift and azimuth only exist in 3D
        dx = c[:, 0] - (x0 + shift)
        dz = c[:, ndims - 1] - z0
        cot_i = 1.0 / np.tan(np.deg2rad(ic.weakzone_inclination))
        t = dx + cot_i * dz
        if ndims == 3:
            y0 = ic.weakzone_ycenter * param.mesh.ylength
            t = t - np.tan(np.deg2rad(ic.weakzone_azimuth)) * (c[:, 1] - y0)
        zmin = -ic.weakzone_depth_max * param.mesh.zlength
        zmax = -ic.weakzone_depth_min * param.mesh.zlength
        sel = (np.abs(t) < halfwidth) & (c[:, ndims - 1] > zmin) \
            & (c[:, ndims - 1] < zmax)
        if ndims == 3:
            sel &= (c[:, 1] > ic.weakzone_y_min * param.mesh.ylength) \
                & (c[:, 1] < ic.weakzone_y_max * param.mesh.ylength)
        plstrain[sel] = ic.weakzone_plstrain
        return plstrain
    if opt == 5:
        # multiple general planar segments with the unit-normal
        # formulation (General_planar_zone, ic.cxx:143-194):
        # n = (-cos(az)*sin(incl), [sin(az)*sin(incl),] -cos(incl)),
        # |n . (x - x0)| < halfwidth with strict x/y/z bounds
        n = ic.weakzone_num_segments
        for i in range(n):
            xc = ic.weakzone_segments_xcenter[i] * param.mesh.xlength
            zc_i = -ic.weakzone_segments_zcenter[i] * param.mesh.zlength
            hw = ic.weakzone_segments_halfwidth[i] * param.mesh.resolution
            az = np.deg2rad(ic.weakzone_segments_azimuth[i]
                            if getattr(ic, "weakzone_segments_azimuth",
                                       None) else 0.0)
            inc = np.deg2rad(ic.weakzone_segments_inclination[i])
            dist = (-np.cos(az) * np.sin(inc) * (c[:, 0] - xc)
                    - np.cos(inc) * (c[:, ndims - 1] - zc_i))
            if ndims == 3:
                yc = ic.weakzone_segments_ycenter[i] * param.mesh.ylength
                dist = dist + np.sin(az) * np.sin(inc) * (c[:, 1] - yc)
            sel = np.abs(dist) < hw
            sel &= (c[:, 0] > ic.weakzone_segments_x_min[i]
                    * param.mesh.xlength) \
                & (c[:, 0] < ic.weakzone_segments_x_max[i]
                   * param.mesh.xlength)
            sel &= (c[:, ndims - 1] > -ic.weakzone_segments_depth_max[i]
                    * param.mesh.zlength) \
                & (c[:, ndims - 1] < -ic.weakzone_segments_depth_min[i]
                   * param.mesh.zlength)
            if ndims == 3:
                sel &= (c[:, 1] > ic.weakzone_segments_y_min[i]
                        * param.mesh.ylength) \
                    & (c[:, 1] < ic.weakzone_segments_y_max[i]
                       * param.mesh.ylength)
            plstrain[sel] = ic.weakzone_plstrain
        return plstrain
    raise NotImplementedError(f"weakzone_option {opt} not yet implemented")


def initial_material_weights(param, coord: np.ndarray, conn: np.ndarray,
                             regattr: np.ndarray = None) -> np.ndarray:
    """Element material weights standing in for marker histograms until the
    marker subsystem takes over (ic.cxx mattype layers, ic.cxx:652-713).

    mattype_option 0 with a .poly mesh: per-element regattr from the
    mesher's regional attributes; otherwise depth layers from
    mattype_layer_depths (fractions of zlength) with layer_mattypes.
    """
    nmat = param.mat.nmat
    nelem = conn.shape[0]
    emw = np.zeros((nelem, nmat))
    if nmat == 1:
        emw[:, 0] = 1.0
        return emw
    if param.ic.mattype_option == 0 and regattr is not None:
        emw[np.arange(nelem), regattr.astype(int)] = 1.0
        return emw
    ndims = coord.shape[1]
    zc = coord[conn, ndims - 1].mean(axis=1)
    depth_frac = -zc / max(param.mesh.zlength, 1e-300)
    depths = list(param.ic.mattype_layer_depths)
    mats = list(param.ic.layer_mattypes)
    bounds = [0.0] + depths + [np.inf]
    for i, m in enumerate(mats):
        sel = (depth_frac >= bounds[i]) & (depth_frac < bounds[i + 1])
        emw[sel, m] = 1.0
    # any unassigned elements get the last layer's material
    unassigned = emw.sum(axis=1) == 0
    emw[unassigned, mats[-1]] = 1.0
    return emw


def initial_hydrostatic_state(param, coord: np.ndarray,
                              bcflag: np.ndarray) -> np.ndarray:
    """Hydrostatic pore pressure + Skempton-loaded excess pressure
    (ic.cxx:450-498).  Positive in compression."""
    if param.control.gravity == 0:
        return np.zeros(coord.shape[0])
    mat = param.mat
    ndims = coord.shape[1]
    rho_fluid = 1000.0  # ic.cxx:460 hard-codes water
    z = coord[:, ndims - 1]
    pp = -rho_fluid * param.control.gravity * z

    loading = param.ic.excess_pore_pressure
    if loading != 0.0:
        from .bc import pp_bc_mask

        ks = mat.bulk_modulus[0]
        mu = mat.shear_modulus[0]
        lame = ks - 2.0 / 3.0 * mu
        alpha_c = mat.biot_coeff[0]
        phi = mat.porosity[0]
        beta_w = 1.0 / mat.fluid_bulk_modulus[0]
        skempton = 1.0 / (phi * beta_w * (lame + 2 * mu)
                          / (alpha_c + phi - phi * alpha_c) + alpha_c)
        free = ~pp_bc_mask(param.bc, bcflag)
        pp[free] += skempton * loading
    return pp



def initial_rsf_state(param, emw: np.ndarray):
    """Initial RSF friction coefficient and state variable
    (ic.cxx:659-726): marker-weighted tan(friction_angle0) and
    characteristic_distance / characteristic_velocity.  ``emw`` is the
    run's (nelem, nmat) weights in the run's dtype."""
    mat = param.mat
    w = emw / emw.sum(axis=1, keepdims=True)
    fric = w @ np.asarray(mat.friction_angle0)
    dfc = np.tan(np.deg2rad(fric))
    c_avg = w @ np.asarray(mat.characteristic_velocity)
    d_avg = w @ np.asarray(mat.characteristic_distance)
    sv = np.where(c_avg > 0, d_avg / np.maximum(c_avg, 1e-300), 1e9)
    return dfc, sv
