"""Marker phase changes and hydrous (water) marker transport (host numpy;
counterpart of dynearthsol_tpu/phasechanges.py).

Reference: phasechanges.cxx (option 1 = the simple subduction set: basalt
-> eclogite, sediment -> schist, serpentinite <-> mantle, with dehydration
releasing hydrous markers) and markerset.cxx:1887-1955 (hydrous markers
rise at hydration_migration_speed).  Runs on the host at the CLI's
10-step wake (dynearthsol.cxx:861-871) from the state read back in
float64; the new material weights go to the run's device in its dtype.
"""

from __future__ import annotations

import time

import numpy as np

from .barycentric import bary_to_coord
from .ic import ref_pressure
from .markers import MarkerSet, emw_from_markers

# material indices of the simple-subduction set (phasechanges.cxx:13-20)
MT_MANTLE = 0
MT_SERPENTINIZED_MANTLE = 1
MT_OCEANIC_CRUST = 2
MT_ECLOGITE = 3
MT_SEDIMENT = 4
MT_SCHIST = 5
MT_UPPER_CONTINENTAL_CRUST = 6
MT_LOWER_CONTINENTAL_CRUST = 7


def marker_ZPT(param, ms: MarkerSet, coord, conn, temperature):
    """Depth, reference pressure and temperature at each marker
    (MarkerSet::get_ZPT, markerset.cxx:959-972)."""
    eta = ms.live("eta")
    nodes = conn[ms.live("elem")]
    ndims = coord.shape[1]
    Z = (coord[nodes, ndims - 1] * eta).sum(axis=1)
    T = (temperature[nodes] * eta).sum(axis=1)
    P = ref_pressure(param, Z)
    return Z, P, T


def simple_subduction(param, ms: MarkerSet, Z, P, T, hydrous_count_at_elem):
    """The phase diagram of phasechanges.cxx:10-104 on every marker at
    once.  Returns (new_mattype, hyd_release_mask)."""
    mt = ms.live("mattype").copy()
    new_mt = mt.copy()
    hyd = np.zeros(ms.n, dtype=bool)

    # basalt -> eclogite (Hacker 1996)
    oc = mt == MT_OCEANIC_CRUST
    to_ecl = oc & (T > 500 + 273) & (P > -0.3e9 + 2.2e6 * T)
    new_mt[to_ecl] = MT_ECLOGITE
    hyd |= oc & ~to_ecl & (T > 150 + 273)

    # sediment -> schist (Nichols et al. 1994)
    sed = mt == MT_SEDIMENT
    to_sch = sed & (T > 650 + 273) & (Z < -20e3)
    new_mt[to_sch] = MT_SCHIST
    hyd |= sed & ~to_sch & (T > 150 + 273)

    # serpentinite -> mantle (Ulmer & Trommsdorff 1995)
    serp = mt == MT_SERPENTINIZED_MANTLE
    trans_p = 2.1e9 + (7.5e9 - 2.1e9) * (T - (730 + 273)) / (500 - 730)
    to_man = serp & (T > 550 + 273) & (P > trans_p)
    new_mt[to_man] = MT_MANTLE
    hyd |= to_man

    # mantle -> serpentinized mantle where hydrous markers are present
    man = mt == MT_MANTLE
    has_hyd = hydrous_count_at_elem[ms.live("elem")] > 0
    to_serp = man & (T <= 550 + 273) & has_hyd
    new_mt[to_serp] = MT_SERPENTINIZED_MANTLE

    return new_mt, hyd


def phase_changes(sim):
    """Apply phase changes and release hydrous markers (phase_changes,
    phasechanges.cxx:109-210).  Mutates sim.markers and
    sim.hydrous_markers; where a marker changed, the material weights go
    to the device as ``sim.state.emw``.  Returns what the wake did:
    {"transitions": {"a->b": markers}, "released": hydrous markers
    released, "read_ms": host ms of the reads of coord and temperature,
    "emw_ms": host ms of the weights' upload}."""
    param = sim.param
    stats = {"transitions": {}, "released": 0, "read_ms": 0.0,
             "emw_ms": 0.0}
    if (param.mat.nmat == 1 or param.mat.phase_change_option == 0
            or sim.markers is None):
        return stats
    ms = sim.markers
    t0 = time.perf_counter()
    coord = sim._host(sim.state.coord)
    temperature = sim._host(sim.state.temperature)
    stats["read_ms"] = (time.perf_counter() - t0) * 1e3
    conn = sim.topo.connectivity

    hyd_count = np.zeros(sim.topo.nelem)
    if sim.hydrous_markers is not None:
        np.add.at(hyd_count, sim.hydrous_markers.live("elem"), 1.0)

    Z, P, T = marker_ZPT(param, ms, coord, conn, temperature)
    if param.mat.phase_change_option == 1:
        new_mt, hyd = simple_subduction(param, ms, Z, P, T, hyd_count)
    elif param.mat.phase_change_option == 101:
        new_mt, hyd = ms.live("mattype").copy(), np.zeros(ms.n, dtype=bool)
    else:
        raise ValueError(
            f"unknown phase_change_option {param.mat.phase_change_option}")

    old_mt = ms.live("mattype")
    moved = new_mt != old_mt
    changed = moved.any()
    if changed:
        pairs, counts = np.unique(
            np.stack([old_mt[moved], new_mt[moved]]), axis=1,
            return_counts=True)
        stats["transitions"] = {f"{a}->{b}": int(c)
                                for (a, b), c in zip(pairs.T, counts)}
    ms.mattype[: ms.n] = new_mt

    # dehydration releases hydrous markers at the dehydrated marker's spot
    # (phasechanges.cxx:160-185)
    if param.control.has_hydration_processes and hyd.any():
        if sim.hydrous_markers is None:
            sim.hydrous_markers = MarkerSet.empty(
                sim.topo.ndims, cap=1024, name="hydrous-markerset")
        idx = np.nonzero(hyd)[0]
        sim.hydrous_markers.append(ms.eta[idx], ms.elem[idx], 0,
                                   genesis=3)
        stats["released"] = int(idx.size)
        changed = True

    if changed:
        emw = emw_from_markers(ms, sim.topo.nelem, param.mat.nmat)
        t0 = time.perf_counter()
        sim.state = sim.state.replace(emw=sim._dev(emw))
        stats["emw_ms"] = (time.perf_counter() - t0) * 1e3
    return stats


def advect_hydrous_markers(sim, dt_subtotal: float):
    """Vertical migration of the hydrous markers
    (advect_hydrous_markers, markerset.cxx:1887-1955); markers that leave
    the domain are deleted."""
    hyd = sim.hydrous_markers
    if hyd is None or hyd.n == 0:
        return
    from .mesh.locate import ElementLocator

    coord = sim._host(sim.state.coord)
    conn = sim.topo.connectivity
    pts = bary_to_coord(coord, conn, hyd.live("elem"), hyd.live("eta"))
    pts[:, -1] += dt_subtotal * sim.param.control.hydration_migration_speed
    loc = ElementLocator(coord, conn)
    elem, eta, found = loc.locate(pts)
    hyd.elem[: hyd.n] = elem
    hyd.eta[: hyd.n] = eta
    lost = np.nonzero(~found)[0]
    if lost.size:
        hyd.remove(lost)
