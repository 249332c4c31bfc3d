"""Remeshing's quality trigger (counterpart of dynearthsol_tpu/remeshing.py;
remeshing.cxx:2738-2852).

The driver reads the state to the host every quality_check_step_interval
steps and asks ``bad_mesh_quality``; the remesh itself is not ported yet,
so a bad mesh stops the run (``__main__.py``).
"""

from __future__ import annotations

import math

import numpy as np

from .constants import BOUNDX0, BOUNDX1, BOUNDY0, BOUNDY1, BOUNDZ0

# volume of the equilateral simplex with unit side (remeshing.cxx sizefactor)
SIZEFACTOR_2D = math.sqrt(3.0) / 4.0
SIZEFACTOR_3D = 1.0 / (6.0 * math.sqrt(2.0))


def _elem_quality_np(coord: np.ndarray, conn: np.ndarray,
                     volume: np.ndarray) -> np.ndarray:
    """Element quality = normalized volume-to-edge ratio
    (geometry.cxx:1157-1211 elem_quality)."""
    v = coord[conn]
    if coord.shape[1] == 2:
        e01 = ((v[:, 1] - v[:, 0]) ** 2).sum(axis=1)
        e12 = ((v[:, 2] - v[:, 1]) ** 2).sum(axis=1)
        e20 = ((v[:, 0] - v[:, 2]) ** 2).sum(axis=1)
        return 4.0 * math.sqrt(3.0) * volume / (e01 + e12 + e20)
    s = np.zeros(conn.shape[0])
    for i, j in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)):
        s += ((v[:, j] - v[:, i]) ** 2).sum(axis=1)
    rms = np.sqrt(s / 6.0)
    return 6.0 * math.sqrt(2.0) * volume / rms ** 3


def bad_mesh_quality(sim) -> tuple[int, float]:
    """Quality trigger (remeshing.cxx:2738-2852).  Returns (code, min_q):
    code 0 good, 1 distorted element, 2 boundary node strayed, 3 tiny
    element."""
    param = sim.param
    ndims = param.sim.ndims
    coord = sim.state.coord.detach().cpu().double().numpy()
    volume = sim.state.volume.detach().cpu().double().numpy()
    conn, bcflag = sim.topo.connectivity, sim.topo.bcflag

    sizefactor = SIZEFACTOR_2D if ndims == 2 else SIZEFACTOR_3D
    smallest_vol = (param.mesh.smallest_size * sizefactor
                    * param.mesh.resolution ** ndims)
    if (volume < smallest_vol).any():
        e = int(np.argmin(volume))
        print(f"    The size of element #{e} is too small.")
        return 3, 1.0

    dist = param.mesh.max_boundary_distortion * param.mesh.resolution

    def strayed(bit, axis, at):
        x = coord[(bcflag & bit) != 0, axis]
        return bool(x.size and (np.abs(x - at) > dist).any())

    if param.mesh.remeshing_option in (1, 2, 11, 13) \
            and strayed(BOUNDZ0, ndims - 1, -param.mesh.zlength):
        print("    A bottom node moved too far from the flat bottom.")
        return 2, 1.0
    if param.mesh.remeshing_option == 13:
        sides = [(BOUNDX0, 0, 0.0), (BOUNDX1, 0, param.mesh.xlength)]
        if ndims == 3:
            sides += [(BOUNDY0, 1, 0.0), (BOUNDY1, 1, param.mesh.ylength)]
        if any([strayed(*side) for side in sides]):
            print("    A side node moved too far from its side.")
            return 2, 1.0

    q = _elem_quality_np(coord, conn, volume)
    worst = float(q.min())
    if ndims == 3:
        worst = worst ** (1.0 / 3.0)
    if worst < param.mesh.min_quality:
        e = int(np.argmin(q))
        print(f"    Element #{e} has mesh quality = {worst:.4f}.")
        return 1, worst
    return 0, worst
