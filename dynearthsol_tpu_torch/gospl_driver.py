"""GoSPL landscape-evolution coupling (surface_process_option 11;
counterpart of dynearthsol_tpu/gospl_driver.py).

The reference embeds a CPython interpreter and calls GoSPL through a C++
extension (gospl_driver/gospl-driver.{hpp,cxx}, bc.cxx:1104-1256,
dynearthsol.cxx:632-709).  Here the coupling is a direct import: when
the ``gospl`` package is available, GoSPLDriver builds a GoSPL mesh from
the DES surface, pushes surface velocities each coupling event, advances
GoSPL, and pulls back erosion/deposition increments which are applied like
any other surface dh (host numpy, from the state read back in float64).
Without GoSPL installed GoSPLDriver raises a clear error at construction
(the reference behaves the same when built without
HAS_GOSPL_CPP_INTERFACE).
"""

from __future__ import annotations

import numpy as np

from .constants import YEAR2SEC


def gospl_available() -> bool:
    try:
        import gospl  # noqa: F401

        return True
    except ImportError:
        return False


def generate_gospl_mesh(x_coords: np.ndarray, y_coords: np.ndarray,
                        resolution: float, perturbation: float,
                        padding: float, seed: int = 42):
    """Build the GoSPL surface mesh over the DES top-surface extent
    (GoSPLDriver::generate_mesh, gospl_driver/gospl-driver.cxx:461-600):
    the domain is padded by ``padding`` fraction per side so all DES
    surface nodes stay interior to the GoSPL mesh, gridded at
    ``resolution`` (auto-sized ~sqrt(n) when <= 0), interior nodes
    randomly perturbed by ``perturbation`` of the grid spacing, then
    Delaunay-triangulated.  Returns (points (N, 2), cells (M, 3))."""
    x = np.asarray(x_coords, dtype=np.float64)
    y = np.asarray(y_coords, dtype=np.float64)
    x_min, x_max = float(x.min()), float(x.max())
    y_min, y_max = float(y.min()), float(y.max())
    if y_max - y_min <= 0:
        # 2D DES surface (y == 0 everywhere): give the GoSPL strip a
        # finite width of one grid spacing so triangulation is 2D
        half = 0.5 * (resolution if resolution > 0
                      else (x_max - x_min) / max(x.size - 1, 1))
        y_min, y_max = -half, half
    x_pad = padding * (x_max - x_min)
    y_pad = padding * (y_max - y_min)
    x_min -= x_pad
    x_max += x_pad
    y_min -= y_pad
    y_max += y_pad
    if resolution > 0:
        nx = max(int((x_max - x_min) / resolution) + 1, 2)
        ny = max(int((y_max - y_min) / resolution) + 1, 2)
    else:
        nx = ny = int(np.sqrt(float(x.size))) + 1
    dx = (x_max - x_min) / (nx - 1)
    dy = (y_max - y_min) / (ny - 1)
    xx, yy = np.meshgrid(np.linspace(x_min, x_max, nx),
                         np.linspace(y_min, y_max, ny))
    xf, yf = xx.ravel(), yy.ravel()
    if perturbation > 0:
        rng = np.random.default_rng(seed)
        interior = ((xf > x_min) & (xf < x_max)
                    & (yf > y_min) & (yf < y_max))
        xf = xf + np.where(interior, rng.uniform(-0.5, 0.5, xf.size)
                           * dx * perturbation, 0.0)
        yf = yf + np.where(interior, rng.uniform(-0.5, 0.5, yf.size)
                           * dy * perturbation, 0.0)
    pts = np.stack([xf, yf], axis=1)
    from scipy.spatial import Delaunay

    cells = Delaunay(pts).simplices.astype(np.int32)
    return pts, cells


class GoSPLDriver:
    """Direct-Python port of GoSPLDriver (gospl-driver.hpp).

    Coupling cadence mirrors the reference: every ``coupling_frequency``
    steps or every ``coupling_interval_in_yr`` model years; it
    accumulates DES surface velocities between events and exchanges
    elevation with GoSPL at each event."""

    def __init__(self, param):
        if not gospl_available():
            raise ImportError(
                "surface_process_option 11 requires the `gospl` package "
                "(pip install gospl); see gospl_driver/gospl-driver.hpp "
                "in the reference for the coupled model description")
        ctrl = param.control
        self.param = param
        self.coupling_by_time = ctrl.gospl_coupling_mode == "time"
        self.coupling_frequency = ctrl.gospl_coupling_frequency
        self.coupling_interval = ctrl.gospl_coupling_interval_in_yr \
            * YEAR2SEC
        # when off, no uplift (DES surface velocity) is pushed to GoSPL
        # each coupling event (gospl-driver.hpp:59, dynearthsol.cxx:694)
        self.velocity_coupling = ctrl.gospl_velocity_coupling
        self.step_counter = 0
        self.accumulated_dt = 0.0
        self.needs_elevation_reset = True
        self.model = None
        self.elevation_history: list = []
        self.time_history: list = []

    # -- mesh/elevation exchange (generate_mesh / reset_elevation) --
    def initialize(self, yml_path: str, surface_xy: np.ndarray,
                   surface_elev: np.ndarray):
        """Create the GoSPL model over the DES surface nodes."""
        from gospl.model import Model  # type: ignore

        self.model = Model(yml_path, verbose=False)
        self._set_elevation(surface_xy, surface_elev)
        self.needs_elevation_reset = False

    def _set_elevation(self, xy, elev):
        # nearest-node transfer onto the GoSPL mesh
        from scipy.spatial import cKDTree

        gxy = self.model.mCoords[:, :2]
        _, idx = cKDTree(xy).query(gxy)
        self.model.hGlobal.setArray(elev[idx])

    def should_couple(self, dt: float) -> bool:
        return self.should_couple_elapsed(1, dt)

    def should_couple_elapsed(self, n_steps: int, dt_elapsed: float) -> bool:
        """Advance the coupling accumulators by a chunk of steps (the
        host-boundary form of the per-step counters, bc.cxx:1113-1125)."""
        self.step_counter += n_steps
        self.accumulated_dt += dt_elapsed
        if self.coupling_by_time:
            return self.accumulated_dt >= self.coupling_interval
        return self.step_counter >= self.coupling_frequency

    def steps_to_next_coupling(self) -> int:
        """Upper bound on steps until the next coupling event (drives the
        host wake-up scheduler in steps mode)."""
        if self.coupling_by_time:
            return 10  # time mode: re-check at the slow-update cadence
        return max(1, self.coupling_frequency - self.step_counter)

    def run_and_get_erosion(self, surface_xy: np.ndarray,
                            surface_elev: np.ndarray,
                            surface_vel: np.ndarray) -> np.ndarray:
        """Advance GoSPL over the accumulated interval and return the
        erosion/deposition increment dh at the DES surface nodes."""
        from scipy.spatial import cKDTree

        if self.needs_elevation_reset:
            self._set_elevation(surface_xy, surface_elev)
            self.needs_elevation_reset = False
        gxy = self.model.mCoords[:, :2]
        _, idx = cKDTree(surface_xy).query(gxy)
        if self.velocity_coupling:
            # push uplift = vertical surface velocity over the interval
            self.model.uplift = surface_vel[idx, -1]
        t0 = self.model.tNow
        self.model.runProcesses(self.accumulated_dt / YEAR2SEC)
        elev_g = np.asarray(self.model.hGlobal.getArray())
        # pull back to DES surface nodes
        _, ridx = cKDTree(gxy).query(surface_xy)
        new_elev = elev_g[ridx]
        dh = new_elev - surface_elev
        self.elevation_history.append(new_elev)
        self.time_history.append(t0)
        self.step_counter = 0
        self.accumulated_dt = 0.0
        return dh

    def on_remesh(self):
        """After remeshing GoSPL must re-initialize from the new DES
        surface (needs_elevation_reset, gospl-driver.hpp)."""
        self.needs_elevation_reset = True
