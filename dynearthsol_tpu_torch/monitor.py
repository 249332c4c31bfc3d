"""Monitor probes: per-point CSV time series (host; counterpart of
dynearthsol_tpu/monitor.py).

Reference: monitor.cxx.  Fixed query points bind to the nearest node and
element (monitor.cxx:134-229); every ``step_interval`` steps a CSV row of
the selected fields is appended (monitor.cxx:263-375); across remeshing the
points rebind by initial or pre-remesh coordinates (monitor.cxx:377-463).
Column names and order match write_csv_header (monitor.cxx:80-131) so the
reference's benchmark checkers parse the files unchanged.  Fields are
read back from the run's device in float64 and written as the JAX
package writes them, text for text.
"""

from __future__ import annotations

import numpy as np
import torch

UNIT_SCALE = {"mm": 1e-3, "cm": 1e-2, "m": 1.0, "km": 1e3}


def _axis_names(ndims):
    return ("x", "z") if ndims == 2 else ("x", "y", "z")


class Monitor:
    def __init__(self, param, sim):
        self.param = param
        mon = param.monitor
        self.enabled = mon.enabled and mon.num_points > 0
        self._files = []
        if not self.enabled:
            self.points = np.zeros((0, param.sim.ndims))
            return
        ndims = param.sim.ndims
        scale = UNIT_SCALE.get(mon.points_unit, 1.0)
        xs = np.asarray(mon.points_x[: mon.num_points]) * scale
        if ndims == 2:
            # 2D: points_y is a legacy alias for points_z (input.cxx:93-96)
            zsrc = mon.points_z if mon.points_z else mon.points_y
            zs = np.asarray(zsrc[: mon.num_points]) * scale
            self.points = np.stack([xs, zs], axis=1)
        else:
            ys = np.asarray(mon.points_y[: mon.num_points]) * scale
            zs = np.asarray(mon.points_z[: mon.num_points]) * scale
            self.points = np.stack([xs, ys, zs], axis=1)
        self.initial_points = self.points.copy()
        self.rebind_points = self.points.copy()
        self.node_id = np.zeros(len(self.points), dtype=int)
        self.elem_id = np.zeros(len(self.points), dtype=int)
        self._files = []
        self.bind(sim)
        self._open(param)
        self.next_step = 0

    # ---- binding (monitor.cxx:134-229) ----
    def _query(self):
        if self.param.monitor.remesh_rebind == "initial_coord":
            return self.initial_points
        return self.rebind_points

    def bind(self, sim):
        if not self.enabled:
            return
        coord = sim._host(sim.state.coord)
        cent = coord[sim.topo.connectivity].mean(axis=1)
        q = self._query()
        for i, p in enumerate(q):
            self.node_id[i] = int(np.argmin(((coord - p) ** 2).sum(axis=1)))
            self.elem_id[i] = int(np.argmin(((cent - p) ** 2).sum(axis=1)))

    def before_remesh(self, sim):
        """Capture pre-remesh coordinates (monitor.cxx:377-392)."""
        if not self.enabled:
            return
        coord = sim._host(sim.state.coord)
        self.rebind_points = coord[self.node_id].copy()

    def rebind(self, sim):
        if not self.enabled:
            return
        self.bind(sim)

    # ---- CSV (monitor.cxx:80-131, 263-375) ----
    def _columns(self):
        m = self.param.monitor
        ndims = self.param.sim.ndims
        nstr = ndims * (ndims + 1) // 2
        ax = _axis_names(ndims)
        cols = ["step", "time_s"] + [f"query_{a}" for a in ax] \
            + ["matched_node", "matched_elem"]
        if m.output_coord:
            cols += [f"coord_{a}" for a in ax]
        if m.output_velocity:
            cols += [f"velocity_{a}" for a in ax]
        if m.output_force:
            cols += [f"force_{a}" for a in ax]
        if m.output_temperature:
            cols += ["temperature"]
        if m.output_pore_pressure:
            cols += ["pore_pressure"]
        if m.output_bcflag:
            cols += ["bcflag"]
        for name, on in (("stress", m.output_stress),
                         ("strain", m.output_strain),
                         ("strain_rate", m.output_strain_rate)):
            if on:
                cols += [f"{name}_{c}" for c in range(nstr)]
        if m.output_plastic_strain:
            cols += ["plastic_strain"]
        if m.output_plastic_strain_rate:
            cols += ["plastic_strain_rate"]
        if m.output_radiogenic_source:
            cols += ["radiogenic_source"]
        if m.output_density:
            cols += ["density"]
        if m.output_mesh_quality:
            cols += ["mesh_quality"]
        if m.output_viscosity:
            cols += ["viscosity"]
        if m.output_material:
            cols += ["material"]
        if m.output_dynamic_friction:
            cols += ["dynamic_friction"]
        if m.output_state_variable:
            cols += ["state_variable"]
        return cols

    def _open(self, param):
        for i in range(len(self.points)):
            f = open(f"{param.monitor.output_prefix}_point_{i}.csv", "w")
            if param.monitor.write_header:
                f.write(",".join(self._columns()) + "\n")
                f.flush()
            self._files.append(f)

    def write_if_due(self, sim):
        """Append a row per point when steps crossed the interval
        (monitor_write_if_due, monitor.cxx:427-443)."""
        if not self.enabled:
            return
        steps = int(sim.state.steps)
        if steps < self.next_step:
            return
        interval = self.param.monitor.step_interval
        self.next_step = (steps // interval + 1) * interval
        m = self.param.monitor
        s, host = sim.state, sim._host
        q = self._query()
        density = sim.elem_density() if m.output_density else None
        quality = sim.elem_quality() if m.output_mesh_quality else None
        # the rows of the fields the CSV reads, gathered on the run's
        # device and brought to the host in float64 at once
        at = {"node": torch.as_tensor(self.node_id, device=sim.device),
              "elem": torch.as_tensor(self.elem_id, device=sim.device)}
        f = {nm: host(getattr(s, nm)[at[kind]]) for nm, kind, on in (
            ("coord", "node", m.output_coord),
            ("vel", "node", m.output_velocity),
            ("force", "node", m.output_force),
            ("temperature", "node", m.output_temperature),
            ("ppressure", "node", m.output_pore_pressure),
            ("stress", "elem", m.output_stress),
            ("strain", "elem", m.output_strain),
            ("strain_rate", "elem", m.output_strain_rate),
            ("plstrain", "elem", m.output_plastic_strain),
            ("delta_plstrain", "elem", m.output_plastic_strain_rate),
            ("radiogenic_source", "elem", m.output_radiogenic_source),
            ("viscosity", "elem", m.output_viscosity),
            ("emw", "elem", m.output_material),
            ("dyn_fric_coeff", "elem", m.output_dynamic_friction),
            ("state_variable", "elem", m.output_state_variable)) if on}
        for i in range(len(self.points)):
            n, e = self.node_id[i], self.elem_id[i]
            row = [steps, float(s.time)] + list(q[i]) + [n, e]
            if m.output_coord:
                row += list(f["coord"][i])
            if m.output_velocity:
                row += list(f["vel"][i])
            if m.output_force:
                row += list(f["force"][i])
            if m.output_temperature:
                row += [float(f["temperature"][i])]
            if m.output_pore_pressure:
                row += [float(f["ppressure"][i])]
            if m.output_bcflag:
                row += [int(sim.topo.bcflag[n])]
            if m.output_stress:
                row += list(f["stress"][i])
            if m.output_strain:
                row += list(f["strain"][i])
            if m.output_strain_rate:
                row += list(f["strain_rate"][i])
            if m.output_plastic_strain:
                row += [float(f["plstrain"][i])]
            if m.output_plastic_strain_rate:
                row += [float(f["delta_plstrain"][i])]
            if m.output_radiogenic_source:
                row += [float(f["radiogenic_source"][i])]
            if m.output_density:
                row += [float(density[e])]
            if m.output_mesh_quality:
                row += [float(quality[e])]
            if m.output_viscosity:
                row += [float(f["viscosity"][i])]
            if m.output_material:
                row += [int(np.argmax(f["emw"][i]))]
            if m.output_dynamic_friction:
                row += [float(f["dyn_fric_coeff"][i])]
            if m.output_state_variable:
                row += [float(f["state_variable"][i])]
            self._files[i].write(
                ",".join(str(v) if isinstance(v, int) else f"{v:.17g}"
                         for v in row) + "\n")
            self._files[i].flush()

    def finalize(self):
        for f in self._files:
            f.close()
        self._files = []
