"""Earthquake-cycle tracking and adaptive (event-triggered) output
scheduling (host; counterpart of dynearthsol_tpu/earthquake.py).

Reference: earthquake_state.cxx (event detection from velocity and plastic
strain-rate thresholds, seismic moment accumulation M0 -> Mw) and
ats_output_scheduler.cxx (earthquake-triggered output with regular-frame
catch-up).  The tracking runs at the CLI's wakes, from the state read back
in float64; the CLI wakes at least every earthquake_output_step_interval
steps when use_global_velocity_scaling is on, which bounds the detection
latency.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .config import RH_RSF
from .constants import YEAR2SEC
from .ops import matprops as M

MIN_EARTHQUAKE_SPEED = 1e-6  # m/s (earthquake_state.cxx:14)


@dataclass
class EarthquakeState:
    in_earthquake_mode: bool = False
    allow_earthquake_output: bool = False
    last_output_step: int = 0
    cumulative_moment_by_mat: np.ndarray = field(
        default_factory=lambda: np.zeros(0))

    @staticmethod
    def init(param) -> "EarthquakeState":
        return EarthquakeState(
            cumulative_moment_by_mat=np.zeros(param.mat.nmat))


def _seismic_moment_rate_by_material(sim) -> np.ndarray:
    """M0 rate per dominant material (earthquake_state.cxx:58-102)."""
    s, host = sim.state, sim._host
    vel = host(s.vel)
    conn = sim.topo.connectivity
    vmean = vel[conn].mean(axis=1)
    vmag = np.sqrt((vmean ** 2).sum(axis=1))
    volume = host(s.volume)
    shearm = host(M.shearm(sim.ctx.mat, s.emw))
    emw = host(s.emw)
    dominant = np.argmax(emw, axis=1)
    out = np.zeros(sim.param.mat.nmat)
    np.add.at(out, dominant, shearm * volume * vmag)
    return out


def update_earthquake_tracking(param, sim, state: EarthquakeState):
    """Event enter/exit and moment accumulation
    (earthquake_state.cxx:114-183); appends to
    seismic_moment_magnitude.txt in the working directory.  Returns the
    host ms of the reads of vel and delta_plstrain (0 off RSF)."""
    if not (param.mat.rheol_type & RH_RSF):
        state.in_earthquake_mode = False
        state.allow_earthquake_output = False
        return 0.0

    s, host = sim.state, sim._host
    t0 = time.perf_counter()
    vel, dpls = host(s.vel), host(s.delta_plstrain)
    read_ms = (time.perf_counter() - t0) * 1e3
    vmax = float(np.sqrt((vel ** 2).sum(axis=1)).max())
    dt = max(float(s.dt), 1e-30)
    max_pls_rate = float(np.abs(dpls).max()) / dt
    plastic_active = max_pls_rate > 0.0

    start_thr = max(param.sim.earthquake_start_factor * sim.ctx.max_vbc_val,
                    MIN_EARTHQUAKE_SPEED)
    end_thr = max(param.sim.earthquake_end_factor * sim.ctx.max_vbc_val,
                  0.5 * MIN_EARTHQUAKE_SPEED)

    now = (vmax > start_thr) and plastic_active
    ended = (vmax < end_thr) or not plastic_active
    steps = int(s.steps)

    if not state.in_earthquake_mode and now:
        state.in_earthquake_mode = True
        state.last_output_step = steps
        if param.sim.seismic_moment_calculate_output:
            state.cumulative_moment_by_mat[:] = 0.0
            with open("seismic_moment_magnitude.txt", "a") as f:
                f.write(f"Earthquake event started at time: "
                        f"{float(s.time)} s\n")
    elif state.in_earthquake_mode and ended:
        state.in_earthquake_mode = False
        if param.sim.seismic_moment_calculate_output:
            m0 = float(state.cumulative_moment_by_mat.sum())
            with open("seismic_moment_magnitude.txt", "a") as f:
                f.write(f"Earthquake event ended at time: "
                        f"{float(s.time)} s\n")
                f.write(f"Total seismic moment (M0): {m0}\n")
                if m0 > 0:
                    mw = (2.0 / 3.0) * (np.log10(m0) - 9.1)
                    f.write(f"Moment magnitude (Mw): {mw}\n")
                f.write("----------------------------------------\n")

    if state.in_earthquake_mode and param.sim.seismic_moment_calculate_output:
        state.cumulative_moment_by_mat += \
            _seismic_moment_rate_by_material(sim) * float(s.dt)

    state.allow_earthquake_output = (
        steps - state.last_output_step
        >= param.sim.earthquake_output_step_interval)
    return read_ms


def handle_ats_output(param, sim, output, state: EarthquakeState,
                      starting_time: float, starting_step: int,
                      next_regular_frame: int) -> int:
    """Adaptive output: earthquake frames and regular frames with catch-up
    (ats_output_scheduler.cxx:11-78).  Returns the new
    next_regular_frame."""
    INT_MAX = 2**31 - 1
    steps = int(sim.state.steps)
    now = float(sim.state.time)

    allowed = (not param.sim.is_outputting_averaged_fields
               or steps % param.mesh.quality_check_step_interval == 0)
    regular_due = allowed and (
        (param.sim.output_step_interval != INT_MAX
         and steps - starting_step
         >= next_regular_frame * param.sim.output_step_interval)
        or (param.sim.output_time_interval_in_yr != float("inf")
            and now - starting_time >= next_regular_frame
            * param.sim.output_time_interval_in_yr * YEAR2SEC))

    wrote_eq = False
    if state.in_earthquake_mode and state.allow_earthquake_output and allowed:
        if next_regular_frame % param.sim.checkpoint_frame_interval == 0:
            output.write_checkpoint(sim)
        output.write(sim)
        state.last_output_step = steps
        wrote_eq = True

    if regular_due:
        if not (wrote_eq and state.last_output_step == steps):
            if next_regular_frame % param.sim.checkpoint_frame_interval == 0:
                output.write_checkpoint(sim)
            output.write(sim)
        frames_due_step = 0
        if param.sim.output_step_interval != INT_MAX:
            frames_due_step = (steps - starting_step) \
                // param.sim.output_step_interval
        frames_due_time = 0
        if param.sim.output_time_interval_in_yr != float("inf"):
            frames_due_time = int((now - starting_time) / YEAR2SEC
                                  / param.sim.output_time_interval_in_yr)
        next_regular_frame = max(frames_due_step, frames_due_time) + 1
    return next_regular_frame
