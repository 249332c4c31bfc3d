"""CLI driver: ``python -m dynearthsol_tpu_torch [--device cuda|cpu]
model.cfg`` (counterpart of dynearthsol_tpu/__main__.py).

Mirrors the reference's main/time loop (dynearthsol.cxx:573-1002): init or
restart, the frame-0 checkpoint and output, the step loop with output and
checkpoint scheduling, the sediment-marker bookkeeping of surface
processes and the mesh-quality check with its remesh at the quality-check
cadence, progress lines, and the end-of-run timing summary (Execute /
Compute / Output / Remesh, s/step).  Steps run in chunks through
``Simulation.run_steps``; the host wakes only at scheduling boundaries.

The run is on the card unless ``--device cpu`` is given; without a card
it fails as ``Simulation`` does.  Not ported yet, and refused with
``NotImplementedError`` before the first step: multi-device stepping
(``DES_N_DEVICES``), profiling (``DES_PROFILE_DIR``), GoSPL and the
custom surface hook (surface_process_option 11 and 101), phase changes,
earthquake tracking and adaptive output (use_global_velocity_scaling),
the monitor, and the isostasy and body-force pre-relaxations.
"""

from __future__ import annotations

import argparse
import os
import sys
import time as _time

import torch

from .config import load_config
from .constants import YEAR2SEC
from .io import Output, restart
from .ops import band2d, fused2d, fused3d
from .remeshing import bad_mesh_quality, remesh
from .simulation import Simulation

INT_MAX = 2**31 - 1


def unported_driver_features(p) -> list:
    """What this config or environment needs of the JAX package's driver
    that this one lacks."""
    out = []
    nd = os.environ.get("DES_N_DEVICES")
    if nd and (nd == "all" or int(nd) > 1):
        out.append("multi-device halo stepping (DES_N_DEVICES)")
    if os.environ.get("DES_PROFILE_DIR"):
        out.append("the profiler trace (DES_PROFILE_DIR)")
    if p.control.surface_process_option == 11:
        out.append("GoSPL coupling (surface_process_option 11)")
    if p.control.surface_process_option == 101:
        out.append("the custom surface hook (surface_process_option 101)")
    if p.mat.nmat > 1 and p.mat.phase_change_option != 0:
        out.append("phase changes (phase_change_option)")
    if p.control.use_global_velocity_scaling:
        out.append("earthquake tracking and adaptive output "
                   "(use_global_velocity_scaling)")
    if p.monitor.enabled and p.monitor.num_points > 0:
        out.append("the monitor ([monitor] enabled)")
    if p.ic.isostasy_adjustment_time_in_yr > 0:
        out.append("the isostasy pre-relaxation "
                   "(isostasy_adjustment_time_in_yr)")
    if p.ic.has_body_force_adjustment and p.control.has_PT \
            and not p.sim.is_restarting:
        out.append("the body-force pre-relaxation "
                   "(has_body_force_adjustment)")
    return out


def _next_event_step(sim, next_regular_frame, starting_step):
    """Smallest future step at which the host must wake: an output frame,
    a quality check or the end (dynearthsol.cxx:879-951)."""
    p = sim.param
    steps = int(sim.state.steps)
    qcsi = p.mesh.quality_check_step_interval
    candidates = [steps + (qcsi - steps % qcsi or qcsi), p.sim.max_steps]
    if p.sim.output_step_interval != INT_MAX:
        target = (starting_step
                  + next_regular_frame * p.sim.output_step_interval)
        if target > steps:
            candidates.append(target)
    return max(min(candidates), steps + 1)


def run(param, device: str = "cuda", argv_echo: str = ""):
    """Run ``param`` to its end on ``device`` ("cuda" or "cpu"), writing
    frames and checkpoints as the reference schedules them; returns the
    Simulation."""
    t_start = _time.monotonic_ns()
    p = param
    missing = unported_driver_features(p)
    if missing:
        raise NotImplementedError(
            "this driver does not port yet: " + "; ".join(missing))
    # the card by default: Simulation raises without one
    sim_device = None if device == "cuda" else device
    on_card = device == "cuda"

    if p.sim.is_restarting:
        sim, start_frame = restart(p, device=sim_device)
        out = Output(p, start_frame=start_frame + 1, start_time_ns=t_start)
        starting_step = int(sim.state.steps)
        starting_time = float(sim.state.time)
        print(f"Restarted from frame {start_frame} "
              f"(step {starting_step}).")
    else:
        sim = Simulation(p, device=sim_device)
        out = Output(p, start_frame=0, start_time_ns=t_start)
        starting_step = 0
        starting_time = 0.0
        if p.ic.has_body_force_adjustment:
            print("Warning: ic.has_body_force_adjustment needs "
                  "control.has_PT; skipping (dynearthsol.cxx:736 "
                  "'Only works with PT loop').")
        if p.sim.has_initial_checkpoint:
            out.write_checkpoint(sim)
        out.write_exact(sim)

    from .runtime_info import (report_mesh_info, report_runtime_status,
                               write_provenance)
    try:
        write_provenance(p, argv_echo, device=sim.device)
    except OSError:
        pass
    print(report_runtime_status(sim.device, sim.dtype))
    print(report_mesh_info(sim))

    next_regular_frame = 1
    last_wake_step = starting_step
    max_time = p.sim.max_time_in_yr * YEAR2SEC
    t_compute_ns = t_output_ns = t_quality_ns = t_remesh_ns = 0
    n_frames = n_quality = n_remesh = 0
    nsteps0 = int(sim.state.steps)

    while (int(sim.state.steps) < p.sim.max_steps
           and float(sim.state.time) <= max_time):
        target = _next_event_step(sim, next_regular_frame, starting_step)
        n = target - int(sim.state.steps)
        t0 = _time.monotonic_ns()
        sim.run_steps(n)
        if on_card:
            torch.cuda.synchronize()
        t_compute_ns += _time.monotonic_ns() - t0

        steps = int(sim.state.steps)
        now = float(sim.state.time)

        # fatal-dt contract (geometry.cxx:912-917): emergency frame + exit 11
        dt_now = float(sim.state.dt)
        if not (dt_now > 0.0):
            print(f"Error: dt <= 0!  dt={dt_now} at step {steps}",
                  file=sys.stderr)
            out.write_exact(sim)
            sys.exit(11)

        # terrigenous/hemipelagic deposition report every 10000 steps
        # (bc.cxx:1446,1491,1811: is_reporting_terrigenous_info)
        if (p.control.is_reporting_terrigenous_info
                and p.control.surface_process_option in (1, 102)
                and steps // 10000 > last_wake_step // 10000):
            dh_acc = sim.state.dhacc.detach().cpu().double().numpy()
            print(f"  surface deposition: max accumulated dh "
                  f"{dh_acc.max():.3e} m, min {dh_acc.min():.3e} m "
                  f"(step {steps})")
        last_wake_step = steps

        # output scheduling (dynearthsol.cxx:887-911)
        step_due = (p.sim.output_step_interval != INT_MAX and
                    (steps - starting_step) == next_regular_frame
                    * p.sim.output_step_interval)
        time_due = (p.sim.output_time_interval_in_yr != float("inf")
                    and (now - starting_time) > next_regular_frame
                    * p.sim.output_time_interval_in_yr * YEAR2SEC)
        avg_ok = (not p.sim.is_outputting_averaged_fields
                  or steps % p.mesh.quality_check_step_interval == 0)
        if (step_due or time_due) and avg_ok:
            t0 = _time.monotonic_ns()
            if next_regular_frame % p.sim.checkpoint_frame_interval == 0:
                out.write_checkpoint(sim)
            out.write(sim)
            t_output_ns += _time.monotonic_ns() - t0
            n_frames += 1
            next_regular_frame += 1
            sim.reference_frame_time = (
                starting_time + next_regular_frame
                * p.sim.output_time_interval_in_yr * YEAR2SEC)

        # sediment marker bookkeeping at quality-check cadence
        # (bc.cxx:1795-1812)
        if (p.control.surface_process_option != 0
                and steps % p.mesh.quality_check_step_interval == 0):
            sim.sync_surface_markers()

        # quality check + remeshing (dynearthsol.cxx:914-934)
        min_quality = 1.0
        if (steps % p.mesh.quality_check_step_interval == 0
                and p.control.has_moving_mesh):
            t0 = _time.monotonic_ns()
            bad, min_quality = bad_mesh_quality(sim)
            t_quality_ns += _time.monotonic_ns() - t0
            n_quality += 1
            if bad:
                t0 = _time.monotonic_ns()
                if p.sim.has_output_during_remeshing:
                    out.write_exact(sim)
                remesh(sim, bad)
                if p.sim.has_output_during_remeshing:
                    out.write_exact(sim)
                t_remesh_ns += _time.monotonic_ns() - t0
                n_remesh += 1

        # progress line (dynearthsol.cxx:936-950)
        if steps >= sim.info_display_next_step:
            wt = (_time.monotonic_ns() - t_start) * 1e-9
            q = f", min_q = {min_quality:.4f}" if min_quality < 1.0 else ""
            print(f"              Step = {steps}, time = "
                  f"{now / YEAR2SEC:.5e} yr, vmax = "
                  f"{float(sim.state.max_global_vel_mag):.3e} m/s{q}, "
                  f"wt = {wt:.1f} s")
            sim.info_display_next_step = (
                steps + p.sim.info_display_step_interval)

    # final timing summary (dynearthsol.cxx:963-1002)
    t_total = (_time.monotonic_ns() - t_start) * 1e-9
    nsteps = int(sim.state.steps) - nsteps0
    print(f"Execute:  {t_total:.2f} s")
    if nsteps:
        print(f"Compute:  {t_compute_ns * 1e-9:.2f} s / {nsteps} steps = "
              f"{t_compute_ns * 1e-9 / nsteps:.3e} s/step")
    print(f"Output:   {t_output_ns * 1e-9:.2f} s / {n_frames} frames"
          + (f" = {t_output_ns * 1e-9 / n_frames:.3e} s/frame"
             if n_frames else ""))
    print(f"Quality:  {t_quality_ns * 1e-9:.2f} s / {n_quality} checks")
    print(f"Remesh:   {t_remesh_ns * 1e-9:.2f} s / {n_remesh}"
          + (f" = {t_remesh_ns * 1e-9 / n_remesh:.2f} s/remesh"
             if n_remesh else ""))
    print(f"Path:     {sim.step_path}")
    print("Launches: " + ", ".join(f"{k} {v}"
                                   for k, v in kernel_launches().items()))
    return sim


def kernel_launches() -> dict:
    """Launches of each hand-written kernel in this process, as their
    wrappers count them (0 on the CPU, where the plain versions run)."""
    return {w.__name__: w.launches for w in (
        fused2d.fused_chunk, fused2d.dt_refresh, fused3d.fused3d_step,
        fused3d.fused3d_finalize, band2d.cgather, band2d.asm_pack,
        band2d.asm_gather)}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m dynearthsol_tpu_torch",
        description="Run a DynEarthSol model (.cfg) with the PyTorch port.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the card (default) or the CPU's plain versions")
    ap.add_argument("config", help="model configuration file")
    args = ap.parse_args(argv)
    run(load_config(args.config), device=args.device,
        argv_echo=" ".join(["python -m dynearthsol_tpu_torch"]
                           + list(argv if argv is not None
                                  else sys.argv[1:])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
