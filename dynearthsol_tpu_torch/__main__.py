"""CLI driver: ``python -m dynearthsol_tpu_torch [--device cuda|cpu]
model.cfg`` (counterpart of dynearthsol_tpu/__main__.py).

Mirrors the reference's main/time loop (dynearthsol.cxx:573-1002): init or
restart, the frame-0 checkpoint and output, the step loop with output and
checkpoint scheduling (adaptive, earthquake-triggered output under
use_global_velocity_scaling), the monitor's rows, the marker phase changes
and hydrous-marker transport, the host-applied surface increments of GoSPL
(surface_process_option 11) and the custom hook (101), the sediment-marker
bookkeeping of surface processes and the mesh-quality check with its
remesh at the quality-check cadence, progress lines, and the end-of-run
timing summary (Execute / Compute / Output / Remesh, s/step, and the host
ms per wake of the host features).  Steps run in chunks through
``Simulation.run_steps``; the host wakes only at scheduling boundaries.
``DES_PROFILE_DIR`` writes a ``torch.profiler`` Chrome trace of the whole
run (CUDA activity included on the card) into that directory.
``DES_N_DEVICES=N`` (or ``all``) steps through the node-sharded halo step
(parallel/halo_step.py) on the first N cards, or on N shards of the CPU
with ``--device cpu``; the host events see the flat state, gathered
after each chunk, and a remesh re-plans the shards.

The isostasy and body-force pre-relaxations run after the initialisation
and before frame 0, as in the JAX package.  The run is on the card unless
``--device cpu`` is given; without a card it fails as ``Simulation``
does.  VTKHDF frames (``output_format = vtkhdf``) need h5py: without it
the run stops with an ImportError that names it, before the set-up and
before any file.
"""

from __future__ import annotations

import argparse
import os
import sys
import time as _time

import numpy as np
import torch

from .config import RH_RSF, load_config
from .constants import YEAR2SEC
from .earthquake import (EarthquakeState, handle_ats_output,
                         update_earthquake_tracking)
from .io import Output, restart
from .monitor import Monitor
from .ops import band2d, fused2d, fused3d
from .phasechanges import advect_hydrous_markers, phase_changes
from .remeshing import bad_mesh_quality, remesh
from .simulation import Simulation

INT_MAX = 2**31 - 1


def unported_driver_features(p) -> list:
    """What this config or environment needs of the JAX package's CLI
    that this one lacks: nothing since multi-device stepping is ported
    (``run`` still checks the list before the set-up)."""
    return []


class HaloStepper:
    """Multi-device stepping for the CLI driver (JAX __main__.HaloStepper).

    Wraps parallel.halo_step: nodal state lives sharded ~1/N (+ halo
    windows) over a group of devices (parallel/group.py), one thread per
    shard.  The CLI's host events (output, checkpoints, quality checks,
    remeshing, marker bookkeeping) need the flat state, so ``run_steps``
    gathers it into ``sim.state`` after each call; where a host event has
    replaced ``sim.state`` since, the next call shards it anew.  After a
    remesh the shapes change: ``rebuild()`` re-plans the partition and
    re-shards the fresh state."""

    def __init__(self, sim, group):
        self.sim = sim
        self.group = group
        self._build()

    def _build(self):
        from .parallel.halo_step import make_halo_runner

        (self._ctx_sh, self._state_sh, self._run_chunk,
         self._plan) = make_halo_runner(self.sim, self.group)
        self._synced = self.sim.state
        self.sim.step_path = "halo"

    def run_steps(self, n: int, chunk: int | None = None):
        from .parallel.halo_step import build_halo_state, shard_state

        if self.sim.state is not self._synced:
            s2 = build_halo_state(self.sim, self._plan)
            self._state_sh = self.group.run(lambda d: shard_state(
                s2, self._plan, d, self.group.devices[d], self.sim.state))
        chunk = chunk or min(n, self.sim.param.sim.scan_chunk_steps
                             or 100)
        done = 0
        while done < n:
            c = min(chunk, n - done)
            self._state_sh = self._run_chunk(self._ctx_sh, self._state_sh,
                                             c)
            done += c
        self.sync()

    def sync(self):
        """Gather the sharded state into sim.state."""
        from .parallel.halo_step import unpack_state

        self.sim.state = unpack_state(self._state_sh, self._plan,
                                      self.sim.state)
        self._synced = self.sim.state

    def rebuild(self):
        """Re-plan and re-shard after a topology change (remesh)."""
        self._build()


def _make_stepper(sim):
    """The CLI's multi-device opt-in (JAX __main__._make_stepper):
    DES_N_DEVICES=N (or 'all') selects the node-sharded halo step on the
    first N cards, as the JAX package takes its first N devices (so one
    card gives one shard), or with the run on the CPU on N shards of it.
    A config the halo step refuses runs on one device, with a warning."""
    from .parallel import make_device_mesh

    nd = os.environ.get("DES_N_DEVICES")
    if not nd:
        return None
    if nd == "all":
        n = torch.cuda.device_count() if sim.device.type == "cuda" else 1
    else:
        n = int(nd)
    if n <= 1:
        return None
    try:
        stepper = HaloStepper(sim, make_device_mesh(n, sim.device.type))
    except (NotImplementedError, ValueError) as e:
        print(f"Warning: multi-chip halo step unavailable ({e}); "
              "running single-device.")
        return None
    print(f"Multi-chip: node-sharded halo step on {n} devices.")
    return stepper


def _next_event_step(sim, next_regular_frame, starting_step, mon=None):
    """Smallest future step at which the host must wake: an output frame,
    a quality check, a monitor row, an earthquake-tracking tick, a phase
    change, a GoSPL coupling or the custom hook, or the end
    (dynearthsol.cxx:879-951; JAX __main__.py:121-147)."""
    p = sim.param
    steps = int(sim.state.steps)
    qcsi = p.mesh.quality_check_step_interval
    candidates = [steps + (qcsi - steps % qcsi or qcsi), p.sim.max_steps]
    if p.sim.output_step_interval != INT_MAX:
        target = (starting_step
                  + next_regular_frame * p.sim.output_step_interval)
        if target > steps:
            candidates.append(target)
    if mon is not None and mon.enabled:
        candidates.append(max(mon.next_step, steps + 1))
    if p.control.use_global_velocity_scaling:
        # the tracking cadence bounds the event-detection latency
        candidates.append(steps + p.sim.earthquake_output_step_interval)
    if p.mat.nmat > 1 and p.mat.phase_change_option != 0:
        candidates.append(steps + 10)  # dynearthsol.cxx:861-871 cadence
    if p.control.surface_process_option == 11 \
            and getattr(sim, "gospl", None) is not None:
        candidates.append(steps + sim.gospl.steps_to_next_coupling())
    elif p.control.surface_process_option == 101:
        # the reference calls the custom hook every step (bc.cxx case 101)
        candidates.append(steps + 1)
    return max(min(candidates), steps + 1)


def _init_gospl(sim, p):
    """GoSPL coupling's set-up (dynearthsol.cxx:632-709): GoSPLDriver, the
    GoSPL mesh file unless one exists (restart reuse), the model over the
    DES surface.  Without ``gospl`` the ImportError is printed and the
    run exits 1, as the JAX package's does."""
    from . import gospl_driver
    try:
        sim.gospl = gospl_driver.GoSPLDriver(p)
        top = np.asarray(sim.ctx.surf.top_nodes)
        coord0 = sim._host(sim.state.coord)
        mesh_file = "gospl_mesh.npz"
        if not os.path.exists(mesh_file):
            xs = coord0[top, 0]
            ys = coord0[top, 1] if p.sim.ndims == 3 else np.zeros_like(xs)
            gp, gc = gospl_driver.generate_gospl_mesh(
                xs, ys, p.control.gospl_mesh_resolution,
                p.control.gospl_mesh_perturbation,
                p.control.gospl_mesh_padding)
            np.savez(mesh_file, v=np.column_stack([gp, np.zeros(len(gp))]),
                     c=gc, z=np.zeros(len(gp)))
        sim.gospl.initialize(p.control.surface_process_gospl_config_file,
                             coord0[top, :-1], coord0[top, -1])
    except ImportError as e:
        print(f"Error: {e}", file=sys.stderr)
        sys.exit(1)


def run(param, device: str = "cuda", argv_echo: str = "",
        wake_log: list | None = None):
    """Run ``param`` to its end on ``device`` ("cuda" or "cpu"), writing
    frames and checkpoints as the reference schedules them; returns the
    Simulation.  Where ``wake_log`` is a list, a record of each wake at
    which a host feature ran is appended to it: its step, the host ms by
    part (keys ending in ``_ms``), the phase transitions and hydrous
    markers, and the seconds and steps of the chunk before it
    (``chunk_s``, ``chunk_steps``)."""
    t_start = _time.monotonic_ns()
    p = param
    missing = unported_driver_features(p)
    if missing:
        raise NotImplementedError(
            "this driver does not port yet: " + "; ".join(missing))
    # the card by default: Simulation raises without one
    sim_device = None if device == "cuda" else device
    on_card = device == "cuda"

    # a trace of the whole run (the JAX package's jax.profiler trace)
    prof_dir = os.environ.get("DES_PROFILE_DIR")
    prof = None
    if prof_dir:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else []))
        prof.start()

    if p.sim.is_restarting:
        sim, start_frame = restart(p, device=sim_device)
        out = Output(p, start_frame=start_frame + 1, start_time_ns=t_start)
        starting_step = int(sim.state.steps)
        starting_time = float(sim.state.time)
        print(f"Restarted from frame {start_frame} "
              f"(step {starting_step}).")
    else:
        # the writer first: it refuses a format it cannot write (VTKHDF
        # without h5py) before the set-up
        out = Output(p, start_frame=0, start_time_ns=t_start)
        sim = Simulation(p, device=sim_device)
        starting_step = 0
        starting_time = 0.0
        # optional isostasy pre-relaxation (dynearthsol.cxx:616-619)
        if p.ic.isostasy_adjustment_time_in_yr > 0:
            n = sim.isostasy_adjustment()
            print(f"Adjusted isostasy for {n} steps.")
        # optional PT gravity pre-relaxation (dynearthsol.cxx:731-739)
        if p.ic.has_body_force_adjustment:
            if not p.control.has_PT:
                print("Warning: ic.has_body_force_adjustment needs "
                      "control.has_PT; skipping (dynearthsol.cxx:736 "
                      "'Only works with PT loop').")
            else:
                n = sim.body_force_adjustment()
                print(f"Adjusted initial body force for {n} PT "
                      "iterations.")
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

    mon = Monitor(p, sim)
    stepper = _make_stepper(sim)
    mon.write_if_due(sim)  # row at the starting step (monitor_initialize)
    eq = EarthquakeState.init(p)
    if p.control.surface_process_option == 11 \
            and getattr(sim, "gospl", None) is None:
        _init_gospl(sim, p)
    phases_on = p.mat.nmat > 1 and p.mat.phase_change_option != 0

    next_regular_frame = 1
    last_phase_time = starting_time
    last_wake_step, last_wake_time = starting_step, starting_time
    max_time = p.sim.max_time_in_yr * YEAR2SEC
    t_compute_ns = t_output_ns = t_quality_ns = t_remesh_ns = 0
    n_frames = n_quality = n_remesh = 0
    nsteps0 = int(sim.state.steps)
    host_ms, n_wakes = {}, 0          # the Wakes: line's running sums

    def timed(wake, key, fn, *args):
        t0 = _time.perf_counter()
        r = fn(*args)
        wake[key] = wake.get(key, 0.0) + (_time.perf_counter() - t0) * 1e3
        return r

    while (int(sim.state.steps) < p.sim.max_steps
           and float(sim.state.time) <= max_time):
        target = _next_event_step(sim, next_regular_frame, starting_step,
                                  mon)
        n = target - int(sim.state.steps)
        t0 = _time.monotonic_ns()
        if stepper is not None:
            stepper.run_steps(n)
        else:
            sim.run_steps(n)
        if on_card:
            torch.cuda.synchronize()
        chunk_ns = _time.monotonic_ns() - t0
        t_compute_ns += chunk_ns

        steps = int(sim.state.steps)
        now = float(sim.state.time)
        wake = {"step": steps}

        # fatal-dt contract (geometry.cxx:912-917): emergency frame + exit 11
        dt_now = float(sim.state.dt)
        if not (dt_now > 0.0):
            print(f"Error: dt <= 0!  dt={dt_now} at step {steps}",
                  file=sys.stderr)
            out.write_exact(sim)
            sys.exit(11)

        # externally driven surface processes at the wakes: GoSPL coupling
        # (option 11, bc.cxx:1104-1256) and the custom hook (option 101,
        # bc.cxx case 101)
        if p.control.surface_process_option == 11 \
                and getattr(sim, "gospl", None) is not None:
            if sim.gospl.should_couple_elapsed(steps - last_wake_step,
                                               now - last_wake_time):
                coord_h = sim._host(sim.state.coord)
                vel_h = sim._host(sim.state.vel)
                top = np.asarray(sim.ctx.surf.top_nodes)
                dh_top = timed(wake, "gospl_ms",
                               sim.gospl.run_and_get_erosion,
                               coord_h[top, :-1], coord_h[top, -1],
                               vel_h[top])
                timed(wake, "surface_dh_ms", sim.apply_host_surface_dh,
                      dh_top)
        elif p.control.surface_process_option == 101:
            from .hooks import get_custom_surface_process
            hook = get_custom_surface_process()
            if hook is not None:
                dh_top = timed(wake, "hook_ms", hook, sim,
                               now - last_wake_time)
                if dh_top is not None:
                    timed(wake, "surface_dh_ms", sim.apply_host_surface_dh,
                          dh_top)
        # terrigenous/hemipelagic deposition report every 10000 steps
        # (bc.cxx:1446,1491,1811: is_reporting_terrigenous_info)
        if (p.control.is_reporting_terrigenous_info
                and p.control.surface_process_option in (1, 102)
                and steps // 10000 > last_wake_step // 10000):
            dh_acc = sim._host(sim.state.dhacc)
            print(f"  surface deposition: max accumulated dh "
                  f"{dh_acc.max():.3e} m, min {dh_acc.min():.3e} m "
                  f"(step {steps})")
        last_wake_step, last_wake_time = steps, now

        if mon.enabled:
            timed(wake, "monitor_ms", mon.write_if_due, sim)
        if p.mat.rheol_type & RH_RSF:
            wake["tracking_read_ms"] = timed(
                wake, "tracking_ms", update_earthquake_tracking, p, sim, eq)

        # marker phase changes + hydrous transport (dynearthsol.cxx:861-871)
        if phases_on:
            st = timed(wake, "phase_changes_ms", phase_changes, sim)
            wake.update(transitions=st["transitions"],
                        released=st["released"], read_ms=st["read_ms"],
                        emw_ms=st["emw_ms"])
            if p.control.has_hydration_processes:
                timed(wake, "advect_ms", advect_hydrous_markers, sim,
                      now - last_phase_time)
                last_phase_time = now
            hyd = sim.hydrous_markers
            wake["hydrous"] = hyd.n if hyd is not None else 0

        if p.control.use_global_velocity_scaling:
            # adaptive (earthquake-triggered) output scheduling
            t0 = _time.monotonic_ns()
            nf = out.frame
            next_regular_frame = handle_ats_output(
                p, sim, out, eq, starting_time, starting_step,
                next_regular_frame)
            t_output_ns += _time.monotonic_ns() - t0
            n_frames += out.frame - nf
            if out.frame > nf:
                wake["frame"] = True
            step_due = time_due = False
            avg_ok = True
        else:
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
            wake["frame"] = True
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
                mon.before_remesh(sim)
                remesh(sim, bad)
                if stepper is not None:
                    # the partition plan and the shard windows follow the
                    # new topology (gather -> remesh -> re-shard)
                    stepper.rebuild()
                mon.rebind(sim)
                if getattr(sim, "gospl", None) is not None:
                    sim.gospl.on_remesh()  # dynearthsol.cxx:632-709
                if p.sim.has_output_during_remeshing:
                    out.write_exact(sim)
                t_remesh_ns += _time.monotonic_ns() - t0
                n_remesh += 1
        if len(wake) > 1:
            n_wakes += 1
            for k, v in wake.items():
                if k.endswith("_ms"):
                    host_ms[k] = host_ms.get(k, 0.0) + v
            if wake_log is not None:
                wake_log.append(dict(wake, chunk_s=chunk_ns * 1e-9,
                                     chunk_steps=n))

        # progress line (dynearthsol.cxx:936-950)
        if steps >= sim.info_display_next_step:
            wt = (_time.monotonic_ns() - t_start) * 1e-9
            q = f", min_q = {min_quality:.4f}" if min_quality < 1.0 else ""
            print(f"              Step = {steps}, time = "
                  f"{now / YEAR2SEC:.5e} yr, vmax = "
                  f"{float(sim.state.max_global_vel_mag):.3e} m/s{q}, "
                  f"wt = {wt:.1f} s")
            if phases_on and "hydrous" in wake:
                print(f"              {wake['hydrous']} hydrous markers, "
                      f"host ms at this wake: phase changes "
                      f"{wake['phase_changes_ms']:.1f}, hydrous advection "
                      f"{wake.get('advect_ms', 0.0):.1f}")
            sim.info_display_next_step = (
                steps + p.sim.info_display_step_interval)

    mon.finalize()

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
    if host_ms:
        print(f"Wakes:    {n_wakes}, host ms per wake: " + ", ".join(
            f"{k[:-3]} {v / n_wakes:.3f}" for k, v in host_ms.items()))
    if phases_on and sim.markers is not None:
        hyd = sim.hydrous_markers
        print(f"Markers:  {sim.markers.n} markers, "
              f"{hyd.n if hyd is not None else 0} hydrous markers")
    print(f"Path:     {sim.step_path}")
    print("Launches: " + ", ".join(f"{k} {v}"
                                   for k, v in kernel_launches().items()))
    if prof is not None:
        prof.stop()
        os.makedirs(prof_dir, exist_ok=True)
        trace = os.path.join(prof_dir, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"Profile:  trace written to {trace}")
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
        description="Run a DynEarthSol model (.cfg) with the PyTorch port.",
        epilog="DES_N_DEVICES=N runs the node-sharded halo step on the "
               "first N cards (N shards of the CPU with --device cpu).")
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
