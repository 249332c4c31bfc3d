"""Frame and checkpoint writer in the reference's formats (counterpart of
dynearthsol_tpu/io/output.py).

Reference: output.cxx.  Frames (``<model>.save.NNNNNN``) double as
visualization dumps and restart state; checkpoints (``<model>.chkpt.NNNNNN``)
add restart-only extras; ``<model>.info`` is the frame index
(output.cxx:42-120).  Names, dtypes and lengths are the JAX package's, so
that its readers and the reference's Dynearthsol.py / 2vtk.py / compare.py
read these files unchanged.  ``output_format = vtkhdf`` writes each frame
as ``<model>.save.NNNNNN.vtkhdf`` through io/vtkhdf.py, which needs h5py.
Tensors move to the host as float64 (float32 to float64 is exact).
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from ..config import RH_RSF
from .tagged import TaggedWriter, rename_to_old_backup


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().double().numpy()


class Output:
    """Reference-format frame/checkpoint writer (output.cxx:23-405)."""

    def __init__(self, param, start_frame: int = 0,
                 start_time_ns: int | None = None):
        if param.sim.output_format == "vtkhdf":
            # VTKHDF frames need h5py: refuse here, before any step or
            # file, rather than fall back to binary frames
            try:
                import h5py  # noqa: F401
            except ImportError as e:
                raise ImportError(
                    "output_format = vtkhdf writes its frames with h5py, "
                    "which is not installed; install h5py or set "
                    "output_format = binary") from e
        self.param = param
        self.modelname = param.sim.modelname
        self.is_averaged = param.sim.is_outputting_averaged_fields
        self.average_interval = param.mesh.quality_check_step_interval
        self.has_marker_output = param.sim.has_marker_output
        self.may_overwrite = (param.sim.is_restarting and
                              param.sim.modelname ==
                              param.sim.restarting_from_modelname)
        self.start_frame = start_frame
        self.frame = start_frame
        self.start_time_ns = (start_time_ns if start_time_ns is not None
                              else _time.monotonic_ns())
        self.run_time_ns = 0

    # ---- .info (output.cxx:42-92) ----
    def write_info(self, sim, dt: float):
        s = sim.state
        row = ("%6d\t%10d\t%12.6e\t%12.4e\t%12.6e\t%8d\t%8d\t%8d\n" % (
            self.frame, int(s.steps), float(s.time), dt,
            self.run_time_ns * 1e-9, sim.topo.nnode, sim.topo.nelem,
            sim.topo.nseg))
        filename = self.modelname + ".info"
        if self.may_overwrite and self.frame == self.start_frame:
            # a restart into its own model name keeps the rows before it
            kept = []
            try:
                with open(filename) as r:
                    for line in r:
                        try:
                            if int(line.split()[0]) < self.start_frame:
                                kept.append(line)
                        except (ValueError, IndexError):
                            pass
            except FileNotFoundError:
                pass
            rename_to_old_backup(filename)
            with open(filename, "w") as w:
                w.writelines(kept)
        mode = "w" if self.frame == 0 else "a"
        with open(filename, mode) as f:
            f.write(row)

    # ---- frame write (output.cxx:95-262) ----
    def _write(self, sim, disable_averaging: bool = True):
        self.run_time_ns = _time.monotonic_ns() - self.start_time_ns
        param, topo, s = sim.param, sim.topo, sim.state

        averaging = self.is_averaged and not disable_averaging
        dt = float(s.dt)
        inv_dt = 0.0
        if averaging:
            span = float(s.time) - float(s.time_avg0)
            dt = span / self.average_interval
            inv_dt = 1.0 / span if span != 0 else 0.0

        coord = _np(s.coord)
        overwrite_ok = self.may_overwrite and self.frame == self.start_frame
        if param.sim.output_format == "vtkhdf":
            from .vtkhdf import VTKHDFWriter

            fname = "%s.save.%06d.vtkhdf" % (self.modelname, self.frame)
            w = VTKHDFWriter(fname, topo.ndims, topo.nnode, topo.nelem,
                             compression=param.sim.hdf5_compression_level,
                             rename_if_exists=not overwrite_ok)
            w.write_grid(coord, topo.connectivity)
            w.write_field_data(float(s.time), int(s.steps),
                               self.run_time_ns * 1e-9)
        else:
            fname = "%s.save.%06d" % (self.modelname, self.frame)
            w = TaggedWriter(fname, topo.ndims,
                             rename_if_exists=not overwrite_ok)
        w.write_array(coord, "coordinate")
        w.write_array(topo.connectivity.astype(np.int32), "connectivity")
        w.write_array(_np(s.vel), "velocity")
        if averaging:
            w.write_array((coord - _np(s.coord_avg0)) * inv_dt,
                          "velocity averaged")
        w.write_array(_np(s.temperature), "temperature")
        w.write_array(_np(s.ppressure), "pore pressure")
        w.write_array(_np(s.radiogenic_source), "radiogenic source")
        w.write_array(_np(s.plstrain), "plastic strain")
        strain = _np(s.strain)
        if averaging:
            w.write_array(_np(s.delta_plstrain_avg) * inv_dt,
                          "plastic strain-rate")
            w.write_array((strain - _np(s.strain_avg0)) * inv_dt,
                          "strain-rate")
        else:
            w.write_array(_np(s.delta_plstrain), "plastic strain-rate")
            w.write_array(_np(s.strain_rate), "strain-rate")
        w.write_array(strain, "strain")
        w.write_array(_np(s.stress), "stress")
        w.write_array(_np(s.viscosity), "viscosity")
        if averaging:
            w.write_array(_np(s.stress_avg) / (self.average_interval + 1),
                          "stress averaged")
        w.write_array(sim.elem_density(), "density")
        w.write_array(sim.elem_quality(), "mesh quality")
        if param.mat.rheol_type & RH_RSF:
            w.write_array(_np(s.dyn_fric_coeff),
                          "dynamic friction coefficient")
            w.write_array(_np(s.state_variable), "friction state variable")
        # most abundant marker material per element (output.cxx:236-242)
        w.write_array(np.argmax(_np(s.emw), axis=1).astype(np.float64),
                      "material")
        w.write_array(_np(s.force), "force")
        w.write_array(_np(s.coord0), "coord0")
        w.write_array(topo.bcflag.astype(np.uint32), "bcflag")
        if self.has_marker_output and sim.markers is not None:
            # the hydrous markers of phase changes after the markers
            # (JAX io/output.py:145-149)
            for ms in (sim.markers, sim.hydrous_markers):
                if ms is not None:
                    for name, arr in ms.save_arrays(
                            coord, topo.connectivity).items():
                        w.write_array(arr, name)
        w.close()

        self.write_info(sim, dt)
        self.frame += 1
        return fname

    def write(self, sim):
        return self._write(sim, disable_averaging=False)

    def write_exact(self, sim):
        """Instantaneous frame + NaN audit + marker-consistency audit
        (output.cxx:277-297)."""
        fname = self._write(sim, disable_averaging=True)
        check_nan(sim)
        if sim.markers is not None:
            check_marker_consistency(sim)
        return fname

    # ---- checkpoint (output.cxx:343-405) ----
    def write_checkpoint(self, sim):
        """Call BEFORE the matching write(): the reference checkpoints at
        the frame index that the following write() produces
        (dynearthsol.cxx:901-904)."""
        chk_frame = self.frame
        param, topo, s = sim.param, sim.topo, sim.state
        fname = "%s.chkpt.%06d" % (self.modelname, chk_frame)
        w = TaggedWriter(fname, topo.ndims, rename_if_exists=not (
            self.may_overwrite and chk_frame == self.start_frame))
        scalars = np.array([
            float(s.time), float(sim.info_display_next_step),
            float(sim.compensation_pressure), float(sim.bottom_temperature),
            float(s.dt), float(s.max_global_vel_mag),
            float(sim.reference_frame_time)])
        w.write_array(scalars, "time info_display_next_step "
                      "compensation_pressure bottom_temperature dt "
                      "max_global_vel_mag reference_frame_time")
        w.write_array(topo.segment.astype(np.int32), "segment")
        w.write_array(topo.segflag.astype(np.int32), "segflag")
        w.write_array(_np(s.edvacc_surf), "dv surface acc")
        w.write_array(_np(s.dhacc), "dhacc")
        w.write_array(_np(s.volume_old), "volume_old")
        # exact-restart extras beyond the reference set (the JAX
        # package's): the state's own values, not a recomputation, so that
        # a restarted run continues bit for bit
        for nm in ("volume", "volume_n", "mass", "tmass", "hmass", "ymass",
                   "old_mean_stress"):
            w.write_array(_np(getattr(s, nm)), nm)
        if param.mat.is_plane_strain:
            w.write_array(_np(s.stressyy), "stressyy")
        if param.mat.rheol_type & RH_RSF:
            w.write_array(_np(s.state_variable), "friction state variable")
        if sim.markers is not None:
            for ms in (sim.markers, sim.hydrous_markers):
                if ms is not None:
                    for name, arr in ms.chkpt_arrays().items():
                        w.write_array(arr, name)
        w.close()
        return fname


def check_nan(sim):
    """NaN audit over all fields (utils.hpp:283-354 check_nan); raises on
    failure like the reference's std::exit."""
    bad = [name for name, v in vars(sim.state).items()
           if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    if bad:
        raise FloatingPointError(f"NaN/Inf detected in fields: {bad}")


def check_marker_consistency(sim):
    """Marker/element cross-consistency audit (markerset.cxx:1480-1525)."""
    ms = sim.markers
    elem = ms.live("elem")
    if ms.n and (elem.min() < 0 or elem.max() >= sim.topo.nelem):
        raise RuntimeError("marker owner element out of range")
    hist = ms.elem_histogram(sim.topo.nelem, sim.param.mat.nmat)
    if ms.n and hist.sum() != ms.n:
        raise RuntimeError("marker histogram inconsistent with population")
