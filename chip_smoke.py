#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (dynearthsol_tpu_torch) on one
NVIDIA GPU.

Run from the root of the repository:  python3 chip_smoke.py

Phases, each printed, the first failure exits non-zero:
  1. device  -- a CUDA device is required (there is no CPU path);
  2. build   -- nvcc builds csrc/ into build/torch_kernels/, one compile per
                source, all started together; registers, stack frame and
                spills per kernel from the -Xptxas -v report;
  3. 2D kernel -- the 2D chunk kernel (one cooperative launch per chunk,
                dt refreshed in the kernel) against its plain PyTorch
                version on the card: maxwell over 10 steps (one launch per
                step, then one launch for the 10), EVP over 1 step, the resident runner (one launch)
                against the tiled runner over 25 steps (16 x 128 cells),
                then one flagship-size step and its dt refresh, with the CPU
                tests' tolerances; a 25-step flagship EVP chunk against 25
                one-step launches, bit for bit; its grid, blocks per SM and
                registers; device times at flagship shapes of the chunk form
                (events around 250-step chunks), the one-step form (a
                CUDA graph of launches, and as Python issues them), the
                chunk's grid barriers alone and the plain version; the
                per-phase µs of a chunk from the kernel's clock stamps;
  4. 3D kernels -- the fused 3D step against its plain version: maxwell
                over 10 steps and EVP over 1 step with and without NMD
                (128 x 16 x 8 cells) and one flagship3d EVP step, the plain
                version on the CPU (see run3); a dt = 0 step that keeps the
                volume bit for bit, the every-step mode of dt_refresh (and
                its device time on flagship3d partials), the
                chunk form (each step's epilogue pending until the next,
                one finalize) against 10 complete steps with torch.equal on
                every plane, one flagship3d maxwell step plane by plane
                against the plain version on the card; kernel and plain
                device times at flagship3d shapes, the kernel in its chunk
                form and its one-step form;
  5. 2D slice -- the flagship config (100 km x 50 km, 512 x 256 cells, EVP,
                f32): Simulation(param, device="cuda"), 250 warm-up steps,
                then 500 timed steps, with launch counts (one chunk kernel
                launch per chunk, no dt_refresh, no plain version), and the
                plain version's rate over 50 steps; then the tiled runner's
                path (the flagship with global velocity scaling): 20 steps,
                one n = 1 launch per step, no dt_refresh, no plain version;
  6. 3D slice -- the flagship3d config (256 x 48 x 16 cells x 5 tets,
                983,040 tetrahedra, EVP, f32): Simulation(param) with the
                default device, 100 warm-up steps, then 500 timed steps,
                with launch counts (a finalize per chunk, no plain
                version), and the plain version's rate over 5 steps;
  7. profile -- torch.profiler over 100 steps of the flagship runner and
                20 of the flagship3d runner: device time per launch by
                kernel, device busy and idle share; for flagship3d the bytes
                each phase of the 3D kernel moves and its TB/s;
  8. gather/assembly kernels -- the three kernels of csrc/band2d.cu
                (cgather, asm_pack, asm_gather) against their plain
                versions with torch.equal (tolerance 0): a small Delaunay
                mesh, a small tet mesh (npe = 4) and the 277k-triangle mesh
                of phase 9, float32 and float64, at the k / kg of the flat
                step's six call sites; their device times at that mesh with
                the L2 cache flushed between launches, beside the plain
                versions' and the library calls' (index_select, index_add_);
  9. unstructured slice -- the flagship config on a Delaunay box mesh
                (meshing_elem_shape 0: 277,258 triangles, 139,400 nodes,
                EVP, f32): Simulation(param) with the default device, a
                warm-up chunk of 100 steps, then 200 timed steps in chunks
                of 100, with launch counts (2 per step of each kernel, no
                plain version), and the plain versions' rate over 5 steps;
                the slice on the card against the port on the CPU at a
                1,062-triangle mesh (maxwell 10 steps and EVP 1 step in f32
                at 1e-5, maxwell 10 steps in f64 at 1e-10);
                the profiler breakdown of 10 steps.
The last lines are a JSON record of the kernels, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]
# NVIDIA H100 SXM data sheet: HBM rate and float32 rate outside the tensor
# cores (the bound of each kernel below is the larger of bytes / PEAK_BYTES
# and operations / PEAK_F32)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def make_sim_cfg(rheology="elasto-visco-plastic"):
    """tests/test_pallas.py make_sim: 16 x 128 cells."""
    return {
        "sim": {"ndims": 2, "float_dtype": "float32",
                "is_outputting_averaged_fields": False},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": 16e3, "ylength": 0.0, "zlength": 128e3,
                 "resolution": 1e3, "quality_check_step_interval": 10**8},
        "control": {"gravity": 10.0, "inertial_scaling": 1e5,
                    "has_thermal_diffusion": True, "damping_option": 1},
        "bc": {"vbc_x0": 1, "vbc_val_x0": -1e-9, "vbc_x1": 1,
               "vbc_val_x1": 1e-9, "vbc_z0": 0, "vbc_z1": 0,
               "has_winkler_foundation": False, "has_water_loading": False},
        "mat": {"rheology_type": rheology, "is_plane_strain": True,
                "rho0": [2800.0], "bulk_modulus": [50e9],
                "shear_modulus": [30e9], "visc_max": 1e24,
                "visc_min": 1e19},
    }


def flagship_cfg(rheology="elasto-visco-plastic"):
    """bench.py flagship_param: 512 x 256 cells, 262,144 triangles."""
    xlength, zlength, nx_cells = 100e3, 50e3, 512
    return {
        "sim": {"max_steps": 10**9, "ndims": 2, "float_dtype": "float32",
                "is_outputting_averaged_fields": False},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": xlength, "ylength": 0.0, "zlength": zlength,
                 "resolution": xlength / nx_cells,
                 "quality_check_step_interval": 10**8},
        "control": {"gravity": 10.0, "inertial_scaling": 1e5,
                    "has_thermal_diffusion": True, "damping_option": 1},
        "bc": {"vbc_x0": 1, "vbc_val_x0": -1e-9, "vbc_x1": 1,
               "vbc_val_x1": 1e-9, "vbc_z0": 0, "vbc_z1": 0,
               "has_winkler_foundation": False, "has_water_loading": False,
               "surface_temperature": 273.0, "mantle_temperature": 1600.0},
        "ic": {"weakzone_option": 2, "weakzone_plstrain": 0.5,
               "weakzone_xcenter": 0.5, "weakzone_zcenter": 0.2,
               "weakzone_xsemi_axis": 3e3, "weakzone_zsemi_axis": 3e3},
        "mat": {"rheology_type": rheology,
                "is_plane_strain": True, "rho0": [2800.0],
                "bulk_modulus": [50e9], "shear_modulus": [30e9],
                "visc_max": 1e24, "visc_min": 1e19},
    }


def unstructured_cfg(rheology="elasto-visco-plastic", small=False):
    """bench.py --case unstructured: flagship_param on a Delaunay box mesh
    (meshing_elem_shape 0).  ``small``: the 16 km x 8 km box of
    tests/test_flat.py at 500 m, 1,062 triangles."""
    cfg = flagship_cfg(rheology)
    cfg["mesh"]["meshing_elem_shape"] = 0
    if small:
        cfg["mesh"].update(xlength=16e3, zlength=8e3, resolution=500.0,
                           quality_check_step_interval=7)
        del cfg["ic"]
    return cfg


# fields the flat-step gate of tests/test_flat.py:38-42 compares
FLAT_FIELDS = ("coord", "vel", "temperature", "stress", "stressyy", "strain",
               "strain_rate", "plstrain", "delta_plstrain", "viscosity",
               "volume", "volume_old", "volume_n", "mass", "tmass", "hmass",
               "ymass", "force", "edvoldt", "dt", "time",
               "max_global_vel_mag", "global_dt_min", "l2_residual")


def sim3d_cfg(rheology="elasto-visco-plastic", weakzone=1):
    """tests/test_pallas3d.py make_sim: 128 x 16 x 8 cells, 81,920 tets."""
    return {
        "sim": {"ndims": 3, "float_dtype": "float32",
                "is_outputting_averaged_fields": False},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": 128e3, "ylength": 16e3, "zlength": 8e3,
                 "resolution": 1e3, "quality_check_step_interval": 10**8},
        "control": {"gravity": 10.0, "inertial_scaling": 1e5,
                    "has_thermal_diffusion": True, "damping_option": 1},
        "bc": {"vbc_x0": 1, "vbc_val_x0": -1e-9, "vbc_x1": 1,
               "vbc_val_x1": 1e-9, "vbc_y0": 1, "vbc_val_y0": 0.0,
               "vbc_y1": 1, "vbc_val_y1": 0.0, "vbc_z0": 0, "vbc_z1": 0,
               "has_winkler_foundation": False, "has_water_loading": False},
        "ic": {"weakzone_option": weakzone},
        "mat": {"rheology_type": rheology, "is_plane_strain": False,
                "rho0": [2800.0], "bulk_modulus": [50e9],
                "shear_modulus": [30e9], "visc_max": 1e24,
                "visc_min": 1e19},
    }


def flagship3d_cfg(rheology="elasto-visco-plastic"):
    """bench.py flagship3d_param: 256 x 48 x 16 cells x 5 tets = 983,040
    tetrahedra, 214,081 nodes; EVP, one material, f32."""
    return {
        "sim": {"max_steps": 10**9, "ndims": 3, "float_dtype": "float32",
                "is_outputting_averaged_fields": False},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": 256e3, "ylength": 48e3, "zlength": 16e3,
                 "resolution": 1e3, "quality_check_step_interval": 10**8},
        "control": {"gravity": 10.0, "inertial_scaling": 1e5,
                    "has_thermal_diffusion": True, "damping_option": 1},
        "bc": {"vbc_x0": 1, "vbc_val_x0": -1e-9, "vbc_x1": 1,
               "vbc_val_x1": 1e-9, "vbc_y0": 1, "vbc_val_y0": 0.0,
               "vbc_y1": 1, "vbc_val_y1": 0.0, "vbc_z0": 0, "vbc_z1": 0,
               "has_winkler_foundation": False, "has_water_loading": False,
               "surface_temperature": 273.0, "mantle_temperature": 1600.0},
        "mat": {"rheology_type": rheology, "is_plane_strain": False,
                "nmat": 1, "rho0": [2800.0], "bulk_modulus": [50e9],
                "shear_modulus": [30e9], "visc_max": 1e24,
                "visc_min": 1e19},
    }


# 3D gates of tests/test_pallas3d.py:79-82, :112-131
FIELDS3 = ("coord", "vel", "temperature", "stress", "strain", "plstrain",
           "volume", "volume_n", "mass", "tmass", "hmass", "force",
           "strain_rate", "edvoldt", "delta_plstrain", "volume_old")


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an "
             "NVIDIA GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import dynearthsol_tpu_torch as des
        from dynearthsol_tpu_torch.mesh.generate import (
            regular_grid_3d, renumber_mesh, unstructured_box_2d)
        from dynearthsol_tpu_torch.ops import (_build, band2d, flat2d,
                                               fused2d, fused3d)
        from dynearthsol_tpu_torch.state import FIELD_NAMES
    except ImportError as e:
        fail(f"the dynearthsol_tpu_torch package is not beside this "
             f"script: {e}")

    t_start = time.perf_counter()

    def sync():
        torch.cuda.synchronize()

    def rel(a, b):
        a, b = a.double(), b.double()
        return float((a - b).abs().max() / a.abs().max().clamp(min=1e-300))

    def check(label, err, tol, stop=True):
        """Print err against tol; fail unless it is below (``stop``), or
        return whether it is."""
        ok = err < tol
        print(f"  {label}: {err:.3e} (tol {tol:.0e}) "
              f"{'ok' if ok else 'FAILED'}")
        if not ok and stop:
            fail(f"{label}: kernel and plain version disagree")
        return ok

    def device_ms(fn, reps):
        """Device time per call: reps calls captured in one CUDA graph and
        replayed between two events, so no host time lies between the
        launches."""
        fn()
        sync()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        sync()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        g.replay()
        t1.record()
        sync()
        del g
        return t0.elapsed_time(t1) / reps

    def issue_ms(fn, reps):
        """Time per call as the main path issues it, one call after the
        other from Python, events around the run."""
        fn()
        sync()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        sync()
        return t0.elapsed_time(t1) / reps

    def cold_ms(fn, reps, flush):
        """Device time per call with the 50 MB L2 cache flushed before
        every call, as the flat step finds it (hundreds of element-wise
        launches lie between two of its gathers): a graph of reps x
        (flush, call) less a graph of reps x flush."""
        def graph_ms(body):
            body()
            sync()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(reps):
                    body()
            g.replay()
            sync()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            g.replay()
            t1.record()
            sync()
            del g
            return t0.elapsed_time(t1) / reps

        def both():
            flush.zero_()
            fn()

        return graph_ms(both) - graph_ms(flush.zero_)

    wrappers = {"fused2d_chunk": fused2d.fused_chunk,
                "dt_refresh": fused2d.dt_refresh,
                "fused3d_step": fused3d.fused3d_step,
                "fused3d_finalize": fused3d.fused3d_finalize,
                "cgather": band2d.cgather, "asm_pack": band2d.asm_pack,
                "asm_gather": band2d.asm_gather}
    plain_calls = (band2d.gather_corners, band2d.scatter_corners,
                   fused3d.chunk_step_plain, fused3d.finalize_plain,
                   fused2d.fused_step_plain, fused2d.dt_refresh_plain)

    def zero_counts():
        """Every kernel's launch count, and the calls of the plain versions
        that count theirs, set to 0: called just before a main path is
        driven."""
        for w in wrappers.values():
            w.launches = 0
        for f in plain_calls:
            f.calls = 0

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def step_bytes(mod, P, b, ncomp, *extra):
        """Bytes one fused step must move (csrc/fused2d.cu, fused3d.cu):
        each plane its kernel loads under the plan's switches, read once,
        and every output written once.  Never loaded: strain_rate,
        edvoldt, hmass and force, which the step recomputes; viscosity
        where a creep law recomputes it, delta_plstrain under EP,
        dpressure under NMD; volume_old outside the Maxwell trial; tmass
        and the top mask without thermal diffusion; ymass without damping
        4.  A vbc target is loaded only where its mask is set."""
        sw = P.sw
        skip = {"strain_rate", "edvoldt", "hmass", "force_x", "force_y",
                "force_z"}
        if sw["rheol"] not in (fused3d.RH_MAXWELL, fused3d.RH_EVP):
            skip.add("volume_old")
        if sw["rheol"] in (fused3d.RH_VISCOUS, fused3d.RH_MAXWELL,
                           fused3d.RH_EVP):
            skip.add("viscosity")
        if sw["rheol"] == fused3d.RH_EP:
            skip.add("delta_plstrain")
        if sw["nmd"]:
            skip.add("dpressure")
        if not sw["thermal"]:
            skip |= {"tmass", "top_mask"}
        if sw["damping"] != 4:
            skip.add("ymass")
        enames = list(mod.E_SLOTS) + [t for t in mod.T_SLOTS
                                      for _ in range(ncomp)]
        n_e = sum(n not in skip for n in enames)
        n_n = sum(n not in skip for n in mod.N_SLOTS + mod.CN_SLOTS)
        masks = [i for i, n in enumerate(mod.CN_SLOTS)
                 if n.startswith("vbc_mask")]
        read = (n_e * nbytes(b.ein[0]) + n_n * nbytes(b.nin[0])
                + int((b.cnp[masks] > 0).sum()) * b.tgt.element_size()
                + nbytes(b.scal, *extra))
        return read, nbytes(b.eout, b.nout, b.part)

    def phase_bytes2(P, b):
        """{phase: bytes} that each phase of csrc/fused2d.cu's chunk kernel
        moves in one step under the plan's switches: every plane a phase
        loads or stores counted once for that phase (nodal planes it
        gathers, element, scratch and const planes), vbc targets only where
        masked; the refresh's partials and scalars (a few KB) aside."""
        sw = P.sw
        N = nbytes(b.nin[0])
        E = nbytes(b.ein[0])
        ce = 0 if P.uniform else E  # a plane of the const element pack
        rh, th, nmd = sw["rheol"], sw["thermal"], sw["nmd"]
        creep = rh in (fused2d.RH_VISCOUS, fused2d.RH_MAXWELL,
                       fused2d.RH_EVP)
        masked = int((b.cnp[1:3] > 0).sum()) * b.tgt.element_size()
        # element planes C loads besides vol, strain, stress, syy, plstrain
        c_in = ((rh != fused2d.RH_EP) + (not creep)
                + (rh in (fused2d.RH_MAXWELL, fused2d.RH_EVP)) + (not nmd))
        return {
            "A": 5 * N + E + (3 * th + 1) * E + 4 * th * ce,
            "B": (1 + 3 * th) * E + (2 + 2 * th) * N + 2 * N,
            "C": 6 * N + (9 + c_in) * E + 15 * E + (2 + P.nmat) * ce,
            "D": (2 * E + 2 * N) if nmd else 0,
            "E": (3 + nmd) * N + (4 + 3 * nmd) * E + 6 * E
                 + 2 * sw["gravity_on"] * ce,
            "F": 6 * E + (7 + (sw["damping"] == 4)) * N + masked + 6 * N,
            "G": 5 * N + 26 * E + (7 + P.nmat * sw["surf_corr"]) * ce,
            "H": 4 * E + 4 * N,
        }

    def phase_bytes3(P, b, pending, last):
        """{phase: bytes} that each launch of csrc/fused3d.cu moves in one
        step of the chunk form under the plan's switches: every plane a
        phase loads or stores counted once for that phase (nodal planes it
        gathers, element, cell-scratch and surface-factor planes), vbc
        targets only where masked.  ``pending``/``last`` as in the chunk
        form; the "finalize" entry is the pass after a chunk."""
        sw = P.sw
        N = nbytes(b.nin[0])
        E = nbytes(b.ein[0])
        C = E // 5
        S = nbytes(b.sfac)
        rh, th, nmd = sw["rheol"], sw["thermal"], sw["nmd"]
        jau, surf = sw["jaumann"], sw["surf_corr"]
        creep = rh in (fused3d.RH_VISCOUS, fused3d.RH_MAXWELL, fused3d.RH_EVP)
        masked = int((b.cnp[1:] > 0).sum()) * b.tgt.element_size()
        # tet planes C loads besides stress, strain, plstrain and volume
        c_in = ((rh != fused3d.RH_EP) + (not creep)
                + (rh in (fused3d.RH_MAXWELL, fused3d.RH_EVP))
                + (not nmd or pending))
        # and the product dpressure * volume for D (NMD)
        c_out = 15 + (not creep or last) + 7 * last + nmd
        ph = {
            "phase_a": (6 + th) * N + E + (8 + 8 * th) * C,
            "phase_b": (8 + 8 * th) * C + (4 + 2 * th) * N,
            "phase_c": (8 + (pending and nmd)) * N + (14 + c_in) * E
                       + (pending and surf) * S + c_out * E,
            "phase_d": (E + 2 * N) if nmd else 0,
            "phase_e": (3 + sw["gravity_on"] + nmd) * N + (7 + nmd) * E
                       + 24 * C,
            "phase_f": 24 * C + 10 * N + masked + (6 + 3 * last) * N,
            "phase_g": 7 * N + 3 * E + (2 + last) * E + surf * S,
            "phase_h": (3 + last) * E + (3 + last) * N,
        }
        # strain rate and plstrain: the scaled top layer
        top = 14 * surf * E // P.cells[2]
        ph["finalize"] = (6 * jau + nmd) * N + surf * S + (
            jau + 12 + nmd) * E + 12 * E + top
        return ph

    # Arithmetic of one fused step, counted by hand from csrc/fused2d.cu,
    # fused3d.cu and their headers: each +, -, *, /, sqrt, exp, log, sin,
    # cos and tan is one operation, compares and selects none.  The
    # constitutive update per element by rheology (elastic, viscous,
    # maxwell, EP, EVP; 3D EP with the eigensolver, 237 of its 368):
    RHEOL_OPS = {2: {1: 14, 2: 40, 3: 60, 5: 100, 7: 169},
                 3: {1: 27, 2: 64, 3: 95, 5: 404, 7: 535}}

    def step_ops(P, nd, nelem, nnode):
        sw = P.sw
        th, nmd, rh = sw["thermal"], sw["nmd"], RHEOL_OPS[nd][sw["rheol"]]
        jau, surf = sw["jaumann"], sw["surf_corr"]
        if nd == 3:  # per tet: phases A, C, D, E, G, H; per node B, D, F, H
            per_e = (96 + 50 * th + 164 + rh + 5 * nmd + 8 * nmd + 163
                     + 9 * nmd + 150 + 197 * jau + 21 * surf + 16)
            per_n = 9 + 11 * th + 9 * nmd + 57 + 32
        else:        # per triangle: A, B, C, D, E, F, G, H; per node B, D, F
            per_e = (38 + 35 * th + 3 + 3 * th + 54 + rh + 3 * nmd
                     + 6 * nmd + 47 + 6 * nmd + 6 + 22 + 45 * jau
                     + 12 * surf + 12)
            per_n = 1 + 3 * th + nmd + 22
        return per_e * nelem + per_n * nnode

    def bound(read, written, ops):
        """Least time the card could take, in ms: bytes (each input read
        once, each output written once) over the HBM rate, against
        operations over the float32 rate; returns (ms, "bytes" or
        "operations", bytes, operations)."""
        t_b = (read + written) / PEAK_BYTES * 1e3
        t_o = ops / PEAK_F32 * 1e3
        by = "bytes" if t_b >= t_o else "operations"
        return max(t_b, t_o), by, read + written, ops

    # ---- 1. device
    try:
        smi = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                             timeout=60)
        card = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = "nvidia-smi unavailable"
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # ---- 2. build
    t = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"phase 2 build: {time.perf_counter() - t:.1f} s -> {lib}")
    for name, (regs, stack, spill) in sorted(_build.ptxas_report().items()):
        print(f"  {name}: {regs} registers, {stack} B stack frame, "
              f"{spill} B spilled")

    # ---- 3. 2D kernels against their plain versions, on the card
    print("phase 3 2D chunk kernel vs plain (16 x 128 cells, then flagship)")

    def sim_of(cfg):
        sim = des.Simulation(des.param_from_dict(cfg), device="cuda")
        return sim, fused2d.make_plan(sim.param, sim.ctx, sim.device)

    def chunk(sim, P, n, resident, plain):
        out = fused2d.run_chunk(P, sim.ctx, sim.state, n, resident, plain)
        sync()
        return out

    # 10 maxwell steps, as one-step launches (the tiled runner) and as one
    # 10-step launch (the resident runner), each against the plain version
    sim, P = sim_of(make_sim_cfg("maxwell"))
    for resident, form in ((False, "one-step launches"),
                           (True, "one chunk launch")):
        ker = chunk(sim, P, 10, resident, False)
        ref = chunk(sim, P, 10, resident, True)
        lab = f"maxwell 10 steps, {form},"
        for f in ("coord", "vel", "temperature", "stress", "strain",
                  "volume", "volume_n", "mass", "tmass", "hmass",
                  "strain_rate", "edvoldt", "force"):
            check(f"{lab} {f}", rel(getattr(ref, f), getattr(ker, f)),
                  1e-3 if f == "force" else 2e-4)
        dlog = (ref.viscosity.double().log()
                - ker.viscosity.double().log())
        check(f"{lab} log-viscosity median", float(dlog.abs().median()),
              0.02)
        for f in ("dt", "time", "max_global_vel_mag"):
            check(f"{lab} {f}", rel(getattr(ref, f), getattr(ker, f)), 1e-5)

    sim, P = sim_of(make_sim_cfg())
    ker = chunk(sim, P, 1, False, False)
    ref = chunk(sim, P, 1, False, True)
    for f in ("coord", "vel", "stress", "strain", "plstrain", "force"):
        check(f"EVP 1 step {f}", rel(getattr(ref, f), getattr(ker, f)),
              2e-6)

    tiled = chunk(sim, P, 25, False, False)
    res = chunk(sim, P, 25, True, False)
    select_tol = {"stressyy": 5e-5, "plstrain": 5e-5,
                  "delta_plstrain": 5e-4, "viscosity": 5e-4}
    for f in ("coord", "vel", "temperature", "stress", "strain",
              "plstrain", "stressyy", "volume", "volume_n", "mass", "tmass",
              "force", "strain_rate", "edvoldt", "delta_plstrain", "hmass",
              "viscosity", "dt", "time", "max_global_vel_mag",
              "global_dt_min"):
        check(f"resident vs tiled 25 steps {f}",
              rel(getattr(tiled, f), getattr(res, f)),
              select_tol.get(f, 1e-6))

    # a step with dt = 0 recomputes the initial volume bit for bit
    b = fused2d.make_buffers(P, sim.ctx, sim.state, 1, tiled=False)
    b.scal[0] = 0.0
    fused2d.fused_chunk(P, b, 1, tiled=False)
    sync()
    vol = fused2d._eslot("volume")
    if not torch.equal(b.ein[vol], b.eout[vol]):
        fail("initial volume differs from the kernel's volume")
    print("  dt = 0 step keeps the initial volume bit for bit: ok")

    # one flagship-size step and its dt refresh (a refresh step), kernel vs
    # plain.  On maxwell: with EVP the first step already meets the
    # min-select tie of rheology.cxx:869-879 in the cold near-surface cells
    # (viscosity at visc_max makes the viscoelastic and elastic-plastic
    # trial deviators equal in f32), and one-ulp differences of expf pick
    # either branch.
    msim, MP = sim_of(flagship_cfg("maxwell"))
    kb = fused2d.make_buffers(MP, msim.ctx, msim.state, 1, tiled=False)
    pb = fused2d.make_buffers(MP, msim.ctx, msim.state, 1, tiled=False)
    kb.flags[0, 0] = pb.flags[0, 0] = 1.0
    fused2d.fused_chunk(MP, kb, 1, tiled=False)
    fused2d.chunk_plain(MP, pb, 1, tiled=False)
    sync()
    names = [f"e.{n}" for n in fused2d.E_SLOTS] \
        + [f"e.{t}[{i}]" for t in fused2d.T_SLOTS for i in range(3)] \
        + [f"n.{n}" for n in fused2d.N_SLOTS]
    step_err = 0.0
    for k, nm in enumerate(names):
        if nm == "e.viscosity":
            v = (pb.ein[k].double().log() - kb.ein[k].double().log())
            check(f"flagship 1 step {nm} (log)", float(v.abs().max()), 1e-5)
            continue
        a, b = (pb.ein[k], kb.ein[k]) if nm[0] == "e" else \
            (pb.nin[k - fused2d.NE], kb.nin[k - fused2d.NE])
        err = rel(a, b)
        step_err = max(step_err, err)
        check(f"flagship 1 step {nm}", err, 2e-6)
    # dt, vmax and gdtmin come from exact min/max partials of values that
    # agree to f32 roundoff; the L2 sum is taken in another order
    scal2_err = 0.0
    for i, nm in enumerate(("dt", "vmax", "gdtmin", "time", "L2 sum")):
        err = rel(pb.scal[i:i + 1], kb.scal[i:i + 1])
        scal2_err = max(scal2_err, err)
        check(f"flagship 1 step refresh {nm}", err, 1e-5 if i == 4 else 1e-6)
    del msim, kb, pb

    fsim, FP = sim_of(flagship_cfg())
    occ = fused2d.chunk_occupancy(FP)
    print(f"  chunk kernel at flagship: {occ['registers']} registers and "
          f"{occ['local_bytes']} B local memory per thread, "
          f"{occ['blocks_per_sm']} blocks per SM x {occ['sms']} SMs, grid "
          f"{occ['grid']} blocks for {FP.nblocks()} virtual blocks")

    # the chunk form against one-step launches at the main path's config
    NV = 25
    cb = fused2d.make_buffers(FP, fsim.ctx, fsim.state, NV, tiled=False)
    fused2d.fused_chunk(FP, cb, NV, tiled=False)
    ob = fused2d.make_buffers(FP, fsim.ctx, fsim.state, NV, tiled=False)
    for k in range(NV):
        fused2d.fused_chunk(FP, ob, 1, tiled=False, k=k)
    sync()
    for k, nm in enumerate(names):
        a, b = (cb.ein[k], ob.ein[k]) if nm[0] == "e" else \
            (cb.nin[k - fused2d.NE], ob.nin[k - fused2d.NE])
        if not torch.equal(a, b):
            fail(f"flagship EVP: a {NV}-step chunk and {NV} one-step "
                 f"launches differ in {nm}")
    if not (torch.equal(cb.scal, ob.scal) and torch.equal(cb.dthist,
                                                           ob.dthist)):
        fail(f"flagship EVP: a {NV}-step chunk and {NV} one-step launches "
             "differ in scal or the dt history")
    print(f"  flagship EVP: a {NV}-step chunk equals {NV} one-step launches "
          "bit for bit (every plane, scal, dt history): ok")
    del cb, ob

    # device times on the main path's config (EVP)
    NCH2 = 250
    cb = fused2d.make_buffers(FP, fsim.ctx, fsim.state, NCH2, tiled=False)
    ob = fused2d.make_buffers(FP, fsim.ctx, fsim.state, 1, tiled=False)
    pb = fused2d.make_buffers(FP, fsim.ctx, fsim.state, 1, tiled=False)

    def chunk2_kernel():
        fused2d.fused_chunk(FP, cb, NCH2, tiled=False)

    def step_kernel():
        fused2d.fused_chunk(FP, ob, 1, tiled=False)

    def step_plain():
        fused2d.chunk_plain(FP, pb, 1, tiled=False)

    labels = fused2d.stamp_labels(FP, NCH2)
    nsync = len(labels) - 1  # grid syncs of an unstamped chunk

    def barriers():
        fused2d.grid_barriers(occ["grid"], nsync)

    # events around 2 chunks (a warm-up chunk first); the one-step form is
    # step 1 of a chunk, off the dt-refresh cadence as nine steps in ten,
    # timed as device time (a CUDA graph of 100 launches) and as Python
    # issues it
    chunk2_ms = issue_ms(chunk2_kernel, 2) / NCH2
    barrier_ms = issue_ms(barriers, 2) / NCH2
    step_ms = device_ms(step_kernel, 100)
    step_issue_ms = issue_ms(step_kernel, 100)
    step_plain_ms = device_ms(step_plain, 5)
    extra = (ob.flags[0],) if ob.cep is None else (ob.flags[0], ob.cep)
    step_bound = bound(*step_bytes(fused2d, FP, ob, 3, *extra),
                       step_ops(FP, 2, fsim.ctx.nelem, fsim.ctx.nnode))
    stamps = torch.zeros(len(labels) + 1, dtype=torch.int64, device="cuda")
    fused2d.fused_chunk(FP, cb, NCH2, tiled=False, stamps=stamps)
    sync()
    span = (stamps[1:] - stamps[:-1]).double().cpu().tolist()
    stamped_ms = float(stamps[-1] - stamps[0]) / 1e6 / NCH2
    per = {}
    for lab, ns in zip(labels, span):
        per.setdefault(lab, []).append(ns / 1e3)
    bytes2 = phase_bytes2(FP, cb)
    phases2 = {}
    for lab, v in per.items():
        nb = sum(bytes2[ph] for ph in lab.split("+"))
        us = sum(v) / len(v)
        phases2[lab] = {"bytes": nb, "us": us, "intervals": len(v),
                        "tb_per_s": nb / us / 1e6 if us > 0 else None}
    print(f"  device time per step at flagship (EVP) on {card}: chunk form "
          f"(events around 2 chunks of {NCH2} steps) {chunk2_ms:.4f} ms; "
          f"one-step form {step_ms:.4f} ms (a CUDA graph of 100 launches; "
          f"{step_issue_ms:.4f} ms issued from Python); "
          f"the chunk's {nsync} grid barriers alone {barrier_ms:.4f} ms "
          f"({barrier_ms * NCH2 / nsync * 1e3:.2f} us each); plain "
          f"{step_plain_ms:.4f} ms; bound {step_bound[0]:.4f} ms by "
          f"{step_bound[1]} ({step_bound[2] / 1e6:.1f} MB)")
    print(f"  chunk of {NCH2} steps by interval (the kernel's clock after "
          f"each barrier; {stamped_ms:.4f} ms per step with the stamps; bytes "
          "per interval as phase_bytes2 counts them):")
    for lab, r in phases2.items():
        bw = f"{r['tb_per_s']:.2f} TB/s" if r["tb_per_s"] else "-"
        print(f"    {lab}: {r['us']:.2f} us x {r['intervals']}, "
              f"{r['bytes'] / 1e6:.1f} MB, {bw}")
    del cb, ob, pb, stamps

    # ---- 4. the 3D kernel against its plain version, on the card
    print("phase 4 3D kernels vs plain (128 x 16 x 8 cells, then "
          "flagship3d)")

    def run3(cfg, n, plain):
        """n fused 3D steps from the config's initial state: the kernel on
        the card, or the plain version on the CPU.  PyTorch on the card
        divides by a Python number as a product with its reciprocal, an
        ulp off true division for a third of the values, which flips exact
        ties of the EVP min-select; on the CPU it divides truly, as the
        kernel does.  The plain run also counts those ties
        (fused3d.evp_ties)."""
        s3 = des.Simulation(des.param_from_dict(cfg),
                            device="cpu" if plain else "cuda")
        P3 = fused3d.make_plan(s3.param, s3.ctx, s3.device)
        out = fused3d.run_chunk(P3, s3.ctx, s3.state, n, plain)
        sync()
        ties = fused3d.evp_ties(P3, s3.ctx, s3.state) \
            if plain and P3.rheol == fused3d.RH_EVP else None
        return out, ties

    def chunk_vs_steps(label, P, ctx, state, n):
        """The chunk form (run_chunk: each step's epilogue pending until
        the next step, one finalize after the last) against n complete
        steps (fused3d_step, dt_refresh, swap), bit for bit on every
        plane."""
        out = fused3d.run_chunk(P, ctx, state, n)
        e_chunk, n_chunk = fused3d.state_to_planes(out, P.nx, P.ny, P.nz)
        b = fused3d.make_buffers(P, ctx, state, n)
        for k in range(n):
            b.tgt = fused3d.vbc_targets(ctx, b.nin, b.scal[3] + b.scal[0])
            fused3d.fused3d_step(P, b)
            fused2d.dt_refresh(P, b, k, tiled=True, every=True)
            b.swap()
        sync()
        for i in range(fused3d.NE):
            if not torch.equal(e_chunk[i], b.ein[i]):
                fail(f"{label}: chunk form and complete steps differ in "
                     f"element plane {i}")
        for i, nm in enumerate(fused3d.N_SLOTS):
            if not torch.equal(n_chunk[i], b.nin[i]):
                fail(f"{label}: chunk form and complete steps differ in {nm}")
        print(f"  {label}: the chunk form equals {n} complete steps bit for "
              "bit, every plane: ok")

    names3 = [f"e.{n}" for n in fused3d.E_SLOTS] \
        + [f"e.{t}[{i}]" for t in fused3d.T_SLOTS for i in range(6)] \
        + [f"n.{n}" for n in fused3d.N_SLOTS]

    def planes_check(label, ref_e, ref_n, ker_e, ker_n, steps=False):
        """Every element and nodal plane of the kernel against the plain
        version's, at 1e-4 of each plane's max (force 1e-3, viscosity
        1e-5 in its log); every plane is printed before a failure.
        ``steps``, for a run of a few steps: a component of a tensor or a
        vector against the max over its components instead (a component
        that is zero but for rounding, as the y-invariant flagship3d's xy
        shear, has no scale of its own; its error at its own scale is
        printed beside)."""
        bad = []
        ne = len(fused3d.E_SLOTS)
        for k, nm in enumerate(names3):
            a, b = (ref_e[k], ker_e[k]) if nm[0] == "e" else \
                (ref_n[k - fused3d.NE], ker_n[k - fused3d.NE])
            tol = 1e-3 if nm.startswith("n.force") else 1e-4
            if nm == "e.viscosity":
                v = a.double().log() - b.double().log()
                err, tol, nm = float(v.abs().max()), 1e-5, nm + " (log)"
            elif steps and ("[" in nm or nm[-2:] in ("_x", "_y", "_z")):
                if nm[0] == "e":
                    t0 = ne + (k - ne) // 6 * 6  # the tensor's first plane
                    comps = ref_e[t0:t0 + 6]
                else:
                    v0 = fused3d._nslot(nm[2:-2] + "_x")
                    comps = ref_n[v0:v0 + 3]
                scale = float(comps.double().abs().max())
                err = float((a.double() - b.double()).abs().max()) / scale
                nm += f" (of the max over its components; of its own " \
                      f"{rel(a, b):.3e})"
            else:
                err = rel(a, b)
            if not check(f"{label} {nm}", err, tol, stop=False):
                bad.append(nm)
        if bad:
            fail(f"{label}: kernel and plain version disagree in {bad}")

    def evp3_check(label, ker, ref, ties):
        """One EVP step, kernel against the plain version on the CPU, at
        the gate of test_pallas3d.py:126-132 (1e-4 of each field's max,
        force 1e-3, log-viscosity median 0.02) over every value, the exact
        ties of the min-select included; returns the largest error."""
        print(f"  {label}: {int(ties.sum())} of {ties.numel()} elements "
              "tie exactly in the min-select; none is set aside")
        worst = 0.0
        for f in FIELDS3:
            err = rel(getattr(ref, f), getattr(ker, f).cpu())
            worst = max(worst, err)
            check(f"{label} {f}", err, 1e-3 if f == "force" else 1e-4)
        dlog = (ref.viscosity.double().log()
                - ker.viscosity.cpu().double().log())
        check(f"{label} log-viscosity median", float(dlog.abs().median()),
              0.02)
        return worst

    cfg = sim3d_cfg("maxwell", weakzone=0)
    (ker, _), (ref, _) = run3(cfg, 10, False), run3(cfg, 10, True)
    for f in FIELDS3 + ("dt", "time", "max_global_vel_mag", "l2_residual"):
        check(f"3D maxwell 10 steps {f}",
              rel(getattr(ref, f), getattr(ker, f).cpu()),
              5e-3 if f == "force" else 1e-3)
    no_nmd = sim3d_cfg()
    no_nmd["control"]["is_using_mixed_stress"] = False
    for label, cfg in (("3D EVP 1 step", sim3d_cfg()),
                       ("3D EVP 1 step without NMD", no_nmd)):
        evp3_check(label, run3(cfg, 1, False)[0], *run3(cfg, 1, True))

    s3 = des.Simulation(des.param_from_dict(sim3d_cfg()), device="cuda")
    P3 = fused3d.make_plan(s3.param, s3.ctx, s3.device)
    b = fused3d.make_buffers(P3, s3.ctx, s3.state, 1)
    b.scal[0] = 0.0
    fused3d.fused3d_step(P3, b)
    sync()
    vol = fused3d._eslot("volume")
    if not torch.equal(b.eout[vol], b.ein[vol]):
        fail("3D initial volume differs from the kernel's volume")
    print("  3D dt = 0 step keeps the initial volume bit for bit: ok")

    # dt_refresh in its every-step mode (the 3D runner's), on an
    # off-cadence and a refresh step
    refresh_err = 0.0
    for flag in (0.0, 1.0):
        b = fused3d.make_buffers(P3, s3.ctx, s3.state, 1)
        fused3d.fused3d_step(P3, b)
        b.flags[0, 0] = flag
        scal, dthist = b.scal.clone(), b.dthist.clone()
        part, flags = b.part.clone(), b.flags.clone()
        fused2d.dt_refresh(P3, b, 0, tiled=True, every=True)
        fused2d.dt_refresh_plain(P3, part, scal, dthist, flags, 0,
                                 tiled=True, every=True)
        sync()
        err = max(rel(scal[i:i + 1], b.scal[i:i + 1]) for i in range(5))
        refresh_err = max(refresh_err, err)
        check(f"3D dt_refresh every-step mode, refresh flag {flag:.0f}",
              err, 1e-6)
    del s3, b

    s3 = des.Simulation(des.param_from_dict(sim3d_cfg("maxwell",
                                                      weakzone=0)),
                        device="cuda")
    P3 = fused3d.make_plan(s3.param, s3.ctx, s3.device)
    chunk_vs_steps("3D maxwell 10 steps", P3, s3.ctx, s3.state, 10)
    del s3

    # the flagship3d main-path Simulation, default device
    t = time.perf_counter()
    g3 = des.Simulation(des.param_from_dict(flagship3d_cfg()))
    sync()
    init3_s = time.perf_counter() - t
    if g3.device.type != "cuda":
        fail(f"Simulation(param) built on {g3.device}, not the card")
    print(f"  flagship3d host setup: {init3_s:.1f} s ({g3.ctx.nelem} tets, "
          f"{g3.ctx.nnode} nodes, sgrid {g3.ctx.sgrid})")

    # one flagship3d-size maxwell step, every output plane against the
    # plain version on the card (maxwell, where no select can tie)
    MP3 = fused3d.make_plan(des.param_from_dict(flagship3d_cfg("maxwell")),
                            g3.ctx, g3.device)
    kb = fused3d.make_buffers(MP3, g3.ctx, g3.state, 1)
    pb = fused3d.make_buffers(MP3, g3.ctx, g3.state, 1)
    kb.tgt = pb.tgt = fused3d.vbc_targets(g3.ctx, kb.nin,
                                          kb.scal[3] + kb.scal[0])
    fused3d.fused3d_step(MP3, kb)
    fused3d.fused3d_step_plain(MP3, pb)
    sync()
    planes_check("flagship3d 1 step", pb.eout, pb.nout, kb.eout, kb.nout)
    del kb, pb

    # the main path's config (EVP): one step against the plain version on
    # the CPU, then kernel and plain times on the card
    FP3 = fused3d.make_plan(g3.param, g3.ctx, g3.device)
    ker = fused3d.run_chunk(FP3, g3.ctx, g3.state, 1)
    step3_err = evp3_check("flagship3d EVP 1 step", ker,
                           *run3(flagship3d_cfg(), 1, True))
    del ker
    kb = fused3d.make_buffers(FP3, g3.ctx, g3.state, 1)
    pb = fused3d.make_buffers(FP3, g3.ctx, g3.state, 1)

    def step3_kernel():
        fused3d.fused3d_step(FP3, kb)

    def step3_plain():
        fused3d.fused3d_step_plain(FP3, pb)

    NCH = 20
    cb = fused3d.make_buffers(FP3, g3.ctx, g3.state, NCH)

    def chunk3_kernel():
        """The chunk form as run_chunk issues it, without the host's vbc
        probe: NCH steps, their dt_refresh calls, one finalize."""
        for k in range(NCH):
            fused3d.fused3d_chunk_step(FP3, cb, k, NCH)
            fused2d.dt_refresh(FP3, cb, k, tiled=True, every=True)
            cb.swap()
        fused3d.fused3d_finalize(FP3, cb, cb.ein, cb.nin, cb.dthist[-1])

    step3_ms = device_ms(chunk3_kernel, 1) / NCH
    step3_one_ms = device_ms(step3_kernel, 20)
    step3_plain_ms = device_ms(step3_plain, 3)
    step3_issue_ms = issue_ms(step3_kernel, 20)

    # dt_refresh (every-step mode, a refresh step) on the partials of a
    # flagship3d step: repeated calls redo the same reduction
    kb.flags[0, 0] = pb.flags[0, 0] = 1.0
    pb.part.copy_(kb.part)

    def refresh_kernel():
        fused2d.dt_refresh(FP3, kb, 0, tiled=True, every=True)

    def refresh_plain():
        fused2d.dt_refresh_plain(FP3, pb.part, pb.scal, pb.dthist, pb.flags,
                                 0, tiled=True, every=True)

    refresh_ms = device_ms(refresh_kernel, 200)
    refresh_plain_ms = device_ms(refresh_plain, 50)
    refresh_issue_ms = issue_ms(refresh_kernel, 200)
    # one min, min, max and add per partial column, then the block's tree
    refresh_bound = bound(nbytes(kb.part, kb.scal, kb.flags[0, :1]),
                          nbytes(kb.scal, kb.dthist[:1]),
                          4 * (kb.part.shape[1] + 256))
    print(f"  device time: dt_refresh (every-step mode, {kb.part.shape[1]} "
          f"partial columns) {refresh_ms:.4f} ms (plain "
          f"{refresh_plain_ms:.4f} ms, bound {refresh_bound[0]:.6f} ms by "
          f"{refresh_bound[1]}; issued from Python {refresh_issue_ms:.4f} "
          f"ms) on {card}")
    read3, written3 = step_bytes(fused3d, FP3, kb, 6)
    ops3 = step_ops(FP3, 3, g3.ctx.nelem, g3.ctx.nnode)
    step3_bound_one = bound(read3, written3, ops3)
    # the chunk form's own bound: it writes the last-only planes on one
    # step of NCH
    e_lo, n_lo = fused3d.last_only_slots(FP3)
    last_only = (len(e_lo) * nbytes(kb.eout[0])
                 + len(n_lo) * nbytes(kb.nout[0]))
    step3_bound = bound(read3, written3 - last_only * (NCH - 1) / NCH, ops3)
    print(f"  device time: flagship3d fused step, chunk form (a graph of "
          f"{NCH} steps, their dt_refresh calls and one finalize, over "
          f"{NCH}) {step3_ms:.4f} ms (bound {step3_bound[0]:.4f} ms by "
          f"{step3_bound[1]}, {step3_bound[2] / 1e6:.1f} MB: the last-only "
          f"planes written on one step of {NCH}); one-step form (step + "
          f"finalize) {step3_one_ms:.4f} ms (bound "
          f"{step3_bound_one[0]:.4f} ms, {step3_bound_one[2] / 1e6:.1f} MB); "
          f"plain {step3_plain_ms:.4f} ms; issued from Python "
          f"{step3_issue_ms:.4f} ms; on {card}")
    pb3 = [phase_bytes3(FP3, cb, k > 0, k == NCH - 1) for k in range(NCH)]
    bytes3 = {ph: sum(d.get(ph, 0) for d in pb3) / NCH
              for ph in pb3[0]}
    bytes3["finalize"] = pb3[0]["finalize"] / NCH
    del kb, pb, cb
    # the chunk form against complete steps at the main path's config
    chunk_vs_steps("flagship3d EVP 3 steps", FP3, g3.ctx, g3.state, 3)

    # the chunk form's pending steps at flagship3d size: a 3-step maxwell
    # run_chunk (its steps 2 and 3 apply the previous step's epilogue
    # first, the finalize the last one), the kernel on the card against
    # the plain version's chunk form on the CPU, every plane
    cfgm = flagship3d_cfg("maxwell")
    ker, ref = run3(cfgm, 3, False)[0], run3(cfgm, 3, True)[0]
    planes_check("flagship3d maxwell 3-step chunk",
                 *fused3d.state_to_planes(ref, MP3.nx, MP3.ny, MP3.nz),
                 *(t.cpu() for t in fused3d.state_to_planes(
                     ker, MP3.nx, MP3.ny, MP3.nz)), steps=True)
    del ker, ref

    # ---- 5. the 2D slice through the main path
    nelem = fsim.ctx.nelem
    t = time.perf_counter()
    fsim.run_steps(250, chunk=250)
    sync()
    warm_s = time.perf_counter() - t
    if fsim.step_path != "pallas2d_res":
        fail(f"flagship dispatched to {fsim.step_path!r}, not pallas2d_res")
    time0 = float(fsim.state.time)
    zero_counts()
    t = time.perf_counter()
    fsim.run_steps(500, chunk=250)
    sync()
    run_s = time.perf_counter() - t
    launches2 = {"fused2d_chunk": fused2d.fused_chunk.launches,
                 "dt_refresh": fused2d.dt_refresh.launches}
    if launches2 != {"fused2d_chunk": 2, "dt_refresh": 0}:
        fail(f"the 2D path did not launch the chunk kernel once per chunk "
             f"and dt_refresh never: {launches2}")
    if fused2d.fused_step_plain.calls or fused2d.dt_refresh_plain.calls:
        fail("the 2D path on the card took a plain version")
    s = fsim.state
    if not float(s.time) > time0 or int(s.steps) != 750:
        fail("model time or the step count did not advance")
    for f in FIELD_NAMES:
        v = getattr(s, f)
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            fail(f"non-finite values in {f}")
    rate = nelem * 500 / run_s

    t = time.perf_counter()
    fused2d.run_chunk(FP, fsim.ctx, s, 50, True, plain=True)
    sync()
    plain_rate = nelem * 50 / (time.perf_counter() - t)
    print(f"phase 5 2D slice: flagship {nelem} triangles, step_path "
          f"{fsim.step_path}, launches {launches2}, plain versions called 0 "
          f"times, warm-up 250 steps "
          f"{warm_s:.2f} s, 500 steps {run_s:.3f} s, model time "
          f"{time0:.6e} -> {float(s.time):.6e} s, fields finite")
    print(f"  elem*steps/s: kernels {rate:.6e}, plain PyTorch "
          f"{plain_rate:.6e} (over 50 steps) on {card}")

    # the tiled runner's path (pallas2d): the flagship with global velocity
    # scaling, which the resident runner does not take; one n = 1 launch of
    # the chunk kernel per step
    cfg_t = flagship_cfg()
    cfg_t["control"]["use_global_velocity_scaling"] = True
    tsim = des.Simulation(des.param_from_dict(cfg_t), device="cuda")
    tsim.run_steps(10, chunk=10)
    sync()
    if tsim.step_path != "pallas2d":
        fail(f"flagship with global velocity scaling dispatched to "
             f"{tsim.step_path!r}, not pallas2d")
    zero_counts()
    t = time.perf_counter()
    tsim.run_steps(20, chunk=20)
    sync()
    tiled_s = time.perf_counter() - t
    launches2t = {"fused2d_chunk": fused2d.fused_chunk.launches,
                  "dt_refresh": fused2d.dt_refresh.launches}
    if launches2t != {"fused2d_chunk": 20, "dt_refresh": 0}:
        fail(f"the tiled 2D path did not launch the chunk kernel once per "
             f"step and dt_refresh never: {launches2t}")
    if fused2d.fused_step_plain.calls or fused2d.dt_refresh_plain.calls:
        fail("the tiled 2D path on the card took a plain version")
    if int(tsim.state.steps) != 30:
        fail("the tiled 2D path did not advance 30 steps")
    for f in FIELD_NAMES:
        v = getattr(tsim.state, f)
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            fail(f"non-finite values in {f} on the tiled 2D path")
    tiled_rate = nelem * 20 / tiled_s
    print(f"  tiled path: step_path {tsim.step_path}, launches "
          f"{launches2t}, plain versions called 0 times, 20 steps "
          f"{tiled_s:.3f} s, {tiled_rate:.6e} elem*steps/s, fields finite")
    del tsim

    # ---- 6. the 3D slice through the main path
    nelem3 = g3.ctx.nelem
    t = time.perf_counter()
    g3.run_steps(100, chunk=100)
    sync()
    warm3_s = time.perf_counter() - t
    if g3.step_path != "pallas3d":
        fail(f"flagship3d dispatched to {g3.step_path!r}, not pallas3d")
    time0 = float(g3.state.time)
    zero_counts()
    t = time.perf_counter()
    g3.run_steps(500, chunk=250)
    sync()
    run3_s = time.perf_counter() - t
    launches3 = {"fused3d_step": fused3d.fused3d_step.launches,
                 "dt_refresh": fused2d.dt_refresh.launches,
                 "fused3d_finalize": fused3d.fused3d_finalize.launches}
    if launches3 != {"fused3d_step": 500, "dt_refresh": 500,
                     "fused3d_finalize": 2}:
        fail(f"the 3D path did not launch each step kernel once per step "
             f"and finalize once per chunk: {launches3}")
    if fused3d.chunk_step_plain.calls or fused3d.finalize_plain.calls:
        fail("the 3D path on the card took a plain version")
    s = g3.state
    if not float(s.time) > time0 or int(s.steps) != 600:
        fail("3D model time or the step count did not advance")
    for f in FIELD_NAMES:
        v = getattr(s, f)
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            fail(f"non-finite values in 3D {f}")
    if s.stress.shape != (nelem3, 6):
        fail(f"3D stress has shape {tuple(s.stress.shape)}")
    rate3 = nelem3 * 500 / run3_s
    t = time.perf_counter()
    fused3d.run_chunk(FP3, g3.ctx, s, 5, plain=True)
    sync()
    plain_rate3 = nelem3 * 5 / (time.perf_counter() - t)
    print(f"phase 6 3D slice: flagship3d {nelem3} tets, step_path "
          f"{g3.step_path}, launches {launches3}, plain versions "
          f"called 0 times, warm-up 100 steps "
          f"{warm3_s:.2f} s, 500 steps {run3_s:.3f} s, model time "
          f"{time0:.6e} -> {float(s.time):.6e} s, fields finite")
    print(f"  elem*steps/s: kernels {rate3:.6e}, plain PyTorch "
          f"{plain_rate3:.6e} (over 5 steps) on {card}")

    # ---- 7. device time per launch, by kernel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def per_kernel(label, run, steps):
        run(2)
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(steps)
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6 / steps
        busy, rows = 0.0, {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            us = e.time_range.elapsed_us() / steps
            busy += us
            if "phase_" in e.name:
                key = e.name[e.name.index("phase_"):][:7]
            elif "finalize" in e.name:
                key = "finalize"
            elif "step_chunk2d" in e.name:
                key = "step_chunk2d (2D chunk kernel)"
            elif "dt_refresh" in e.name:
                key = "dt_refresh"
            elif "gather_corners_kernel" in e.name:
                key = "gather_corners_kernel (cgather, asm_gather)"
            elif "scatter_corners_kernel" in e.name:
                key = "scatter_corners_kernel (asm_pack, asm_gather)"
            else:
                key = "other (PyTorch ops, copies)"
            n, t = rows.get(key, (0, 0.0))
            rows[key] = (n + 1, t + us)
        print(f"phase 7 profile {label}: {steps} steps, wall "
              f"{wall_us:.1f} us/step, device busy {busy:.1f} us/step "
              f"(idle {max(0.0, 1 - busy / wall_us):.1%} of wall)")
        for key, (n, us) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
            print(f"  {key}: {us:.1f} us/step ({n / steps:g} launches/step)")
        return rows

    per_kernel("flagship 2D (resident runner)",
               lambda n: fused2d.run_chunk(FP, fsim.ctx, fsim.state, n,
                                           True), 100)
    rows3 = per_kernel("flagship3d", lambda n: fused3d.run_chunk(
        FP3, g3.ctx, g3.state, n), NCH)
    print(f"  flagship3d kernel 3 by phase, chunk form of {NCH} steps "
          f"(bytes per step as phase_bytes3 counts them), on {card}:")
    phases3 = {}
    for ph, nb in bytes3.items():
        us = rows3.get(ph, (0, 0.0))[1]
        phases3[ph] = {"bytes": nb, "us": us,
                       "tb_per_s": nb / us / 1e6 if us else None}
        bw = f"{nb / us / 1e6:.2f} TB/s" if us else "not launched"
        print(f"    {ph}: {nb / 1e6:.1f} MB, {us:.1f} us, {bw}")
    print(f"    sum: {sum(bytes3.values()) / 1e6:.1f} MB per step, "
          f"{sum(v['us'] for v in phases3.values()):.1f} us")


    # ---- 8. the gather and assembly kernels against their plain versions
    print("phase 8 gather/assembly kernels vs plain (tolerance 0)")
    from dynearthsol_tpu_torch import simulation as sim_mod

    mesher, mesh_s = sim_mod.create_new_mesh, []

    def timed_mesher(param):
        t = time.perf_counter()
        mesh = mesher(param)
        mesh_s.append(time.perf_counter() - t)
        return mesh

    sim_mod.create_new_mesh = timed_mesher
    try:
        t = time.perf_counter()
        usim = des.Simulation(des.param_from_dict(unstructured_cfg()))
        sync()
        uinit_s = time.perf_counter() - t
    finally:
        sim_mod.create_new_mesh = mesher
    if usim.device.type != "cuda":
        fail(f"Simulation(param) built on {usim.device}, not the card")
    unelem, unnode = usim.ctx.nelem, usim.ctx.nnode
    print(f"  unstructured flagship host setup: {uinit_s:.1f} s, of which "
          f"the mesh build {mesh_s[0]:.1f} s ({unelem} triangles, {unnode} "
          f"nodes, sgrid {usim.ctx.sgrid})")
    if usim.ctx.sgrid is not None:
        fail("the Delaunay mesh was taken for a structured grid")

    small = unstructured_box_2d(16e3, 8e3, 250.0)
    small = renumber_mesh(small.coord, small.connectivity)
    tets = regular_grid_3d(16e3, 8e3, 4e3, 1e3)
    SITES = {"cgather": (6, 2), "asm_pack": (2, 5),
             "asm_gather": ((2, 1), (1, 1))}
    gen = torch.Generator(device="cuda").manual_seed(12345)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, dtype=dtype, device="cuda")

    band_err = {"cgather": 0.0, "asm_pack": 0.0, "asm_gather": 0.0}

    def band_check(label, bt):
        for dtype in (torch.float32, torch.float64):
            worst = dict.fromkeys(band_err, 0.0)
            for k in SITES["cgather"]:
                pack = rnd((bt.nnode, k), dtype)
                a, b = band2d.cgather(pack, bt), \
                    band2d.gather_corners(pack, bt)
                worst["cgather"] = max(worst["cgather"],
                                       float((a - b).abs().max()))
                if not torch.equal(a, b):
                    fail(f"{label} {dtype} cgather k={k} differs from "
                         "its plain version")
            for k in SITES["asm_pack"]:
                cols = rnd((k, bt.npe, bt.nelem), dtype)
                a, b = band2d.asm_pack(cols, bt), \
                    band2d.scatter_corners(cols, bt)
                worst["asm_pack"] = max(worst["asm_pack"],
                                        float((a - b).abs().max()))
                if not torch.equal(a, b):
                    fail(f"{label} {dtype} asm_pack k={k} differs from "
                         "its plain version")
            for k, kg in SITES["asm_gather"]:
                cols = rnd((k, bt.npe, bt.nelem), dtype)
                a, b = band2d.asm_gather(cols, bt, kg), \
                    band2d.scatter_gather_corners(cols, bt, kg)
                worst["asm_gather"] = max(
                    worst["asm_gather"], float((a[0] - b[0]).abs().max()),
                    float((a[1] - b[1]).abs().max()))
                if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                    fail(f"{label} {dtype} asm_gather k={k} kg={kg} "
                         "differs from its plain version")
            sync()
            for name in band_err:
                band_err[name] = max(band_err[name], worst[name])
            print(f"  {label}, {str(dtype)[6:]}: cgather k=6,2; asm_pack "
                  f"k=2,5; asm_gather (k,kg)=(2,1),(1,1) equal bit for bit")

    band_check(f"Delaunay {small[1].shape[0]} triangles",
               band2d.build_tables(small[1], small[0].shape[0], "cuda"))
    band_check(f"{tets.nelem} tets",
               band2d.build_tables(tets.connectivity, tets.nnode, "cuda"))
    ubt = band2d.build_tables(usim.topo.connectivity, unnode, "cuda")
    band_check(f"Delaunay {unelem} triangles", ubt)

    # device times at the 277k-triangle mesh, f32, L2 flushed before each
    # call.  Library calls: index_select(0, conn) gives the gathered rows
    # as (slots, k); index_add_ into zeros gives the nodal sums, but with
    # atomics, in an order that changes from run to run.
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    conn_l = ubt.conn_cm.long()
    es = 4
    nslots = 3 * unelem
    tab_b = nbytes(ubt.row_ptr, ubt.slots)
    band_t = {}
    for k in SITES["cgather"]:
        pack = rnd((unnode, k), torch.float32)
        band_t[f"cgather k={k}"] = dict(
            ms=cold_ms(lambda: band2d.cgather(pack, ubt), 20, flush),
            warm_ms=device_ms(lambda: band2d.cgather(pack, ubt), 50),
            issue_ms=issue_ms(lambda: band2d.cgather(pack, ubt), 50),
            plain_ms=cold_ms(lambda: band2d.gather_corners(pack, ubt), 10,
                             flush),
            library_ms=cold_ms(lambda: pack.index_select(0, conn_l), 20,
                               flush),
            bound=bound(nbytes(pack, ubt.conn_cm), k * nslots * es, 0))
    for k in SITES["asm_pack"]:
        cols = rnd((k, 3, unelem), torch.float32)
        rows = cols.reshape(k, nslots).t().contiguous()
        band_t[f"asm_pack k={k}"] = dict(
            ms=cold_ms(lambda: band2d.asm_pack(cols, ubt), 20, flush),
            warm_ms=device_ms(lambda: band2d.asm_pack(cols, ubt), 50),
            issue_ms=issue_ms(lambda: band2d.asm_pack(cols, ubt), 50),
            plain_ms=cold_ms(lambda: band2d.scatter_corners(cols, ubt), 5,
                             flush),
            library_ms=cold_ms(
                lambda: torch.zeros((unnode, k), device="cuda")
                .index_add_(0, conn_l, rows), 20, flush),
            bound=bound(nbytes(cols) + tab_b, unnode * k * es, nslots * k))
    for k, kg in SITES["asm_gather"]:
        cols = rnd((k, 3, unelem), torch.float32)
        rows = cols.reshape(k, nslots).t().contiguous()
        band_t[f"asm_gather k={k} kg={kg}"] = dict(
            ms=cold_ms(lambda: band2d.asm_gather(cols, ubt, kg), 20, flush),
            warm_ms=device_ms(lambda: band2d.asm_gather(cols, ubt, kg), 50),
            issue_ms=issue_ms(lambda: band2d.asm_gather(cols, ubt, kg), 50),
            plain_ms=cold_ms(
                lambda: band2d.scatter_gather_corners(cols, ubt, kg), 5,
                flush),
            library_ms=None,
            library_two_calls_ms=cold_ms(
                lambda: torch.zeros((unnode, k), device="cuda")
                .index_add_(0, conn_l, rows)[:, :kg]
                .index_select(0, conn_l), 20, flush),
            bound=bound(nbytes(cols, ubt.conn_cm) + tab_b,
                        (unnode * k + kg * nslots) * es, nslots * k))
    for site, r in band_t.items():
        lib = (f"{r['library_ms']:.4f}" if r["library_ms"] is not None
               else f"none as one call (index_add_ + index_select "
                    f"{r['library_two_calls_ms']:.4f})")
        print(f"  {site}: {r['ms']:.4f} ms (L2 warm {r['warm_ms']:.4f}, "
              f"issued from Python {r['issue_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
              f"{r['bound'][0]:.4f} ms by {r['bound'][1]} "
              f"({r['bound'][2]} bytes)")
    del flush, conn_l

    # ---- 9. the unstructured slice through the main path
    t = time.perf_counter()
    usim.run_steps(100, chunk=100)
    sync()
    uwarm_s = time.perf_counter() - t
    if usim.step_path != "flat2d":
        fail(f"the unstructured flagship dispatched to {usim.step_path!r}, "
             "not flat2d")
    time0 = float(usim.state.time)
    zero_counts()
    t = time.perf_counter()
    usim.run_steps(200, chunk=100)
    sync()
    urun_s = time.perf_counter() - t
    launches_u = {n: wrappers[n].launches
                  for n in ("cgather", "asm_pack", "asm_gather")}
    if any(v != 400 for v in launches_u.values()):
        fail(f"the flat path did not launch each kernel twice per step: "
             f"{launches_u}")
    if band2d.gather_corners.calls or band2d.scatter_corners.calls:
        fail("the flat path on the card took a plain version")
    s = usim.state
    if not float(s.time) > time0 or int(s.steps) != 300:
        fail("unstructured model time or the step count did not advance")
    for f in FIELD_NAMES:
        v = getattr(s, f)
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            fail(f"non-finite values in unstructured {f}")
    if s.stress.shape != (unelem, 3) or s.coord.shape != (unnode, 2):
        fail(f"unstructured stress has shape {tuple(s.stress.shape)}")
    urate = unelem * 200 / urun_s
    plain_run = flat2d.make_chunk_runner(usim.param, usim.ctx, 5, plain=True)
    plain_run(usim.ctx, s)
    sync()
    t = time.perf_counter()
    plain_run(usim.ctx, s)
    sync()
    uplain_rate = unelem * 5 / (time.perf_counter() - t)
    print(f"phase 9 unstructured slice: {unelem} triangles, {unnode} nodes, "
          f"step_path {usim.step_path}, launches {launches_u}, plain "
          f"versions called 0 times, host setup {uinit_s:.1f} s (mesh "
          f"{mesh_s[0]:.1f} s), warm-up "
          f"100 steps {uwarm_s:.2f} s, 200 steps {urun_s:.3f} s, model time "
          f"{time0:.6e} -> {float(s.time):.6e} s, fields finite")
    print(f"  elem*steps/s: kernels {urate:.6e}, plain versions "
          f"{uplain_rate:.6e} (over 5 steps) on {card}")

    # the slice on the card against the port on the CPU, small mesh
    # (f64 runs the double instantiations of the kernels; the two sides
    # then differ by the ulps of exp and log only)
    for rheology, n, dtype, tol in (
            ("maxwell", 10, "float32", 1e-5),
            ("elasto-visco-plastic", 1, "float32", 1e-5),
            ("maxwell", 10, "float64", 1e-10)):
        cfg = unstructured_cfg(rheology, small=True)
        cfg["sim"]["float_dtype"] = dtype
        par = des.param_from_dict(cfg)
        on_card = des.Simulation(par).run_steps(n, chunk=n)
        on_cpu = des.Simulation(par, device="cpu").run_steps(n, chunk=n)
        sync()
        for f in FLAT_FIELDS:
            check(f"flat {rheology} {dtype} {n} step(s), card vs CPU, {f}",
                  rel(getattr(on_cpu, f), getattr(on_card, f).cpu()), tol)

    per_kernel("unstructured flagship (flat2d)",
               lambda n: flat2d.make_chunk_runner(usim.param, usim.ctx, n)(
                   usim.ctx, usim.state), 10)

    src2 = "dynearthsol_tpu_torch/csrc/fused2d.cu"
    src3 = "dynearthsol_tpu_torch/csrc/fused3d.cu"
    err_metric = ("max |kernel - plain| / max |plain| over the output "
                  "planes of one flagship-size maxwell step, viscosity "
                  "aside")
    bound2 = {"bound_ms": step_bound[0], "bound_by": step_bound[1],
              "bound_bytes": step_bound[2], "bound_ops": step_bound[3]}
    occ2 = {"blocks_per_sm": occ["blocks_per_sm"], "grid": occ["grid"],
            "registers": occ["registers"],
            "local_bytes": occ["local_bytes"]}
    by_phase2 = {"bytes_by_phase": {k: v["bytes"] for k, v in
                                    phases2.items()},
                 "us_by_phase": {k: v["us"] for k, v in phases2.items()},
                 "by_phase_note": f"per interval between the chunk "
                                  f"kernel's barrier stamps, averaged over a "
                                  f"{NCH2}-step chunk (A alone on its first "
                                  f"step, H alone on its last)"}
    kernels = [
        {"name": "fused2d_step", "route": "cuda", "source": src2,
         "replaces": "dynearthsol_tpu/ops/pallas2d.py:1431",
         "form": "the chunk kernel with n = 1, one launch per step: the "
                 "tiled runner's (pallas2d, driven with global velocity "
                 "scaling); the resident main path runs no one-step launch",
         "launches": launches2t["fused2d_chunk"],
         "launches_by_path": {"pallas2d": launches2t["fused2d_chunk"],
                              "pallas2d_res": 0},
         "max_abs_err": step_err,
         "err_metric": err_metric, "ms": step_ms, "plain_ms": step_plain_ms,
         "timed_as": "a CUDA graph of 100 launches, over 100",
         **bound2, "library_ms": None, "ms_issued_from_python":
             step_issue_ms, **occ2, **by_phase2},
        {"name": "fused2d_chunk", "route": "cuda", "source": src2,
         "replaces": "dynearthsol_tpu/ops/pallas2d.py:1330",
         "form": f"one cooperative launch per chunk of {NCH2} steps, dt "
                 f"refreshed in the kernel (the resident runner's, the "
                 f"main path)",
         "launches": launches2["fused2d_chunk"],
         "launches_by_path": {"pallas2d_res": launches2["fused2d_chunk"]},
         "max_abs_err": max(step_err, scal2_err),
         "err_metric": err_metric + "; its dt refresh's dt, vmax, gdtmin, "
                       "time and L2 sum; a 25-step chunk equals 25 "
                       "one-step launches bit for bit",
         "ms": chunk2_ms, "plain_ms": step_plain_ms,
         "timed_as": f"per step: CUDA events around 2 chunks of {NCH2} "
                     f"steps, over {2 * NCH2}",
         "barrier_only_ms": barrier_ms, "grid_barriers_per_step":
             nsync / NCH2, "stamped_ms": stamped_ms,
         **bound2, "library_ms": None, "ms_issued_from_python": chunk2_ms,
         **occ2, **by_phase2},
        {"name": "dt_refresh", "route": "cuda", "source": src2,
         "replaces": "dynearthsol_tpu/ops/pallas2d.py:1330",
         "form": "one block, launched after every 3D step (the 2D path "
                 "refreshes dt inside the chunk kernel)",
         "launches": launches3["dt_refresh"] + launches2["dt_refresh"],
         "launches_by_path": {"pallas3d": launches3["dt_refresh"],
                              "pallas2d_res": launches2["dt_refresh"]},
         "max_abs_err": refresh_err,
         "err_metric": "max |kernel - plain| / max |plain| over dt, vmax, "
                       "gdtmin, time, L2 partial (3D every-step mode)",
         "ms": refresh_ms, "plain_ms": refresh_plain_ms,
         "bound_ms": refresh_bound[0], "bound_by": refresh_bound[1],
         "bound_bytes": refresh_bound[2], "bound_ops": refresh_bound[3],
         "library_ms": None, "ms_issued_from_python": refresh_issue_ms},
        {"name": "fused3d_step", "route": "cuda", "source": src3,
         "replaces": "dynearthsol_tpu/ops/pallas3d.py:1583",
         "launches": launches3["fused3d_step"], "max_abs_err": step3_err,
         "err_metric": "max |kernel - plain| / max |plain| over the State "
                       "fields of one flagship3d EVP step, the plain version "
                       "on the CPU",
         "ms": step3_ms, "plain_ms": step3_plain_ms,
         "timed_as": f"chunk form: a CUDA graph of {NCH} steps, their "
                     f"dt_refresh calls and one finalize, over {NCH}",
         "ms_one_step_form": step3_one_ms,
         "finalize_launches": launches3["fused3d_finalize"],
         "bound_ms": step3_bound[0], "bound_by": step3_bound[1],
         "bound_bytes": step3_bound[2], "bound_ops": step3_bound[3],
         "bound_note": f"the chunk form's: each step's inputs read once and "
                       f"its outputs written once, the planes no later step "
                       f"reads (strain rate, edvoldt, viscosity, force, "
                       f"hmass) on one step of {NCH}",
         "bound_ms_one_step_form": step3_bound_one[0],
         "bound_bytes_one_step_form": step3_bound_one[2],
         "bytes_by_phase": phases3,
         "library_ms": None, "ms_issued_from_python": step3_issue_ms},
    ]
    srcb = "dynearthsol_tpu_torch/csrc/band2d.cu"
    for name, main_site, line in (
            ("asm_gather", "asm_gather k=2 kg=1", 519),
            ("cgather", "cgather k=6", 663),
            ("asm_pack", "asm_pack k=5", 795)):
        r = band_t[main_site]
        kernels.append({
            "name": name, "route": "cuda", "source": srcb,
            "replaces": f"dynearthsol_tpu/ops/band2d.py:{line}",
            "launches": launches_u[name], "max_abs_err": band_err[name],
            "err_metric": "max |kernel - plain| over random inputs at a "
                          "small Delaunay mesh, a tet mesh and the "
                          "277k-triangle mesh, f32 and f64, every call "
                          "site's k (torch.equal required)",
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "bound_bytes": r["bound"][2], "bound_ops": r["bound"][3],
            "library_ms": r["library_ms"],
            "ms_issued_from_python": r["issue_ms"],
            "timed_at": main_site + ", 277k-triangle mesh, f32, L2 flushed "
                        "before each call",
            "call_sites": {
                site: {"ms": v["ms"], "ms_l2_warm": v["warm_ms"],
                       "ms_issued_from_python": v["issue_ms"],
                       "plain_ms": v["plain_ms"],
                       "library_ms": v["library_ms"],
                       "library_two_calls_ms":
                           v.get("library_two_calls_ms"),
                       "bound_ms": v["bound"][0],
                       "bound_bytes": v["bound"][2]}
                for site, v in band_t.items() if site.startswith(name)}})
    print(json.dumps({"kernels": kernels,
                      "elem_steps_per_s": rate,
                      "plain_elem_steps_per_s": plain_rate,
                      "elem_steps_per_s_tiled": tiled_rate,
                      "elem_steps_per_s_3d": rate3,
                      "plain_elem_steps_per_s_3d": plain_rate3,
                      "elem_steps_per_s_unstructured": urate,
                      "plain_elem_steps_per_s_unstructured": uplain_rate,
                      "init_s_unstructured": uinit_s,
                      "mesh_s_unstructured": mesh_s[0],
                      "init_s_3d": init3_s,
                      "script_s": time.perf_counter() - t_start}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
