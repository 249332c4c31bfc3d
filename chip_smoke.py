#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (dynearthsol_tpu_torch) on one
NVIDIA GPU.

Run from the root of the repository:  python3 chip_smoke.py

Phases, each printed, the first failure exits non-zero:
  1. device  -- a CUDA device is required (there is no CPU path);
  2. build   -- nvcc builds csrc/ into build/torch_kernels/, one compile per
                source, all started together; registers, stack frame and
                spills per kernel from the -Xptxas -v report;
  3. 2D kernels -- each 2D CUDA kernel against its plain PyTorch version on
                the card: maxwell over 10 steps, EVP over 1 step, the
                resident runner against the tiled runner over 25 steps
                (16 x 128 cells), then one flagship-size step, with the CPU
                tests' tolerances; kernel and plain device times at
                flagship shapes (CUDA graph replay);
  4. 3D kernels -- the fused 3D step against its plain version: maxwell
                over 10 steps and EVP over 1 step with and without NMD
                (128 x 16 x 8 cells) and one flagship3d EVP step, the plain
                version on the CPU (see run3); a dt = 0 step that keeps the
                volume bit for bit, the every-step mode of dt_refresh, one
                flagship3d maxwell step plane by plane against the plain
                version on the card; kernel and plain device times at
                flagship3d shapes;
  5. 2D slice -- the flagship config (100 km x 50 km, 512 x 256 cells, EVP,
                f32): Simulation(param, device="cuda"), 250 warm-up steps,
                then 500 timed steps, with launch counts, and the plain
                version's rate over 50 steps;
  6. 3D slice -- the flagship3d config (256 x 48 x 16 cells x 5 tets,
                983,040 tetrahedra, EVP, f32): Simulation(param) with the
                default device, 100 warm-up steps, then 500 timed steps,
                with launch counts, and the plain version's rate over 5
                steps;
  7. profile -- torch.profiler over 100 steps of the flagship runner and
                20 of the flagship3d runner: device time per launch by
                kernel, device busy and idle share;
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

    def check(label, err, tol):
        ok = err < tol
        print(f"  {label}: {err:.3e} (tol {tol:.0e}) "
              f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"{label}: kernel and plain version disagree")

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

    wrappers = {"fused2d_step": fused2d.fused_step,
                "dt_refresh": fused2d.dt_refresh,
                "fused3d_step": fused3d.fused3d_step,
                "cgather": band2d.cgather, "asm_pack": band2d.asm_pack,
                "asm_gather": band2d.asm_gather}

    def zero_counts():
        """Every kernel's launch count, and the calls of the plain gather
        and assembly, set to 0: called just before a main path is driven."""
        for w in wrappers.values():
            w.launches = 0
        band2d.gather_corners.calls = band2d.scatter_corners.calls = 0

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
    print("phase 3 2D kernels vs plain (16 x 128 cells, then flagship)")

    def sim_of(cfg):
        sim = des.Simulation(des.param_from_dict(cfg), device="cuda")
        return sim, fused2d.make_plan(sim.param, sim.ctx, sim.device)

    def chunk(sim, P, n, resident, plain):
        out = fused2d.run_chunk(P, sim.ctx, sim.state, n, resident, plain)
        sync()
        return out

    sim, P = sim_of(make_sim_cfg("maxwell"))
    ker = chunk(sim, P, 10, False, False)
    ref = chunk(sim, P, 10, False, True)
    for f in ("coord", "vel", "temperature", "stress", "strain", "volume",
              "volume_n", "mass", "tmass", "hmass", "strain_rate",
              "edvoldt", "force"):
        check(f"maxwell 10 steps {f}", rel(getattr(ref, f),
                                           getattr(ker, f)),
              1e-3 if f == "force" else 2e-4)
    dlog = (ref.viscosity.double().log() - ker.viscosity.double().log())
    check("maxwell 10 steps log-viscosity median",
          float(dlog.abs().median()), 0.02)
    for f in ("dt", "time", "max_global_vel_mag"):
        check(f"maxwell 10 steps {f}", rel(getattr(ref, f),
                                           getattr(ker, f)), 1e-5)

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
    fused2d.fused_step(P, b, 0)
    sync()
    vol = fused2d._eslot("volume")
    if not torch.equal(b.eout[vol], b.ein[vol]):
        fail("initial volume differs from the kernel's volume")
    print("  dt = 0 step keeps the initial volume bit for bit: ok")

    # one flagship-size step, kernel vs plain.  On maxwell: with EVP the
    # first step already meets the min-select tie of rheology.cxx:869-879
    # in the cold near-surface cells (viscosity at visc_max makes the
    # viscoelastic and elastic-plastic trial deviators equal in f32), and
    # one-ulp differences of expf pick either branch.
    msim, MP = sim_of(flagship_cfg("maxwell"))
    kb = fused2d.make_buffers(MP, msim.ctx, msim.state, 1, tiled=False)
    pb = fused2d.make_buffers(MP, msim.ctx, msim.state, 1, tiled=False)
    fused2d.fused_step(MP, kb, 0)
    fused2d.fused_step_plain(MP, pb, 0)
    sync()
    names = [f"e.{n}" for n in fused2d.E_SLOTS] \
        + [f"e.{t}[{i}]" for t in fused2d.T_SLOTS for i in range(3)] \
        + [f"n.{n}" for n in fused2d.N_SLOTS]
    step_err = 0.0
    for k, nm in enumerate(names):
        if nm == "e.viscosity":
            v = (pb.eout[k].double().log() - kb.eout[k].double().log())
            check(f"flagship 1 step {nm} (log)", float(v.abs().max()), 1e-5)
            continue
        a, b = (pb.eout[k], kb.eout[k]) if nm[0] == "e" else \
            (pb.nout[k - fused2d.NE], kb.nout[k - fused2d.NE])
        err = rel(a, b)
        step_err = max(step_err, err)
        check(f"flagship 1 step {nm}", err, 2e-6)
    del msim, kb, pb

    # kernel and plain times on the main path's config (EVP)
    fsim, FP = sim_of(flagship_cfg())
    kb = fused2d.make_buffers(FP, fsim.ctx, fsim.state, 1, tiled=False)
    pb = fused2d.make_buffers(FP, fsim.ctx, fsim.state, 1, tiled=False)

    def step_kernel():
        fused2d.fused_step(FP, kb, 0)

    def step_plain():
        fused2d.fused_step_plain(FP, pb, 0)

    # a step off the dt-refresh cadence, as nine steps in ten are
    step_ms = device_ms(step_kernel, 50)
    step_plain_ms = device_ms(step_plain, 5)
    step_issue_ms = issue_ms(step_kernel, 50)
    extra = (kb.flags[0],) if kb.cep is None else (kb.flags[0], kb.cep)
    step_bound = bound(*step_bytes(fused2d, FP, kb, 3, *extra),
                       step_ops(FP, 2, fsim.ctx.nelem, fsim.ctx.nnode))

    # dt_refresh on a refresh step: kernel vs plain from equal inputs.
    # Repeated calls redo the same work: they read the same partials and
    # refresh dt from them.
    kb.flags[0, 0] = 1.0
    pb.flags[0, 0] = 1.0
    step_kernel()
    pb.part.copy_(kb.part)
    pb.scal.copy_(kb.scal)

    def refresh_kernel():
        fused2d.dt_refresh(FP, kb, 0, False)

    def refresh_plain():
        fused2d.dt_refresh_plain(FP, pb.part, pb.scal, pb.dthist, pb.flags,
                                 0, False)

    refresh_kernel()
    refresh_plain()
    sync()
    refresh_err = max(rel(pb.scal[i:i + 1], kb.scal[i:i + 1])
                      for i in range(5))
    check("flagship dt_refresh scalars", refresh_err, 1e-6)
    refresh_ms = device_ms(refresh_kernel, 200)
    refresh_plain_ms = device_ms(refresh_plain, 50)
    refresh_issue_ms = issue_ms(refresh_kernel, 200)
    # one min, min, max and add per partial column, then the block's tree
    refresh_bound = bound(nbytes(kb.part, kb.scal, kb.flags[0, :1]),
                          nbytes(kb.scal, kb.dthist[:1]),
                          4 * (kb.part.shape[1] + 256))
    print(f"  device time: flagship fused step {step_ms:.4f} ms (plain "
          f"{step_plain_ms:.4f} ms, bound {step_bound[0]:.4f} ms by "
          f"{step_bound[1]}); dt_refresh {refresh_ms:.4f} ms (plain "
          f"{refresh_plain_ms:.4f} ms, bound {refresh_bound[0]:.6f} ms by "
          f"{refresh_bound[1]})")
    print(f"  issued from Python: fused step {step_issue_ms:.4f} ms, "
          f"dt_refresh {refresh_issue_ms:.4f} ms per call")
    del kb, pb

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
        ties = fused3d.evp_ties(P3, s3.ctx, s3.state) if plain else None
        return out, ties

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
    names = [f"e.{n}" for n in fused3d.E_SLOTS] \
        + [f"e.{t}[{i}]" for t in fused3d.T_SLOTS for i in range(6)] \
        + [f"n.{n}" for n in fused3d.N_SLOTS]
    for k, nm in enumerate(names):
        if nm == "e.viscosity":
            v = (pb.eout[k].double().log() - kb.eout[k].double().log())
            check(f"flagship3d 1 step {nm} (log)", float(v.abs().max()),
                  1e-5)
            continue
        a, b = (pb.eout[k], kb.eout[k]) if nm[0] == "e" else \
            (pb.nout[k - fused3d.NE], kb.nout[k - fused3d.NE])
        check(f"flagship3d 1 step {nm}", rel(a, b),
              1e-3 if nm.startswith("n.force") else 1e-4)
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

    step3_ms = device_ms(step3_kernel, 20)
    step3_plain_ms = device_ms(step3_plain, 3)
    step3_issue_ms = issue_ms(step3_kernel, 20)
    step3_bound = bound(*step_bytes(fused3d, FP3, kb, 6),
                        step_ops(FP3, 3, g3.ctx.nelem, g3.ctx.nnode))
    print(f"  device time: flagship3d fused step {step3_ms:.4f} ms (plain "
          f"{step3_plain_ms:.4f} ms, bound {step3_bound[0]:.4f} ms by "
          f"{step3_bound[1]}); issued from Python {step3_issue_ms:.4f} ms")
    del kb, pb

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
    launches2 = {"fused2d_step": fused2d.fused_step.launches,
                 "dt_refresh": fused2d.dt_refresh.launches}
    if min(launches2.values()) <= 0:
        fail(f"a kernel of the 2D path was not launched: {launches2}")
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
          f"{fsim.step_path}, launches {launches2}, warm-up 250 steps "
          f"{warm_s:.2f} s, 500 steps {run_s:.3f} s, model time "
          f"{time0:.6e} -> {float(s.time):.6e} s, fields finite")
    print(f"  elem*steps/s: kernels {rate:.6e}, plain PyTorch "
          f"{plain_rate:.6e} (over 50 steps) on {card}")

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
                 "dt_refresh": fused2d.dt_refresh.launches}
    if min(launches3.values()) <= 0:
        fail(f"a kernel of the 3D path was not launched: {launches3}")
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
          f"{g3.step_path}, launches {launches3}, warm-up 100 steps "
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

    per_kernel("flagship 2D (resident runner)",
               lambda n: fused2d.run_chunk(FP, fsim.ctx, fsim.state, n,
                                           True), 100)
    per_kernel("flagship3d", lambda n: fused3d.run_chunk(
        FP3, g3.ctx, g3.state, n), 20)


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
    kernels = [
        {"name": "fused2d_step", "route": "cuda", "source": src2,
         "replaces": "dynearthsol_tpu/ops/pallas2d.py:1431",
         "launches": launches2["fused2d_step"], "max_abs_err": step_err,
         "err_metric": err_metric,
         "ms": step_ms, "plain_ms": step_plain_ms,
         "bound_ms": step_bound[0], "bound_by": step_bound[1],
         "bound_bytes": step_bound[2], "bound_ops": step_bound[3],
         "library_ms": None, "ms_issued_from_python": step_issue_ms},
        {"name": "dt_refresh", "route": "cuda", "source": src2,
         "replaces": "dynearthsol_tpu/ops/pallas2d.py:1330",
         "launches": launches2["dt_refresh"] + launches3["dt_refresh"],
         "launches_by_path": {"pallas2d_res": launches2["dt_refresh"],
                              "pallas3d": launches3["dt_refresh"]},
         "max_abs_err": refresh_err,
         "err_metric": "max |kernel - plain| / max |plain| over dt, vmax, "
                       "gdtmin, time, L2 partial (2D and 3D modes)",
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
         "bound_ms": step3_bound[0], "bound_by": step3_bound[1],
         "bound_bytes": step3_bound[2], "bound_ops": step3_bound[3],
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
