#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (dynearthsol_tpu_torch) on one
NVIDIA GPU.

Run from the root of the repository:  python3 chip_smoke.py

Phases, each printed, the first failure exits non-zero:
  1. device  -- a CUDA device is required (there is no CPU path);
  2. build   -- nvcc builds csrc/ into build/torch_kernels/, one compile per
                source, all started together; registers, stack frame,
                spills and static shared memory per kernel from the
                -Xptxas -v report;
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
                then the production instance (Winkler and water
                tractions, surface process 1, two materials): one EVP
                step and a 10-step maxwell chunk against the plain
                version (16 x 128 cells), one full-size maxwell step and
                its dt refresh plane by plane against the plain version, a
                25-step chunk at full size against 25 one-step launches
                bit for bit, its chunk time, stamps and bytes per
                interval;
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
                form and its one-step form; the two-material instances (the
                const pack): a 3-step maxwell chunk, one maxwell step
                and one EVP step against the plain version on the CPU, the
                chunk form against 10 complete steps bit for bit; at
                flagship3d_multimat one maxwell step plane by plane
                against the plain version on the card and one EVP step
                against it on the CPU (the small EVP step away from what
                its ties of rounding reach, fused3d.evp_tie_reach);
  5. 2D slice -- the flagship config (100 km x 50 km, 512 x 256 cells, EVP,
                f32): Simulation(param, device="cuda"), 250 warm-up steps,
                then 500 timed steps, with launch counts (one chunk kernel
                launch per chunk, no dt_refresh, no plain version), and the
                plain version's rate over 50 steps; then the tiled runner's
                path (the flagship with global velocity scaling): 20 steps,
                one n = 1 launch per step, no dt_refresh, no plain version;
  5b. production slice -- bench.py production_param (512 x 256 cells,
                two materials by markers, Winkler and water tractions,
                surface process 1, EVP): a warm-up chunk of 250 steps, then
                2 chunks of 250, 2 chunk-kernel launches, no dt_refresh, no
                plain version, dhacc moved;
  6. 3D slice -- the flagship3d config (256 x 48 x 16 cells x 5 tets,
                983,040 tetrahedra, EVP, f32): Simulation(param) with the
                default device, 100 warm-up steps, then 500 timed steps,
                with launch counts (a finalize per chunk, no plain
                version), and the plain version's rate over 5 steps;
  6b. two-material 3D slice -- bench.py flagship3d_param(nmat=2): 100
                warm-up steps, then 500 in chunks of 250, 500 fused3d_step
                launches and a finalize per chunk, no plain version; the
                two-material kernel's device times;
  6c. production3d -- kernel 3's boundary-process instances (the Winkler
                and water facet tractions, surface process 1 with its top-lane
                pass S): at 128 x 16 x 8 cells a 10-step maxwell chunk with
                the tractions and surface process 1 and one production3d
                EVP step against the plain version on the CPU, every
                field's error printed, dhacc and edvacc_surf included (the
                EVP step away from what its ties of rounding reach); then
                bench.py production3d_param (983,040 tets, two materials):
                one maxwell step plane by plane against the plain version
                on the card, a 20-step EVP chunk against 20 complete steps
                bit for bit, the kernel's chunk-form and one-step device
                times and the plain version's, and the main path through
                Simulation.run_steps: 100 warm-up steps, then 500 in chunks
                of 250, 500 fused3d_step launches and a finalize per chunk,
                no plain version, dhacc moved, its elem*steps/s;
  7. profile -- torch.profiler over 100 steps of the flagship and
                production runners and 20 of the flagship3d,
                flagship3d_multimat and production3d runners: device time
                per launch by kernel, device busy and idle share; for the 3D
                ones the bytes each phase of the 3D kernel moves and its
                TB/s;
  8. gather/assembly kernels -- the three kernels of csrc/band2d.cu
                (cgather, asm_pack, asm_gather) against their plain
                versions with torch.equal (tolerance 0): a small Delaunay
                mesh, a small tet mesh (npe = 4) and the 277k-triangle mesh
                of phase 9, float32 and float64, at the k / kg of every
                call site of the flat step (cgather 6, 2, 8, 4, 1;
                asm_pack 2, 5, 3); the gather's staged and unstaged
                tiles and widest window at that mesh; their device times
                there with the L2 cache flushed between launches, L2-warm
                and as issued from Python, beside the plain versions', the
                library calls' (index_select, index_add_) and the bound;
                then the same at the flagship3d-unstructured mesh (phase
                12, npe = 4: its host setup and mesh build timed) at the
                call sites of the 3D column step (cgather 8, 2, 3, 6, 1;
                asm_pack 3, 4, 5; asm_gather (2, 1), (1, 1));
  9. unstructured slice -- the flagship config on a Delaunay box mesh
                (meshing_elem_shape 0: 277,258 triangles, 139,400 nodes,
                EVP, f32): Simulation(param) with the default device, a
                warm-up chunk of 100 steps, then 200 timed steps in chunks
                of 100, with launch counts (2 per step of each kernel, no
                plain version), and the plain versions' rate over 5 steps;
                the slice on the card against the port on the CPU at a
                1,062-triangle mesh (maxwell 10 steps and EVP 1 step in f32
                at 1e-5, maxwell 10 steps in f64 at 1e-10);
                the profiler breakdown of 10 steps;
  10. CLI, formats and goldens on the card -- (a) the maxwell-2d and
                maxwell-2mat-2d goldens of tests/golden/runs/ through the
                CLI's run() on the card (flat2d, float64: the double
                instances of the band kernels) and on the CPU, every frame
                held to the golden thresholds (1e-8 / 3e-8 accumulated,
                1e-7 rates), the worst difference per frame printed beside
                the card's against the CPU's; (b) the flagship written as a
                .cfg and run by `python -m dynearthsol_tpu_torch` in a
                subprocess, 1000 steps with a frame every 500 and a
                checkpoint every frame, on pallas2d_res; its frames read
                back with the port's OutputReader equal the state of the
                same config driven in this process through run_steps
                without output; its Compute s/step beside run_steps', the
                Output s per frame and the host's mesh-quality check;
                (c) the run restarted from frame 1 to step 1000 writes the
                continuous run's last frame bit for bit;
  11. the column step's features on the card -- (a) the evp-winkler-2d
                golden (EVP without plane strain, Winkler, surface
                process 1: the generic step in float64) through the CLI's
                run() on the card and on the CPU, frames 0-2 held to the
                golden's rule (1e-6 accumulated, 1e-5 rates), every
                frame's difference to the reference and card against CPU
                printed, 2 launches per step of each band kernel; (b)
                production-unstructured (bench.py's production feature set
                on phase 9's 277,258-triangle mesh), pt2d (the flagship
                with the pseudo-transient loop, 5 iterations at 1e-3) and
                flagship-hydraulic (the flagship, maxwell, Biot diffusion)
                on flat2d: one step with the kernels equal on every field
                to one with the plain versions on the card (the new k of
                each band kernel: cgather 8, 4 and 1, asm_pack 3), then 2
                timed chunks with elem*steps/s, launches per step,
                pseudo-transient iterations and host reads per step, and
                the profiler's device-idle share; (c) rate-and-state
                friction, the elastic foundation, Neumann tractions with
                the three facet kinds, and surface process 102 at the test
                sizes, float64, card against CPU at 1e-10;
  12. the 3D column step (flat3d) on the card -- (a) the ep-3d and
                maxwell-2mat-3d goldens (flat3d, float64, the reference's
                TetGen meshes) through the CLI's run() on the card and on
                the CPU, every frame at 1e-8 accumulated and 1e-7 rates,
                each frame's difference to the reference and card against
                CPU printed, the band kernels' launches per step as the
                step makes them; (b) flagship3d-unstructured (flagship3d's
                physics on a Delaunay box cut to 128 x 48 x 16 km, 680,794
                tets, phase 8's Simulation) and flagship3d-hydraulic
                (flagship3d's mesh, maxwell, Biot diffusion, the 8 + 2
                gather): one step with the kernels equal on every field to
                one with the plain versions on the card, then two timed
                chunks with elem*steps/s, launches per step, plain-version
                calls (0), the profiler's device-idle share and the
                gather's staged tiles; (c) rate-and-state friction, the
                pseudo-transient loop with hydraulic diffusion, Neumann
                tractions with the elastic foundation, and surface process
                1 with the Winkler foundation at the test sizes, float64,
                card against CPU at 1e-10;
  13. remeshing on the card -- (a) at test sizes a card run and a CPU run
                that takes its state and markers remesh to the same mesh
                and markers (the finalize card against CPU at 1e-12 in
                float64), then the kernels on the card against the plain
                versions on the CPU: option 11 on flat2d in float64 (20
                steps at 1e-10), option 100 from a Delaunay start onto the
                resident 2D kernel (16 x 128 cells; float32 maxwell, 10
                steps at phase 3's tolerances) and option 100 in 3D on the
                fused 3D step (128 x 4 x 8 cells, the smallest box its
                gate admits; one float32 maxwell step at phase 4's
                one-step bound); (b) bench.py's postremesh: the flagship with
                option 100 on phase 9's 277,258-triangle mesh, 20 flat2d
                steps (one with the kernels equal on every field to one
                with the plain versions), a remesh onto 512 x 256 cells,
                then a second with the same dims; after each the host
                seconds by part (SPR, regeneration, location, ACM,
                markers, finalize), one maxwell step of the resident
                kernel against the plain version on the card on every
                field (phase 3's flagship rule, 2e-6), 200 timed steps on
                pallas2d_res with their launches and elem*steps/s;
  14. the plane steps and the 3D remeshing on the card -- (a) the
                evp-remesh-3d golden (3D EVP, two materials, water
                loading, surface process 1, remeshing option 13 about
                every 5-7 steps, 400 float64 steps on flat3d) through the
                CLI's run() on the card, held to the gates of
                tests/test_golden_vs_reference.py:339-392: the step paths,
                the number of remeshes, the host seconds per remesh by
                part, the band kernels' launches per step and the wall
                seconds; (b) grid3d (8 x 2 x 4 cells) and grid2d (the
                flagship at 32 x 16 cells), float64, 20 steps card against
                CPU on every field, then the float64 flagship on grid2d
                and float64 flagship3d on grid3d: elem*steps/s, launches
                per step and the device's idle share, and each against its
                column step (flat2d, flat3d) on the same mesh from the same
                state; (c) a metric-driven 3D remesh (use_mesh_optimizer,
                its spacing clipped flat, before the first step) and option
                100's 3D fallback at test size, card against CPU from one
                state: the regeneration through its quality loop at the
                first try, the same mesh and markers, every volume
                positive, the finalize at 1e-12, then 10 flat3d steps with
                the kernels against the plain versions on the CPU at
                1e-10;
  15. the CLI's host features on the card -- (a) subduction-2d: bench.py
                production's box and mesh (512 x 256 cells, 4 markers per
                element) with the flagship's physics, 8 materials,
                sediment over oceanic crust over mantle, a 30 Myr plate's
                geotherm and phase_change_option 1 with the hydration
                processes, 100 steps through the CLI's run() on the card
                (the resident 2D kernel in 10-step chunks between the
                phase-change wakes) and with phase_change_option 0, twice
                each: the step path, the kernels' launches per step, the
                transitions, released and hydrous markers and the host ms
                of phase_changes, the emw upload and the hydrous advection
                at each wake, Compute s/step, and the s/step of 10-step
                chunks after the first with and without the phase changes;
                from the state of the first wake that changed the weights,
                the chunk kernel's 8-material instance against its plain
                version with a maxwell plan, as phase 13 holds a run's
                state (one step at 2e-6, a 10-step chunk at phase 3's
                10-step gates, and against the weights before the wake),
                and one step of the run's EVP plan (its stress apart only
                in the cold cells at visc_max, where the min-select ties); at
                test size (tests/test_phasechanges.py's 40 x 40 km box,
                float32, 50 steps) card against CPU, every marker's
                material and release wake by wake (one that differs must
                lie within 1e-5 of its phase boundary, or, for the
                mantle's serpentinization, in an element whose hydrous
                markers differ because they lie within 1e-5 of an element
                side) and the fields at the maxwell gate; (b)
                rsf-cycle-2d: tests/test_monitor.py's rate-and-state
                simple shear on the flagship mesh, float32, with
                earthquake tracking, adaptive output and a monitor of 4
                points, 200 steps on flat2d through run(): the band
                kernels' launches per step, the events, the frame steps,
                the monitor rows, the host ms of tracking and of the
                monitor per wake, Compute s/step; at test size (float64)
                card against CPU, the event log, frames and monitor CSVs
                at 1e-10; (c) surface process 101 with a registered hook
                and option 11 with a GoSPL stand-in over 5 steps, card
                against CPU frame for frame at 1e-10, and DES_PROFILE_DIR's
                trace of a run on the resident 2D kernel naming
                step_chunk2d;
  16. the ways a run starts -- (a) the isostasy pre-relaxation (maxwell,
                f32) on phase 9's 277,258 triangles (20 steps) and phase
                12's 680,794 tets (10 steps), their meshes reused: the band
                kernels against their plain versions from one state at the
                maxwell trajectory rule, steps, s/step, band-kernel and
                CUDA launches per step, the device's idle share; (b) the
                body-force pre-relaxation on the 277,258 triangles:
                iterations, host reads, s per iteration, kernels against
                plain versions; (c) the 3D generic step (DES_NO_FLAT) on
                the 680,794 tets: one step with the kernels equal to the
                plain versions', two timed chunks of 10 steps,
                elem*steps/s, launches per step; (d) at test size, float64,
                card against CPU at 1e-10: both pre-relaxations in 2D and
                3D, the 3D generic step with hydraulic diffusion, a 2D
                .poly run with two regions and a 3D .poly run with inclined
                BCs (types 13 and 3); (e) the ep-remesh-2d golden through
                the CLI on the card, frames 0-2 (5,000 of its 40,000
                steps) at the accumulated bounds of its pre-remesh frames,
                with its seconds;
  17. the registry's models and their output -- (a) rifting-2d,
                production-rifting-2d (262,144 triangles), oblique-rift-3d
                and production-rifting-3d (983,040 tets) at their default
                widths through the CLI's run() with averaged frames (60 /
                12 steps, a frame every 30 / 6): the step path (grid2d /
                grid3d, the JAX package's: the fused gates refuse averaged
                output), no hand-written kernel launched, elem*steps/s,
                CUDA launches per step, host set-up seconds and seconds
                per frame, and one step on the card against the CPU at
                phase 15's EVP rule; (b) each last frame through to_vtk
                (principal stress, melting, heat flux) and to_vtp, timed,
                the derived fields card against CPU at 1e-12; (c) freeair
                and bouguer at 512 points over rifting-2d's last frame,
                card against CPU; (d) VTKHDF written and read back where
                h5py imports, else its refusal naming h5py;
  18. multi-device stepping -- the node-sharded halo step
                (parallel/halo_step.py) against the single-device generic
                step from one state: (a) phase 9's 277,258 triangles in
                f64 on 4 shards of cuda:0: maxwell over 10 steps and EVP's
                first step at 1e-12 (the viscosity at 1e-9), EVP's next 9
                at 1e-9 on coord, temperature, strain, plastic strain,
                mass and the scalars, 1e-8 on velocity and stress, the
                viscosity differing in at most 5 % of the elements; the
                overlap rows and scalars equal bit for
                bit, h, B, W and the nodal bytes per shard; (b)
                production (maxwell) in f64, 4 shards, 10 steps, at 1e-9;
                (c) f32 rates at 1, 2 and 4 shards and on
                one device, the band-kernel launches per shard per step,
                host ms per collective, the device's idle share; (d)
                cgather and asm_pack on a shard's window against their
                plain versions; (e) the 3D halo step at test size, card
                against CPU; (f) the CLI with DES_N_DEVICES=2 through a
                remesh against the single-device CLI at 1e-9; (g) with two
                cards or more, one shard per card.
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


def production_cfg(rheology="elasto-visco-plastic", small=False):
    """bench.py production_param, the examples/rifting-2d.cfg feature set:
    Winkler foundation, water loading, surface process 1 (hillslope
    diffusion), the surface-element correction and two materials by
    markers (4 per element), EVP, 512 x 256 cells, 262,144 triangles.
    ``small``: tests/test_pallas.py _production_sim, the same features on
    make_sim's 16 x 128 cells with damping 2 (factor 0.4)."""
    cfg = make_sim_cfg(rheology) if small else flagship_cfg(rheology)
    cfg["markers"] = {"markers_per_element": 4, "init_marker_option": 1}
    cfg["control"].update(surface_process_option=1, surface_diffusivity=1e-6,
                          has_surface_correction=True)
    if small:
        cfg["control"].update(damping_option=2, damping_factor=0.4)
    cfg["bc"].update(has_winkler_foundation=True, has_water_loading=True,
                     winkler_delta_rho=100.0)
    cfg.setdefault("ic", {}).update(mattype_layer_depths=[0.3],
                                    layer_mattypes=[0, 1])
    cfg["mat"].update(nmat=2, rho0=[2800.0, 3300.0],
                      bulk_modulus=[50e9, 80e9], shear_modulus=[30e9, 48e9])
    return cfg


def golden_cfg(rundir: Path, modelname: str) -> str:
    """tests/test_golden_vs_reference.py _prepare_case: the golden's cfg,
    renamed, on the reference binary's mesh with its marker stream."""
    cfg = (rundir / "case.cfg").read_text()
    if "modelname = ref" not in cfg:
        fail(f"{rundir}/case.cfg does not name the model ref")
    return (cfg.replace("modelname = ref", f"modelname = {modelname}")
            + f"\n[mesh]\nmesh_from_run = {rundir / 'ref'}\n"
            "mesh_from_run_frame = 0\n[markers]\n"
            "reference_compatible_rng = yes\n")


# the golden gates of tests/test_golden_vs_reference.py:86-133: rates and
# instantaneous quantities at 1e-7, the rest at the case's threshold
GOLDEN_RATES = {"X velocity", "Z velocity", "S. rate I", "S. rate II",
                "Stress I", "Stress II", "Viscosity"}
GOLDEN_ACCUM = {"maxwell-2d": 1e-8, "maxwell-2mat-2d": 3e-8}


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


def multimat3d_cfg(cfg):
    """A 3D config with the two materials of tests/test_pallas3d.py:135-153
    (_multimat_over: crust over mantle by markers, contrasting moduli,
    densities, heat capacities, conductivities and creep laws)."""
    cfg["mat"].update({
        "nmat": 2, "rho0": [2700.0, 3300.0], "bulk_modulus": [40e9, 120e9],
        "shear_modulus": [24e9, 70e9], "heat_capacity": [1000.0, 1200.0],
        "therm_cond": [2.5, 3.3], "alpha": [3e-5, 2e-5],
        "visc_coefficient": [1e2, 1e3],
        "visc_activation_energy": [3.0e5, 4.0e5],
        "cohesion0": [4e7, 6e7], "friction_angle0": [30.0, 25.0]})
    cfg.setdefault("ic", {}).update(num_mattype_layers=2,
                                    layer_mattypes=[0, 1],
                                    mattype_layer_depths=[0.4])
    cfg["markers"] = {"markers_per_element": 4, "random_seed": 11}
    return cfg


def flagship3d_cfg(rheology="elasto-visco-plastic", nmat=1):
    """bench.py flagship3d_param: 256 x 48 x 16 cells x 5 tets = 983,040
    tetrahedra, 214,081 nodes; EVP, one material, f32.  ``nmat=2``:
    flagship3d_param(nmat=2), crust (the top 40 %) over mantle by 4
    markers per element."""
    cfg = {
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
    if nmat == 2:
        cfg["markers"] = {"markers_per_element": 4, "init_marker_option": 1}
        cfg["ic"] = {"mattype_layer_depths": [0.4], "layer_mattypes": [0, 1]}
        cfg["mat"].update(nmat=2, rho0=[2800.0, 3300.0],
                          bulk_modulus=[50e9, 80e9],
                          shear_modulus=[30e9, 48e9])
    return cfg


# bench.py production3d_param's boundary processes: surface process 1
# (diffusivity 1e-6 m^2/s) with the surface correction, the Winkler
# foundation (delta rho 100) and water loading
BOUNDARY3 = {
    "control": {"surface_process_option": 1, "surface_diffusivity": 1e-6,
                "has_surface_correction": True},
    "bc": {"has_winkler_foundation": True, "has_water_loading": True,
           "winkler_delta_rho": 100.0}}


def production3d_cfg(rheology="elasto-visco-plastic", small=False, nmat=2):
    """bench.py production3d_param: flagship3d_param(nmat=2) with
    BOUNDARY3, 983,040 tets.  ``small``: the same features at 128 x 16 x 8
    cells (tests/test_pallas3d.py:287-303; two materials as
    multimat3d_cfg, or one with ``nmat=1`` and no weak zone, :262-276), the
    base level raised to 10 m so that the flat top takes water pressure."""
    if small:
        cfg = sim3d_cfg(rheology, weakzone=int(nmat == 2))
        if nmat == 2:
            cfg = multimat3d_cfg(cfg)
    else:
        cfg = flagship3d_cfg(rheology, nmat=2)
    for sec, kv in BOUNDARY3.items():
        cfg[sec].update(kv)
    if small:
        cfg["control"]["surf_base_level"] = 10.0
    return cfg


# 3D gates of tests/test_pallas3d.py:79-82, :112-131
FIELDS3 = ("coord", "vel", "temperature", "stress", "strain", "plstrain",
           "volume", "volume_n", "mass", "tmass", "hmass", "force",
           "strain_rate", "edvoldt", "delta_plstrain", "volume_old")


def cli_formats_goldens(des, wrappers, zero_counts, card):
    """Phase 10: the CLI, the file formats and the goldens on the card
    (see the module's docstring).  Returns the numbers for the JSON
    record."""
    import contextlib
    import copy
    import io
    import os
    import re
    import tempfile

    import numpy as np
    import torch

    from dynearthsol_tpu_torch import __main__ as cli
    from dynearthsol_tpu_torch.compare import _frame_quantities, reldiff
    from dynearthsol_tpu_torch.postproc import OutputReader
    from dynearthsol_tpu_torch.remeshing import bad_mesh_quality
    from torch_cases import tagged_arrays, write_cfg

    root = Path(__file__).resolve().parent
    runs = root / "tests" / "golden" / "runs"
    rec = {"goldens": {}}

    def quiet_run(cfg, device):
        """cli.run on a .cfg, its progress lines kept; returns (sim, the
        summary lines, seconds)."""
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            sim = cli.run(des.load_config(cfg), device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t
        return sim, [ln for ln in buf.getvalue().splitlines()
                     if ln.startswith(("Compute:", "Output:"))], secs

    def summary(text, label):
        m = re.search(rf"^{label}:\s+([0-9.]+) s / ([0-9]+) \w+"
                      rf"(?: = ([0-9.e+-]+) s/\w+)?$", text, re.M)
        if not m:
            fail(f"the CLI printed no {label} line")
        return (float(m.group(1)), int(m.group(2)),
                float(m.group(3)) if m.group(3) else None)

    print("phase 10 CLI, formats and goldens on the card")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        os.chdir(work)
        try:
            # (a) the goldens through the CLI, card and CPU
            for case, accum in GOLDEN_ACCUM.items():
                for dev in ("card", "cpu"):
                    (work / f"{case}-{dev}.cfg").write_text(
                        golden_cfg(runs / case, f"{case}-{dev}"))
                zero_counts()
                sim, lines, card_s = quiet_run(f"{case}-card.cfg", "cuda")
                launches = {n: wrappers[n].launches
                            for n in ("cgather", "asm_pack", "asm_gather")}
                nsteps = int(sim.state.steps)
                if sim.step_path != "flat2d" or \
                        sim.dtype != torch.float64:
                    fail(f"{case} ran on {sim.step_path!r} in {sim.dtype}, "
                         "not flat2d in float64")
                if any(v != 2 * nsteps for v in launches.values()):
                    fail(f"{case}: the float64 band kernels were not "
                         f"launched twice per step: {launches}")
                _, _, cpu_s = quiet_run(f"{case}-cpu.cfg", "cpu")
                ref = OutputReader(str(runs / case / "ref"))
                our = OutputReader(f"{case}-card")
                cpu = OutputReader(f"{case}-cpu")
                if our.frames != ref.frames or our.steps != ref.steps:
                    fail(f"{case}: frames {our.frames} at steps "
                         f"{our.steps}, the golden's {ref.steps}")
                print(f"  {case}: flat2d float64, {nsteps} steps on the "
                      f"card in {card_s:.1f} s ({' '.join(lines)}), on the "
                      f"CPU {cpu_s:.1f} s; launches {launches}")
                worst = []
                for frame in ref.frames:
                    q = [_frame_quantities(r, frame, include_markers=False)
                         for r in (ref, our, cpu)]
                    w = {"accumulated": 0.0, "rates": 0.0,
                         "card_vs_cpu": 0.0}
                    for kind in q[0]:
                        e = sum(reldiff(q[0][kind], q[1][kind]))
                        cls = "rates" if kind in GOLDEN_RATES \
                            else "accumulated"
                        thr = 1e-7 if cls == "rates" else accum
                        if not (np.isfinite(e) and e <= thr):
                            fail(f"{case} frame {frame} {kind}: {e:.3e} "
                                 f"against the reference (limit {thr:g})")
                        w[cls] = max(w[cls], e)
                        w["card_vs_cpu"] = max(w["card_vs_cpu"], sum(
                            reldiff(q[2][kind], q[1][kind])))
                    worst.append(w)
                    print(f"    frame {frame:2d}: against the reference "
                          f"accumulated {w['accumulated']:.3e} (limit "
                          f"{accum:g}), rates {w['rates']:.3e} (limit "
                          f"1e-7); card against CPU {w['card_vs_cpu']:.3e}")
                rec["goldens"][case] = {
                    "launches": launches, "card_s": card_s,
                    "cpu_s": cpu_s, "worst_by_frame": worst}

            # (b) the flagship through `python -m dynearthsol_tpu_torch`
            fcfg = flagship_cfg()
            fcfg["sim"].update(modelname="flag", max_steps=1000,
                               output_step_interval=500,
                               checkpoint_frame_interval=1)
            write_cfg(work / "flag.cfg", fcfg)
            rcfg = copy.deepcopy(fcfg)
            rcfg["sim"].update(modelname="rest", is_restarting=True,
                               restarting_from_modelname="flag",
                               restarting_from_frame=1)
            write_cfg(work / "rest.cfg", rcfg)
            env = dict(os.environ, PYTHONPATH=str(root))

            def cli_call(cfg):
                t = time.perf_counter()
                r = subprocess.run(
                    [sys.executable, "-m", "dynearthsol_tpu_torch", cfg],
                    cwd=work, env=env, capture_output=True, text=True,
                    timeout=600)
                secs = time.perf_counter() - t
                if r.returncode:
                    fail(f"python -m dynearthsol_tpu_torch {cfg} exited "
                         f"{r.returncode}: {r.stderr[-2000:]}")
                if "Path:     pallas2d_res" not in r.stdout:
                    fail(f"{cfg} did not run on pallas2d_res")
                launches = dict(
                    (k, int(v)) for k, v in re.findall(
                        r"(\w+) (\d+)", re.search(r"^Launches: (.*)$",
                                                  r.stdout, re.M).group(1)))
                return r.stdout, secs, launches

            text, cli_s, cli_launches = cli_call("flag.cfg")
            compute = summary(text, "Compute")
            output = summary(text, "Output")
            if cli_launches["fused_chunk"] != 10 or any(
                    v for k, v in cli_launches.items() if k != "fused_chunk"):
                fail(f"the CLI's flagship launched {cli_launches}, not 10 "
                     "chunk kernels and nothing else")
            print(f"  flagship through the CLI: {cli_s:.1f} s in all, "
                  f"Compute {compute[0]:.2f} s / {compute[1]} steps = "
                  f"{compute[2]:.3e} s/step, Output {output[0]:.2f} s / "
                  f"{output[1]} frames = {output[2]:.3e} s/frame (with "
                  f"their checkpoints); launches {cli_launches} on {card}")

            # the same config in this process, no output: the frames
            # written by the CLI must equal its state
            sim = des.Simulation(des.load_config(str(work / "flag.cfg")))
            fields = {"coordinate": "coord", "velocity": "vel",
                      "temperature": "temperature", "force": "force",
                      "coord0": "coord0", "pore pressure": "ppressure",
                      "plastic strain": "plstrain",
                      "plastic strain-rate": "delta_plstrain",
                      "strain-rate": "strain_rate", "strain": "strain",
                      "stress": "stress", "viscosity": "viscosity",
                      "radiogenic source": "radiogenic_source"}
            reader = OutputReader("flag")

            def same_as_state(frame):
                st = sim.state
                for name, f in fields.items():
                    a = reader.read_field(frame, name)
                    b = getattr(st, f).cpu().double().numpy()
                    if not np.array_equal(a.ravel(), b.ravel()):
                        fail(f"flagship frame {frame} {name} differs from "
                             f"the state of run_steps")
                mk = reader.read_markers(frame)
                if mk["size"] != sim.markers.n or not np.array_equal(
                        mk["markerset.elem"], sim.markers.live("elem")):
                    fail(f"flagship frame {frame}: markers differ")

            same_as_state(0)
            zero_counts()
            run_s = 0.0
            for frame in (1, 2):
                t = time.perf_counter()
                sim.run_steps(500)
                torch.cuda.synchronize()
                run_s += time.perf_counter() - t
                same_as_state(frame)
            if sim.step_path != "pallas2d_res" or \
                    wrappers["fused2d_chunk"].launches != 10:
                fail("run_steps of the flagship did not take pallas2d_res "
                     "in 10 chunks")
            t = time.perf_counter()
            quality = bad_mesh_quality(sim)
            quality_s = time.perf_counter() - t
            print(f"  frames 0-2 read back with OutputReader equal the "
                  f"state of run_steps (13 fields and the markers): ok; "
                  f"run_steps without output {run_s:.2f} s / 1000 steps = "
                  f"{run_s / 1000:.3e} s/step against the CLI's "
                  f"{compute[2]:.3e}; the host's mesh-quality check "
                  f"{quality_s:.2f} s ({sim.topo.nelem} elements, code "
                  f"{quality[0]}, min quality {quality[1]:.4f})")

            # (c) restart from frame 1
            text, rest_s, rest_launches = cli_call("rest.cfg")
            rcompute = summary(text, "Compute")
            if "Restarted from frame 1 (step 500)." not in text \
                    or rest_launches["fused_chunk"] != 5:
                fail(f"the restart did not start at step 500 or launched "
                     f"{rest_launches}")
            a, b = (tagged_arrays(f"{m}.save.000002")
                    for m in ("flag", "rest"))
            if a.keys() != b.keys() or any(a[k] != b[k] for k in a):
                fail("the restarted flagship's last frame differs from the "
                     "continuous run's: " + ", ".join(
                         k for k in a if a.get(k) != b.get(k)))
            a, b = (tagged_arrays(f"{m}.chkpt.000002")
                    for m in ("flag", "rest"))
            scal = [k for k in a if k.startswith("time info_display")]
            if a.keys() != b.keys() or any(a[k] != b[k] for k in a
                                           if k not in scal):
                fail("the restarted flagship's last checkpoint differs")
            sa, sb = (np.frombuffer(x[scal[0]], np.float64) for x in (a, b))
            if not np.array_equal(sa[[0, 2, 3, 4, 5]], sb[[0, 2, 3, 4, 5]]):
                fail("the restarted flagship's time, dt or vmax differ")
            print(f"  restart from frame 1 (step 500) to step 1000: "
                  f"{rest_s:.1f} s in all, Compute {rcompute[0]:.2f} s; the "
                  f"last frame equals the continuous run's bit for bit "
                  f"({len(a)} checkpoint arrays, the driver scalars "
                  f"info_display_next_step and reference_frame_time aside)")
            rec.update(
                cli_flagship_s=cli_s, cli_compute_s_per_step=compute[2],
                run_steps_s_per_step=run_s / 1000,
                cli_output_s_per_frame=output[2], cli_frames=output[1],
                cli_launches=cli_launches, quality_check_s=quality_s,
                restart_s=rest_s, restart_compute_s=rcompute[0],
                restart_launches=rest_launches)
        finally:
            os.chdir(cwd)
    return rec


# tests/test_flat.py:188-203: the Biot material of flagship-hydraulic
HYD_MAT = {"porosity": [0.1], "hydraulic_perm": [1e-15],
           "fluid_bulk_modulus": [2.2e9], "biot_coeff": [0.8]}


def feature_cfgs():
    """Phase 11's full-size column-step paths: bench.py's production
    feature set on the Delaunay flagship mesh, bench.py's pt2d (the
    flagship with the pseudo-transient loop, 5 iterations at 1e-3) and the
    flagship (maxwell) with Biot hydraulic diffusion.  (label, config,
    chunk)."""
    prod = production_cfg()
    prod["mesh"]["meshing_elem_shape"] = 0
    pt = flagship_cfg()
    pt["control"].update(has_PT=True, PT_max_iter=5,
                         PT_relative_tolerance=1e-3)
    hyd = flagship_cfg("maxwell")
    hyd["control"]["has_hydraulic_diffusion"] = True
    hyd["mat"].update(HYD_MAT)
    return (("production-unstructured", prod, 10), ("pt2d", pt, 5),
            ("flagship-hydraulic", hyd, 10))


def small_feature_cfgs():
    """Phase 11's test-size paths (tests/test_torch_flat2d_features.py),
    float64 on the 1,062-triangle box: (label, config, steps)."""
    def box(rheology, **over):
        cfg = unstructured_cfg(rheology, small=True)
        cfg["sim"]["float_dtype"] = "float64"
        for sec, kv in over.items():
            cfg.setdefault(sec, {}).update(kv)
        return cfg

    rsf = box("elasto-visco-plastic-rate-state-friction",
              mesh={"xlength": 1.0, "zlength": 1.0, "resolution": 1.0,
                    "quality_check_step_interval": 10**8},
              control={"gravity": 0.0, "fixed_dt": 1.0,
                       "use_global_velocity_scaling": True,
                       "has_thermal_diffusion": False},
              bc={"vbc_x0": 1, "vbc_val_x0": 0.0, "vbc_x1": 1,
                  "vbc_val_x1": 0.0, "vbc_z0": 1, "vbc_val_z0": 0.0,
                  "vbc_z1": 4, "vbc_val_z1": 1e-5},
              mat={"rho0": [1.0], "alpha": [0.0], "bulk_modulus": [2e8],
                   "shear_modulus": [2e8], "cohesion0": [1e6],
                   "cohesion1": [1e6], "friction_angle0": [30.0],
                   "friction_angle1": [30.0], "direct_a": [0.2],
                   "evolution_b": [0.1], "characteristic_distance": [1e-3],
                   "characteristic_velocity": [1e-6], "state_var_model": 1})
    return (
        ("rsf", rsf, 30),
        ("elastic-foundation", box("maxwell", bc={
            "has_elastic_foundation": True}), 10),
        ("neumann-side-walls", box("maxwell", control={
            "surf_base_level": 10.0}, bc={
            "has_winkler_foundation": True, "has_water_loading": True,
            "winkler_delta_rho": 100.0, "vbc_x1": 0, "stress_bc_x0": 1,
            "stress_val_x0": 2e6}), 10),
        ("surface-process-102", box("elasto-visco-plastic", control={
            "surface_process_option": 102, "surface_diffusivity": 1e-6,
            "has_surface_correction": True}), 20))


def features_on_card(des, wrappers, zero_counts, card, usim, per_kernel,
                     prof_last):
    """Phase 11: the column step's features on the card -- (a) the
    evp-winkler-2d golden through the CLI on the card and on the CPU
    (generic path, float64), frames 0-2 at the golden's rule; (b) the
    full-size paths of feature_cfgs: one step with the kernels against
    one with the plain versions on the card, every field equal, then
    timed chunks with launch counts, pseudo-transient iterations and host
    reads per step, and the profiler's idle share; (c) the test-size
    paths of small_feature_cfgs, card against CPU.  Returns the numbers
    for the JSON record."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np
    import torch

    from dynearthsol_tpu_torch import __main__ as cli
    from dynearthsol_tpu_torch import simulation as sim_mod
    from dynearthsol_tpu_torch.compare import _frame_quantities, reldiff
    from dynearthsol_tpu_torch.ops import band2d, flat2d
    from dynearthsol_tpu_torch.postproc import OutputReader
    from dynearthsol_tpu_torch.state import FIELD_NAMES

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    rundir = root / "tests" / "golden" / "runs" / "evp-winkler-2d"
    band = ("cgather", "asm_pack", "asm_gather")
    rec = {"paths": {}, "small": {}}
    print("phase 11 the column step's features on the card")

    # (a) evp-winkler-2d: tests/test_golden_vs_reference.py:123's rule,
    # 1e-6 accumulated and 1e-5 rates at frames 0-2
    accum, rates, last = 1e-6, 1e-5, 2
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            secs, sims = {}, {}
            for dev in ("cuda", "cpu"):
                Path(f"ew-{dev}.cfg").write_text(
                    golden_cfg(rundir, f"ew-{dev}"))
                zero_counts()
                t = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    sims[dev] = cli.run(des.load_config(f"ew-{dev}.cfg"),
                                        device=dev)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    launches = {n: wrappers[n].launches for n in band}
                secs[dev] = time.perf_counter() - t
            sim = sims["cuda"]
            nsteps = int(sim.state.steps)
            if sim.step_path != "generic" or sim.dtype != torch.float64:
                fail(f"evp-winkler-2d ran on {sim.step_path!r} in "
                     f"{sim.dtype}, not the generic step in float64")
            if any(v != 2 * nsteps for v in launches.values()):
                fail("evp-winkler-2d: the float64 band kernels were not "
                     f"launched twice per step: {launches}")
            ref = OutputReader(str(rundir / "ref"))
            our, cpu = OutputReader("ew-cuda"), OutputReader("ew-cpu")
            if our.frames != ref.frames or our.steps != ref.steps:
                fail(f"evp-winkler-2d: frames {our.frames} at steps "
                     f"{our.steps}, the golden's {ref.steps}")
            print(f"  (a) evp-winkler-2d: generic float64, {nsteps} steps "
                  f"on the card in {secs['cuda']:.1f} s, on the CPU "
                  f"{secs['cpu']:.1f} s; launches {launches}")
            worst = []
            for frame in ref.frames:
                q = [_frame_quantities(r, frame, include_markers=False)
                     for r in (ref, our, cpu)]
                w = {"accumulated": 0.0, "rates": 0.0, "card_vs_cpu": 0.0,
                     "cpu_accumulated": 0.0, "cpu_rates": 0.0}
                for kind in q[0]:
                    cls = "rates" if kind in GOLDEN_RATES else "accumulated"
                    e = sum(reldiff(q[0][kind], q[1][kind]))
                    w[cls] = max(w[cls], e)
                    w["cpu_" + cls] = max(w["cpu_" + cls],
                                          sum(reldiff(q[0][kind],
                                                      q[2][kind])))
                    w["card_vs_cpu"] = max(w["card_vs_cpu"], sum(
                        reldiff(q[2][kind], q[1][kind])))
                    thr = rates if cls == "rates" else accum
                    if frame <= last and not (np.isfinite(e) and e <= thr):
                        fail(f"evp-winkler-2d frame {frame} {kind}: "
                             f"{e:.3e} against the reference (limit {thr:g})")
                worst.append(w)
                gate = "gated" if frame <= last else "not gated"
                print(f"    frame {frame}: against the reference "
                      f"accumulated {w['accumulated']:.3e}, rates "
                      f"{w['rates']:.3e} ({gate}; the CPU's "
                      f"{w['cpu_accumulated']:.3e}, {w['cpu_rates']:.3e}); "
                      f"card against CPU {w['card_vs_cpu']:.3e}")
            rec["golden"] = {"launches": launches, "card_s": secs["cuda"],
                             "cpu_s": secs["cpu"], "worst_by_frame": worst}
        finally:
            os.chdir(cwd)

    # (b) the full-size paths; production-unstructured on phase 9's mesh
    mesher = sim_mod.create_new_mesh
    for label, cfg, chunk in feature_cfgs():
        t = time.perf_counter()
        if cfg["mesh"]["meshing_elem_shape"] == 0:
            sim_mod.create_new_mesh = lambda param: usim.mesh
        try:
            sim = des.Simulation(des.param_from_dict(cfg))
        finally:
            sim_mod.create_new_mesh = mesher
        run1 = sim._chunk_fn(1)
        if sim.step_path != "flat2d":
            fail(f"{label} dispatched to {sim.step_path!r}, not flat2d")
        init_s = time.perf_counter() - t
        nelem = sim.ctx.nelem
        plain1 = flat2d.make_chunk_runner(sim.param, sim.ctx,
                                          sim.compensation_pressure, 1,
                                          plain=True)
        a = run1(sim.ctx, sim.state)
        b = plain1(sim.ctx, sim.state)
        torch.cuda.synchronize()
        diff = 0.0
        for f in FIELD_NAMES:
            x, y = getattr(a, f), getattr(b, f)
            if not torch.equal(x, y):
                diff = max(diff, float((x.double() - y.double()).abs()
                                       .max()))
                print(f"  {label}: {f} differs, kernels against plain "
                      f"versions by {diff:.3e}")
        if diff:
            fail(f"{label}: one step with the kernels is not the step "
                 "with the plain versions")
        runc = sim._chunk_fn(chunk)
        sim.run_steps(chunk, chunk=chunk)           # warm-up chunk
        torch.cuda.synchronize()
        zero_counts()
        stats0 = dict(runc.stats)
        t = time.perf_counter()
        sim.run_steps(2 * chunk, chunk=chunk)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        n = 2 * chunk
        launches = {k: wrappers[k].launches for k in band}
        if band2d.gather_corners.calls or band2d.scatter_corners.calls:
            fail(f"{label}: the main path took a plain version")
        if any(v == 0 for v in launches.values()):
            fail(f"{label}: a band kernel was not launched: {launches}")
        st = sim.state
        for f in FIELD_NAMES:
            v = getattr(st, f)
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                fail(f"{label}: non-finite values in {f}")
        if int(st.steps) != 3 * chunk:
            fail(f"{label}: {int(st.steps)} steps, not {3 * chunk}")
        pt_it = (runc.stats["pt_iterations"] - stats0["pt_iterations"]) / n
        syncs = (runc.stats["host_syncs"] - stats0["host_syncs"]) / n
        extra = ""
        if label == "pt2d" and not pt_it:
            fail("pt2d ran no pseudo-transient iteration")
        if label == "flagship-hydraulic":
            dpp = float(st.dppressure.abs().max())
            if not dpp > 0:
                fail("flagship-hydraulic: the pore pressure did not move")
            extra = f", max |dpp| {dpp:.3e} Pa"
        if label == "production-unstructured":
            dh = float(st.dhacc.abs().max())
            if not dh > 0:
                fail("production-unstructured: no surface moved")
            extra = f", max |dhacc| {dh:.3e} m"
        rate = nelem * n / secs
        per_kernel(label, lambda k: flat2d.make_chunk_runner(
            sim.param, sim.ctx, sim.compensation_pressure, k)(
            sim.ctx, sim.state), min(chunk, 5))
        r = {"nelem": nelem, "init_s": init_s, "steps": n, "secs": secs,
             "elem_steps_per_s": rate, "launches": launches,
             "launches_per_step": {k: v / n for k, v in launches.items()},
             "pt_iterations_per_step": pt_it, "host_syncs_per_step": syncs,
             "device_idle": prof_last["idle"],
             "wall_us_per_step_profiled": prof_last["wall_us"],
             "busy_us_per_step": prof_last["busy_us"],
             "kernels_equal_plain_one_step": True}
        rec["paths"][label] = r
        print(f"  (b) {label}: {nelem} triangles, init {init_s:.1f} s, one "
              f"step with the kernels equals the plain versions' on every "
              f"field; {n} steps in {secs:.3f} s, {rate:.6e} elem*steps/s "
              f"on {card}; launches per step "
              f"{r['launches_per_step']}, PT iterations {pt_it:g} and host "
              f"reads {syncs:g} per step, device idle "
              f"{prof_last['idle']:.1%}{extra}")
        del sim, a, b, runc, run1, plain1
        torch.cuda.empty_cache()

    # (c) the test-size paths, card against CPU, float64
    for label, cfg, n in small_feature_cfgs():
        par = des.param_from_dict(cfg)
        on_card = des.Simulation(par)
        on_card.run_steps(n, chunk=n)
        on_cpu = des.Simulation(par, device="cpu").run_steps(n, chunk=n)
        torch.cuda.synchronize()
        if on_card.step_path != "flat2d":
            fail(f"{label} ran on {on_card.step_path!r}")
        worst = 0.0
        for f in FLAT_FIELDS + ("dhacc", "dyn_fric_coeff",
                                "state_variable"):
            a = getattr(on_cpu, f).double()
            b = getattr(on_card.state, f).cpu().double()
            e = float((a - b).abs().max() / a.abs().max().clamp(min=1e-300))
            if f == "stressyy" and label == "rsf":
                e = float((a - b).abs().max()
                          / on_cpu.stress.abs().max())
            if f == "edvoldt" and label == "rsf":
                e = float((a - b).abs().max()
                          / on_cpu.strain_rate.abs().max())
            if not e < 1e-10:
                fail(f"{label} {f}: card against CPU {e:.3e} (tol 1e-10)")
            worst = max(worst, e)
        rec["small"][label] = {"steps": n, "worst_card_vs_cpu": worst}
        print(f"  (c) {label}: {n} float64 steps, card against CPU worst "
              f"{worst:.3e} of a field's max (tol 1e-10)")
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 11: {rec['phase_s']:.1f} s")
    return rec


def flagship3d_unstructured_cfg(rheology="elasto-visco-plastic"):
    """flagship3d's physics (EVP, f32, thermal diffusion, damping 1) on a
    Delaunay box (meshing_elem_shape 0), the 3D run's mesh after a remesh,
    cut from 256 km to 128 km in x (680,794 tets, 107,457 nodes): the
    mesher's host time grows about 2.9x per doubling of x, so the whole
    box would take some minutes on the host before the first step."""
    cfg = flagship3d_cfg(rheology)
    cfg["mesh"].update(meshing_elem_shape=0, xlength=128e3)
    return cfg


def flat3d_launches(param):
    """Band-kernel launches of one flat3d step without the
    pseudo-transient loop (ops/flat3d.py): the packed gather (two calls of
    8 + 2 fields with hydraulic diffusion) and the post-move gather; the
    thermal + dvoldt hop and the mixed-stress hop; the force and the mass
    assemblies."""
    ctrl = param.control
    return {"cgather": 1 + ctrl.has_hydraulic_diffusion + 1,
            "asm_gather": 1 + ctrl.is_using_mixed_stress,
            "asm_pack": 1 + ctrl.has_moving_mesh}


def flat3d_box_cfg(rheology, **over):
    """tests/test_torch_flat3d.py's box: 8 km x 4 km x 4 km Delaunay at 1
    km (886 tets), float64, thermal diffusion, damping 1, the surface
    correction; ``over`` updates its sections."""
    cfg = {
        "sim": {"ndims": 3, "float_dtype": "float64",
                "is_outputting_averaged_fields": False},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 0,
                 "xlength": 8e3, "ylength": 4e3, "zlength": 4e3,
                 "resolution": 1e3, "quality_check_step_interval": 10**8},
        "control": {"gravity": 10.0, "inertial_scaling": 1e5,
                    "has_thermal_diffusion": True, "damping_option": 1,
                    "has_surface_correction": True},
        "bc": {"vbc_x0": 1, "vbc_val_x0": -1e-9, "vbc_x1": 1,
               "vbc_val_x1": 1e-9, "vbc_y0": 1, "vbc_val_y0": 0.0,
               "vbc_y1": 1, "vbc_val_y1": 0.0, "vbc_z0": 0, "vbc_z1": 0,
               "has_winkler_foundation": False,
               "has_water_loading": False},
        "ic": {"weakzone_option": 0},
        "mat": {"rheology_type": rheology, "is_plane_strain": False,
                "rho0": [2800.0], "bulk_modulus": [50e9],
                "shear_modulus": [30e9], "visc_max": 1e24,
                "visc_min": 1e19}}
    for sec, kv in over.items():
        cfg.setdefault(sec, {}).update(kv)
    return cfg


def small_flat3d_cfgs():
    """Phase 12's test-size paths (tests/test_torch_flat3d.py), float64 on
    the 8 km x 4 km x 4 km Delaunay box (886 tets): (label, config,
    steps)."""
    box = flat3d_box_cfg
    rsf = box("elasto-plastic-rate-state-friction",
              mesh={"xlength": 1.0, "ylength": 1.0, "zlength": 1.0,
                    "resolution": 1.0},
              control={"gravity": 0.0, "fixed_dt": 1.0,
                       "use_global_velocity_scaling": True,
                       "has_thermal_diffusion": False},
              bc={"vbc_x0": 1, "vbc_val_x0": 0.0, "vbc_x1": 1,
                  "vbc_val_x1": 0.0, "vbc_z0": 1, "vbc_val_z0": 0.0,
                  "vbc_z1": 4, "vbc_val_z1": 1e-5},
              mat={"rho0": [1.0], "alpha": [0.0], "bulk_modulus": [2e8],
                   "shear_modulus": [2e8], "cohesion0": [1e6],
                   "cohesion1": [1e6], "friction_angle0": [30.0],
                   "friction_angle1": [30.0], "direct_a": [0.2],
                   "evolution_b": [0.1], "characteristic_distance": [1e-3],
                   "characteristic_velocity": [1e-6], "state_var_model": 0})
    return (
        ("rsf", rsf, 20),
        ("pseudo-transient-hydraulic", box("maxwell", control={
            "has_PT": True, "PT_max_iter": 6, "PT_relative_tolerance": 1e-12,
            "has_hydraulic_diffusion": True}, mat=dict(HYD_MAT)), 4),
        ("neumann-elastic-foundation", box("maxwell", bc={
            "has_elastic_foundation": True, "vbc_y1": 0,
            "stress_bc_z1": 3, "stress_val_z1": -1e5}), 10),
        ("surface-process-1-winkler", box("maxwell", control={
            "surface_process_option": 1, "surface_diffusivity": 1e-6,
            "surf_base_level": 10.0}, bc={
            "has_winkler_foundation": True, "has_water_loading": True,
            "winkler_delta_rho": 100.0}), 10))


def flat3d_on_card(des, wrappers, zero_counts, card, u3sim, per_kernel,
                   prof_last):
    """Phase 12: the 3D column step (flat3d) on the card -- (a) the ep-3d
    and maxwell-2mat-3d goldens through the CLI on the card and on the
    CPU (float64), every frame at the golden rule (1e-8 accumulated, 1e-7
    rates); (b) flagship3d-unstructured (``u3sim``, phase 8's) and
    flagship3d-hydraulic: one step with the kernels against one with the
    plain versions on the card, every field equal, then two timed chunks
    with launches per step, the staged tile share and the profiler's idle
    share; (c) the test-size paths of small_flat3d_cfgs, card against CPU
    at 1e-10.  Returns the numbers for the JSON record."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np
    import torch

    from dynearthsol_tpu_torch import __main__ as cli
    from dynearthsol_tpu_torch.compare import _frame_quantities, reldiff
    from dynearthsol_tpu_torch.ops import band2d, flat3d
    from dynearthsol_tpu_torch.postproc import OutputReader
    from dynearthsol_tpu_torch.state import FIELD_NAMES

    t_phase = time.perf_counter()
    runs = Path(__file__).resolve().parent / "tests" / "golden" / "runs"
    band = ("cgather", "asm_pack", "asm_gather")
    rec = {"goldens": {}, "paths": {}, "small": {}}
    print("phase 12 the 3D column step (flat3d) on the card")

    # (a) the 3D goldens; test_golden_vs_reference.py:122-133 gives them
    # no rule of their own: 1e-8 accumulated and 1e-7 rates at every frame
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for case in ("ep-3d", "maxwell-2mat-3d"):
                secs, sims = {}, {}
                for dev in ("cuda", "cpu"):
                    Path(f"{case}-{dev}.cfg").write_text(
                        golden_cfg(runs / case, f"{case}-{dev}"))
                    zero_counts()
                    t = time.perf_counter()
                    with contextlib.redirect_stdout(io.StringIO()):
                        sims[dev] = cli.run(
                            des.load_config(f"{case}-{dev}.cfg"), device=dev)
                    if dev == "cuda":
                        torch.cuda.synchronize()
                        launches = {n: wrappers[n].launches for n in band}
                        plain = (band2d.gather_corners.calls,
                                 band2d.scatter_corners.calls)
                    secs[dev] = time.perf_counter() - t
                sim = sims["cuda"]
                nsteps = int(sim.state.steps)
                if sim.step_path != "flat3d" or sim.dtype != torch.float64:
                    fail(f"{case} ran on {sim.step_path!r} in {sim.dtype}, "
                         "not flat3d in float64")
                want = {n: v * nsteps
                        for n, v in flat3d_launches(sim.param).items()}
                if launches != want:
                    fail(f"{case}: band-kernel launches {launches}, not "
                         f"{want}")
                if any(plain):
                    fail(f"{case}: the card took a plain version")
                ref = OutputReader(str(runs / case / "ref"))
                our, cpu = (OutputReader(f"{case}-cuda"),
                            OutputReader(f"{case}-cpu"))
                if our.frames != ref.frames or our.steps != ref.steps:
                    fail(f"{case}: frames {our.frames} at steps "
                         f"{our.steps}, the golden's {ref.steps}")
                print(f"  (a) {case}: flat3d float64, {sim.ctx.nelem} tets, "
                      f"{nsteps} steps on the card in {secs['cuda']:.1f} s, "
                      f"on the CPU {secs['cpu']:.1f} s; launches {launches}")
                worst = []
                for frame in ref.frames:
                    q = [_frame_quantities(r, frame, include_markers=False)
                         for r in (ref, our, cpu)]
                    w = {"accumulated": 0.0, "rates": 0.0,
                         "cpu_accumulated": 0.0, "cpu_rates": 0.0,
                         "card_vs_cpu": 0.0}
                    for kind in q[0]:
                        cls = ("rates" if kind in GOLDEN_RATES
                               else "accumulated")
                        e = sum(reldiff(q[0][kind], q[1][kind]))
                        thr = 1e-7 if cls == "rates" else 1e-8
                        if not (np.isfinite(e) and e <= thr):
                            fail(f"{case} frame {frame} {kind}: {e:.3e} "
                                 f"against the reference (limit {thr:g})")
                        w[cls] = max(w[cls], e)
                        w["cpu_" + cls] = max(w["cpu_" + cls], sum(
                            reldiff(q[0][kind], q[2][kind])))
                        w["card_vs_cpu"] = max(w["card_vs_cpu"], sum(
                            reldiff(q[2][kind], q[1][kind])))
                    worst.append(w)
                    print(f"    frame {frame}: against the reference "
                          f"accumulated {w['accumulated']:.3e} (limit "
                          f"1e-8), rates {w['rates']:.3e} (limit 1e-7; "
                          f"the CPU's {w['cpu_accumulated']:.3e}, "
                          f"{w['cpu_rates']:.3e}); card against CPU "
                          f"{w['card_vs_cpu']:.3e}")
                rec["goldens"][case] = {
                    "nelem": sim.ctx.nelem, "steps": nsteps,
                    "launches": launches, "card_s": secs["cuda"],
                    "cpu_s": secs["cpu"], "worst_by_frame": worst}
                del sims, sim
        finally:
            os.chdir(cwd)

    # (b) the full-size paths
    hyd = flagship3d_cfg("maxwell")
    hyd["control"]["has_hydraulic_diffusion"] = True
    hyd["mat"].update(HYD_MAT)
    for label, cfg, chunk in (("flagship3d-unstructured", None, 10),
                              ("flagship3d-hydraulic", hyd, 10)):
        t = time.perf_counter()
        sim = u3sim if cfg is None else des.Simulation(
            des.param_from_dict(cfg))
        run1 = sim._chunk_fn(1)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        if sim.step_path != "flat3d":
            fail(f"{label} dispatched to {sim.step_path!r}, not flat3d")
        nelem, bt = sim.ctx.nelem, sim.ctx.band
        plain1 = flat3d.make_chunk_runner(sim.param, sim.ctx,
                                          sim.compensation_pressure, 1,
                                          plain=True)
        a = run1(sim.ctx, sim.state)
        b = plain1(sim.ctx, sim.state)
        torch.cuda.synchronize()
        diff = 0.0
        for f in FIELD_NAMES:
            x, y = getattr(a, f), getattr(b, f)
            if not torch.equal(x, y):
                diff = max(diff, float((x.double() - y.double()).abs()
                                       .max()))
                print(f"  {label}: {f} differs, kernels against plain "
                      f"versions by {diff:.3e}")
        if diff:
            fail(f"{label}: one step with the kernels is not the step "
                 "with the plain versions")
        del a, b
        sim.run_steps(chunk, chunk=chunk)           # warm-up chunk
        torch.cuda.synchronize()
        zero_counts()
        chunk_s = []
        for _ in range(2):
            t = time.perf_counter()
            sim.run_steps(chunk, chunk=chunk)
            torch.cuda.synchronize()
            chunk_s.append(time.perf_counter() - t)
        n = 2 * chunk
        launches = {k: wrappers[k].launches for k in band}
        if band2d.gather_corners.calls or band2d.scatter_corners.calls:
            fail(f"{label}: the main path took a plain version")
        want = {k: v * n for k, v in flat3d_launches(sim.param).items()}
        if launches != want:
            fail(f"{label}: band-kernel launches {launches}, not {want}")
        st = sim.state
        for f in FIELD_NAMES:
            v = getattr(st, f)
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                fail(f"{label}: non-finite values in {f}")
        if int(st.steps) != 3 * chunk:
            fail(f"{label}: {int(st.steps)} steps, not {3 * chunk}")
        extra = ""
        if label == "flagship3d-hydraulic":
            dpp = float(st.dppressure.abs().max())
            if not dpp > 0:
                fail("flagship3d-hydraulic: the pore pressure did not move")
            extra = f", max |dpp| {dpp:.3e} Pa"
        rates = [nelem * chunk / c for c in chunk_s]
        per_kernel(label, lambda k: flat3d.make_chunk_runner(
            sim.param, sim.ctx, sim.compensation_pressure, k)(
            sim.ctx, sim.state), 5)
        staged = int(bt.tile_staged.sum())
        tiles = {"tiles": bt.tile_staged.numel(), "staged": staged,
                 "staged_share": staged / bt.tile_staged.numel(),
                 "window_max": int(bt.tile_w.max()),
                 "window_max_staged": bt.win_rows,
                 "max_degree": bt.g_cols.shape[0]}
        r = {"nelem": nelem, "nnode": sim.ctx.nnode, "init_s": init_s,
             "steps": n, "chunk_s": chunk_s, "elem_steps_per_s": rates,
             "launches": launches,
             "launches_per_step": {k: v / n for k, v in launches.items()},
             "device_idle": prof_last["idle"],
             "wall_us_per_step_profiled": prof_last["wall_us"],
             "busy_us_per_step": prof_last["busy_us"],
             "gather_tiles": tiles, "kernels_equal_plain_one_step": True}
        rec["paths"][label] = r
        print(f"  (b) {label}: {nelem} tets, {sim.ctx.nnode} nodes, setup "
              f"{init_s:.1f} s; one step with the kernels equals the plain "
              f"versions' on every field; two chunks of {chunk} steps in "
              f"{chunk_s[0]:.3f} s and {chunk_s[1]:.3f} s, "
              f"{rates[0]:.6e} and {rates[1]:.6e} elem*steps/s on {card}; "
              f"launches per step {r['launches_per_step']}, plain versions "
              f"called 0 times, device idle {prof_last['idle']:.1%}; gather "
              f"tiles {staged} of {tiles['tiles']} staged "
              f"({tiles['staged_share']:.1%}), widest window "
              f"{tiles['window_max']} rows, max degree "
              f"{tiles['max_degree']}{extra}")
        del sim, run1, plain1
        torch.cuda.empty_cache()

    # (c) the test-size paths, card against CPU, float64
    for label, cfg, n in small_flat3d_cfgs():
        par = des.param_from_dict(cfg)
        on_card = des.Simulation(par)
        on_card.run_steps(n, chunk=n)
        on_cpu = des.Simulation(par, device="cpu").run_steps(n, chunk=n)
        torch.cuda.synchronize()
        if on_card.step_path != "flat3d":
            fail(f"{label} ran on {on_card.step_path!r}")
        # zero but for roundoff: judged at the scale of their field
        scale_of = {"dppressure": "ppressure", "dpressure": "stress",
                    **({"edvoldt": "strain_rate"} if label == "rsf"
                       else {})}
        worst = 0.0
        for f in FLAT_FIELDS + ("dhacc", "edvacc_surf", "dyn_fric_coeff",
                                "state_variable", "ppressure",
                                "dppressure", "dpressure"):
            a = getattr(on_cpu, f).double()
            b = getattr(on_card.state, f).cpu().double()
            sc = getattr(on_cpu, scale_of.get(f, f)).double().abs().max()
            e = float((a - b).abs().max() / sc.clamp(min=1e-300))
            if not e < 1e-10:
                fail(f"{label} {f}: card against CPU {e:.3e} (tol 1e-10)")
            worst = max(worst, e)
        rec["small"][label] = {"steps": n, "worst_card_vs_cpu": worst}
        print(f"  (c) {label}: {n} float64 steps, card against CPU worst "
              f"{worst:.3e} of a field's max (tol 1e-10)")
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 12: {rec['phase_s']:.1f} s")
    return rec


# phase 13's test-size cases
REMESH_11 = "option 11, f64, 16 x 8 km Delaunay at 500 m"
REMESH_2D = "option 100, f32 maxwell, 16 x 128 km Delaunay at 1 km"
REMESH_3D = ("option 100 3D, f32 maxwell, 128 x 4 x 8 cells (the smallest "
             "box of the fused 3D gate: nxc % 128, nzc % 8, a y tile of 4)")


def remesh_on_card(des, wrappers, zero_counts, card, usim, check, rel):
    """Phase 13: remeshing on the card -- (a) at test sizes, a card run
    and a CPU run that takes the card's state and markers remesh alike:
    the same mesh and markers, then the kernels on the card against the
    plain versions on the CPU: option 11 in float64 on flat2d (20 steps
    at 1e-10), option 100 from a Delaunay start back onto the resident 2D
    kernel (float32 maxwell, 10 steps at phase 3's tolerances) and option
    100 in 3D on the fused 3D step (one float32 maxwell step at phase 4's
    one-step bound); (b) bench.py's postremesh at
    full size: the flagship with option 100 on phase 9's 277,258-triangle
    mesh, 20 steps on flat2d (one step with the kernels equal on every
    field to one with the plain versions), remesh, then the resident
    kernel, a second remesh with the same dims; after each remesh the
    host seconds by part, the step path, one maxwell step of the kernel
    against the plain version on the card on every field at phase 3's
    flagship rule, the launches and the elem*steps/s of 200 steps.  Returns the numbers for
    the JSON record."""
    import numpy as np
    import torch

    from dynearthsol_tpu_torch import simulation as sim_mod
    from dynearthsol_tpu_torch.markers import MarkerSet
    from dynearthsol_tpu_torch.ops import band2d, fused2d, fused3d
    from dynearthsol_tpu_torch.remeshing import remesh
    from dynearthsol_tpu_torch.state import FIELD_NAMES, State

    t_phase = time.perf_counter()
    band = ("cgather", "asm_pack", "asm_gather")
    plain_calls = (band2d.gather_corners, band2d.scatter_corners,
                   fused2d.fused_step_plain, fused2d.dt_refresh_plain,
                   fused3d.chunk_step_plain, fused3d.finalize_plain)
    rec = {"test_size": {}, "postremesh": {}}
    print("phase 13 remeshing on the card")

    def launches(names):
        return {n: wrappers[n].launches for n in names}

    def no_plain(label):
        called = [f.__name__ for f in plain_calls if f.calls]
        if called:
            fail(f"{label}: the main path on the card called the plain "
                 f"versions {called}")

    def cpu_twin(sim):
        """A CPU Simulation of sim's config with a copy of its state and
        markers, so that both remesh from the same host arrays."""
        cpu = des.Simulation(sim.param, device="cpu")
        if not np.array_equal(cpu.topo.connectivity, sim.topo.connectivity):
            fail("the CPU twin built another mesh")
        cpu.state = State(**{f: getattr(sim.state, f).cpu()
                             for f in FIELD_NAMES})
        if sim.markers is not None:
            m = sim.markers
            cpu.markers = MarkerSet.from_arrays(
                sim.param.sim.ndims, m.save_arrays(), m.chkpt_arrays())
        return cpu

    def same_mesh(label, a, b):
        for f in ("connectivity", "bcflag", "segment", "segflag"):
            if not np.array_equal(getattr(a.topo, f), getattr(b.topo, f)):
                fail(f"{label}: card and CPU remeshed to another {f}")
        if a.ctx.sgrid != b.ctx.sgrid:
            fail(f"{label}: sgrid {a.ctx.sgrid} on the card, "
                 f"{b.ctx.sgrid} on the CPU")
        if a.markers is not None:
            for nm in ("eta", "elem", "mattype", "id"):
                if not np.array_equal(a.markers.live(nm),
                                      b.markers.live(nm)):
                    fail(f"{label}: card and CPU markers differ in {nm}")

    # (a) the test sizes
    sim3 = sim3d_cfg("maxwell", weakzone=0)
    sim3["mesh"].update(ylength=4e3, remeshing_option=100)
    small11 = unstructured_cfg("elasto-visco-plastic", small=True)
    small11["sim"]["float_dtype"] = "float64"
    small11["mesh"]["remeshing_option"] = 11
    small100 = make_sim_cfg("maxwell")
    small100["mesh"].update(meshing_elem_shape=0, remeshing_option=100)
    f2 = ("coord", "vel", "temperature", "stress", "strain", "volume",
          "volume_n", "mass", "tmass", "hmass", "strain_rate", "edvoldt",
          "force")
    f3 = ("coord", "vel", "temperature", "stress", "strain", "plstrain",
          "volume", "volume_n", "mass", "tmass", "hmass", "force",
          "strain_rate", "edvoldt", "delta_plstrain", "volume_old")
    # label, config, steps before the remesh and after, the path after,
    # its kernels, the fields compared, their tolerance (force, scalars),
    # the finalize's tolerance card against CPU
    for label, cfg, before, after, path, names, fields, tols, ftol in (
            (REMESH_11, small11, 21, 20, "flat2d", band, FLAT_FIELDS,
             (1e-10, 1e-10, 1e-10), 1e-12),
            (REMESH_2D, small100, 10, 10, "pallas2d_res",
             ("fused2d_chunk",), f2, (2e-4, 1e-3, 1e-5), 1e-5),
            # one step at phase 4's one-step bound: over 10 steps damping
            # 1 switches on the sign of the y velocity of this y-invariant
            # box, which is rounding, and two correct float32 steps part
            # (on the CPU the JAX grid3d and the plain version by 1.38e-3
            # of |v| after 10 steps, 4.8e-7 after 1)
            (REMESH_3D, sim3, 5, 1, "pallas3d",
             ("fused3d_step", "fused3d_finalize"), f3, (1e-4, 1e-3, 1e-4),
             1e-5)):
        tol, force_tol, scalar_tol = tols
        sim = des.Simulation(des.param_from_dict(cfg))
        sim.run_steps(before, chunk=before)
        cpu = cpu_twin(sim)
        remesh(sim, 1)
        remesh(cpu, 1)
        torch.cuda.synchronize()
        same_mesh(label, sim, cpu)
        fin = max(rel(getattr(cpu.state, f), getattr(sim.state, f).cpu())
                  for f in FIELD_NAMES
                  if getattr(cpu.state, f).is_floating_point())
        check(f"{label}: after the remesh, card vs CPU, every field", fin,
              ftol)
        zero_counts()
        sim.run_steps(after)
        torch.cuda.synchronize()
        got = launches(names)
        no_plain(label)
        if sim.step_path != path or not all(got.values()):
            fail(f"{label}: after the remesh the run took "
                 f"{sim.step_path!r} with launches {got}, not {path}")
        cpu.run_steps(after)
        errs = {}
        for f in fields + ("dt", "time", "max_global_vel_mag"):
            errs[f] = rel(getattr(cpu.state, f), getattr(sim.state, f).cpu())
            check(f"{label}: {after} steps, card vs CPU, {f}", errs[f],
                  force_tol if f == "force" else
                  scalar_tol if f in ("dt", "time", "max_global_vel_mag")
                  else tol)
        print(f"  {label}: {sim.topo.nelem} elements, sgrid "
              f"{sim.ctx.sgrid}, step path {path}, launches {got}, host "
              f"remesh s {sim.remesh_seconds}")
        rec["test_size"][label] = {
            "nelem": sim.topo.nelem, "step_path": path, "launches": got,
            "finalize_card_vs_cpu": fin, "max_err": max(errs.values()),
            "remesh_s": sim.remesh_seconds}
        del sim, cpu

    # (b) postremesh at full size, on phase 9's mesh
    cfg = unstructured_cfg()
    cfg["mesh"]["remeshing_option"] = 100
    mesher = sim_mod.create_new_mesh
    sim_mod.create_new_mesh = lambda param: usim.mesh
    try:
        t = time.perf_counter()
        sim = des.Simulation(des.param_from_dict(cfg))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
    finally:
        sim_mod.create_new_mesh = mesher
    maxwell = des.param_from_dict(unstructured_cfg("maxwell"))
    post = rec["postremesh"]
    post["init_s"] = init_s
    zero_counts()
    sim.run_steps(20, chunk=20)
    torch.cuda.synchronize()
    post["launches_before"] = launches(band)
    no_plain("postremesh before the remesh")
    if sim.step_path != "flat2d" or not all(post["launches_before"]
                                            .values()):
        fail(f"postremesh started on {sim.step_path!r}, not flat2d")
    a = sim._chunk_fn(1)(sim.ctx, sim.state)
    b = flat2d_plain_step(sim)
    torch.cuda.synchronize()
    for f in FIELD_NAMES:
        if not torch.equal(getattr(a, f), getattr(b, f)):
            fail(f"postremesh before the remesh: one step with the kernels "
                 f"differs from the plain versions' in {f}")
    print(f"  postremesh: {sim.topo.nelem} triangles, host setup "
          f"{init_s:.1f} s, 20 steps on {sim.step_path}, launches "
          f"{post['launches_before']}, one step with the kernels equal on "
          f"every field to the plain versions'")
    post["remeshes"] = []
    for k in range(2):
        t = time.perf_counter()
        remesh(sim, 1)
        wall = time.perf_counter() - t
        r = {"wall_s": wall, "seconds": sim.remesh_seconds,
             "nelem": sim.topo.nelem, "sgrid": sim.ctx.sgrid}
        # one maxwell step at phase 3's flagship rule (2e-6 of each field's
        # max, log-viscosity 1e-5, the refresh's L2 sum 1e-5; on EVP the
        # min-select ties at f32 rounding, phase 3)
        P = fused2d.make_plan(maxwell, sim.ctx, sim.device,
                              sim.compensation_pressure)
        ker = fused2d.run_chunk(P, sim.ctx, sim.state, 1, True, False)
        ref = fused2d.run_chunk(P, sim.ctx, sim.state, 1, True, True)
        torch.cuda.synchronize()
        errs = {}
        for f in FIELD_NAMES:
            x, y = getattr(ref, f), getattr(ker, f)
            if not x.is_floating_point():
                if not torch.equal(x, y):
                    fail(f"postremesh remesh {k + 1}: {f} differs")
                continue
            if f == "viscosity":
                errs[f] = float((x.double().log() - y.double().log())
                                .abs().max())
                check(f"postremesh remesh {k + 1}: 1 maxwell step, "
                      f"log-viscosity", errs[f], 1e-5)
                continue
            if f == "dpressure":
                # the step's pressure change, a difference of two
                # pressures: its rounding is the pressure's, so it is held
                # at the stress's scale
                errs[f] = float((x.double() - y.double()).abs().max()
                                / ref.stress.double().abs().max())
                check(f"postremesh remesh {k + 1}: 1 maxwell step, kernel "
                      f"vs plain, dpressure at the stress's scale", errs[f],
                      2e-6)
                continue
            errs[f] = rel(x, y)
            check(f"postremesh remesh {k + 1}: 1 maxwell step, kernel "
                  f"vs plain, {f}", errs[f],
                  1e-5 if f == "l2_residual" else 2e-6)
        del ker, ref
        sim.run_steps(100, chunk=100)                   # warm-up chunk
        torch.cuda.synchronize()
        zero_counts()
        t = time.perf_counter()
        sim.run_steps(200, chunk=100)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        r.update(step_path=sim.step_path,
                 launches=launches(("fused2d_chunk", "dt_refresh") + band),
                 chunk_max_err=max(errs.values()),
                 elem_steps_per_s=sim.topo.nelem * 200 / run_s)
        no_plain(f"postremesh remesh {k + 1}")
        if sim.step_path != "pallas2d_res" \
                or r["launches"]["fused2d_chunk"] != 2:
            fail(f"postremesh after remesh {k + 1}: {sim.step_path!r}, "
                 f"launches {r['launches']}")
        s = sim.state
        for f in FIELD_NAMES:
            v = getattr(s, f)
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                fail(f"postremesh: non-finite values in {f}")
        secs = ", ".join(f"{n} {v:.2f}" for n, v in r["seconds"].items())
        print(f"  postremesh remesh {k + 1}: {wall:.2f} s on the host "
              f"({secs}); {r['nelem']} triangles, sgrid {r['sgrid']}; then "
              f"{sim.step_path}, launches {r['launches']} over 200 steps, "
              f"elem*steps/s {r['elem_steps_per_s']:.6e} on {card}")
        post["remeshes"].append(r)
    if post["remeshes"][1]["sgrid"] != post["remeshes"][0]["sgrid"]:
        fail("the second remesh changed the structured dims")
    del sim
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 13: {rec['phase_s']:.1f} s")
    return rec


# phase 14's test-size cases
GRID3D_SMALL = "grid3d, f64 maxwell, 8 x 2 x 4 cells"
GRID2D_SMALL = "grid2d, f64 maxwell, the flagship at 32 x 16 cells"
METRIC_3D = ("metric-driven 3D remesh (use_mesh_optimizer, mmg_hmin_factor = "
             "mmg_hmax_factor = 2), f64 maxwell, 8 x 4 x 4 km Delaunay at 1 "
             "km with a weak zone, before the first step")
FALLBACK_3D = ("option 100's 3D fallback, f64 maxwell, 8 x 2 x 4 cells with "
               "the x0 wall moved")


def grid3d_small_cfg():
    """tests/torch_cases.py grid3d_cfg("maxwell", winkler=False): 8 x 2 x
    4 cells of 1 km, float64, water loading (base level 10 m), surface
    process 1 with the surface correction, thermal diffusion, damping 1."""
    cfg = sim3d_cfg("maxwell", weakzone=0)
    cfg["sim"]["float_dtype"] = "float64"
    cfg["mesh"].update(xlength=8e3, ylength=2e3, zlength=4e3)
    cfg["control"].update(surface_process_option=1, surface_diffusivity=1e-6,
                          has_surface_correction=True, surf_base_level=10.0)
    cfg["bc"]["has_water_loading"] = True
    return cfg


def grid2d_small_cfg():
    """tests/test_torch_grid2d.py flagship64(): the flagship's physics at
    32 x 16 cells of 3.125 km, maxwell, float64."""
    cfg = flagship_cfg("maxwell")
    cfg["sim"]["float_dtype"] = "float64"
    cfg["mesh"].update(xlength=100e3, zlength=50e3, resolution=50e3 / 16)
    return cfg


def metric3d_cfg():
    """tests/test_torch_remesh3d.py METRIC_3D_OVER: phase 12's 8 km x 4 km
    x 4 km Delaunay box (886 tets), maxwell, float64, a weak zone of
    plastic strain 0.5, remeshing option 11 with the metric-driven
    regeneration and its spacing field clipped flat at 2 km, where the
    regeneration passes its own quality loop at the first try (a graded
    field or a top that has moved leaves slivers, in the JAX package
    too)."""
    return flat3d_box_cfg(
        "maxwell", mesh={"remeshing_option": 11, "use_mesh_optimizer": True,
                         "mmg_hmin_factor": 2.0, "mmg_hmax_factor": 2.0},
        ic={"weakzone_option": 2, "weakzone_plstrain": 0.5,
            "weakzone_xcenter": 0.5, "weakzone_ycenter": 0.5,
            "weakzone_zcenter": 0.5, "weakzone_xsemi_axis": 1.5e3,
            "weakzone_ysemi_axis": 1.5e3, "weakzone_zsemi_axis": 1.5e3})


def remesh3d_on_card(des, wrappers, zero_counts, card, check, rel,
                     per_kernel, prof_last):
    """Phase 14: the structured plane steps and the 3D remeshing on the
    card -- (a) the evp-remesh-3d golden through the CLI's run() on the
    card (float64, remeshing option 13 about every 5-7 steps, flat3d
    between the remeshes), held to the gates of
    tests/test_golden_vs_reference.py:339-392 (compare.remesh_golden_3d):
    the step paths, the remeshes, the host seconds per remesh by part, the
    band kernels' launches per step and the wall seconds; (b) grid3d and
    grid2d at test size, float64, 20 steps card against CPU on every
    field, then the float64 flagship on grid2d and flagship3d on grid3d:
    elem*steps/s, launches per step and the device's idle share, and each
    against its column step (flat2d, flat3d) on the same mesh; (c) a
    metric-driven 3D remesh and option 100's 3D fallback at test size,
    card against CPU from one state: the regeneration through its quality
    loop at the first try, the same mesh and markers, every volume
    positive, the finalize at 1e-12, then 10 flat3d steps with the kernels
    on the card against the plain versions on the CPU at phase 12's 1e-10.
    Returns the numbers for the JSON record."""
    import contextlib
    import io
    import os
    import tempfile
    from dataclasses import replace

    import numpy as np
    import torch

    from dynearthsol_tpu_torch import __main__ as cli
    from dynearthsol_tpu_torch import remesh_impl
    from dynearthsol_tpu_torch import simulation as sim_mod
    from dynearthsol_tpu_torch.compare import remesh_golden_3d
    from dynearthsol_tpu_torch.markers import MarkerSet
    from dynearthsol_tpu_torch.ops import (band2d, flat2d, flat3d, fused2d,
                                           fused3d, grid2d, grid3d)
    from dynearthsol_tpu_torch.postproc import OutputReader
    from dynearthsol_tpu_torch.remeshing import remesh
    from dynearthsol_tpu_torch.state import FIELD_NAMES, State

    t_phase = time.perf_counter()
    runs = Path(__file__).resolve().parent / "tests" / "golden" / "runs"
    band = ("cgather", "asm_pack", "asm_gather")
    plain_calls = (band2d.gather_corners, band2d.scatter_corners,
                   fused2d.fused_step_plain, fused2d.dt_refresh_plain,
                   fused3d.chunk_step_plain, fused3d.finalize_plain)
    rec = {"golden": {}, "grids": {}, "remesh": {}}
    print("phase 14 the plane steps and the 3D remeshing on the card")

    def launches(names):
        return {n: wrappers[n].launches for n in names}

    def no_plain(label):
        called = [f.__name__ for f in plain_calls if f.calls]
        if called:
            fail(f"{label}: the main path on the card called the plain "
                 f"versions {called}")

    def cpu_twin(sim):
        """A CPU Simulation of sim's config with a copy of its state and
        markers."""
        cpu = des.Simulation(sim.param, device="cpu")
        if not np.array_equal(cpu.topo.connectivity, sim.topo.connectivity):
            fail("the CPU twin built another mesh")
        cpu.state = State(**{f: getattr(sim.state, f).cpu()
                             for f in FIELD_NAMES})
        if sim.markers is not None:
            m = sim.markers
            cpu.markers = MarkerSet.from_arrays(
                sim.param.sim.ndims, m.save_arrays(), m.chkpt_arrays())
        return cpu

    def card_vs_cpu(cpu, sim):
        """Every floating State field's max difference over its max; the
        pressure change, a difference of traces, at the stress's."""
        errs = {}
        for f in FIELD_NAMES:
            a, b = getattr(cpu.state, f), getattr(sim.state, f).cpu()
            if not a.is_floating_point():
                if not torch.equal(a, b):
                    fail(f"{f} differs card against CPU")
                continue
            if f == "dpressure":
                errs[f] = float((a.double() - b.double()).abs().max()
                                / cpu.state.stress.double().abs().max()
                                .clamp(min=1e-300))
            else:
                errs[f] = rel(a, b)
        return errs

    # (a) the evp-remesh-3d golden through the CLI on the card
    case = "evp-remesh-3d"
    paths, secs = [], []
    chunk_fn, remesh_fn = sim_mod.Simulation._chunk_fn, \
        remesh_impl.remesh_simulation

    def traced_chunk_fn(self, n):
        f = chunk_fn(self, n)
        if not paths or paths[-1] != self.step_path:
            paths.append(self.step_path)
        return f

    def timed_remesh(sim, bad_quality):
        remesh_fn(sim, bad_quality)
        secs.append(dict(sim.remesh_seconds))

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        sim_mod.Simulation._chunk_fn = traced_chunk_fn
        remesh_impl.remesh_simulation = timed_remesh
        try:
            Path(f"{case}.cfg").write_text(golden_cfg(runs / case, case))
            zero_counts()
            buf = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                sim = cli.run(des.load_config(f"{case}.cfg"), device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            got = launches(band)
            no_plain(case)
            nsteps = int(sim.state.steps)
            nremesh = buf.getvalue().count("remeshing (trigger")
            ref = OutputReader(str(runs / case / "ref"))
            our = OutputReader(case)
            nums, bad = remesh_golden_3d(ref, our, sim.param.mesh.xlength)
        finally:
            sim_mod.Simulation._chunk_fn = chunk_fn
            remesh_impl.remesh_simulation = remesh_fn
            os.chdir(cwd)
    want = {n: v * nsteps for n, v in flat3d_launches(sim.param).items()}
    if sim.dtype != torch.float64 or paths != ["flat3d"] or got != want:
        fail(f"{case}: paths {paths} in {sim.dtype}, launches {got}, not "
             f"flat3d in float64 with {want}")
    if len(secs) != nremesh or nremesh < 40:
        fail(f"{case}: {nremesh} remeshes ({len(secs)} timed), fewer than "
             "the reference's about one in 5-7 steps")
    if bad:
        fail(f"{case} on the card: " + "; ".join(bad))
    parts = {k: sum(s[k] for s in secs) / len(secs) for k in secs[0]}
    per_step = {n: v / nsteps for n, v in got.items()}
    print(f"  (a) {case}: float64, step paths {paths}, {nsteps} steps, "
          f"{nremesh} remeshes, {wall:.1f} s wall on {card}; host s per "
          f"remesh " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f" (total {sum(parts.values()):.3f}); band launches per step "
          f"{per_step}")
    for k in sorted(nums["frame0"]):
        print(f"    frame 0 {k}: {nums['frame0'][k]:.3e}")
    for f, m in nums["frames"].items():
        print(f"    frame {f}: nelem {m['run']['nelem']} (reference "
              f"{m['reference']['nelem']}), rel. volume "
              f"{m['rel']['vol']:.3e} (1e-3), plastic strain "
              f"{m['rel']['plsv']:.3e} (5e-2), mean stress II "
              f"{m['rel']['sII_mean']:.3e} (1.5e-1)")
    print(f"    frame 8 relief {nums['relief_run']:.1f} m against the "
          f"reference's {nums['relief_reference']:.1f} m, max |dz| "
          f"{nums['dz_max']:.1f} m; every gate passed")
    rec["golden"] = {"steps": nsteps, "remeshes": nremesh, "paths": paths,
                     "wall_s": wall, "remesh_s_by_part": parts,
                     "launches": got, "launches_per_step": per_step,
                     "gates": nums}
    del sim

    # (b) the plane steps, test size card against CPU, then the flagship
    for label, cfg, path in ((GRID3D_SMALL, grid3d_small_cfg(), "grid3d"),
                             (GRID2D_SMALL, grid2d_small_cfg(), "grid2d")):
        sim = des.Simulation(des.param_from_dict(cfg))
        cpu = cpu_twin(sim)
        zero_counts()
        sim.run_steps(20, chunk=20)
        torch.cuda.synchronize()
        got = launches(tuple(wrappers))
        no_plain(label)
        cpu.run_steps(20, chunk=20)
        if not sim.step_path == cpu.step_path == path or any(got.values()):
            fail(f"{label}: paths {sim.step_path!r} / {cpu.step_path!r}, "
                 f"launches {got}")
        errs = card_vs_cpu(cpu, sim)
        worst = max(errs, key=errs.get)
        check(f"{label}: 20 steps card vs CPU, worst field ({worst})",
              errs[worst], 1e-12)
        rec["grids"][label] = {"errors": errs, "path": path}
        del sim, cpu
    def flagship_on_grid(label, cfg, path, mod, warm, steps, chunk, nprof):
        """cfg (a flagship at float64, off both fused gates) on its plane
        step: a warm-up chunk, then ``steps`` timed with the counts set to
        0 just before: no hand-written kernel, no plain version, finite
        fields; elem*steps/s, launches per step and the device's idle share
        from ``nprof`` profiled steps.  Returns (sim, record)."""
        cfg["sim"]["float_dtype"] = "float64"
        t = time.perf_counter()
        sim = des.Simulation(des.param_from_dict(cfg))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        sim.run_steps(warm, chunk=warm)
        torch.cuda.synchronize()
        zero_counts()
        t = time.perf_counter()
        sim.run_steps(steps, chunk=chunk)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        got = launches(tuple(wrappers))
        no_plain(label)
        if sim.step_path != path or any(got.values()):
            fail(f"{label} took {sim.step_path!r}, launches {got}, not "
                 f"{path} with no hand-written kernel")
        for f in FIELD_NAMES:
            v = getattr(sim.state, f)
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                fail(f"{label}: non-finite values in {f}")
        nelem = sim.topo.nelem
        rate = nelem * steps / run_s
        rows = per_kernel(f"{label} ({path})",
                          lambda k: mod.make_chunk_runner(
                              sim.param, sim.ctx, sim.compensation_pressure,
                              k)(sim.ctx, sim.state), nprof)
        per_step = sum(n for n, _ in rows.values()) / nprof
        print(f"  (b) {label} on {path}: {nelem} elements, init "
              f"{init_s:.1f} s, {steps} steps in {run_s:.3f} s, {rate:.6e} "
              f"elem*steps/s on {card}; {per_step:g} launches per step "
              f"(PyTorch ops; the hand-written kernels launched {got}), "
              f"device idle {prof_last['idle']:.1%}")
        return sim, {
            "nelem": nelem, "init_s": init_s, "steps": steps, "secs": run_s,
            "elem_steps_per_s": rate, "launches_per_step": per_step,
            "device_idle": prof_last["idle"],
            "wall_us_per_step_profiled": prof_last["wall_us"],
            "busy_us_per_step": prof_last["busy_us"]}

    def grid_vs_flat(label, sim, gmod, fmod, gate, n):
        """The plane step against the column step on one mesh: n steps of
        each runner from copies of sim's state (the column step's band
        tables built for this mesh), run grid, flat, flat, grid after a
        warm-up call of each.  Prints and returns the seconds of each run
        and the largest difference of the two end states over each
        field's max."""
        param, comp = sim.param, sim.compensation_pressure
        if not gate(param, sim.ctx):
            fail(f"{label}: the column step's gate refuses the config")
        ctxs = {"grid": sim.ctx, "flat": replace(sim.ctx, band=(
            band2d.build_tables(sim.topo.connectivity, sim.topo.nnode,
                                sim.device)))}
        run = {"grid": gmod.make_chunk_runner(param, ctxs["grid"], comp, n),
               "flat": fmod.make_chunk_runner(param, ctxs["flat"], comp, n)}

        def copy():
            return State(**{f: getattr(sim.state, f).clone()
                            for f in FIELD_NAMES})

        for k in run:
            run[k](ctxs[k], copy())
        secs, out = {"grid": [], "flat": []}, {}
        for k in ("grid", "flat", "flat", "grid"):
            s0 = copy()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out[k] = run[k](ctxs[k], s0)
            torch.cuda.synchronize()
            secs[k].append(time.perf_counter() - t)
        diff = {}
        for f in FIELD_NAMES:
            a, b = getattr(out["grid"], f), getattr(out["flat"], f)
            if a.is_floating_point():
                if not bool(torch.isfinite(b).all()):
                    fail(f"{label}: the column step gave non-finite {f}")
                diff[f] = rel(a, b)
        worst = max(diff, key=diff.get)
        nelem = sim.topo.nelem
        print(f"  (b) {label}, one mesh ({nelem} elements), {n} steps from "
              f"one state on {card}: grid s {secs['grid']}, flat s "
              f"{secs['flat']} (grid, flat, flat, grid); best "
              f"{nelem * n / min(secs['grid']):.6e} / "
              f"{nelem * n / min(secs['flat']):.6e} elem*steps/s; end "
              f"states apart by {diff[worst]:.3e} ({worst})")
        return {"steps": n, "grid_s": secs["grid"], "flat_s": secs["flat"],
                "grid_elem_steps_per_s": nelem * n / min(secs["grid"]),
                "flat_elem_steps_per_s": nelem * n / min(secs["flat"]),
                "max_rel_diff": diff[worst], "worst_field": worst}

    # the flagships at float64: both fused gates refuse float64, so the
    # flagship takes grid2d and flagship3d (983,040 tets) grid3d; each
    # then against its column step on the same mesh
    sim, rec["grids"]["flagship_f64"] = flagship_on_grid(
        "flagship f64", flagship_cfg(), "grid2d", grid2d, 10, 100, 50, 5)
    rec["grids"]["flagship_f64"]["vs_flat2d"] = grid_vs_flat(
        "flagship f64 grid2d vs flat2d", sim, grid2d, flat2d,
        flat2d.flat_step_applicable, 50)
    del sim
    torch.cuda.empty_cache()
    sim, rec["grids"]["flagship3d_f64"] = flagship_on_grid(
        "flagship3d f64", flagship3d_cfg(), "grid3d", grid3d, 5, 20, 10, 3)
    rec["grids"]["flagship3d_f64"]["vs_flat3d"] = grid_vs_flat(
        "flagship3d f64 grid3d vs flat3d", sim, grid3d, flat3d,
        flat3d.flat3d_step_applicable, 10)
    del sim
    torch.cuda.empty_cache()

    # (c) the metric-driven remesh and option 100's 3D fallback
    def move_x0(sim):
        """The x0 wall moved by up to 30 m at random: no longer a plane,
        so the structured regeneration refuses the box."""
        x0 = torch.as_tensor((sim.topo.bcflag & 1) != 0, device=sim.device)
        rng = np.random.default_rng(4)
        dx = torch.as_tensor(rng.uniform(0.0, 30.0, sim.topo.nnode),
                             device=sim.device, dtype=sim.dtype)
        c = sim.state.coord.clone()
        c[:, 0] = torch.where(x0, c[:, 0] + dx, c[:, 0])
        sim.state = sim.state.replace(coord=c)

    def positive_volumes(label, when, *sims):
        for s in sims:
            v = float(s.state.volume.min())
            if not v > 0.0:
                fail(f"{label}: a tet of volume {v:.6e} m^3 {when} on "
                     f"{s.device}")

    fallback = grid3d_small_cfg()
    fallback["mesh"]["remeshing_option"] = 100
    for label, cfg, before, path0, move in (
            (METRIC_3D, metric3d_cfg(), 0, None, None),
            (FALLBACK_3D, fallback, 5, "grid3d", move_x0)):
        after = 10
        sim = des.Simulation(des.param_from_dict(cfg))
        if before:
            sim.run_steps(before, chunk=before)
            if sim.step_path != path0:
                fail(f"{label}: the run took {sim.step_path!r}, not {path0}")
        if move is not None:
            move(sim)
        cpu = cpu_twin(sim)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            remesh(sim, 1)
            remesh(cpu, 1)
        torch.cuda.synchronize()
        log = buf.getvalue()
        print("    " + log.strip().replace("\n", "\n    "))
        if "retrying" in log or "risks" in log:
            fail(f"{label}: the regeneration failed its quality loop")
        positive_volumes(label, "after the remesh", sim, cpu)
        for f in ("connectivity", "bcflag", "segment", "segflag"):
            if not np.array_equal(getattr(sim.topo, f), getattr(cpu.topo, f)):
                fail(f"{label}: card and CPU remeshed to another {f}")
        for nm in ("eta", "elem", "mattype", "id"):
            if not np.array_equal(sim.markers.live(nm), cpu.markers.live(nm)):
                fail(f"{label}: card and CPU markers differ in {nm}")
        if sim.ctx.sgrid is not None or sim._struct_regen_dims is not None:
            fail(f"{label}: the remesh left a structured grid")
        fin = card_vs_cpu(cpu, sim)
        check(f"{label}: after the remesh, card vs CPU, every field",
              max(fin.values()), 1e-12)
        zero_counts()
        sim.run_steps(after, chunk=after)
        torch.cuda.synchronize()
        got = launches(band)
        no_plain(label)
        cpu.run_steps(after, chunk=after)
        want = {n: v * after
                for n, v in flat3d_launches(sim.param).items()}
        if sim.step_path != "flat3d" or got != want:
            fail(f"{label}: after the remesh {sim.step_path!r} with "
                 f"launches {got}, not flat3d with {want}")
        for f in FIELD_NAMES:
            v = getattr(sim.state, f)
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                fail(f"{label}: non-finite values in {f}")
        positive_volumes(label, f"after {after} steps", sim, cpu)
        errs = card_vs_cpu(cpu, sim)
        worst = max(errs, key=errs.get)
        check(f"{label}: {after} flat3d steps, kernels on the card vs "
              f"plain versions on the CPU, worst field ({worst})",
              errs[worst], 1e-10)
        print(f"  (c) {label}: {sim.topo.nelem} tets after the remesh (host "
              f"s " + ", ".join(f"{k} {v:.3f}" for k, v in
                                sim.remesh_seconds.items())
              + f"), launches {got}")
        rec["remesh"][label] = {
            "nelem": sim.topo.nelem, "steps_after": after,
            "finalize_card_vs_cpu": max(fin.values()),
            "max_err": errs[worst], "launches": got,
            "remesh_s": sim.remesh_seconds,
            "min_volume": float(cpu.state.volume.min())}
        del sim, cpu
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 14: {rec['phase_s']:.1f} s")
    return rec


# the materials of the simple-subduction set (phasechanges.cxx:13-20):
# mantle, serpentinized mantle, oceanic crust, eclogite, sediment, schist,
# upper and lower continental crust
SUBDUCTION_MAT = {
    "nmat": 8, "phase_change_option": 1,
    "rho0": [3300.0, 3000.0, 2900.0, 3500.0, 2400.0, 2700.0, 2700.0,
             2900.0],
    "bulk_modulus": [122e9, 60e9, 70e9, 130e9, 40e9, 55e9, 50e9, 63e9],
    "shear_modulus": [74e9, 30e9, 40e9, 80e9, 20e9, 33e9, 30e9, 38e9]}


def subduction_cfg(small=False):
    """Phase 15a.  Full: bench.py production's box and mesh (100 km x 50
    km, 512 x 256 cells, 262,144 triangles, 4 markers per element) with
    the flagship's physics (EVP, plane strain, float32), the 8 materials
    of the simple-subduction set, sediment (4) over oceanic crust (2) over
    mantle (0) by depth (0-2 km, 2-8 km), the half-space geotherm of a 30
    Myr plate (423 K at about 5 km, 773 K at about 21 km) and
    phase_change_option 1 with the hydration processes.  ``small``:
    tests/test_phasechanges.py's 40 km x 40 km box at 5 km, elastic, with
    the same layers (0-4, 4-12 km) and geotherm."""
    cfg = flagship_cfg()
    if small:
        cfg["mesh"].update(xlength=40e3, zlength=40e3, resolution=5e3)
        cfg["mat"]["rheology_type"] = "elastic"
        del cfg["ic"]
        depths = [0.1, 0.3]
    else:
        depths = [0.04, 0.16]
    cfg["markers"] = {"markers_per_element": 4, "random_seed": 2}
    cfg["control"].update(has_hydration_processes=True,
                          hydration_migration_speed=3e-9)
    cfg.setdefault("ic", {}).update(
        num_mattype_layers=3, layer_mattypes=[4, 2, 0],
        mattype_layer_depths=depths, temperature_option=1,
        oceanic_plate_age_in_yr=3e7)
    cfg["mat"].update(SUBDUCTION_MAT)
    return cfg


def rsf_cycle_cfg(small=False):
    """Phase 15b.  tests/torch_cases.py rsf_events_cfg:
    tests/test_monitor.py's rate-and-state simple shear
    (elasto-plastic-rate-state-friction, the top dragged at 1e-5 m/s over
    a fixed bottom, use_global_velocity_scaling)
    with seismic_moment_calculate_output and an event threshold of half the
    drag speed.  ``small``: as it is, its 1 m box (2 triangles) in float64
    and the monitor's 2 points (tests/test_torch_monitor.py).  Full: on the
    flagship mesh (100 km x 50 km, 512 x 256 cells), float32, the cohesion
    at 100 Pa so that it yields from the first steps,
    earthquake_output_step_interval 10, an end threshold of twice the drag
    speed, 200 steps with a frame every 100, a monitor of 4 points every 10
    steps."""
    from torch_cases import rsf_events_cfg

    if small:
        return rsf_events_cfg()
    return rsf_events_cfg(
        200, sim={"float_dtype": "float32", "output_step_interval": 100,
                  "checkpoint_frame_interval": 10,
                  "earthquake_output_step_interval": 10,
                  "earthquake_end_factor": 2.0},
        mesh={"xlength": 100e3, "zlength": 50e3, "resolution": 100e3 / 512,
              "quality_check_step_interval": 10**8},
        control={"fixed_dt": 0.0},
        mat={"cohesion0": [1e2], "cohesion1": [1e2]},
        monitor={"num_points": 4, "points_unit": "km",
                 "points_x": [20.0, 40.0, 60.0, 80.0],
                 "points_y": [-10.0, -20.0, -30.0, -40.0],
                 "output_velocity": True,
                 "output_plastic_strain_rate": True})


def surface_hook_cfg(opt):
    """Phase 15c: tests/test_gospl_wiring.py's 10 km x 5 km box at 1 km,
    elastic, float64, 5 steps with a frame every step, surface process
    ``opt`` (101, the custom hook; 11, GoSPL every 2 steps)."""
    return {
        "sim": {"max_steps": 5, "ndims": 2, "float_dtype": "float64",
                "output_step_interval": 1,
                "is_outputting_averaged_fields": False},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": 10e3, "ylength": 0.0, "zlength": 5e3,
                 "resolution": 1e3, "quality_check_step_interval": 10**6},
        "markers": {"markers_per_element": 0},
        "control": {"gravity": 0.0, "inertial_scaling": 1e5,
                    "damping_option": 1, "surface_process_option": opt,
                    "gospl_coupling_frequency": 2,
                    "gospl_coupling_mode": "steps"},
        "bc": {"vbc_x0": 1, "vbc_val_x0": 0.0, "vbc_x1": 1,
               "vbc_val_x1": 0.0, "vbc_z0": 1, "vbc_val_z0": 0.0,
               "vbc_z1": 0, "has_winkler_foundation": False},
        "mat": {"rheology_type": "elastic", "is_plane_strain": True,
                "rho0": [2800.0], "bulk_modulus": [50e9],
                "shear_modulus": [30e9]}}


class GoSPLStandIn:
    """Stands in for GoSPLDriver (gospl is not installed): 1 m of erosion
    at each coupling, every ``gospl_coupling_frequency`` steps (the
    stand-in of tests/test_gospl_wiring.py)."""

    def __init__(self, param):
        self.freq = param.control.gospl_coupling_frequency
        self.step_counter = 0
        self.couplings = 0

    def initialize(self, yml, xy, elev):
        pass

    def should_couple_elapsed(self, n_steps, dt_elapsed):
        self.step_counter += n_steps
        return self.step_counter >= self.freq

    def steps_to_next_coupling(self):
        return max(1, self.freq - self.step_counter)

    def run_and_get_erosion(self, xy, elev, vel):
        import numpy as np
        self.couplings += 1
        self.step_counter = 0
        return np.full(len(elev), -1.0)

    def on_remesh(self):
        pass


def driver_features_on_card(des, wrappers, zero_counts, card, check, rel):
    """Phase 15: the CLI's host features on the card -- (a) subduction-2d:
    at test size card against CPU over 50 float32 steps, the material
    history wake by wake over every marker (a material or a release that
    differs must lie within float32 rounding of its phase boundary, or, for
    the mantle's serpentinization, in an element whose hydrous-marker count
    differs because hydrous markers lie within rounding of an element side)
    and the fields at the maxwell trajectory gate; at full width 100 steps
    through the CLI's run() with the phase changes and without, twice
    each: the step path, the hand-written kernels' launches per step, the
    transitions, released and hydrous markers and the host ms of each wake
    by part, Compute s/step and the s/step of the 10-step chunks after the
    first; from the state of the first wake that changed the weights, the
    chunk kernel's 8-material instance against its plain version (see
    _chunk_after_wake); (b)
    rsf-cycle-2d: the monitor's test-size config card against CPU (the
    same event log and frame steps, the monitor CSVs at 1e-10 in float64);
    at full width 200 steps on flat2d through run(): the band kernels'
    launches per step, the events, the frame steps, the monitor rows, the
    host ms per wake, Compute s/step; (c) the option-101 hook and a GoSPL
    stand-in over 5 steps, card against CPU frame for frame, and
    DES_PROFILE_DIR's trace naming a hand-written kernel the run launched.
    Returns the numbers for the JSON record."""
    import contextlib
    import io
    import json as _json
    import os
    import re
    import tempfile

    import numpy as np
    import torch

    from dynearthsol_tpu_torch import __main__ as cli
    from dynearthsol_tpu_torch import gospl_driver, hooks, phasechanges
    from dynearthsol_tpu_torch.ops import band2d, fused2d, fused3d
    from torch_cases import assert_frames_close, write_cfg

    t_phase = time.perf_counter()
    plain_calls = (band2d.gather_corners, band2d.scatter_corners,
                   fused2d.fused_step_plain, fused2d.dt_refresh_plain,
                   fused3d.chunk_step_plain, fused3d.finalize_plain)
    rec = {}
    print("phase 15 the CLI's host features on the card")

    def launches():
        return {n: w.launches for n, w in wrappers.items() if w.launches}

    def run_cli(cfg, name, device, wake_log=None):
        """cli.run on cfg written as name.cfg, its wakes into wake_log;
        returns (sim, the printed summary lines, seconds).  The card's run
        starts with every count at 0 and must call no plain version."""
        write_cfg(f"{name}.cfg",
                  {**cfg, "sim": {**cfg["sim"], "modelname": name}})
        buf = io.StringIO()
        if device == "cuda":
            zero_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            sim = cli.run(des.load_config(f"{name}.cfg"), device=device,
                          wake_log=wake_log)
        if device == "cuda":
            torch.cuda.synchronize()
            called = [f.__name__ for f in plain_calls if f.calls]
            if called:
                fail(f"{name}: the run on the card called the plain "
                     f"versions {called}")
        secs = time.perf_counter() - t
        keep = ("Compute:", "Output:", "Wakes:", "Markers:", "Path:")
        return sim, [ln for ln in buf.getvalue().splitlines()
                     if ln.startswith(keep)], secs

    def compute_s_per_step(lines):
        for ln in lines:
            m = re.match(r"Compute:.* = ([0-9.e+-]+) s/step", ln)
            if m:
                return float(m.group(1))
        fail("the CLI printed no Compute line")

    def frames_close(a, b, tol):
        """torch_cases.assert_frames_close on two frames of a float64 run;
        returns the worst difference."""
        try:
            return assert_frames_close(a, b, tol)
        except AssertionError as e:
            fail(f"{a} against {b}: {e}")

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            rec["subduction"] = _subduction(
                des, cli, phasechanges, run_cli, compute_s_per_step,
                launches, rel, check)
            rec["rsf_cycle"] = _rsf_cycle(run_cli, compute_s_per_step,
                                          launches, frames_close)
            # (c) the option-101 hook and the GoSPL stand-in, card vs CPU
            print(" (c) surface processes 101 and 11 at test size, card "
                  "against CPU")
            rec["surface_hooks"] = {}
            real_driver = gospl_driver.GoSPLDriver
            gospl_driver.GoSPLDriver = GoSPLStandIn
            hooks.set_custom_surface_process(
                lambda sim, dt: -0.5 * (1.0 + np.arange(
                    int(sim.ctx.surf.ntop)) / int(sim.ctx.surf.ntop)))
            try:
                for opt in (101, 11):
                    out, wakes = {}, []
                    for dev in ("cuda", "cpu"):
                        out[dev] = run_cli(
                            surface_hook_cfg(opt), f"sp{opt}-{dev}", dev,
                            wakes if dev == "cuda" else None)[0]
                    worst = max(frames_close(
                        f"sp{opt}-cpu.save.{f:06d}",
                        f"sp{opt}-cuda.save.{f:06d}", 1e-10)
                        for f in range(6))
                    applied = sum("surface_dh_ms" in w for w in wakes)
                    if applied != (5 if opt == 101 else 2):
                        fail(f"option {opt}: {applied} increments applied")
                    print(f"  option {opt}: {applied} increments applied, "
                          f"6 frames card against CPU, worst {worst:.3e} "
                          f"(tol 1e-10) on {out['cuda'].step_path}")
                    rec["surface_hooks"][opt] = {
                        "applied": applied, "worst_frame_err": worst}
            finally:
                gospl_driver.GoSPLDriver = real_driver
                hooks.set_custom_surface_process(None)
            # the profiler trace of a run on the resident 2D kernel
            os.environ["DES_PROFILE_DIR"] = str(Path(tmp) / "prof")
            try:
                cfg = make_sim_cfg()
                cfg["sim"].update(max_steps=20)
                sim, _, _ = run_cli(cfg, "prof", "cuda")
            finally:
                del os.environ["DES_PROFILE_DIR"]
            with open(Path(tmp) / "prof" / "trace.json") as f:
                names = {e.get("name", "") for e in
                         _json.load(f)["traceEvents"]}
            named = sorted(n for n in names if "step_chunk2d" in n)
            if sim.step_path != "pallas2d_res" or not named \
                    or not wrappers["fused2d_chunk"].launches:
                fail(f"DES_PROFILE_DIR: the trace names no launched "
                     f"kernel ({sim.step_path}, {len(names)} names)")
            print(f"  DES_PROFILE_DIR: trace.json with {len(names)} event "
                  f"names, the launched kernel among them: {named[0][:60]}")
            rec["profile_trace_kernel"] = named[0]
        finally:
            os.chdir(cwd)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 15: {rec['phase_s']:.1f} s")
    return rec


def _subduction(des, cli, phasechanges, run_cli, compute_s_per_step,
                launches, rel, check):
    """Phase 15a (see driver_features_on_card)."""
    import numpy as np
    import torch

    from dynearthsol_tpu_torch.ops import fused2d
    from dynearthsol_tpu_torch.state import FIELD_NAMES

    print(" (a) subduction-2d")
    rec = {}
    # the material history of each run, wake by wake: the markers'
    # material before and after, their release mask, depth, pressure and
    # temperature, and the hydrous markers' count per element and their
    # placement, all as the wake found them
    history = {}
    real = cli.phase_changes

    def recording(sim):
        ms = sim.markers
        Z, P, T = phasechanges.marker_ZPT(
            sim.param, ms, sim._host(sim.state.coord), sim.topo.connectivity,
            sim._host(sim.state.temperature))
        hyd = sim.hydrous_markers
        count = np.zeros(sim.topo.nelem)
        if hyd is not None:
            np.add.at(count, hyd.live("elem"), 1.0)
        release = phasechanges.simple_subduction(sim.param, ms, Z, P, T,
                                                 count)[1]
        h = dict(step=int(sim.state.steps), before=ms.live("mattype").copy(),
                 release=release, Z=Z, P=P, T=T,
                 count=count[ms.live("elem")],
                 hyd_elem=None if hyd is None else hyd.live("elem").copy(),
                 hyd_eta=None if hyd is None else hyd.live("eta").copy())
        st = real(sim)
        history[run_dev[0]].append(dict(
            h, after=ms.live("mattype").copy(), released=st["released"]))
        return st

    cli.phase_changes = recording
    run_dev, out = [None], {}
    try:
        small = subduction_cfg(small=True)
        small["sim"].update(max_steps=50)
        for dev in ("cuda", "cpu"):
            run_dev[0] = dev
            history[dev] = []
            out[dev] = run_cli(small, f"sub-{dev}", dev)[0]
    finally:
        cli.phase_changes = real
    if not len(history["cuda"]) == len(history["cpu"]) == 5:
        fail("subduction-2d test size: not 5 wakes on each device")

    def boundaries(h, i):
        """Relative distance of marker i to each boundary of the phase
        diagram (phasechanges.cxx:10-104), from the CPU's inputs."""
        T, P, Z = h["T"][i], h["P"][i], h["Z"][i]
        trans_p = 2.1e9 + 5.4e9 * (T - 1003.0) / -230.0
        return {"T 423": abs(T - 423) / 423, "T 773": abs(T - 773) / 773,
                "T 923": abs(T - 923) / 923, "T 823": abs(T - 823) / 823,
                "P eclogite": abs(P - (-0.3e9 + 2.2e6 * T)) / abs(P),
                "P serpentinite": abs(P - trans_p) / abs(P),
                "Z -20 km": abs(Z + 20e3) / 20e3}

    # every marker at every wake: a material or a release that differs card
    # against CPU must lie within float32 rounding (1e-5) of a boundary, or
    # (mantle -> serpentinite, which reads the hydrous markers) in an
    # element whose hydrous-marker count differs because hydrous markers lie
    # within rounding of an element side (the same index on both devices in
    # another element, the smallest barycentric coordinate 1e-5 or less on
    # each).  A divergence, once accepted, is carried to the next wakes
    # only while both devices keep its materials.
    TOL = 1e-5
    carried, new_diff, release_diff, side = {}, [], 0, 0
    for w, (a, b) in enumerate(zip(history["cuda"], history["cpu"])):
        na = 0 if a["hyd_elem"] is None else a["hyd_elem"].size
        nb = 0 if b["hyd_elem"] is None else b["hyd_elem"].size
        if na != nb and abs(na - nb) > release_diff:
            fail(f"subduction-2d wake {w}: {na} hydrous markers on the card, "
                 f"{nb} on the CPU, {release_diff} releases apart")
        placed = na == nb
        if placed and na:
            moved = np.flatnonzero(a["hyd_elem"] != b["hyd_elem"])
            for j in moved:
                ea, eb = a["hyd_eta"][j].min(), b["hyd_eta"][j].min()
                print(f"    wake {w}: hydrous marker {j} in element "
                      f"{a['hyd_elem'][j]} on the card, {b['hyd_elem'][j]} "
                      f"on the CPU; least barycentric {ea:.2e}, {eb:.2e}")
                if max(ea, eb) > TOL:
                    fail(f"subduction-2d wake {w}: hydrous marker {j} lies "
                         f"in another element on the card, off its sides")
            side += moved.size
        for i in np.flatnonzero(a["release"] != b["release"]):
            d = boundaries(b, i)
            print(f"    wake {w}: marker {i} releases on the card "
                  f"{a['release'][i]}, on the CPU {b['release'][i]}; nearest "
                  f"boundary {min(d, key=d.get)} at {min(d.values()):.2e}")
            if i not in carried and min(d.values()) > TOL:
                fail(f"subduction-2d wake {w}: marker {i} released "
                     f"differently on the card, off its boundaries")
            release_diff += 1
        for i in list(carried):
            if a["after"][i] == b["after"][i]:
                del carried[i]
        for i in np.flatnonzero(a["after"] != b["after"]):
            pair = (a["after"][i], b["after"][i])
            if carried.get(i) == pair and a["before"][i] == pair[0] \
                    and b["before"][i] == pair[1]:
                continue
            d = boundaries(b, i)
            near = min(d.values())
            hyd = (placed and a["count"][i] != b["count"][i]
                   and phasechanges.MT_MANTLE in (a["before"][i],
                                                  b["before"][i]))
            print(f"    wake {w}: marker {i} {a['before'][i]}/"
                  f"{b['before'][i]} -> card {pair[0]}, CPU {pair[1]}; "
                  f"nearest boundary {min(d, key=d.get)} at {near:.2e}; "
                  f"hydrous markers in its element card {a['count'][i]:.0f}, "
                  f"CPU {b['count'][i]:.0f}")
            if near > TOL and not hyd:
                fail(f"subduction-2d wake {w}: marker {i}'s material differs "
                     f"on the card, {near:.2e} from its boundary")
            carried[i] = pair
            new_diff.append(int(i))
    n_moved = {dev: [int((h["before"] != h["after"]).sum()) for h in hs]
               for dev, hs in history.items()}
    released = {dev: [h["released"] for h in hs]
                for dev, hs in history.items()}
    print(f"  test size (40 x 40 km, float32, 50 steps, "
          f"{out['cuda'].step_path}): {len(history['cuda'])} wakes, "
          f"transitions card {n_moved['cuda']}, CPU {n_moved['cpu']}; "
          f"released card {released['cuda']}, CPU {released['cpu']}; over "
          f"all markers at all wakes, materials that differ "
          f"{len(new_diff)}, releases {release_diff}, hydrous markers in "
          f"another element {side}")
    worst = 0.0
    for f in ("coord", "vel", "stress", "strain", "temperature"):
        worst = max(worst, rel(getattr(out["cpu"].state, f),
                               getattr(out["cuda"].state, f).cpu()))
    check("subduction-2d test size, 50 steps card vs CPU, worst field",
          worst, 2e-4)
    rec["test_size"] = {"wakes": len(history["cuda"]),
                        "differing_markers": len(new_diff),
                        "differing_releases": release_diff,
                        "hydrous_in_another_element": side,
                        "worst_field_err": worst}

    # full width, with the phase changes and without, twice each.  The
    # first run keeps the state of the first wake that changed the weights,
    # for the kernel-against-plain check after it.
    snap = {}

    def snapping(sim):
        emw0 = sim.state.emw
        st = real(sim)
        if not snap and not torch.equal(emw0, sim.state.emw):
            s = sim.state
            snap.update(step=int(s.steps), ctx=sim.ctx, emw0=emw0.clone(),
                        state=s.replace(**{
                            f: getattr(s, f).clone() for f in FIELD_NAMES
                            if torch.is_tensor(getattr(s, f))}))
        return st

    chunk_rates = {1: [], 0: []}
    for k, phases in enumerate((1, 0, 1, 0)):
        cfg = subduction_cfg()
        cfg["sim"].update(max_steps=100, output_step_interval=10**9)
        cfg["mat"]["phase_change_option"] = phases
        wakes = []
        cli.phase_changes = snapping if k == 0 else real
        try:
            sim, lines, secs = run_cli(cfg, f"subduction-{phases}", "cuda",
                                       wakes)
        finally:
            cli.phase_changes = real
        n = int(sim.state.steps)
        per_step = {nm: v / n for nm, v in launches().items()}
        if not per_step or sim.step_path not in ("pallas2d_res",
                                                 "pallas2d"):
            fail(f"subduction-2d ran on {sim.step_path} with launches "
                 f"{per_step}")
        if not all(np.isfinite(sim._host(getattr(sim.state, f))).all()
                   for f in ("coord", "vel", "stress", "temperature")):
            fail("subduction-2d: non-finite fields")
        cs = compute_s_per_step(lines)
        if phases:
            # the 10-step chunks between the wakes, the first (which builds
            # the runner) aside
            rates = [w["chunk_s"] / w["chunk_steps"] for w in wakes[1:]]
        else:
            # the same 10-step chunks on the run without phase changes,
            # after one to warm the 10-step runner
            rates = []
            for j in range(6):
                t = time.perf_counter()
                sim.run_steps(10)
                torch.cuda.synchronize()
                if j:
                    rates.append((time.perf_counter() - t) / 10)
        chunk_rates[phases] += rates
        r = {"step_path": sim.step_path, "launches_per_step": per_step,
             "compute_s_per_step": cs, "wall_s": secs,
             "chunk10_s_per_step": rates}
        print(f"  full width, phase_change_option {phases}, run {k // 2 + 1}:"
              f" {sim.topo.nelem} triangles, {sim.markers.n} markers, "
              f"{sim.step_path}, launches per step {per_step}, Compute "
              f"{cs:.3e} s/step, wall {secs:.1f} s; 10-step chunks "
              f"{min(rates):.3e}-{max(rates):.3e} s/step (median "
              f"{float(np.median(rates)):.3e}, {len(rates)} chunks)")
        if k == 0:
            for w in wakes:
                print(f"    step {w['step']}: transitions "
                      f"{w['transitions']}, released {w['released']}, "
                      f"hydrous {w['hydrous']}; host ms phase_changes "
                      f"{w['phase_changes_ms']:.1f} (reads of coord and "
                      f"temperature {w['read_ms']:.2f}, emw upload "
                      f"{w['emw_ms']:.2f}), advect {w['advect_ms']:.1f}")
            r["wakes"] = [{key: w[key] for key in (
                "step", "transitions", "released", "hydrous",
                "phase_changes_ms", "read_ms", "emw_ms", "advect_ms",
                "chunk_s", "chunk_steps")} for w in wakes]
            if not sim.hydrous_markers or not sim.hydrous_markers.n:
                fail("subduction-2d released no hydrous markers")
            if not snap:
                fail("subduction-2d: no wake changed the material weights")
            r["after_wake"] = _chunk_after_wake(des, sim, snap, fused2d,
                                                rel, check)
        rec.setdefault(f"phase_change_option_{phases}", r)
        rec.setdefault(f"runs_phase_change_option_{phases}", []).append(
            {"compute_s_per_step": cs, "chunk10_s_per_step": rates})
        del sim
        torch.cuda.empty_cache()
    med = {p: float(np.median(v)) for p, v in chunk_rates.items()}
    print(f"  10-step chunks at full width, 2 runs each: with the phase "
          f"changes {min(chunk_rates[1]):.3e}-{max(chunk_rates[1]):.3e} "
          f"s/step (median {med[1]:.3e}, {len(chunk_rates[1])} chunks), "
          f"without {min(chunk_rates[0]):.3e}-{max(chunk_rates[0]):.3e} "
          f"(median {med[0]:.3e}, {len(chunk_rates[0])}); ratio of the "
          f"medians {med[1] / med[0]:.3f}")
    rec["chunk10_median_s_per_step"] = med
    return rec


def _chunk_after_wake(des, sim, snap, fused2d, rel, check):
    """Phase 15a's kernel against its plain version at full width after a
    phase-change wake, from the state the first weight-changing wake left
    (8 materials in the const pack, the new emw), on the runner the run
    took.  With a maxwell plan of the same model, as phase 13 holds a run's
    state (on EVP the min-select of rheology.cxx:869-879 ties at float32
    rounding in the cold cells at visc_max, where the viscoelastic and
    elastic-plastic deviators are equal and one-ulp differences of expf
    pick either branch, phase 3): one step on every field at phase 3's
    rule (2e-6 of each field's max, the log-viscosity 1e-5, dpressure at
    the stress's scale) and one 10-step chunk at its 10-step rule (2e-4,
    the force 1e-3, the log-viscosity's median 0.02, dt and time 1e-5);
    the same chunk with the weights before the wake must move the force by
    more than the kernel's rounding does.  Then one step of the run's own
    EVP plan: coord, temperature, strain and plstrain at 2e-6, and every
    element whose stress differs by more than 2e-6 of the max must be such
    a cold cell, at visc_max on both sides."""
    import torch

    from dynearthsol_tpu_torch.state import FIELD_NAMES

    s, ctx = snap["state"], snap["ctx"]
    resident = sim.step_path == "pallas2d_res"
    cfg = subduction_cfg()
    cfg["mat"]["rheology_type"] = "maxwell"
    MP, EP = (fused2d.make_plan(p, ctx, sim.device,
                                sim.compensation_pressure)
              for p in (des.param_from_dict(cfg), sim.param))

    def chunk(P, state, n, plain):
        out = fused2d.run_chunk(P, ctx, state, n, resident, plain)
        torch.cuda.synchronize()
        return out

    lab = f"subduction-2d after the wake at step {snap['step']}"
    errs = {}
    ker, ref = chunk(MP, s, 1, False), chunk(MP, s, 1, True)
    for f in FIELD_NAMES:
        x, y = getattr(ref, f), getattr(ker, f)
        if not torch.is_tensor(x):
            continue
        if not x.is_floating_point():
            if not torch.equal(x, y):
                fail(f"{lab}: 1 maxwell step, {f} differs")
            continue
        if f == "viscosity":
            e, tol = float((x.double().log() - y.double().log()).abs()
                           .max()), 1e-5
        elif f == "dpressure":
            e, tol = float((x.double() - y.double()).abs().max()
                           / ref.stress.double().abs().max()), 2e-6
        else:
            e, tol = rel(x, y), 1e-5 if f == "l2_residual" else 2e-6
        errs[f"maxwell 1 step {f}"] = e
        check(f"{lab}, 1 maxwell step, kernel vs plain, {f}", e, tol)
    ker, ref = chunk(MP, s, 10, False), chunk(MP, s, 10, True)
    for f in ("coord", "vel", "temperature", "stress", "strain", "volume",
              "volume_n", "mass", "tmass", "hmass", "strain_rate", "edvoldt",
              "force"):
        errs[f"maxwell 10 steps {f}"] = rel(getattr(ref, f), getattr(ker, f))
        check(f"{lab}, maxwell 10 steps kernel vs plain, {f}",
              errs[f"maxwell 10 steps {f}"], 1e-3 if f == "force" else 2e-4)
    dlog = ref.viscosity.double().log() - ker.viscosity.double().log()
    errs["maxwell 10 steps log-viscosity median"] = float(dlog.abs().median())
    check(f"{lab}, maxwell 10 steps log-viscosity median",
          errs["maxwell 10 steps log-viscosity median"], 0.02)
    for f in ("dt", "time", "max_global_vel_mag"):
        errs[f"maxwell 10 steps {f}"] = rel(getattr(ref, f), getattr(ker, f))
        check(f"{lab}, maxwell 10 steps {f}", errs[f"maxwell 10 steps {f}"],
              1e-5)
    old = chunk(MP, s.replace(emw=snap["emw0"]), 10, False)
    moved = {f: rel(getattr(ker, f), getattr(old, f))
             for f in ("force", "stress", "vel")}
    kv = {f: errs[f"maxwell 10 steps {f}"] for f in moved}
    print(f"  {lab}: the maxwell chunk with the weights before the wake "
          f"differs by " + ", ".join(f"{f} {moved[f]:.3e}" for f in moved)
          + "; kernel against plain by "
          + ", ".join(f"{f} {kv[f]:.3e}" for f in kv))
    if not moved["force"] > kv["force"]:
        fail(f"{lab}: the new weights move the force no more than the "
             f"kernel's rounding does")
    # one step of the run's own EVP plan
    ker, ref = chunk(EP, s, 1, False), chunk(EP, s, 1, True)
    for f in ("coord", "temperature", "strain", "plstrain"):
        errs[f"EVP 1 step {f}"] = rel(getattr(ref, f), getattr(ker, f))
        check(f"{lab}, 1 EVP step, kernel vs plain, {f}",
              errs[f"EVP 1 step {f}"], 2e-6)
    d = ((ker.stress.double() - ref.stress.double()).abs().max(1).values
         / ref.stress.double().abs().max())
    over = d > 2e-6
    vmax = sim.param.mat.visc_max
    cold = (ker.viscosity == vmax) & (ref.viscosity == vmax)
    errs["EVP 1 step stress"] = float(d.max())
    errs["EVP 1 step stress, elements over 2e-6"] = int(over.sum())
    print(f"  {lab}, 1 EVP step, kernel vs plain: stress "
          f"{float(d.max()):.3e} of its max, {int(over.sum())} of "
          f"{d.numel()} elements over 2e-6, {int((over & cold).sum())} of "
          f"them at visc_max on both sides (the min-select's ties), force "
          f"{rel(ref.force, ker.force):.3e}")
    if bool((over & ~cold).any()):
        fail(f"{lab}: 1 EVP step, {int((over & ~cold).sum())} elements "
             f"below visc_max differ by more than 2e-6 in stress")
    return {"step": snap["step"], "kernel_vs_plain": errs,
            "old_weights_moved": moved}


def _rsf_cycle(run_cli, compute_s_per_step, launches, frames_close):
    """Phase 15b (see driver_features_on_card)."""
    import os
    import re

    import numpy as np

    from dynearthsol_tpu_torch.postproc import OutputReader

    print(" (b) rsf-cycle-2d")
    rec = {}
    small = rsf_cycle_cfg(small=True)
    logs, frames = {}, {}
    for dev in ("cuda", "cpu"):
        d = Path(f"rsf-{dev}")
        d.mkdir()
        cwd = Path.cwd()
        os.chdir(d)
        try:
            run_cli(small, "rsf", dev)
            logs[dev] = Path("seismic_moment_magnitude.txt").read_text()
            frames[dev] = OutputReader("rsf").steps
        finally:
            os.chdir(cwd)
    if logs["cuda"].count("ended") < 2 or frames["cuda"] != frames["cpu"]:
        fail(f"rsf-cycle-2d test size: events {logs['cuda'].count('ended')}"
             f", frames card {frames['cuda']} CPU {frames['cpu']}")
    num = r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?"
    if re.sub(num, "#", logs["cuda"]) != re.sub(num, "#", logs["cpu"]):
        fail("rsf-cycle-2d test size: the event logs differ in text")
    a = np.array([float(x) for x in re.findall(num, logs["cpu"])])
    b = np.array([float(x) for x in re.findall(num, logs["cuda"])])
    log_err = float((np.abs(a - b) / np.maximum(np.abs(a), 1e-300)).max())
    csv_err = 0.0
    for i in range(2):
        ra, rb = (np.loadtxt(f"rsf-{dev}/mon_point_{i}.csv", delimiter=",",
                             skiprows=1) for dev in ("cpu", "cuda"))
        if ra.shape != rb.shape:
            fail("rsf-cycle-2d test size: monitor rows differ")
        csv_err = max(csv_err, float((np.abs(ra - rb) / np.maximum(
            np.abs(ra), 1e-300)).max()))
    frame_err = max(frames_close(f"rsf-cpu/rsf.save.{f:06d}",
                                 f"rsf-cuda/rsf.save.{f:06d}", 1e-10)
                    for f in range(len(frames["cpu"])))
    for label, err in (("event log", log_err), ("monitor CSV", csv_err)):
        if err > 1e-10:
            fail(f"rsf-cycle-2d test size: {label} {err:.3e} over 1e-10")
    print(f"  test size (float64): {logs['cuda'].count('ended')} events, "
          f"frames at steps {frames['cuda']} on both; card against CPU: "
          f"event log {log_err:.3e}, monitor CSV {csv_err:.3e}, frames "
          f"{frame_err:.3e} (tol 1e-10)")
    rec["test_size"] = {"events": logs["cuda"].count("ended"),
                        "frame_steps": frames["cuda"], "log_err": log_err,
                        "csv_err": csv_err, "frame_err": frame_err}

    wakes = []
    sim, lines, secs = run_cli(rsf_cycle_cfg(), "rsf-full", "cuda", wakes)
    n = int(sim.state.steps)
    per_step = {k: v / n for k, v in launches().items()}
    band = {k: per_step.get(k, 0) for k in ("cgather", "asm_pack",
                                            "asm_gather")}
    if sim.step_path != "flat2d" or not all(band.values()):
        fail(f"rsf-cycle-2d ran on {sim.step_path}, launches {per_step}")
    if not all(np.isfinite(sim._host(getattr(sim.state, f))).all()
               for f in ("coord", "vel", "stress", "state_variable")):
        fail("rsf-cycle-2d: non-finite fields")
    events = Path("seismic_moment_magnitude.txt").read_text() \
        if Path("seismic_moment_magnitude.txt").exists() else ""
    steps = OutputReader("rsf-full").steps
    rows = [len(Path(f"mon_point_{i}.csv").read_text().splitlines()) - 1
            for i in range(4)]
    # mean host ms per wake by part
    host = {k: sum(w.get(k, 0.0) for w in wakes) / max(len(wakes), 1)
            for k in ("tracking_ms", "tracking_read_ms", "monitor_ms")}
    cs = compute_s_per_step(lines)
    print(f"  full width (float32, {sim.topo.nelem} triangles, 200 steps): "
          f"{sim.step_path}, band launches per step {band}, "
          f"{events.count('started')} events started and "
          f"{events.count('ended')} ended, frames at steps {steps}, "
          f"monitor rows {rows}, host ms per wake {host}, Compute {cs:.3e} "
          f"s/step, wall {secs:.1f} s")
    for ln in events.splitlines()[:8]:
        print(f"    {ln}")
    rec["full"] = {"step_path": sim.step_path, "launches_per_step":
                   per_step, "events_started": events.count("started"),
                   "events_ended": events.count("ended"),
                   "frame_steps": steps, "monitor_rows": rows,
                   "host_ms_per_wake": host, "compute_s_per_step": cs,
                   "wall_s": secs}
    return rec


def small_prerelax_cases(tmp: Path):
    """Phase 16d's test-size cases (tests/test_torch_prerelax.py,
    test_torch_generic3d.py, test_torch_poly.py), float64: (label, cfg,
    what, DES_NO_FLAT), ``what`` a pre-relaxation or a number of steps.
    The .poly files are written into ``tmp``."""
    import torch_cases as tc

    tc.write_poly2d(tmp / "box.poly")
    tc.write_poly3d(tmp / "block.poly")
    pt = {"has_PT": True, "PT_max_iter": 30}
    return [
        ("isostasy 2D", tc.flat_cfg(
            ic={"isostasy_adjustment_time_in_yr": 0.3}),
         "isostasy_adjustment", False),
        ("isostasy 3D", tc.flat3d_cfg(
            ic={"isostasy_adjustment_time_in_yr": 0.006}),
         "isostasy_adjustment", False),
        ("body force 2D", tc.flat_cfg(
            ic={"has_body_force_adjustment": True},
            control={**pt, "PT_relative_tolerance": 1e-3}),
         "body_force_adjustment", False),
        ("body force 3D, hydraulic", tc.flat3d_cfg(
            "elasto-plastic", ic={"has_body_force_adjustment": True},
            mat=dict(HYD_MAT),
            control={**pt, "PT_relative_tolerance": 1e-12,
                     "has_hydraulic_diffusion": True}),
         "body_force_adjustment", False),
        ("generic 3D, hydraulic", tc.flat3d_cfg(
            mat=dict(HYD_MAT),
            control={"has_hydraulic_diffusion": True,
                     "use_global_velocity_scaling": True}), 3, True),
        ("2D .poly, two regions", tc.poly2d_cfg(tmp / "box.poly", False),
         5, False),
        ("3D .poly, inclined BCs 13 and 3",
         tc.poly3d_cfg(tmp / "block.poly"), 5, False),
    ]


def prerelax_on_card(des, wrappers, zero_counts, card, check, umesh,
                     u3mesh):
    """Phase 16: the ways a run starts on the card -- (a) the isostasy
    pre-relaxation at full width (maxwell, f32) on phase 9's 277,258
    triangles and on phase 12's 680,794 tets (their meshes reused, not
    meshed again): the band kernels against their plain versions from one
    state at the maxwell trajectory rule (2e-4 of each field's max, force
    1e-3), steps, s/step, the band kernels' and all CUDA launches per step;
    (b) the body-force pre-relaxation at full width in 2D: iterations,
    host reads, s per iteration, kernels against plain versions; (c) the
    3D generic step (DES_NO_FLAT) on the 680,794 tets: one step with the
    kernels equal to one with the plain versions, two timed chunks,
    elem*steps/s and launches per step; (d) at test size, float64, card
    against CPU at 1e-10: both pre-relaxations in 2D and 3D, the 3D
    generic step, a 2D .poly run with two regions and a 3D .poly run with
    inclined BCs; (e) the ep-remesh-2d golden (the 2D generic step on the
    reference's refined-zone mesh) through the CLI on the card, frames 0-2
    (5,000 steps, cut from 40,000) at the accumulated bounds of
    tests/test_golden_vs_reference.py:194-196.  Returns the numbers for
    the JSON record."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dynearthsol_tpu_torch import __main__ as cli
    from dynearthsol_tpu_torch import simulation as sim_mod
    from dynearthsol_tpu_torch.compare import (ACCUM_KINDS,
                                               _frame_quantities, reldiff)
    from dynearthsol_tpu_torch.constants import YEAR2SEC
    from dynearthsol_tpu_torch.ops import band2d, flat3d
    from dynearthsol_tpu_torch.postproc import OutputReader
    from dynearthsol_tpu_torch.state import FIELD_NAMES

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    band = ("cgather", "asm_pack", "asm_gather")
    rec = {"isostasy": {}, "small": {}}
    print("phase 16 the pre-relaxations, the 3D generic step and the "
          ".poly meshes on the card")

    def launches():
        return {n: wrappers[n].launches for n in band}

    def no_plain(label):
        if band2d.gather_corners.calls or band2d.scatter_corners.calls:
            fail(f"{label}: the main path took a plain version")

    def build(cfg, mesh):
        mesher = sim_mod.create_new_mesh
        sim_mod.create_new_mesh = lambda param: mesh
        try:
            t = time.perf_counter()
            sim = des.Simulation(des.param_from_dict(cfg))
            torch.cuda.synchronize()
            return sim, time.perf_counter() - t
        finally:
            sim_mod.create_new_mesh = mesher

    def held(label, ker, plain):
        """Kernels against plain versions at the maxwell trajectory rule;
        returns (worst error, equal bit for bit)."""
        worst, equal = 0.0, True
        for f in FIELD_NAMES:
            x, y = getattr(plain, f), getattr(ker, f)
            if torch.equal(x, y):
                continue
            equal = False
            if not x.is_floating_point():
                fail(f"{label}: {f} differs")
            scale = plain.stress if f == "dpressure" else x
            err = float((x.double() - y.double()).abs().max()
                        / scale.double().abs().max().clamp(min=1e-300))
            worst = max(worst, err)
            check(f"{label}, kernels vs plain, {f}", err,
                  1e-3 if f == "force" else 2e-4)
        return worst, equal

    def profiled(fn, steps):
        """CUDA launches, device busy us and wall us per step of fn()."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6 / steps
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in ev) / steps
        return {"cuda_launches_per_step": len(ev) / steps,
                "busy_us_per_step": busy, "wall_us_per_step": wall,
                "device_idle": max(0.0, 1 - busy / wall)}

    def set_iso_steps(sim, n):
        """isostasy_adjustment_time_in_yr for n steps at the state's dt."""
        sim.param.ic.isostasy_adjustment_time_in_yr = \
            (n + 0.5) * float(sim.state.dt) / YEAR2SEC

    # (a) isostasy at full width, 2D and 3D; (c) the 3D generic step
    sims = {}
    for label, cfg, mesh, nsteps in (
            ("2D, 277k triangles", unstructured_cfg("maxwell"), umesh, 20),
            ("3D, 680,794 tets",
             flagship3d_unstructured_cfg("maxwell"), u3mesh, 10)):
        sim, init_s = build(cfg, mesh)
        s0 = sim.state
        set_iso_steps(sim, nsteps)
        n_plain = sim.isostasy_adjustment(plain=True)
        plain = sim.state
        sim.state = s0
        zero_counts()
        t = time.perf_counter()
        n = sim.isostasy_adjustment()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        got = launches()
        no_plain(f"isostasy {label}")
        if n != n_plain or n != nsteps:
            fail(f"isostasy {label}: {n} steps, the plain run {n_plain}, "
                 f"asked {nsteps}")
        want = {"cgather": 2 * n, "asm_gather": n, "asm_pack": 2 * n}
        if got != want:
            fail(f"isostasy {label}: band-kernel launches {got}, not {want}")
        worst, equal = held(f"isostasy {label}, {n} steps", sim.state,
                            plain)
        st = sim.state
        dz = float((st.coord - s0.coord)[:, -1].abs().max())
        if not (dz > 0 and bool(torch.isfinite(st.coord).all())):
            fail(f"isostasy {label}: the mesh did not move or is not finite")
        sim.state = s0
        set_iso_steps(sim, 3)
        prof = profiled(lambda: sim.isostasy_adjustment(), 3)
        r = {"nelem": sim.ctx.nelem, "init_s": init_s, "steps": n,
             "s": secs, "s_per_step": secs / n,
             "launches": got, "launches_per_step": {
                 k: v / n for k, v in got.items()},
             "max_err_kernels_vs_plain": worst, "equal_bit_for_bit": equal,
             "max_dz_m": dz, **prof}
        rec["isostasy"][label] = r
        print(f"  (a) isostasy {label}: {sim.ctx.nelem} elements, setup "
              f"{init_s:.1f} s; {n} steps in {secs:.3f} s ({secs / n:.4e} "
              f"s/step) on {card}; band-kernel launches per step "
              f"{r['launches_per_step']}, CUDA launches per step "
              f"{prof['cuda_launches_per_step']:.1f}, device idle "
              f"{prof['device_idle']:.1%}; kernels against plain versions "
              f"{'equal bit for bit' if equal else f'{worst:.3e}'}; max "
              f"vertical move {dz:.3e} m")
        sims[label] = (sim, s0)

    # (b) the body-force pre-relaxation, 2D at full width
    sim, s0 = sims.pop("2D, 277k triangles")
    sim.param.ic.has_body_force_adjustment = True
    sim.param.control.has_PT = True
    sim.param.control.PT_max_iter = 50
    sim.param.control.PT_relative_tolerance = 1e-3
    sim.state = s0
    k_plain = sim.body_force_adjustment(plain=True)
    plain = sim.state
    sim.state = s0
    zero_counts()
    t = time.perf_counter()
    k = sim.body_force_adjustment()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    got = launches()
    no_plain("body force 2D")
    reads = sim.prerelax_stats["host_syncs"]
    if k != k_plain or not 1 < k <= 50 or reads not in (k - 1, k):
        fail(f"body force 2D: {k} iterations ({k_plain} with the plain "
             f"versions), {reads} host reads")
    worst, equal = held(f"body force 2D, {k} iterations", sim.state, plain)
    rec["body_force_2d"] = {
        "nelem": sim.ctx.nelem, "iterations": k, "host_reads": reads,
        "s": secs, "s_per_iteration": secs / k, "launches": got,
        "launches_per_iteration": {n_: v / k for n_, v in got.items()},
        "max_err_kernels_vs_plain": worst, "equal_bit_for_bit": equal}
    print(f"  (b) body force 2D: {k} PT iterations in {secs:.3f} s "
          f"({secs / k:.4e} s each), {reads} host reads; launches "
          f"{got}; kernels against plain versions "
          f"{'equal bit for bit' if equal else f'{worst:.3e}'}")
    del sim, s0, plain

    # (c) the 3D generic step on the 680,794 tets, from the initial state
    sim, s0 = sims.pop("3D, 680,794 tets")
    sim.state = s0
    os.environ["DES_NO_FLAT"] = "1"
    try:
        run1 = sim._chunk_fn(1)
        if sim.step_path != "generic":
            fail(f"DES_NO_FLAT in 3D dispatched to {sim.step_path!r}")
        plain1 = flat3d.make_chunk_runner(sim.param, sim.ctx,
                                          sim.compensation_pressure, 1,
                                          plain=True, generic=True)
        a = run1(sim.ctx, s0)
        b = plain1(sim.ctx, s0)
        torch.cuda.synchronize()
        _, equal = held("generic 3D, one step", a, b)
        if not equal:
            fail("generic 3D: one step with the kernels is not the step "
                 "with the plain versions")
        del a, b
        chunk = 10
        sim.run_steps(chunk, chunk=chunk)
        torch.cuda.synchronize()
        zero_counts()
        chunk_s = []
        for _ in range(2):
            t = time.perf_counter()
            sim.run_steps(chunk, chunk=chunk)
            torch.cuda.synchronize()
            chunk_s.append(time.perf_counter() - t)
        got = launches()
        no_plain("generic 3D")
        n = 2 * chunk
        want = {k_: v * n for k_, v in flat3d_launches(sim.param).items()}
        if got != want:
            fail(f"generic 3D: band-kernel launches {got}, not {want}")
        if not all(bool(torch.isfinite(v).all()) for v in (
                sim.state.coord, sim.state.stress, sim.state.vel)):
            fail("generic 3D: non-finite values")
        prof = profiled(lambda: sim.run_steps(3, chunk=3), 3)
        rates = [sim.ctx.nelem * chunk / c for c in chunk_s]
    finally:
        del os.environ["DES_NO_FLAT"]
    rec["generic3d"] = {
        "nelem": sim.ctx.nelem, "chunk_s": chunk_s,
        "elem_steps_per_s": rates, "launches": got,
        "launches_per_step": {k_: v / n for k_, v in got.items()},
        "kernels_equal_plain_one_step": True, **prof}
    print(f"  (c) generic 3D: {sim.ctx.nelem} tets, one step with the "
          f"kernels equals the plain versions'; two chunks of {chunk} "
          f"steps in {chunk_s[0]:.3f} s and {chunk_s[1]:.3f} s, "
          f"{rates[0]:.4e} and {rates[1]:.4e} elem*steps/s on {card}; "
          f"band-kernel launches per step "
          f"{rec['generic3d']['launches_per_step']}, "
          f"CUDA launches per step {prof['cuda_launches_per_step']:.1f}, "
          f"device idle {prof['device_idle']:.1%}")
    del sim, s0, sims
    torch.cuda.empty_cache()

    # (d) test sizes, card against CPU
    with tempfile.TemporaryDirectory() as tmp:
        for label, cfg, what, no_flat in small_prerelax_cases(Path(tmp)):
            if no_flat:
                os.environ["DES_NO_FLAT"] = "1"
            try:
                out = {}
                for dev in ("cuda", "cpu"):
                    sim = des.Simulation(des.param_from_dict(cfg),
                                         device=dev)
                    if dev == "cuda":
                        zero_counts()
                    if isinstance(what, str):
                        count = getattr(sim, what)()
                    else:
                        count = what
                        sim.run_steps(what, chunk=what)
                    if dev == "cuda":
                        torch.cuda.synchronize()
                        got = launches()
                        path = sim.step_path
                    out[dev] = (sim.state, count)
            finally:
                os.environ.pop("DES_NO_FLAT", None)
            (sc, nc), (sp, np_) = out["cuda"], out["cpu"]
            if nc != np_ or not all(got.values()):
                fail(f"{label}: {nc} on the card, {np_} on the CPU, "
                     f"launches {got}")
            worst = 0.0
            for f in FLAT_FIELDS + ("dpressure",):
                x, y = getattr(sp, f), getattr(sc, f).cpu()
                scale = sp.stress if f == "dpressure" else x
                err = float((x.double() - y.double()).abs().max()
                            / scale.double().abs().max().clamp(min=1e-300))
                worst = max(worst, err)
                check(f"{label}, card vs CPU, {f}", err, 1e-10)
            rec["small"][label] = {"count": nc, "launches": got,
                                   "step_path": path, "max_err": worst}
            unit = ("PT iterations" if what == "body_force_adjustment"
                    else f"steps on {path}" if path else "steps")
            print(f"  (d) {label}: {nc} {unit}, card against CPU "
                  f"{worst:.3e}, launches {got}")

    # (e) the ep-remesh-2d golden's frames 0-2 on the card
    rundir = root / "tests" / "golden" / "runs" / "ep-remesh-2d"
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            Path("er.cfg").write_text(golden_cfg(rundir, "er")
                                      + "[sim]\nmax_steps = 5000\n")
            zero_counts()
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                sim = cli.run(des.load_config("er.cfg"), device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            got = launches()
            no_plain("ep-remesh-2d")
            nsteps = int(sim.state.steps)
            if sim.step_path != "generic" or sim.dtype != torch.float64 \
                    or nsteps != 5000:
                fail(f"ep-remesh-2d ran {nsteps} steps on "
                     f"{sim.step_path!r} in {sim.dtype}")
            if not all(got.values()):
                fail(f"ep-remesh-2d: band-kernel launches {got}")
            ref = OutputReader(str(rundir / "ref"))
            our = OutputReader("er")
            if our.frames != [0, 1, 2] or our.steps != ref.steps[:3]:
                fail(f"ep-remesh-2d: frames {our.frames} at steps "
                     f"{our.steps}")
            worst = []
            for frame in our.frames:
                old = _frame_quantities(ref, frame, include_markers=False)
                new = _frame_quantities(our, frame, include_markers=False)
                w = {}
                for kind, thr in ACCUM_KINDS.items():
                    if kind not in old:
                        continue
                    e = sum(reldiff(old[kind], new[kind]))
                    w[kind] = e
                    if not (np.isfinite(e) and e <= thr):
                        fail(f"ep-remesh-2d frame {frame} {kind}: {e:.3e} "
                             f"against the reference (limit {thr:g})")
                worst.append(w)
                print(f"  (e) ep-remesh-2d frame {frame} against the "
                      f"reference: " + ", ".join(
                          f"{k_} {e:.3e} (limit {ACCUM_KINDS[k_]:g})"
                          for k_, e in w.items()))
            rec["golden_ep_remesh_2d"] = {
                "nelem": sim.ctx.nelem, "steps": nsteps, "card_s": secs,
                "launches": got, "launches_per_step": {
                    k_: v / nsteps for k_, v in got.items()},
                "worst_by_frame": worst}
            print(f"  (e) ep-remesh-2d: {nsteps} generic float64 steps on "
                  f"{sim.ctx.nelem} triangles through the CLI in "
                  f"{secs:.1f} s; band-kernel launches per step "
                  f"{rec['golden_ep_remesh_2d']['launches_per_step']}")
            del sim
        finally:
            os.chdir(cwd)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 16: {rec['phase_s']:.1f} s")
    return rec


# phase 17: the registry's in-repo models (dynearthsol_tpu_torch/models)
# with the steps each runs for and the output interval (also the averaging
# window, quality_check_step_interval: an averaged frame is written only
# at its multiples); the path the JAX package takes for each
REGISTRY_RUNS = (("rifting-2d", 60, 30, "grid2d"),
                 ("production-rifting-2d", 60, 30, "grid2d"),
                 ("oblique-rift-3d", 12, 6, "grid3d"),
                 ("production-rifting-3d", 12, 6, "grid3d"))


def models_on_card(des, wrappers, zero_counts, card, check, rel):
    """Phase 17: the registry's models and their output on the card.  (a)
    Each of the four in-repo models at its default, full width, through
    the CLI's run() with averaged frames (only max_steps and the output
    interval set): its step path, elem*steps/s (the CLI's Compute, and a
    timed chunk after), CUDA launches per step, host set-up seconds and
    seconds per frame; one step on the card against one on the CPU from
    the run's last state, at phase 15's EVP rule (coord, temperature,
    strain and plstrain within 2e-6 of each field's max; an element whose
    stress differs by more than 2e-6 of the max must be at visc_max on
    both sides: the min-select's ties).  (b) The last frame of each:
    to_vtk with principal stress, melting and heat flux, and to_vtp,
    timed; the derived fields on the card against the CPU within 1e-12 of
    each result's max (3D s1/s3 by length, and up to sign where the
    eigenvalue is apart from its neighbour by more than 1e-2 of the
    largest, within 1e-12 of the frame's largest |principal stress|: they
    are differences of eigenvalues of that size; and the same error
    within 5e-12 of the largest s1/s3 length), with their card ms.  (c)
    freeair and bouguer at 512 points
    over rifting-2d's last frame, card against CPU within 1e-12.  (d)
    VTKHDF: with h5py, a frame written and read back through OutputReader;
    without, the Output refusal and the CLI's, before the set-up, naming
    h5py.  Returns the numbers for the JSON record."""
    import contextlib
    import io
    import os
    import re
    import tempfile
    from types import SimpleNamespace

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dynearthsol_tpu_torch import __main__ as cli
    from dynearthsol_tpu_torch import models, postproc
    from dynearthsol_tpu_torch import simulation as sim_mod
    from dynearthsol_tpu_torch.io.output import Output
    from dynearthsol_tpu_torch.ops import matprops as M
    from dynearthsol_tpu_torch.state import FIELD_NAMES, State
    from dynearthsol_tpu_torch.utils import gravity

    t_phase = time.perf_counter()
    rec = {"models": {}}
    print("phase 17 the registry's models at full width, their frames and "
          "their post-processing on the card")

    def sync():
        torch.cuda.synchronize()

    def timed(fn, *a, **k):
        """(fn(*a, **k), seconds), synchronised."""
        sync()
        t = time.perf_counter()
        out = fn(*a, **k)
        sync()
        return out, time.perf_counter() - t

    def cpu_step(sim, state):
        """One step of sim's config on the CPU from ``state``: a step
        context of the same mesh on the CPU and the dispatch's runner."""
        cpu = SimpleNamespace(
            param=sim.param, topo=sim.topo, device=torch.device("cpu"),
            compensation_pressure=sim.compensation_pressure, _chunk_fns={},
            step_path=None, ctx=sim_mod.make_step_ctx(
                sim.param, sim.topo, "cpu", M.MatTables.from_param(
                    sim.param.mat, dtype=sim.dtype, device="cpu"),
                sim.ctx.max_vbc_val, sim.ctx.sgrid, sim.mesh.coord))
        run1 = sim_mod.Simulation._chunk_fn(cpu, 1)
        out = run1(cpu.ctx, State(**{f: getattr(state, f).cpu()
                                     for f in FIELD_NAMES}))
        return out, cpu.step_path

    def evp_rule(label, ker, ref, vmax):
        """phase 15's EVP rule, card ``ker`` against CPU ``ref``."""
        errs = {}
        for f in ("coord", "temperature", "strain", "plstrain"):
            errs[f] = rel(getattr(ref, f), getattr(ker, f).cpu())
            check(f"{label}, card vs CPU, {f}", errs[f], 2e-6)
        d = ((ker.stress.cpu().double() - ref.stress.double()).abs()
             .max(1).values / ref.stress.double().abs().max())
        over = d > 2e-6
        cold = (ker.viscosity.cpu() == vmax) & (ref.viscosity == vmax)
        for f in ("vel", "force", "stress"):
            errs[f] = rel(getattr(ref, f), getattr(ker, f).cpu())
        errs["stress_elements_over_2e-6"] = int(over.sum())
        errs["of_them_at_visc_max"] = int((over & cold).sum())
        print(f"  {label}, card vs CPU: stress {errs['stress']:.3e} of its "
              f"max, {int(over.sum())} of {d.numel()} elements over 2e-6, "
              f"{int((over & cold).sum())} of them at visc_max on both "
              f"sides; not gated: velocity {errs['vel']:.3e}, force "
              f"{errs['force']:.3e}")
        if bool((over & ~cold).any()):
            fail(f"{label}: {int((over & ~cold).sum())} elements below "
                 f"visc_max differ by more than 2e-6 in stress")
        return errs

    def profiled(fn, steps):
        """CUDA launches, device busy us and wall us per step of fn()
        under the profiler, and the device's idle share."""
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as pr:
            t0 = time.perf_counter()
            fn()
            sync()
            wall = (time.perf_counter() - t0) * 1e6 / steps
        ev = [e for e in pr.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in ev) / steps
        return {"cuda_launches_per_step": len(ev) / steps,
                "busy_us_per_step": busy, "wall_us_per_step": wall,
                "device_idle": max(0.0, 1 - busy / wall)}

    def derived(label, r, frame):
        """The derived fields of ``frame``, card against CPU, with their
        card ms (the second of two calls)."""
        get = {n: r.read_field(frame, n) for n in (
            "coordinate", "connectivity", "temperature", "material",
            "bcflag", "stress")}
        coord, conn = get["coordinate"], get["connectivity"]
        out, ms = {}, {}
        fns = {
            "principal stress": lambda d: postproc.compute_principal_stress(
                get["stress"], device=d),
            "heat flux": lambda d: postproc.compute_heat_flux(
                coord, conn, get["temperature"], device=d),
            "melting": lambda d: (postproc.compute_melting(
                coord, conn, get["temperature"], get["material"],
                get["bcflag"], device=d),)}
        for nm, fn in fns.items():
            fn("cuda")
            card_v, s = timed(fn, "cuda")
            ms[nm] = s * 1e3
            cpu_v = fn("cpu")
            card_v = [v.cpu() for v in card_v]
            if nm == "principal stress" and r.ndims == 3:
                st = torch.as_tensor(get["stress"])
                m = torch.zeros((len(st), 3, 3), dtype=torch.float64)
                i, j = [0, 1, 2, 0, 1, 0, 2, 1, 2], [0, 1, 2, 1, 0, 2, 0, 2, 1]
                m[:, i, j] = st[:, [0, 1, 2, 3, 3, 4, 4, 5, 5]]
                w = torch.linalg.eigvalsh(m)
                scale = w.abs().max(1).values
                # the deviatoric parts are differences of eigenvalues as
                # large as the pressure: their rounding is at its scale
                top = float(scale.max())
                worst, of_len, nclear = 0.0, 0.0, []
                for k, (x, y) in enumerate(zip(cpu_v, card_v)):
                    lx, ly = x.norm(dim=1), y.norm(dim=1)
                    gap = w[:, 2] - w[:, 1] if k else w[:, 1] - w[:, 0]
                    clear = gap > 1e-2 * scale
                    d = torch.minimum((x - y).abs().max(1).values,
                                      (x + y).abs().max(1).values)
                    e = max(float((lx - ly).abs().max()),
                            float((d * clear).max()))
                    worst = max(worst, e / top)
                    of_len = max(of_len, e / float(lx.max()))
                    nclear.append(int(clear.sum()))
                out[nm] = worst
                out["principal stress, of the largest s1/s3 length"] = of_len
                out["principal stress, elements held up to sign (s1, s3)"] \
                    = nclear
            elif nm == "heat flux":
                out[nm] = max(rel(cpu_v[0], card_v[0]),
                              rel(cpu_v[1], card_v[1]))
            else:
                out[nm] = max(rel(x, y) for x, y in zip(cpu_v, card_v))
            check(f"{label} {nm}", out[nm], 1e-12)
            if nm == "principal stress" and r.ndims == 3:
                # by length too, so that a wrong eigenvector of a small
                # deviator cannot hide behind the pressure's scale: the
                # H100 read 8.0e-13 and 2.1e-13 here
                check(f"{label} {nm}, of the largest s1/s3 length",
                      of_len, 5e-12)
        return out, ms

    cwd = os.getcwd()
    tmpdir = tempfile.TemporaryDirectory()
    os.chdir(tmpdir.name)
    try:
        for name, nsteps, every, want_path in REGISTRY_RUNS:
            p = models.REGISTRY[name]()
            p.sim.modelname = name
            p.sim.max_steps = nsteps
            p.sim.output_step_interval = every
            p.mesh.quality_check_step_interval = every
            setup = []

            def timed_sim(*a, **k):
                sim, s = timed(sim_mod.Simulation, *a, **k)
                setup.append(s)
                return sim

            zero_counts()
            buf = io.StringIO()
            cli.Simulation = timed_sim
            try:
                with contextlib.redirect_stdout(buf):
                    sim, wall = timed(cli.run, p, device="cuda")
            finally:
                cli.Simulation = sim_mod.Simulation
            got = {n: w.launches for n, w in wrappers.items()}
            text = buf.getvalue()
            comp = re.search(r"Compute:\s+([\d.]+) s / (\d+) steps", text)
            outl = re.search(r"Output:\s+([\d.]+) s / (\d+) frames", text)
            nelem = sim.topo.nelem
            r = postproc.OutputReader(name)
            if (sim.step_path != want_path or any(got.values())
                    or int(comp[2]) != nsteps or r.frames != [0, 1, 2]
                    or not r.has_field(2, "stress averaged")
                    or not r.has_field(2, "velocity averaged")):
                fail(f"{name}: path {sim.step_path!r} (the JAX package "
                     f"takes {want_path}), launches {got}, "
                     f"{comp and comp[2]} steps, frames {r.frames}")
            for f in FIELD_NAMES:
                v = getattr(sim.state, f)
                if v.is_floating_point() and not bool(torch.isfinite(v)
                                                      .all()):
                    fail(f"{name}: non-finite values in {f}")
            compute_s, out_s = float(comp[1]), float(outl[1])
            m = {"nelem": nelem, "nnode": sim.topo.nnode,
                 "markers": sim.markers.n if sim.markers else 0,
                 "step_path": sim.step_path, "steps": nsteps,
                 "frames": r.frames, "setup_s": setup[0], "run_s": wall,
                 "compute_s": compute_s,
                 "elem_steps_per_s_cli": nelem * nsteps / compute_s,
                 "output_s": out_s, "frames_timed": int(outl[2]),
                 "s_per_frame": out_s / int(outl[2]),
                 "launches": got}

            # one step card against CPU from the run's last state
            s = sim.state
            ker = sim._chunk_fn(1)(sim.ctx, s)
            sync()
            ref, cpu_path = cpu_step(sim, s)
            if cpu_path != want_path:
                fail(f"{name}: the CPU took {cpu_path!r}")
            m["card_vs_cpu_one_step"] = evp_rule(
                f"{name}, one step", ker, ref, sim.param.mat.visc_max)
            del ker, ref

            # launches per step and a timed chunk after the run
            k = 20 if sim.topo.ndims == 2 else 5
            m.update(profiled(lambda: sim.run_steps(2, chunk=2), 2))
            _, chunk_s = timed(sim.run_steps, k, chunk=k)
            m["elem_steps_per_s"] = nelem * k / chunk_s
            print(f"  (a) {name}: {nelem} elements, {m['markers']} "
                  f"markers, on {sim.step_path} (the JAX package's path); "
                  f"set-up {setup[0]:.1f} s, {nsteps} steps through the "
                  f"CLI, Compute {compute_s:.2f} s = "
                  f"{m['elem_steps_per_s_cli']:.4e} elem*steps/s, a "
                  f"{k}-step chunk after: {m['elem_steps_per_s']:.4e} "
                  f"elem*steps/s on {card}; "
                  f"{m['cuda_launches_per_step']:.1f} CUDA launches per "
                  f"step, none of a hand-written kernel, device idle "
                  f"{m['device_idle']:.1%}; frames "
                  f"{r.frames}, {m['s_per_frame']:.2f} s per averaged "
                  f"frame")
            del sim, s
            torch.cuda.empty_cache()

            # (b) post-processing of the last frame
            frame = r.frames[-1]
            vtk, m["to_vtk_s"] = timed(postproc.to_vtk, name, frame,
                                       principal=True, melting=True,
                                       heatflux=True, device="cuda")
            vtp, m["to_vtp_s"] = timed(postproc.to_vtp, name, frame)
            m["vtk_bytes"] = os.path.getsize(vtk)
            m["vtp_bytes"] = os.path.getsize(vtp)
            m["derived_card_vs_cpu"], m["derived_ms"] = derived(
                f"(b) {name} frame {frame}", r, frame)
            print(f"  (b) {name} frame {frame}: to_vtk {m['to_vtk_s']:.1f} "
                  f"s ({m['vtk_bytes'] / 1e6:.0f} MB), to_vtp "
                  f"{m['to_vtp_s']:.1f} s ({m['vtp_bytes'] / 1e6:.0f} MB); "
                  f"derived fields on {card}: " + ", ".join(
                      f"{k_} {v:.2f} ms" for k_, v in m["derived_ms"].items()))
            if name == "rifting-2d":
                # (c) gravity over this frame
                coord = r.read_field(frame, "coordinate")
                conn = r.read_field(frame, "connectivity")
                rho = r.read_field(frame, "density")
                pts = np.column_stack([
                    np.linspace(coord[:, 0].min(), coord[:, 0].max(), 512),
                    np.full(512, coord[:, 1].max() + 1e3)])
                g = {}
                for fn in (gravity.freeair, gravity.bouguer):
                    fn(pts, coord, conn, rho, device="cuda")
                    a, s_ = timed(fn, pts, coord, conn, rho, device="cuda")
                    b = fn(pts, coord, conn, rho, device="cpu")
                    g[fn.__name__] = {"card_ms": s_ * 1e3,
                                      "card_vs_cpu": rel(b, a.cpu())}
                    check(f"(c) {fn.__name__} at 512 points over "
                          f"{len(conn)} triangles, card vs CPU",
                          g[fn.__name__]["card_vs_cpu"], 1e-12)
                rec["gravity"] = g
                print(f"  (c) freeair {g['freeair']['card_ms']:.1f} ms, "
                      f"bouguer {g['bouguer']['card_ms']:.1f} ms on {card}")
            for fn in os.listdir("."):
                os.remove(fn)
            rec["models"][name] = m

        # (d) VTKHDF, a 32 x 16-cell rifting-2d
        p = models.rifting_2d(32, 16)
        p.sim.modelname = "h5"
        p.sim.output_format = "vtkhdf"
        try:
            import h5py  # noqa: F401
            have = True
        except ImportError:
            have = False
        if have:
            sim = des.Simulation(p, device="cuda")
            sim.run_steps(2)
            Output(p).write_exact(sim)
            r = postproc.OutputReader("h5")
            errs = {nm: rel(getattr(sim.state, f).cpu(),
                            torch.as_tensor(r.read_field(0, nm)))
                    for nm, f in (("coordinate", "coord"),
                                  ("stress", "stress"))}
            if r.format != "hdf5" or any(errs.values()):
                fail(f"(d) VTKHDF read back as {r.format}: {errs}")
            rec["vtkhdf"] = "written and read back"
        else:
            msgs = []
            for call in (lambda: Output(p),
                         lambda: cli.run(p, device="cuda")):
                cli.Simulation = None  # the refusal comes before set-up
                try:
                    call()
                    fail("(d) output_format = vtkhdf without h5py was "
                         "not refused")
                except ImportError as e:
                    msgs.append(str(e))
                finally:
                    cli.Simulation = sim_mod.Simulation
            if not all("h5py" in s_ for s_ in msgs) or os.listdir("."):
                fail(f"(d) the refusals {msgs} do not name h5py, or files "
                     f"{os.listdir('.')} were written")
            rec["vtkhdf"] = "refused: " + msgs[0]
        print(f"  (d) VTKHDF: {rec['vtkhdf']}")
    finally:
        os.chdir(cwd)
        tmpdir.cleanup()
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 17: {rec['phase_s']:.1f} s")
    return rec


# phase 18: multi-device stepping (dynearthsol_tpu_torch/parallel)
def halo_on_card(des, wrappers, zero_counts, card, check, rel, umesh):
    """Phase 18: the node-sharded halo step (parallel/halo_step.py) on the
    card, held against the port's single-device generic step from one
    state (the card's machine has no JAX): (a) the flagship-unstructured
    mesh (phase 9's 277,258 triangles, reused), float64, 4 shards on
    cuda:0: maxwell over 10 steps and EVP's first step at 1e-12 of each
    field's max over tests/test_halo.py's fields, EVP's next 9 steps at
    ``evp_rule`` (every field gated); the overlap rows of neighbours equal bit for bit, h, B,
    W and the nodal bytes per shard; (b) production (the 512 x 256-cell
    raster, Winkler, water, surface process 1, two materials; maxwell),
    float64, 4 shards, 10 steps, at 1e-9; (c) in float32 on
    (a)'s mesh at 1, 2 and 4 shards and on one device: elem*steps/s, the
    band-kernel launches per shard per step, host ms per collective, the
    device's idle share (torch.profiler, the union of the kernels' time
    on all streams); (d) cgather and asm_pack on a shard's window tables
    against their plain versions at each k of the generic step, tolerance
    0; (e) the 3D halo step at test size (3,542 tets, 2 shards) on the
    card against the same on the CPU at 1e-10; (f) the CLI with
    DES_N_DEVICES=2 through a remesh (one card: one shard), its frames
    against the single-device CLI's at 1e-9; (g) with two cards or more,
    (a) with one shard per card.  Returns the numbers for the JSON
    record."""
    import contextlib
    import io
    import os
    import tempfile
    from dataclasses import fields, replace

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from types import SimpleNamespace

    from dynearthsol_tpu_torch import __main__ as cli
    from dynearthsol_tpu_torch import simulation as sim_mod
    from dynearthsol_tpu_torch.config import RH_MAXWELL
    from dynearthsol_tpu_torch.ops import band2d, flat2d
    from dynearthsol_tpu_torch.parallel import ShardGroup
    from dynearthsol_tpu_torch.parallel import halo_step as H
    from torch_cases import (HALO_FIELDS, assert_frames_close, flat3d_cfg,
                             write_cfg)

    t_phase = time.perf_counter()
    band = ("cgather", "asm_pack", "asm_gather")
    rec = {}
    print("phase 18 multi-device stepping: the node-sharded halo step")

    def launches():
        return {n: wrappers[n].launches for n in band}

    def no_plain(label):
        if band2d.gather_corners.calls or band2d.scatter_corners.calls:
            fail(f"{label}: the main path took a plain version")

    def build(cfg, mesh=None):
        mesher = sim_mod.create_new_mesh
        if mesh is not None:
            sim_mod.create_new_mesh = lambda param: mesh
        try:
            t = time.perf_counter()
            sim = des.Simulation(des.param_from_dict(cfg))
            torch.cuda.synchronize()
            return sim, time.perf_counter() - t
        finally:
            sim_mod.create_new_mesh = mesher

    def single_runner(sim, n):
        ctx = replace(sim.ctx, band=band2d.build_tables(
            sim.topo.connectivity, sim.topo.nnode, sim.device))
        run = flat2d.make_chunk_runner(sim.param, ctx,
                                       sim.compensation_pressure, n,
                                       generic=True)
        return lambda s: run(ctx, s)

    def nodal_names(sim, plan):
        return [f.name for f in fields(sim.state)
                if H._field_kind(sim.state, f.name, plan) == "nodal"]

    def overlaps_equal(st, plan, names):
        h2 = 2 * plan.h
        return all(torch.equal(getattr(st[d], f)[plan.width - h2:],
                               getattr(st[d + 1], f)[:h2])
                   for d in range(len(st) - 1) for f in names)

    failed = []   # the gates missed: the phase fails after printing all

    def gated(label, err, tol):
        if not check(label, err, tol, stop=False):
            failed.append(label)

    def strict(tol, extra=()):
        """Every field of tests/test_halo.py's list (and ``extra``) within
        ``tol`` of its max, but the viscosity, within 1e-9: a power of the
        strain-rate invariant, which cancellation leaves ill-conditioned
        where the strain rate is small against the velocities (at full
        width 4e-10 of the max apart after 20 maxwell steps whose stress
        agrees to 5e-16)."""
        def gate(label, ref, out):
            errs = {f: rel(getattr(ref, f).cpu(), getattr(out, f).cpu())
                    for f in HALO_FIELDS + tuple(extra)}
            for f, e in errs.items():
                gated(f"{label}, halo vs one device, {f}", e,
                      max(tol, 1e-9) if f == "viscosity" else tol)
            return errs
        gate.rule = (f"every field within {tol:.0e} of its max, the "
                     f"viscosity within {max(tol, 1e-9):.0e}")
        return gate

    def evp_rule(label, ref, out):
        """EVP after its min-select has met ties: a regrouped overlap sum
        (an ulp) can send an element whose viscous and plastic trials tie
        to the other branch, and dynamic relaxation spreads the jump to the
        velocity and stress.  The integrated fields (coord, temperature,
        strain, plastic strain), the mass and the scalars stay within 1e-9
        of their max; the velocity and the stress within 1e-8 (2.8e-10 and
        8.7e-10 after 10 steps, 3.1e-10 and 4.9e-10 after 20, on the
        H100); the viscosity may differ in at most 5 % of the elements
        (0.95 % after 10 steps, 1.7 % after 20)."""
        errs = {}
        for f in ("coord", "temperature", "strain", "plstrain", "mass",
                  "dt", "time", "l2_residual", "max_global_vel_mag"):
            errs[f] = rel(getattr(ref, f).cpu(), getattr(out, f).cpu())
            gated(f"{label}, halo vs one device, {f}", errs[f], 1e-9)
        for f in ("vel", "stress"):
            errs[f] = rel(getattr(ref, f).cpu(), getattr(out, f).cpu())
            gated(f"{label}, halo vs one device, {f}", errs[f], 1e-8)
        errs["viscosity"] = rel(ref.viscosity.cpu(), out.viscosity.cpu())
        differs = int((ref.viscosity != out.viscosity).sum())
        errs["elements_viscosity_differs"] = differs
        gated(f"{label}, halo vs one device, share of elements whose "
              "viscosity differs", differs / ref.viscosity.numel(), 0.05)
        print(f"  {label}: viscosity {errs['viscosity']:.3e} of its max "
              f"(not gated); it differs in {differs} of "
              f"{ref.viscosity.numel()} elements")
        return errs
    evp_rule.rule = ("coord, temperature, strain, plstrain, mass and the "
                     "scalars within 1e-9 of their max, velocity and stress "
                     "within 1e-8, the viscosity differing in at most 5 % "
                     "of the elements")

    kept = []   # the last run's shard contexts: (d) reuses (a)'s

    def halo_vs_single(label, sim, devices, legs):
        """The halo step on ``devices`` against the single-device generic
        step from sim.state, leg by leg: ``legs`` is [(steps, gate), ...],
        each gate applied after its leg (overlap rows and scalars equal bit
        for bit after each); the record of the run."""
        s0 = sim.state
        ctx1 = replace(sim.ctx, band=band2d.build_tables(
            sim.topo.connectivity, sim.topo.nnode, sim.device))
        step1 = flat2d.make_flat_step(sim.param, ctx1,
                                      sim.compensation_pressure,
                                      generic=True)
        g = flat2d.state_to_flat(s0)
        group = ShardGroup(devices)
        t = time.perf_counter()
        ctx_sh, st, run_chunk, plan = H.make_halo_runner(sim, group)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t
        names = nodal_names(sim, plan)
        group.reset_stats()
        secs, n, errs = 0.0, 0, []
        got = dict.fromkeys(band, 0)
        for k, gate in legs:
            for _ in range(k):
                g = step1(ctx1, g)
            torch.cuda.synchronize()
            zero_counts()
            t = time.perf_counter()
            st = run_chunk(ctx_sh, st, k)
            torch.cuda.synchronize()
            secs += time.perf_counter() - t
            n += k
            got = {b: got[b] + v for b, v in launches().items()}
            no_plain(label)
            if not overlaps_equal(st, plan, names):
                fail(f"{label}: an overlap row differs between neighbours")
            for f in ("dt", "time", "steps", "l2_residual",
                      "max_global_vel_mag"):
                if not all(torch.equal(getattr(st[0], f).cpu(),
                                       getattr(x, f).cpu()) for x in st[1:]):
                    fail(f"{label}: {f} differs between shards")
            errs.append({"after_steps": n, "rule": gate.rule,
                         **gate(f"{label}, {n} step(s)",
                                flat2d.flat_to_state(g),
                                H.unpack_state(st, plan, s0))})
        if got["asm_pack"] == 0 or got["cgather"] == 0:
            fail(f"{label}: the band kernels were not launched: {got}")
        whole = sum(getattr(s0, f).nbytes for f in names)
        part = [sum(getattr(x, f).nbytes for f in names) for x in st]
        kept.append(ctx_sh)
        r = {"nelem": sim.ctx.nelem, "nnode": sim.ctx.nnode,
             "shards": len(devices), "devices": [str(d) for d in devices],
             "h": plan.h, "block": plan.block, "width": plan.width,
             "elems_per_shard": [plan.n_elems(d) for d in range(plan.ndev)],
             "nodal_bytes_per_shard": part, "nodal_bytes_one_device": whole,
             "steps": n, "s": secs, "setup_s": setup_s,
             "launches": got,
             "collectives_per_shard_per_step":
                 group.stats[0]["collectives"] / n,
             "host_ms_per_collective": group.host_ms_per_collective(),
             "errors": errs, "overlap_rows_equal": True,
             "scalars_equal": True}
        print(f"  {label}: {r['nelem']} elements on {len(devices)} shards "
              f"of {sorted(set(r['devices']))}; h {plan.h}, B {plan.block}, "
              f"W {plan.width}; elements per shard {r['elems_per_shard']}; "
              f"nodal bytes per shard {part} against {whole} on one device; "
              f"{n} steps in {secs:.3f} s (set-up {setup_s:.1f} s) on "
              f"{card}; launches {got}; "
              f"{r['collectives_per_shard_per_step']:.1f} collectives per "
              f"shard per step, {r['host_ms_per_collective']:.3f} host ms "
              f"each; overlap rows and scalars equal bit for bit")
        return r

    def stand_in(sim, rheology):
        """``sim`` with another rheology on the same mesh and state."""
        p = replace(sim.param, mat=replace(sim.param.mat,
                                           rheol_type=rheology))
        return SimpleNamespace(param=p, ctx=sim.ctx, state=sim.state,
                               device=sim.device, dtype=sim.dtype,
                               topo=sim.topo, compensation_pressure=sim
                               .compensation_pressure)

    # (a) full width, the flagship-unstructured mesh, f64, 4 shards:
    # maxwell over 10 steps and EVP's first step at 1e-12, EVP over 9
    # more at the EVP rule
    cfg = unstructured_cfg()
    cfg["sim"]["float_dtype"] = "float64"
    usim, uinit = build(cfg, umesh)
    four = [torch.device("cuda", 0)] * 4
    rec["unstructured_f64_maxwell"] = halo_vs_single(
        "(a) flagship-unstructured f64 maxwell", stand_in(usim, RH_MAXWELL),
        four, [(10, strict(1e-12))])
    rec["unstructured_f64_evp"] = halo_vs_single(
        "(a) flagship-unstructured f64 EVP", usim, four,
        [(1, strict(1e-12)), (9, evp_rule)])
    rec["unstructured_f64_evp"]["init_s"] = uinit
    launches_halo = dict(rec["unstructured_f64_maxwell"]["launches"])

    # (d) the band kernels on a shard's window tables: (a)'s
    bt = kept[0][1].band
    dwin = {}
    gen = torch.Generator(device="cuda").manual_seed(18)
    for dtype in (torch.float32, torch.float64):
        for name, ks in (("cgather", (6, 2, 1)), ("asm_pack", (5, 2, 1))):
            for k in ks:
                if name == "cgather":
                    x = torch.randn((bt.nnode, k), dtype=dtype,
                                    device="cuda", generator=gen)
                    fn, ref_fn = band2d.cgather, band2d.gather_corners
                else:
                    x = torch.randn((k, bt.npe, bt.nelem), dtype=dtype,
                                    device="cuda", generator=gen)
                    fn, ref_fn = band2d.asm_pack, band2d.scatter_corners
                got = fn(x, bt)
                want = ref_fn(x, bt)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"(d) {name} k={k} {dtype} on shard 1's window "
                         f"differs from its plain version")
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(20):
                    fn(x, bt)
                t1.record()
                torch.cuda.synchronize()
                dwin[f"{name} k={k} {str(dtype)[6:]}"] = \
                    t0.elapsed_time(t1) / 20
    rec["window_kernels"] = {"shard": 1, "nnode": bt.nnode,
                             "nelem": bt.nelem, "win_rows": bt.win_rows,
                             "ms_issued_from_python": dwin,
                             "equal_to_plain": True}
    print(f"  (d) cgather and asm_pack on shard 1's window ({bt.nelem} "
          f"elements, {bt.nnode} rows, widest staged tile {bt.win_rows}): "
          f"equal to their plain versions bit for bit at every k, f32 and "
          f"f64; ms per call issued from Python on {card}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in dwin.items()))
    # (g) one shard per card, where there are cards enough
    ncards = torch.cuda.device_count()
    if ncards >= 2:
        devs = [torch.device("cuda", i) for i in range(min(4, ncards))]
        rec["one_shard_per_card"] = halo_vs_single(
            "(g) flagship-unstructured f64 maxwell, one shard per card",
            stand_in(usim, RH_MAXWELL), devs, [(10, strict(1e-12))])
    else:
        rec["one_shard_per_card"] = None
        print(f"  (g) not run: {ncards} card visible, one shard "
              f"per card needs two or more")

    del kept[:], usim
    torch.cuda.empty_cache()

    # (b) production at full width, f64 maxwell, 4 shards
    cfg = production_cfg("maxwell")
    cfg["sim"]["float_dtype"] = "float64"
    psim, pinit = build(cfg)
    rec["production_f64"] = halo_vs_single(
        "(b) production f64 maxwell", psim, four,
        [(10, strict(1e-9, ("dhacc", "edvacc_surf")))])
    rec["production_f64"]["init_s"] = pinit
    del psim
    torch.cuda.empty_cache()

    # (c) rates in f32 on (a)'s mesh at 1, 2, 4 shards and on one device
    def idle_share(fn, steps):
        """Device busy (the union of the kernels' intervals on all
        streams) against the wall, per step."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
        iv = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
        busy, end = 0.0, None
        for a, b in iv:
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return {"wall_us_per_step": wall / steps,
                "busy_us_per_step": busy / steps,
                "cuda_launches_per_step": len(iv) / steps,
                "device_idle": max(0.0, 1 - busy / wall) if wall else 0.0}

    fsim, finit = build(unstructured_cfg(), umesh)
    ne = fsim.ctx.nelem
    nt = 10
    rates = {}
    one = single_runner(fsim, nt)
    one(fsim.state)
    torch.cuda.synchronize()
    zero_counts()
    t = time.perf_counter()
    one(fsim.state)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    rates["one device"] = {
        "elem_steps_per_s": ne * nt / secs, "launches_per_step": {
            k: v / nt for k, v in launches().items()},
        **idle_share(lambda: one(fsim.state), nt)}
    for n in (1, 2, 4):
        group = ShardGroup([torch.device("cuda", 0)] * n)
        ctx_sh, st, run_chunk, plan = H.make_halo_runner(fsim, group)
        run_chunk(ctx_sh, st, 2)
        torch.cuda.synchronize()
        zero_counts()
        group.reset_stats()
        t = time.perf_counter()
        run_chunk(ctx_sh, st, nt)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        no_plain(f"(c) {n} shards")
        rates[f"{n} shards"] = {
            "elem_steps_per_s": ne * nt / secs,
            "band_launches_per_shard_per_step": {
                k: v / (n * nt) for k, v in launches().items()},
            "collectives_per_shard_per_step":
                group.stats[0]["collectives"] / nt,
            "host_ms_per_collective": group.host_ms_per_collective(),
            **idle_share(lambda: run_chunk(ctx_sh, st, nt), nt)}
        del ctx_sh, st, run_chunk, group
    rec["rates_f32"] = {"nelem": ne, "steps": nt, "init_s": finit,
                        "by_layout": rates}
    for lay, r in rates.items():
        extra = (f", band-kernel launches per shard per step "
                 f"{r['band_launches_per_shard_per_step']}, "
                 f"{r['collectives_per_shard_per_step']:.1f} collectives "
                 f"per shard per step at {r['host_ms_per_collective']:.3f} "
                 f"host ms" if "shards" in lay else
                 f", band-kernel launches per step {r['launches_per_step']}")
        print(f"  (c) f32 {lay}: {r['elem_steps_per_s']:.6e} elem*steps/s "
              f"on {card}{extra}; {r['cuda_launches_per_step']:.1f} CUDA "
              f"launches per step, device idle {r['device_idle']:.1%}")
    del fsim, one
    torch.cuda.empty_cache()

    # (e) 3D at test size: the card against the CPU, 2 shards
    par = des.param_from_dict(flat3d_cfg(mesh={"xlength": 32e3}))
    outs = {}
    for where in ("cuda:0", "cpu"):
        sim = des.Simulation(par, device=where)
        group = ShardGroup([where] * 2)
        zero_counts()
        ctx_sh, st, run_chunk, plan = H.make_halo_runner(sim, group)
        st = run_chunk(ctx_sh, st, 10)
        torch.cuda.synchronize()
        if where != "cpu":
            got3 = launches()
            no_plain("(e) 3D halo")
            if not overlaps_equal(st, plan, nodal_names(sim, plan)):
                fail("(e) 3D: an overlap row differs between neighbours")
        outs[where] = H.unpack_state(st, plan, sim.state, device="cpu")
    worst3 = 0.0
    for f in HALO_FIELDS:
        err = rel(getattr(outs["cpu"], f), getattr(outs["cuda:0"], f))
        worst3 = max(worst3, err)
        gated(f"(e) 3D halo 2 shards, card vs CPU, {f}", err, 1e-10)
    rec["box3d_card_vs_cpu"] = {"nelem": sim.ctx.nelem, "shards": 2,
                                "steps": 10, "launches": got3,
                                "max_err": worst3, "tol": 1e-10}
    print(f"  (e) 3D halo step, {sim.ctx.nelem} tets on 2 shards, 10 steps: "
          f"card against CPU {worst3:.3e} (tol 1e-10), launches {got3}")

    # (f) the CLI with DES_N_DEVICES=2 through a remesh
    cfg = {
        "sim": {"modelname": "run", "max_steps": 40,
                "output_step_interval": 20,
                "checkpoint_frame_interval": 1000000,
                "is_outputting_averaged_fields": False},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 0,
                 "xlength": 128e3, "ylength": 0, "zlength": 8e3,
                 "resolution": 1e3, "quality_check_step_interval": 25,
                 "remeshing_option": 1, "max_boundary_distortion": 1e-6},
        "markers": {"markers_per_element": 4, "random_seed": 7},
        "control": {"gravity": 10, "inertial_scaling": 1e5,
                    "has_thermal_diffusion": True, "damping_option": 1},
        "bc": {"vbc_x0": 1, "vbc_val_x0": -1e-9, "vbc_x1": 1,
               "vbc_val_x1": 1e-9, "vbc_z0": 0, "vbc_z1": 0,
               "surface_temperature": 273, "mantle_temperature": 1600},
        "mat": {"rheology_type": "elasto-visco-plastic", "rho0": [2800],
                "bulk_modulus": [50e9], "shear_modulus": [30e9],
                "max_viscosity": 1e24, "min_viscosity": 1e19}}
    cwd = os.getcwd()
    said = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for tag in ("single", "multi"):
                d = Path(tmp) / tag
                d.mkdir()
                os.chdir(d)
                write_cfg("case.cfg", cfg)
                os.environ.pop("DES_N_DEVICES", None)
                if tag == "multi":
                    os.environ["DES_N_DEVICES"] = "2"
                zero_counts()
                buf = io.StringIO()
                t = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    cli.run(des.load_config("case.cfg"))
                torch.cuda.synchronize()
                said[tag] = (buf.getvalue(), time.perf_counter() - t,
                             launches())
        finally:
            os.environ.pop("DES_N_DEVICES", None)
            os.chdir(cwd)
        line = "Multi-chip: node-sharded halo step on 2 devices."
        if line not in said["multi"][0] or line in said["single"][0]:
            fail("(f) the CLI with DES_N_DEVICES=2 did not take the halo "
                 "step")
        for tag in said:
            if said[tag][0].count("remeshing (trigger") != 1:
                fail(f"(f) the {tag} CLI run did not remesh once")
        try:
            cli_err = max(assert_frames_close(
                Path(tmp) / "single" / f"run.save.{fr}",
                Path(tmp) / "multi" / f"run.save.{fr}", tol=1e-9,
                eta_exact=False) for fr in ("000001", "000002"))
        except AssertionError as e:
            cli_err = float("nan")
            failed.append(f"(f) CLI frames: {e}")
            print(f"  (f) CLI frames FAILED: {e}")
    rec["cli"] = {"devices_asked": 2, "shards_on_this_machine":
                  min(2, ncards), "max_frame_err": cli_err, "tol": 1e-9,
                  "s": {t: v[1] for t, v in said.items()},
                  "launches": {t: v[2] for t, v in said.items()}}
    print(f"  (f) CLI DES_N_DEVICES=2 ({min(2, ncards)} shard(s) on "
          f"{ncards} card(s)) through a remesh: frames 1-2 against the "
          f"single-device CLI {cli_err:.3e} (tol 1e-9); seconds "
          f"{rec['cli']['s']}; launches {rec['cli']['launches']}")
    rec["launches_halo"] = launches_halo
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 18: {rec['phase_s']:.1f} s")
    if failed:
        fail(f"phase 18: {len(failed)} gate(s) missed, the first: "
             f"{failed[0]}")
    return rec



def flat2d_plain_step(sim):
    """One step of sim's flat2d runner with the plain versions."""
    from dynearthsol_tpu_torch.ops import flat2d

    return flat2d.make_chunk_runner(sim.param, sim.ctx,
                                    sim.compensation_pressure, 1,
                                    plain=True)(sim.ctx, sim.state)


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an "
             "NVIDIA GPU")
    root = Path(__file__).resolve().parent
    sys.path[:0] = [str(root), str(root / "tests")]
    try:
        import torch_cases  # noqa: F401  (the shared cfg and file helpers)

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
        4.  A vbc target is loaded only where its mask is set.  The 2D
        surface-process accumulators (dhacc, edv) are loaded and stored on
        the top lane only, and only with surface process 1."""
        sw = P.sw
        skip = {"strain_rate", "edvoldt", "hmass", "force_x", "force_y",
                "force_z"}
        acc = [n for n in mod.N_SLOTS if n in ("dhacc", "edv")]
        acc_b = (len(acc) * b.nin.shape[1] * b.nin.element_size()
                 if sw.get("surf_on") else 0)
        if mod is fused3d and sw["surf_on"]:
            # the 3D accumulator planes (dhacc, edv_a, edv_b): the top lane
            acc_b = (len(fused3d.SURF_SLOTS) * b.nin.shape[1]
                     * b.nin.shape[2] * b.nin.element_size())
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
        n_n = sum(n not in skip and n not in acc
                  for n in mod.N_SLOTS + mod.CN_SLOTS)
        masks = [i for i, n in enumerate(mod.CN_SLOTS)
                 if n.startswith("vbc_mask")]
        read = (n_e * nbytes(b.ein[0]) + n_n * nbytes(b.nin[0])
                + int((b.cnp[masks] > 0).sum()) * b.tgt.element_size()
                + nbytes(b.scal, *extra) + acc_b)
        written = (nbytes(b.eout, b.part) + acc_b
                   + (len(mod.N_SLOTS) - len(acc)) * nbytes(b.nout[0]))
        return read, written

    def phase_bytes2(P, b):
        """{phase: bytes} that each phase of csrc/fused2d.cu's chunk kernel
        moves in one step under the plan's switches: every plane a phase
        loads or stores counted once for that phase (nodal planes it
        gathers, element, scratch and const planes), vbc targets only where
        masked, and the boundary lanes and rows that the facet tractions
        and surface process 1 read and write; the refresh's partials and
        scalars (a few KB) aside."""
        sw = P.sw
        N = nbytes(b.nin[0])
        E = nbytes(b.ein[0])
        es = b.nin.element_size()
        wink, surf = sw["winkler"], sw["surf_on"]
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
                 + 2 * sw["gravity_on"] * ce
                 + wink * P.nxc * es * (1 + 2 * (not P.uniform)),
            "F": 6 * E + (7 + (sw["damping"] == 4)) * N + masked + 6 * N
                 + wink * P.nxc * es + surf * P.nx * es,
            "S": 8 * P.nx * es if surf else 0,
            "G": 5 * N + 26 * E + (7 + P.nmat * sw["surf_corr"]) * ce,
            "H": 4 * E + 4 * N,
        }

    def phase_bytes3(P, b, pending, last):
        """{phase: bytes} that each launch of csrc/fused3d.cu moves in one
        step of the chunk form under the plan's switches: every plane a
        phase loads or stores counted once for that phase (nodal planes it
        gathers, element, cell-scratch and surface-factor planes), vbc
        targets only where masked; with the boundary processes the facet
        partials (12 columns' planes a boundary row, written by E, read by
        F) and the top-lane planes of surface process 1 (S: x, y, z, the
        top mask, dh; G: dh, edv_a and edv_b in and out; H: dh, z and
        dhacc).  ``pending``/``last`` as in the chunk form; the "finalize"
        entry is the pass after a chunk."""
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
        # the const pack of a mixed plan: A reads the radiogenic source and
        # the weights (thermal), C, E (gravity) and G the weights
        w = 0 if P.uniform else P.nmat * E
        # and the product dpressure * volume for D (NMD)
        c_out = 15 + (not creep or last) + 7 * last + nmd
        ph = {
            "phase_a": (6 + th) * N + E + (8 + 8 * th) * C
                       + th * (w + E * (not P.uniform)),
            "phase_b": (8 + 8 * th) * C + (4 + 2 * th) * N,
            "phase_c": (8 + (pending and nmd)) * N + (14 + c_in) * E
                       + (pending and surf) * S + c_out * E + w,
            "phase_d": (E + 2 * N) if nmd else 0,
            "phase_e": (3 + sw["gravity_on"] + nmd) * N + (7 + nmd) * E
                       + 24 * C + sw["gravity_on"] * w,
            "phase_f": 24 * C + 10 * N + masked + (6 + 3 * last) * N,
            "phase_g": 7 * N + 3 * E + (2 + last) * E + surf * S + w,
            "phase_h": (3 + last) * E + (3 + last) * N,
        }
        es = b.nin.element_size()
        rows = 12 * P.cells[0] * P.cells[1] * es * (sw["winkler"]
                                                    + sw["water"])
        lane = P.nx * P.ny * es
        ph["phase_e"] += rows
        ph["phase_f"] += rows
        if sw["surf_on"]:
            ph = {**{k: v for k, v in ph.items() if k <= "phase_f"},
                  "phase_s": 5 * lane,
                  **{k: v for k, v in ph.items() if k > "phase_f"}}
            ph["phase_g"] += 5 * lane
            ph["phase_h"] += 5 * lane
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
            if not P.uniform:
                # two materials: the mixtures where each phase reads them
                # (A 25 with thermal diffusion, C 8 and the second
                # material's creep and weakening terms 30, E 26 with
                # gravity, G 50)
                per_e += 25 * th + 38 + 26 * sw["gravity_on"] + 50
            per_n = 9 + 11 * th + 9 * nmd + 57 + 32
            # per (x, y) column, with the boundary processes: each
            # boundary row's two facets (about 56 operations each in E)
            # and F's lane sums (15); surface process 1's S (up to 8
            # triangles of about 37 operations), G's deposited volumes
            # (26) and H's two additions
            per_col = (127 * (sw["winkler"] + sw["water"])
                       + 329 * sw["surf_on"])
            return (per_e * nelem + per_n * nnode
                    + per_col * P.nx * P.ny)
        else:        # per triangle: A, B, C, D, E, F, G, H; per node B, D, F
            per_e = (38 + 35 * th + 3 + 3 * th + 54 + rh + 3 * nmd
                     + 6 * nmd + 47 + 6 * nmd + 6 + 22 + 45 * jau
                     + 12 * surf + 12)
            per_n = 1 + 3 * th + nmd + 22
            # per boundary node: two facets of 13 operations and 4 adds
            # (each tractions lane); per top node the diffusion's ~40
            per_n_lane = (30 * (sw["winkler"] + sw["water"])
                          + 40 * sw["surf_on"])
            return per_e * nelem + per_n * nnode + per_n_lane * P.nx

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
    for name, (regs, stack, spill, smem) in sorted(
            _build.ptxas_report().items()):
        print(f"  {name}: {regs} registers, {stack} B stack frame, "
              f"{spill} B spilled, {smem} B static shared memory")

    # ---- 3. 2D kernels against their plain versions, on the card
    print("phase 3 2D chunk kernel vs plain (16 x 128 cells, then flagship)")

    def sim_of(cfg):
        sim = des.Simulation(des.param_from_dict(cfg), device="cuda")
        return sim, fused2d.make_plan(sim.param, sim.ctx, sim.device,
                                      sim.compensation_pressure)

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

    # the production instance of the chunk kernel (Winkler and water
    # tractions, surface process 1, two materials), 16 x 128 cells: one EVP
    # step and a 10-step maxwell chunk (one launch) against the plain
    # version at the gates above.  The velocity is compared at the scale of
    # its increment dt f / m: its own max is the side walls' 1e-9 m/s, and
    # at a free node of the Winkler-balanced column the force is the
    # residual of ~1e12 N element terms.
    psim, PP = sim_of(production_cfg(small=True))
    ker = chunk(psim, PP, 1, False, False)
    ref = chunk(psim, PP, 1, False, True)
    prod_err = 0.0
    for f in ("coord", "stress", "strain", "plstrain", "force", "dhacc",
              "edvacc_surf"):
        err = rel(getattr(ref, f), getattr(ker, f))
        prod_err = max(prod_err, err)
        check(f"production EVP 1 step {f}", err, 2e-6)
    inc = psim.state.dt * (ref.force / psim.state.mass[:, None]).abs().max()
    check("production EVP 1 step vel (of dt |f / m|)",
          float((ref.vel - ker.vel).abs().max() / inc), 2e-6)
    if not float(ker.dhacc.abs().max()) > 0:
        fail("production EVP 1 step: surface process 1 left dhacc at 0")
    msim, MPP = sim_of(production_cfg("maxwell", small=True))
    ker = chunk(msim, MPP, 10, True, False)
    ref = chunk(msim, MPP, 10, True, True)
    lab = "production maxwell 10 steps, one chunk launch,"
    for f in ("coord", "vel", "temperature", "stress", "strain", "volume",
              "volume_n", "mass", "tmass", "hmass", "strain_rate",
              "edvoldt", "force", "dhacc", "edvacc_surf"):
        check(f"{lab} {f}", rel(getattr(ref, f), getattr(ker, f)),
              1e-3 if f == "force" else 2e-4)
    dlog = ref.viscosity.double().log() - ker.viscosity.double().log()
    check(f"{lab} log-viscosity median", float(dlog.abs().median()), 0.02)
    for f in ("dt", "time", "max_global_vel_mag"):
        check(f"{lab} {f}", rel(getattr(ref, f), getattr(ker, f)), 1e-5)
    del psim, msim, ker, ref

    # one production-size step and its dt refresh, kernel vs plain, every
    # plane (dhacc and edv included) and the refresh scalars, at the
    # flagship's gates; on maxwell, as the flagship.  The velocity planes
    # at the scale of their increment dt |f / m|, as at 16 x 128 cells
    msim, MPP = sim_of(production_cfg("maxwell"))
    kb = fused2d.make_buffers(MPP, msim.ctx, msim.state, 1, tiled=False)
    pb = fused2d.make_buffers(MPP, msim.ctx, msim.state, 1, tiled=False)
    kb.flags[0, 0] = pb.flags[0, 0] = 1.0
    fused2d.fused_chunk(MPP, kb, 1, tiled=False)
    fused2d.chunk_plain(MPP, pb, 1, tiled=False)
    sync()
    pn = {nm: pb.nin[fused2d._nslot(nm)] for nm in
          ("force_x", "force_z", "mass")}
    inc = float(msim.state.dt * (torch.stack([pn["force_x"], pn["force_z"]])
                                 .abs() / pn["mass"]).max())
    for k, nm in enumerate(names):
        if nm == "e.viscosity":
            v = (pb.ein[k].double().log() - kb.ein[k].double().log())
            check(f"production 1 step {nm} (log)", float(v.abs().max()),
                  1e-5)
            continue
        a, b = (pb.ein[k], kb.ein[k]) if nm[0] == "e" else \
            (pb.nin[k - fused2d.NE], kb.nin[k - fused2d.NE])
        if nm.startswith("n.vel_"):
            err = float((a.double() - b.double()).abs().max()) / inc
            nm += " (of dt |f / m|)"
        else:
            err = rel(a, b)
        prod_err = max(prod_err, err)
        check(f"production 1 step {nm}", err, 2e-6)
    for i, nm in enumerate(("dt", "vmax", "gdtmin", "time", "L2 sum")):
        err = rel(pb.scal[i:i + 1], kb.scal[i:i + 1])
        prod_err = max(prod_err, err)
        check(f"production 1 step refresh {nm}", err,
              1e-5 if i == 4 else 1e-6)
    del msim, kb, pb

    # the production main path's config: a 25-step EVP chunk against 25
    # one-step launches, bit for bit, every plane (dhacc and edv too)
    gsim, GP = sim_of(production_cfg())
    gocc = fused2d.chunk_occupancy(GP)
    print(f"  production instance at full size: {gocc['registers']} "
          f"registers and {gocc['local_bytes']} B local memory per thread, "
          f"{gocc['blocks_per_sm']} blocks per SM, grid {gocc['grid']}")
    cb = fused2d.make_buffers(GP, gsim.ctx, gsim.state, NV, tiled=False)
    fused2d.fused_chunk(GP, cb, NV, tiled=False)
    ob = fused2d.make_buffers(GP, gsim.ctx, gsim.state, NV, tiled=False)
    for k in range(NV):
        fused2d.fused_chunk(GP, ob, 1, tiled=False, k=k)
    sync()
    for k, nm in enumerate(names):
        a, b = (cb.ein[k], ob.ein[k]) if nm[0] == "e" else \
            (cb.nin[k - fused2d.NE], ob.nin[k - fused2d.NE])
        if not torch.equal(a, b):
            fail(f"production EVP: a {NV}-step chunk and {NV} one-step "
                 f"launches differ in {nm}")
    if not (torch.equal(cb.scal, ob.scal) and torch.equal(cb.dthist,
                                                           ob.dthist)):
        fail(f"production EVP: a {NV}-step chunk and {NV} one-step "
             "launches differ in scal or the dt history")
    if not float(cb.nin[fused2d._nslot("dhacc")].abs().max()) > 0:
        fail(f"production EVP: dhacc did not move in {NV} steps")
    print(f"  production EVP: a {NV}-step chunk equals {NV} one-step "
          "launches bit for bit (every plane, dhacc and edv included, "
          "scal, dt history): ok")
    del cb, ob

    # device times and the per-interval table of the production chunk
    gb = fused2d.make_buffers(GP, gsim.ctx, gsim.state, NCH2, tiled=False)
    gpb = fused2d.make_buffers(GP, gsim.ctx, gsim.state, 1, tiled=False)

    def gchunk_kernel():
        fused2d.fused_chunk(GP, gb, NCH2, tiled=False)

    def gstep_plain():
        fused2d.chunk_plain(GP, gpb, 1, tiled=False)

    gchunk_ms = issue_ms(gchunk_kernel, 2) / NCH2
    gplain_ms = device_ms(gstep_plain, 5)
    gextra = (gpb.flags[0], gpb.cep[1:])  # the pack less "valid"
    gbound = bound(*step_bytes(fused2d, GP, gpb, 3, *gextra),
                   step_ops(GP, 2, gsim.ctx.nelem, gsim.ctx.nnode))
    glabels = fused2d.stamp_labels(GP, NCH2)
    stamps = torch.zeros(len(glabels) + 1, dtype=torch.int64, device="cuda")
    fused2d.fused_chunk(GP, gb, NCH2, tiled=False, stamps=stamps)
    sync()
    span = (stamps[1:] - stamps[:-1]).double().cpu().tolist()
    gstamped_ms = float(stamps[-1] - stamps[0]) / 1e6 / NCH2
    per = {}
    for lab, ns in zip(glabels, span):
        per.setdefault(lab, []).append(ns / 1e3)
    gbytes = phase_bytes2(GP, gb)
    gphases = {}
    for lab, v in per.items():
        nb = sum(gbytes[ph] for ph in lab.split("+"))
        us = sum(v) / len(v)
        gphases[lab] = {"bytes": nb, "us": us, "intervals": len(v),
                        "tb_per_s": nb / us / 1e6 if us > 0 else None}
    print(f"  device time per step at production (EVP) on {card}: chunk "
          f"form (events around 2 chunks of {NCH2} steps) {gchunk_ms:.4f} "
          f"ms, {(len(glabels) - 1) / NCH2:g} grid barriers per step; plain "
          f"{gplain_ms:.4f} ms; bound {gbound[0]:.4f} ms by {gbound[1]} "
          f"({gbound[2] / 1e6:.1f} MB)")
    print(f"  production chunk of {NCH2} steps by interval "
          f"({gstamped_ms:.4f} ms per step with the stamps):")
    for lab, r in gphases.items():
        bw = f"{r['tb_per_s']:.2f} TB/s" if r["tb_per_s"] else "-"
        print(f"    {lab}: {r['us']:.2f} us x {r['intervals']}, "
              f"{r['bytes'] / 1e6:.1f} MB, {bw}")
    del gb, gpb, stamps

    # ---- 4. the 3D kernel against its plain version, on the card
    print("phase 4 3D kernels vs plain (128 x 16 x 8 cells, then "
          "flagship3d)")

    def run3(cfg, n, plain, reach=False):
        """n fused 3D steps from the config's initial state: the kernel on
        the card, or the plain version on the CPU.  PyTorch on the card
        divides by a Python number as a product with its reciprocal, an
        ulp off true division for a third of the values, which flips exact
        ties of the EVP min-select; on the CPU it divides truly, as the
        kernel does.  The plain run also counts those ties
        (fused3d.evp_ties) and, with ``reach``, returns what ties of equal
        nonzero invariants can change and how near a tie they are
        (fused3d.evp_tie_reach)."""
        s3 = des.Simulation(des.param_from_dict(cfg),
                            device="cpu" if plain else "cuda")
        P3 = fused3d.make_plan(s3.param, s3.ctx, s3.device,
                               s3.compensation_pressure)
        out = fused3d.run_chunk(P3, s3.ctx, s3.state, n, plain)
        sync()
        ties = fused3d.evp_ties(P3, s3.ctx, s3.state) \
            if plain and P3.rheol == fused3d.RH_EVP else None
        if reach:
            return out, ties, fused3d.evp_tie_reach(P3, s3.ctx, s3.state)
        return out, ties

    def chunk_vs_steps(label, P, ctx, state, n):
        """The chunk form (run_chunk: each step's epilogue pending until
        the next step, one finalize after the last) against n complete
        steps (fused3d_step, dt_refresh, swap), bit for bit on every
        plane."""
        out = fused3d.run_chunk(P, ctx, state, n)
        e_chunk, n_chunk = fused3d.state_to_planes(out, P.nx, P.ny, P.nz,
                                                   P.smaps)
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
        for i, nm in enumerate((fused3d.N_SLOTS + fused3d.SURF_SLOTS)
                               [:P.nn]):
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
        printed beside).  Returns the largest error, the viscosity's
        aside."""
        bad, worst = [], 0.0
        ne = len(fused3d.E_SLOTS)
        names = names3 + [f"n.{n}" for n in fused3d.SURF_SLOTS][
            :ref_n.shape[0] - fused3d.NN]
        for k, nm in enumerate(names):
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
            if nm != "e.viscosity (log)":
                worst = max(worst, err)
            if not check(f"{label} {nm}", err, tol, stop=False):
                bad.append(nm)
        if bad:
            fail(f"{label}: kernel and plain version disagree in {bad}")
        return worst

    def evp3_check(label, ker, ref, ties=None, reach=None):
        """One step, kernel against the plain version on the CPU, at the
        gate of test_pallas3d.py:126-132 (1e-4 of each field's max, force
        1e-3, log-viscosity median 0.02) over every value, the exact ties
        of the EVP min-select included, or, with ``reach``
        (fused3d.evp_tie_reach), over the elements and nodes that no tie
        of equal nonzero invariants reaches, the full error printed
        beside.  Those are set aside only while each tie is one of
        rounding (the invariants' float64 gap below the f32 step's own
        error in them) and they reach at most 5 % of the elements;
        returns the largest error."""
        if reach is not None:
            elems, nodes, gap = reach
            share = float(elems.double().mean())
            print(f"  {label}: {int(ties.sum())} of {ties.numel()} "
                  f"elements tie with both invariants 0, none set aside; "
                  f"ties of equal nonzero invariants reach "
                  f"{int(elems.sum())} elements ({share:.2%}, at most 5%) "
                  f"and {int(nodes.sum())} of {nodes.numel()} "
                  f"nodes, set aside: their invariants' float64 gap is "
                  f"{gap:.3f} of the f32 step's own error in them (below "
                  f"1: a tie of rounding)")
            if not gap < 1 or share > 0.05:
                fail(f"{label}: the ties set aside are not ties of "
                     "rounding, or reach more than 5% of the elements")
        elif ties is not None:
            print(f"  {label}: {int(ties.sum())} of {ties.numel()} "
                  "elements tie exactly in the min-select; none is set "
                  "aside")
        worst = 0.0
        for f in FIELDS3:
            a, b = getattr(ref, f), getattr(ker, f).cpu()
            lab = f"{label} {f}"
            if reach is not None:
                m = ~elems if a.shape[0] == elems.numel() else ~nodes
                lab += f" (all: {rel(a, b):.3e})"
                a, b = a[m], b[m]
            err = rel(a, b)
            worst = max(worst, err)
            check(lab, err, 1e-3 if f == "force" else 1e-4)
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

    # the mixed instances (two materials, the const pack), 128 x 16 x 8
    # cells: a 3-step maxwell chunk and one EVP step against the plain
    # version on the CPU, at the gates above; the chunk form against its
    # complete steps
    cfgm = multimat3d_cfg(sim3d_cfg("maxwell", weakzone=1))
    ker, ref = run3(cfgm, 3, False)[0], run3(cfgm, 3, True)[0]
    for f in FIELDS3 + ("dt", "time", "max_global_vel_mag", "l2_residual"):
        check(f"3D two materials maxwell 3-step chunk {f}",
              rel(getattr(ref, f), getattr(ker, f).cpu()),
              5e-3 if f == "force" else 1e-3)
    # the same config on maxwell (no select), one step at the one-step
    # gate over every value
    mm_err = evp3_check("3D two materials maxwell 1 step",
                        run3(cfgm, 1, False)[0], run3(cfgm, 1, True)[0])
    # on EVP, at visc_max the viscoelastic and elastic-plastic trial
    # deviators agree and the select compares two invariants that differ
    # by less than the f32 step rounds them (pressures 1e5 Pa apart)
    cfge = multimat3d_cfg(sim3d_cfg())
    mm_err = max(mm_err, evp3_check("3D two materials EVP 1 step",
                                    run3(cfge, 1, False)[0],
                                    *run3(cfge, 1, True, reach=True)))
    s3 = des.Simulation(des.param_from_dict(cfgm), device="cuda")
    P3 = fused3d.make_plan(s3.param, s3.ctx, s3.device)
    if P3.uniform:
        fail("the two-material config took the uniform plan")
    chunk_vs_steps("3D two materials maxwell 10 steps", P3, s3.ctx,
                   s3.state, 10)
    del s3, ker, ref

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

    # the flagship3d_multimat main-path Simulation (bench.py
    # flagship3d_param(nmat=2)), default device: one maxwell step, every
    # plane against the plain version on the card, and one step of its
    # own config (EVP) against the plain version on the CPU over every
    # value, its ties included
    t = time.perf_counter()
    m3 = des.Simulation(des.param_from_dict(flagship3d_cfg(nmat=2)))
    sync()
    minit_s = time.perf_counter() - t
    MP3 = fused3d.make_plan(m3.param, m3.ctx, m3.device)
    if MP3.uniform or MP3.nmat != 2:
        fail("flagship3d_multimat did not take the two-material plan")
    XP3 = fused3d.make_plan(des.param_from_dict(
        flagship3d_cfg("maxwell", nmat=2)), m3.ctx, m3.device)
    kb = fused3d.make_buffers(XP3, m3.ctx, m3.state, 1)
    pb = fused3d.make_buffers(XP3, m3.ctx, m3.state, 1)
    kb.tgt = pb.tgt = fused3d.vbc_targets(m3.ctx, kb.nin,
                                          kb.scal[3] + kb.scal[0])
    fused3d.fused3d_step(XP3, kb)
    fused3d.fused3d_step_plain(XP3, pb)
    sync()
    mm_err = max(mm_err, planes_check("flagship3d_multimat maxwell 1 step",
                                      pb.eout, pb.nout, kb.eout, kb.nout))
    del kb, pb
    ker = fused3d.run_chunk(MP3, m3.ctx, m3.state, 1)
    mm_err = max(mm_err, evp3_check(
        "flagship3d_multimat EVP 1 step", ker,
        *run3(flagship3d_cfg(nmat=2), 1, True)))
    del ker

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

    # ---- 5b. the production slice (bench.py production_param): the
    # production instance of the chunk kernel through the main path
    t = time.perf_counter()
    gp = des.Simulation(des.param_from_dict(production_cfg()))
    sync()
    ginit_s = time.perf_counter() - t
    gnelem = gp.ctx.nelem
    t = time.perf_counter()
    gp.run_steps(250, chunk=250)
    sync()
    gwarm_s = time.perf_counter() - t
    if gp.step_path != "pallas2d_res":
        fail(f"production dispatched to {gp.step_path!r}, not pallas2d_res")
    time0 = float(gp.state.time)
    zero_counts()
    t = time.perf_counter()
    gp.run_steps(500, chunk=250)
    sync()
    grun_s = time.perf_counter() - t
    launches2p = {"fused2d_chunk": fused2d.fused_chunk.launches,
                  "dt_refresh": fused2d.dt_refresh.launches}
    if launches2p != {"fused2d_chunk": 2, "dt_refresh": 0}:
        fail(f"the production path did not launch the chunk kernel once "
             f"per chunk and dt_refresh never: {launches2p}")
    if fused2d.fused_step_plain.calls or fused2d.dt_refresh_plain.calls:
        fail("the production path on the card took a plain version")
    s = gp.state
    if not float(s.time) > time0 or int(s.steps) != 750:
        fail("production model time or the step count did not advance")
    for f in FIELD_NAMES:
        v = getattr(s, f)
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            fail(f"non-finite values in production {f}")
    if not float(s.dhacc.abs().max()) > 0:
        fail("production: surface process 1 left dhacc at 0")
    grate = gnelem * 500 / grun_s
    print(f"phase 5b production slice: {gnelem} triangles, two materials, "
          f"Winkler and water tractions, surface process 1; step_path "
          f"{gp.step_path}, launches {launches2p}, plain versions called 0 "
          f"times, host setup {ginit_s:.1f} s, warm-up 250 steps "
          f"{gwarm_s:.2f} s, 500 steps {grun_s:.3f} s, model time "
          f"{time0:.6e} -> {float(s.time):.6e} s, max |dhacc| "
          f"{float(s.dhacc.abs().max()):.3e} m, fields finite")
    print(f"  elem*steps/s: {grate:.6e} on {card}")
    del gp

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

    # ---- 6b. the flagship3d_multimat slice (bench.py flagship3d_param(
    # nmat=2)): the mixed instances of kernel 3 through the main path,
    # chunked as phase 6 chunks flagship3d
    mnelem = m3.ctx.nelem
    t = time.perf_counter()
    m3.run_steps(100, chunk=100)
    sync()
    mwarm_s = time.perf_counter() - t
    if m3.step_path != "pallas3d":
        fail(f"flagship3d_multimat dispatched to {m3.step_path!r}, not "
             "pallas3d")
    time0 = float(m3.state.time)
    zero_counts()
    t = time.perf_counter()
    m3.run_steps(500, chunk=250)
    sync()
    mrun_s = time.perf_counter() - t
    launches3m = {"fused3d_step": fused3d.fused3d_step.launches,
                  "dt_refresh": fused2d.dt_refresh.launches,
                  "fused3d_finalize": fused3d.fused3d_finalize.launches}
    if launches3m != {"fused3d_step": 500, "dt_refresh": 500,
                      "fused3d_finalize": 2}:
        fail(f"the two-material 3D path did not launch each step kernel "
             f"once per step and finalize once per chunk: {launches3m}")
    if fused3d.chunk_step_plain.calls or fused3d.finalize_plain.calls:
        fail("the two-material 3D path on the card took a plain version")
    s = m3.state
    if not float(s.time) > time0 or int(s.steps) != 600:
        fail("two-material 3D model time or the step count did not advance")
    for f in FIELD_NAMES:
        v = getattr(s, f)
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            fail(f"non-finite values in two-material 3D {f}")
    mrate = mnelem * 500 / mrun_s
    print(f"phase 6b 3D two-material slice: flagship3d_multimat {mnelem} "
          f"tets, step_path {m3.step_path}, launches {launches3m}, plain "
          f"versions called 0 times, host setup {minit_s:.1f} s, warm-up "
          f"100 steps {mwarm_s:.2f} s, 500 steps {mrun_s:.3f} s, model time "
          f"{time0:.6e} -> {float(s.time):.6e} s, fields finite")
    print(f"  elem*steps/s: {mrate:.6e} on {card}")

    # the mixed kernel's device times at this size, as phase 4 times the
    # uniform one
    mcb = fused3d.make_buffers(MP3, m3.ctx, m3.state, NCH)
    mkb = fused3d.make_buffers(MP3, m3.ctx, m3.state, 1)
    mpb = fused3d.make_buffers(MP3, m3.ctx, m3.state, 1)

    def mchunk_kernel():
        for k in range(NCH):
            fused3d.fused3d_chunk_step(MP3, mcb, k, NCH)
            fused2d.dt_refresh(MP3, mcb, k, tiled=True, every=True)
            mcb.swap()
        fused3d.fused3d_finalize(MP3, mcb, mcb.ein, mcb.nin, mcb.dthist[-1])

    mstep_ms = device_ms(mchunk_kernel, 1) / NCH
    mstep_one_ms = device_ms(lambda: fused3d.fused3d_step(MP3, mkb), 20)
    mstep_plain_ms = device_ms(lambda: fused3d.fused3d_step_plain(MP3, mpb),
                               2)
    mread, mwritten = step_bytes(fused3d, MP3, mkb, 6, mkb.cep)
    mops = step_ops(MP3, 3, mnelem, m3.ctx.nnode)
    e_lo, n_lo = fused3d.last_only_slots(MP3)
    m_last_only = (len(e_lo) * nbytes(mkb.eout[0])
                   + len(n_lo) * nbytes(mkb.nout[0]))
    mbound = bound(mread, mwritten - m_last_only * (NCH - 1) / NCH, mops)
    mbound_one = bound(mread, mwritten, mops)
    mpb3 = [phase_bytes3(MP3, mcb, k > 0, k == NCH - 1) for k in range(NCH)]
    mbytes3 = {ph: sum(d.get(ph, 0) for d in mpb3) / NCH for ph in mpb3[0]}
    mbytes3["finalize"] = mpb3[0]["finalize"] / NCH
    print(f"  device time: flagship3d_multimat fused step, chunk form (a "
          f"graph of {NCH} steps, their dt_refresh calls and one finalize, "
          f"over {NCH}) {mstep_ms:.4f} ms (bound {mbound[0]:.4f} ms by "
          f"{mbound[1]}, {mbound[2] / 1e6:.1f} MB); one-step form "
          f"{mstep_one_ms:.4f} ms (bound {mbound_one[0]:.4f} ms); plain "
          f"{mstep_plain_ms:.4f} ms; on {card}")
    del mcb, mkb, mpb

    # ---- 6c. production3d (bench.py production3d_param): kernel 3's
    # boundary-process instances (the Winkler and water facet tractions,
    # surface process 1 and its top-lane pass S), first at 128 x 16 x 8
    # cells against the plain version on the CPU, then at full size and
    # through the main path
    print("phase 6c production3d: kernel 3 with the facet tractions and "
          "surface process 1 (128 x 16 x 8 cells, then full size)")
    # a 10-step maxwell chunk of one material with the tractions and
    # surface process 1, at the maxwell gate of test_pallas3d.py:262-276
    # (dhacc and edvacc_surf 5e-3)
    cfgw = production3d_cfg("maxwell", small=True, nmat=1)
    ker, ref = run3(cfgw, 10, False)[0], run3(cfgw, 10, True)[0]
    prod_err = 0.0
    for f in FIELDS3 + ("dhacc", "edvacc_surf"):
        err = rel(getattr(ref, f), getattr(ker, f).cpu())
        prod_err = max(prod_err, err)
        check(f"3D facets + surface process 1 maxwell 10-step chunk {f}",
              err, 5e-3 if f in ("force", "dhacc", "edvacc_surf") else 1e-3)
    for f in ("dt", "time", "max_global_vel_mag", "l2_residual"):
        check(f"3D facets + surface process 1 maxwell 10-step chunk {f}",
              rel(getattr(ref, f), getattr(ker, f).cpu()), 1e-3)
    if not float(ref.dhacc.abs().max()) > 0:
        fail("3D surface process 1 left dhacc at 0")
    # one step of the production3d feature set (two materials, EVP) at the
    # one-step gate, away from what its ties of rounding reach; dhacc and
    # edvacc_surf printed, not gated (test_pallas3d.py:287-303 excludes
    # them: the min-select amplifies a rounding into them)
    cfgp = production3d_cfg(small=True)
    ker = run3(cfgp, 1, False)[0]
    ref, ties, reach = run3(cfgp, 1, True, reach=True)
    prod_err = max(prod_err, evp3_check("3D production3d EVP 1 step", ker,
                                        ref, ties, reach))
    for f in ("dhacc", "edvacc_surf"):
        a, b = getattr(ref, f), getattr(ker, f).cpu()
        line = f"all {rel(a, b):.3e}"
        if f == "dhacc":
            away = rel(a[~reach[1]], b[~reach[1]])
            line += f", away from the ties' reach {away:.3e}"
        print(f"  3D production3d EVP 1 step {f}: {line} (not gated)")
    del ker, ref

    t = time.perf_counter()
    p3 = des.Simulation(des.param_from_dict(production3d_cfg()))
    sync()
    pinit_s = time.perf_counter() - t
    PP3 = fused3d.make_plan(p3.param, p3.ctx, p3.device,
                            p3.compensation_pressure)
    if PP3.uniform or not (PP3.facets and PP3.sw["surf_on"]):
        fail("production3d did not take the two-material plan with the "
             "facet tractions and surface process 1")
    pnelem = p3.ctx.nelem
    print(f"  production3d host setup: {pinit_s:.1f} s ({pnelem} tets, "
          f"{p3.ctx.nnode} nodes, {p3.ctx.sbc.n_grav} gravity facets, "
          f"{p3.ctx.surf.etop} top facets)")
    # one maxwell step, every plane against the plain version on the card
    XP3 = fused3d.make_plan(des.param_from_dict(production3d_cfg("maxwell")),
                            p3.ctx, p3.device, p3.compensation_pressure)
    kb = fused3d.make_buffers(XP3, p3.ctx, p3.state, 1)
    pb = fused3d.make_buffers(XP3, p3.ctx, p3.state, 1)
    kb.tgt = pb.tgt = fused3d.vbc_targets(p3.ctx, kb.nin,
                                          kb.scal[3] + kb.scal[0])
    fused3d.fused3d_step(XP3, kb)
    fused3d.fused3d_step_plain(XP3, pb)
    sync()
    prod_err = max(prod_err, planes_check("production3d maxwell 1 step",
                                          pb.eout, pb.nout, kb.eout, kb.nout))
    del kb, pb
    # its own config (EVP): a 20-step chunk against 20 complete steps
    chunk_vs_steps("production3d EVP 20 steps", PP3, p3.ctx, p3.state, NCH)

    # device times at this size, as phase 4 times flagship3d
    pcb = fused3d.make_buffers(PP3, p3.ctx, p3.state, NCH)
    pkb = fused3d.make_buffers(PP3, p3.ctx, p3.state, 1)
    ppb = fused3d.make_buffers(PP3, p3.ctx, p3.state, 1)

    def pchunk_kernel():
        for k in range(NCH):
            fused3d.fused3d_chunk_step(PP3, pcb, k, NCH)
            fused2d.dt_refresh(PP3, pcb, k, tiled=True, every=True)
            pcb.swap()
        fused3d.fused3d_finalize(PP3, pcb, pcb.ein, pcb.nin, pcb.dthist[-1])

    pstep_ms = device_ms(pchunk_kernel, 1) / NCH
    pstep_one_ms = device_ms(lambda: fused3d.fused3d_step(PP3, pkb), 20)
    pstep_plain_ms = device_ms(lambda: fused3d.fused3d_step_plain(PP3, ppb),
                               2)
    pread, pwritten = step_bytes(fused3d, PP3, pkb, 6, pkb.cep)
    pops = step_ops(PP3, 3, pnelem, p3.ctx.nnode)
    e_lo, n_lo = fused3d.last_only_slots(PP3)
    p_last_only = (len(e_lo) * nbytes(pkb.eout[0])
                   + len(n_lo) * nbytes(pkb.nout[0]))
    pbound = bound(pread, pwritten - p_last_only * (NCH - 1) / NCH, pops)
    pbound_one = bound(pread, pwritten, pops)
    ppb3 = [phase_bytes3(PP3, pcb, k > 0, k == NCH - 1) for k in range(NCH)]
    pbytes3 = {ph: sum(d.get(ph, 0) for d in ppb3) / NCH for ph in ppb3[0]}
    pbytes3["finalize"] = ppb3[0]["finalize"] / NCH
    print(f"  device time: production3d fused step, chunk form (a graph of "
          f"{NCH} steps, their dt_refresh calls and one finalize, over "
          f"{NCH}) {pstep_ms:.4f} ms (bound {pbound[0]:.4f} ms by "
          f"{pbound[1]}, {pbound[2] / 1e6:.1f} MB); one-step form "
          f"{pstep_one_ms:.4f} ms (bound {pbound_one[0]:.4f} ms); plain "
          f"{pstep_plain_ms:.4f} ms; on {card}")
    del pcb, pkb, ppb

    # the main path
    t = time.perf_counter()
    p3.run_steps(100, chunk=100)
    sync()
    pwarm_s = time.perf_counter() - t
    if p3.step_path != "pallas3d":
        fail(f"production3d dispatched to {p3.step_path!r}, not pallas3d")
    time0 = float(p3.state.time)
    zero_counts()
    t = time.perf_counter()
    p3.run_steps(500, chunk=250)
    sync()
    prun_s = time.perf_counter() - t
    launches3p = {"fused3d_step": fused3d.fused3d_step.launches,
                  "dt_refresh": fused2d.dt_refresh.launches,
                  "fused3d_finalize": fused3d.fused3d_finalize.launches}
    if launches3p != {"fused3d_step": 500, "dt_refresh": 500,
                      "fused3d_finalize": 2}:
        fail(f"the production3d path did not launch each step kernel once "
             f"per step and finalize once per chunk: {launches3p}")
    if fused3d.chunk_step_plain.calls or fused3d.finalize_plain.calls:
        fail("the production3d path on the card took a plain version")
    s = p3.state
    if not float(s.time) > time0 or int(s.steps) != 600:
        fail("production3d model time or the step count did not advance")
    for f in FIELD_NAMES:
        v = getattr(s, f)
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            fail(f"non-finite values in production3d {f}")
    if not float(s.dhacc.abs().max()) > 0:
        fail("production3d: surface process 1 left dhacc at 0")
    prate = pnelem * 500 / prun_s
    print(f"  production3d slice: step_path {p3.step_path}, launches "
          f"{launches3p}, plain versions called 0 times, warm-up 100 steps "
          f"{pwarm_s:.2f} s, 500 steps {prun_s:.3f} s, model time "
          f"{time0:.6e} -> {float(s.time):.6e} s, max |dhacc| "
          f"{float(s.dhacc.abs().max()):.3e} m, fields finite")
    print(f"  elem*steps/s: {prate:.6e} on {card}")

    # ---- 7. device time per launch, by kernel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof_last = {}

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
            elif "asm_pack_kernel" in e.name:
                key = "asm_pack_kernel (asm_pack, asm_gather)"
            else:
                key = "other (PyTorch ops, copies)"
            n, t = rows.get(key, (0, 0.0))
            rows[key] = (n + 1, t + us)
        prof_last.update(wall_us=wall_us, busy_us=busy,
                         idle=max(0.0, 1 - busy / wall_us))
        print(f"phase 7 profile {label}: {steps} steps, wall "
              f"{wall_us:.1f} us/step, device busy {busy:.1f} us/step "
              f"(idle {max(0.0, 1 - busy / wall_us):.1%} of wall)")
        for key, (n, us) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
            print(f"  {key}: {us:.1f} us/step ({n / steps:g} launches/step)")
        return rows

    per_kernel("flagship 2D (resident runner)",
               lambda n: fused2d.run_chunk(FP, fsim.ctx, fsim.state, n,
                                           True), 100)
    per_kernel("production 2D (resident runner)",
               lambda n: fused2d.run_chunk(GP, gsim.ctx, gsim.state, n,
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
    rows3m = per_kernel("flagship3d_multimat", lambda n: fused3d.run_chunk(
        MP3, m3.ctx, m3.state, n), NCH)
    print(f"  flagship3d_multimat kernel 3 (mixed instances) by phase, "
          f"chunk form of {NCH} steps, on {card}:")
    phases3m = {}
    for ph, nb in mbytes3.items():
        us = rows3m.get(ph, (0, 0.0))[1]
        phases3m[ph] = {"bytes": nb, "us": us,
                        "tb_per_s": nb / us / 1e6 if us else None}
        bw = f"{nb / us / 1e6:.2f} TB/s" if us else "not launched"
        print(f"    {ph}: {nb / 1e6:.1f} MB, {us:.1f} us, {bw}")
    print(f"    sum: {sum(mbytes3.values()) / 1e6:.1f} MB per step, "
          f"{sum(v['us'] for v in phases3m.values()):.1f} us")
    rows3p = per_kernel("production3d", lambda n: fused3d.run_chunk(
        PP3, p3.ctx, p3.state, n), NCH)
    print(f"  production3d kernel 3 (boundary-process instances) by phase, "
          f"chunk form of {NCH} steps, on {card}:")
    phases3p = {}
    for ph, nb in pbytes3.items():
        us = rows3p.get(ph, (0, 0.0))[1]
        phases3p[ph] = {"bytes": nb, "us": us,
                        "tb_per_s": nb / us / 1e6 if us else None}
        bw = f"{nb / us / 1e6:.2f} TB/s" if us else "not launched"
        print(f"    {ph}: {nb / 1e6:.1f} MB, {us:.1f} us, {bw}")
    print(f"    sum: {sum(pbytes3.values()) / 1e6:.1f} MB per step, "
          f"{sum(v['us'] for v in phases3p.values()):.1f} us")


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
    # every call site's k: the step's (cgather 6, 2; asm_pack 2, 5), and
    # hydraulic diffusion's 8-column gather and 3-column force pack, the
    # 4-column gather after surface processes and in the pseudo-transient
    # loop and its 1-column gathers
    SITES = {"cgather": (6, 2, 8, 4, 1), "asm_pack": (2, 5, 3),
             "asm_gather": ((2, 1), (1, 1))}
    gen = torch.Generator(device="cuda").manual_seed(12345)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, dtype=dtype, device="cuda")

    band_err = {"cgather": 0.0, "asm_pack": 0.0, "asm_gather": 0.0}

    def band_check(label, bt, sites=SITES):
        for dtype in (torch.float32, torch.float64):
            worst = dict.fromkeys(band_err, 0.0)
            for k in sites["cgather"]:
                pack = rnd((bt.nnode, k), dtype)
                a, b = band2d.cgather(pack, bt), \
                    band2d.gather_corners(pack, bt)
                worst["cgather"] = max(worst["cgather"],
                                       float((a - b).abs().max()))
                if not torch.equal(a, b):
                    fail(f"{label} {dtype} cgather k={k} differs from "
                         "its plain version")
            for k in sites["asm_pack"]:
                cols = rnd((k, bt.npe, bt.nelem), dtype)
                a, b = band2d.asm_pack(cols, bt), \
                    band2d.scatter_corners(cols, bt)
                worst["asm_pack"] = max(worst["asm_pack"],
                                        float((a - b).abs().max()))
                if not torch.equal(a, b):
                    fail(f"{label} {dtype} asm_pack k={k} differs from "
                         "its plain version")
            for k, kg in sites["asm_gather"]:
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
            print(f"  {label} (max degree {bt.g_cols.shape[0]}), "
                  f"{str(dtype)[6:]}: cgather k={sites['cgather']}; "
                  f"asm_pack k={sites['asm_pack']}; asm_gather (k,kg)="
                  f"{sites['asm_gather']} equal bit for bit")

    band_check(f"Delaunay {small[1].shape[0]} triangles",
               band2d.build_tables(small[1], small[0].shape[0], "cuda"))
    band_check(f"{tets.nelem} tets",
               band2d.build_tables(tets.connectivity, tets.nnode, "cuda"))
    ubt = band2d.build_tables(usim.topo.connectivity, unnode, "cuda")
    band_check(f"Delaunay {unelem} triangles", ubt)
    ustaged = int(ubt.tile_staged.sum())
    utiles = {"tiles": ubt.tile_staged.numel(), "staged": ustaged,
              "unstaged": ubt.tile_staged.numel() - ustaged,
              "window_max": int(ubt.tile_w.max()),
              "window_max_staged": ubt.win_rows}
    print(f"  gather tiles of {band2d.TILE} elements at {unelem} "
          f"triangles: {utiles['staged']} staged, {utiles['unstaged']} "
          f"unstaged, widest window {utiles['window_max']} rows (staged "
          f"{ubt.win_rows})")
    if not ustaged:
        fail("no gather tile of the 277k-triangle mesh is staged")

    def gather_table_bytes(bt):
        """Bytes of the tables the gather kernel reads: an int16 relative
        id per slot of a staged tile, the int32 node id per slot of an
        unstaged one, and the tile tables."""
        per_tile = torch.full_like(bt.tile_w, band2d.TILE)
        per_tile[-1] = bt.nelem - band2d.TILE * (per_tile.numel() - 1)
        slots = bt.npe * per_tile.long()
        st = bt.tile_staged
        return int(2 * slots[st].sum() + 4 * slots[~st].sum()) \
            + nbytes(bt.tile_lo, bt.tile_w, bt.tile_staged)

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
            bound=bound(nbytes(pack) + gather_table_bytes(ubt),
                        k * nslots * es, 0))
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
            bound=bound(nbytes(cols) + gather_table_bytes(ubt) + tab_b,
                        (unnode * k + kg * nslots) * es, nslots * k))
    def band_times(label, bt, sites, nslots):
        """Device times of the band kernels at ``sites`` on the tables
        ``bt``, f32, L2 flushed before each call, beside the plain
        versions', the library calls' and the bound."""
        nn, npe, ne = bt.nnode, bt.npe, bt.nelem
        conn_l = bt.conn_cm.long()
        tab_b = nbytes(bt.row_ptr, bt.slots)
        out = {}
        for k in sites["cgather"]:
            pack = rnd((nn, k), torch.float32)
            out[f"cgather k={k}"] = dict(
                ms=cold_ms(lambda: band2d.cgather(pack, bt), 20, flush),
                warm_ms=device_ms(lambda: band2d.cgather(pack, bt), 50),
                issue_ms=issue_ms(lambda: band2d.cgather(pack, bt), 50),
                plain_ms=cold_ms(lambda: band2d.gather_corners(pack, bt),
                                 10, flush),
                library_ms=cold_ms(lambda: pack.index_select(0, conn_l), 20,
                                   flush),
                bound=bound(nbytes(pack) + gather_table_bytes(bt),
                            k * nslots * es, 0))
        for k in sites["asm_pack"]:
            cols = rnd((k, npe, ne), torch.float32)
            rows = cols.reshape(k, nslots).t().contiguous()
            out[f"asm_pack k={k}"] = dict(
                ms=cold_ms(lambda: band2d.asm_pack(cols, bt), 20, flush),
                warm_ms=device_ms(lambda: band2d.asm_pack(cols, bt), 50),
                issue_ms=issue_ms(lambda: band2d.asm_pack(cols, bt), 50),
                plain_ms=cold_ms(lambda: band2d.scatter_corners(cols, bt), 5,
                                 flush),
                library_ms=cold_ms(
                    lambda: torch.zeros((nn, k), device="cuda")
                    .index_add_(0, conn_l, rows), 20, flush),
                bound=bound(nbytes(cols) + tab_b, nn * k * es, nslots * k))
        for k, kg in sites["asm_gather"]:
            cols = rnd((k, npe, ne), torch.float32)
            rows = cols.reshape(k, nslots).t().contiguous()
            out[f"asm_gather k={k} kg={kg}"] = dict(
                ms=cold_ms(lambda: band2d.asm_gather(cols, bt, kg), 20,
                           flush),
                warm_ms=device_ms(lambda: band2d.asm_gather(cols, bt, kg),
                                  50),
                issue_ms=issue_ms(lambda: band2d.asm_gather(cols, bt, kg),
                                  50),
                plain_ms=cold_ms(
                    lambda: band2d.scatter_gather_corners(cols, bt, kg), 5,
                    flush),
                library_ms=None,
                library_two_calls_ms=cold_ms(
                    lambda: torch.zeros((nn, k), device="cuda")
                    .index_add_(0, conn_l, rows)[:, :kg]
                    .index_select(0, conn_l), 20, flush),
                bound=bound(nbytes(cols) + gather_table_bytes(bt) + tab_b,
                            (nn * k + kg * nslots) * es, nslots * k))
        for site, r in out.items():
            lib = (f"{r['library_ms']:.4f}" if r["library_ms"] is not None
                   else f"none as one call (index_add_ + index_select "
                        f"{r['library_two_calls_ms']:.4f})")
            print(f"  {label} {site}: {r['ms']:.4f} ms (L2 warm "
                  f"{r['warm_ms']:.4f}, issued from Python "
                  f"{r['issue_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
                  f"library {lib} ms, bound {r['bound'][0]:.4f} ms by "
                  f"{r['bound'][1]} ({r['bound'][2]} bytes)")
        return out

    for site, r in band_t.items():
        lib = (f"{r['library_ms']:.4f}" if r["library_ms"] is not None
               else f"none as one call (index_add_ + index_select "
                    f"{r['library_two_calls_ms']:.4f})")
        print(f"  {site}: {r['ms']:.4f} ms (L2 warm {r['warm_ms']:.4f}, "
              f"issued from Python {r['issue_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
              f"{r['bound'][0]:.4f} ms by {r['bound'][1]} "
              f"({r['bound'][2]} bytes)")
    del conn_l

    # the tet call sites of the 3D column step (ops/flat3d.py) at the
    # flagship3d-unstructured mesh: the packed gather (8, or 8 + 2 with
    # hydraulic diffusion), the post-move gathers (3, or 6 after surface
    # processes), the force (3, 4 with hydraulic diffusion) and mass (5)
    # assemblies and the thermal + dvoldt hop (2, 1)
    SITES3 = {"cgather": (8, 2, 3, 6, 1), "asm_pack": (3, 4, 5),
              "asm_gather": ((2, 1), (1, 1))}
    sim_mod.create_new_mesh = timed_mesher
    try:
        t = time.perf_counter()
        u3sim = des.Simulation(des.param_from_dict(
            flagship3d_unstructured_cfg()))
        u3sim._chunk_fn(1)                  # builds the gather tables
        sync()
        u3init_s = time.perf_counter() - t
    finally:
        sim_mod.create_new_mesh = mesher
    u3bt = u3sim.ctx.band
    u3nelem, u3nnode = u3sim.ctx.nelem, u3sim.ctx.nnode
    if u3sim.step_path != "flat3d" or u3bt.npe != 4:
        fail(f"flagship3d-unstructured dispatched to {u3sim.step_path!r}")
    print(f"  flagship3d-unstructured (x cut to 128 km) host setup: "
          f"{u3init_s:.1f} s, of which the mesh build {mesh_s[1]:.1f} s "
          f"({u3nelem} tets, {u3nnode} nodes)")
    band_check(f"Delaunay {u3nelem} tets", u3bt, SITES3)
    u3staged = int(u3bt.tile_staged.sum())
    u3tiles = {"tiles": u3bt.tile_staged.numel(), "staged": u3staged,
               "unstaged": u3bt.tile_staged.numel() - u3staged,
               "window_max": int(u3bt.tile_w.max()),
               "window_max_staged": u3bt.win_rows,
               "max_degree": u3bt.g_cols.shape[0]}
    print(f"  gather tiles of {band2d.TILE} elements at {u3nelem} tets: "
          f"{u3staged} staged, {u3tiles['unstaged']} unstaged, widest "
          f"window {u3tiles['window_max']} rows (staged {u3bt.win_rows}), "
          f"max degree {u3tiles['max_degree']}")
    band_t3 = band_times("tets", u3bt, SITES3, 4 * u3nelem)
    del flush

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
    plain_run = flat2d.make_chunk_runner(
        usim.param, usim.ctx, usim.compensation_pressure, 5, plain=True)
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
               lambda n: flat2d.make_chunk_runner(
                   usim.param, usim.ctx, usim.compensation_pressure, n)(
                   usim.ctx, usim.state), 10)

    # ---- 10. the CLI, the file formats and the goldens on the card
    phase10 = cli_formats_goldens(des, wrappers, zero_counts, card)

    # ---- 11. the column step's features on the card
    phase11 = features_on_card(des, wrappers, zero_counts, card, usim,
                               per_kernel, prof_last)

    # ---- 12. the 3D column step on the card
    phase12 = flat3d_on_card(des, wrappers, zero_counts, card, u3sim,
                             per_kernel, prof_last)
    u3mesh = u3sim.mesh             # phase 16 reuses it
    del u3sim

    # ---- 13. remeshing on the card
    phase13 = remesh_on_card(des, wrappers, zero_counts, card, usim, check,
                             rel)
    umesh = usim.mesh               # phase 16 reuses it
    del usim
    torch.cuda.empty_cache()

    # ---- 14. the plane steps and the 3D remeshing on the card
    phase14 = remesh3d_on_card(des, wrappers, zero_counts, card, check, rel,
                               per_kernel, prof_last)

    # ---- 15. the CLI's host features on the card
    phase15 = driver_features_on_card(des, wrappers, zero_counts, card,
                                      check, rel)

    # ---- 16. the pre-relaxations, the 3D generic step, the .poly meshes
    phase16 = prerelax_on_card(des, wrappers, zero_counts, card, check,
                               umesh, u3mesh)
    del u3mesh
    torch.cuda.empty_cache()

    # ---- 17. the registry's models, their frames and post-processing
    phase17 = models_on_card(des, wrappers, zero_counts, card, check, rel)

    # ---- 18. multi-device stepping: the node-sharded halo step
    phase18 = halo_on_card(des, wrappers, zero_counts, card, check, rel,
                           umesh)
    del umesh

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
         "launches_by_path": {
             "pallas2d_res": launches2["fused2d_chunk"],
             "postremesh (pallas2d_res after each remesh, 200 steps)": [
                 r["launches"]["fused2d_chunk"]
                 for r in phase13["postremesh"]["remeshes"]],
             "option 100 from a Delaunay start, test size": phase13[
                 "test_size"][REMESH_2D]["launches"]["fused2d_chunk"]},
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
        {"name": "fused2d_chunk_production", "route": "cuda",
         "source": src2,
         "replaces": "dynearthsol_tpu/ops/pallas2d.py:1330",
         "form": f"the chunk kernel's instance with the Winkler and water "
                 f"tractions and surface process 1 (two materials), one "
                 f"cooperative launch per chunk of {NCH2} steps: the "
                 f"production path (pallas2d_res)",
         "launches": launches2p["fused2d_chunk"],
         "launches_by_path": {"pallas2d_res (production)":
                              launches2p["fused2d_chunk"]},
         "max_abs_err": prod_err,
         "err_metric": "max |kernel - plain| / max |plain| over coord, "
                       "stress, strain, plstrain, force, dhacc and "
                       "edvacc_surf after one production EVP step (16 x "
                       "128 cells), and over every plane (viscosity "
                       "aside, the velocity of dt |f / m|) and the refresh "
                       "scalars of one full-size production maxwell step; "
                       "a 25-step chunk at full size equals 25 one-step "
                       "launches bit for bit",
         "ms": gchunk_ms, "plain_ms": gplain_ms,
         "timed_as": f"per step: CUDA events around 2 chunks of {NCH2} "
                     f"steps, over {2 * NCH2}",
         "stamped_ms": gstamped_ms,
         "grid_barriers_per_step": (len(glabels) - 1) / NCH2,
         "bound_ms": gbound[0], "bound_by": gbound[1],
         "bound_bytes": gbound[2], "bound_ops": gbound[3],
         "library_ms": None, "ms_issued_from_python": gchunk_ms,
         "blocks_per_sm": gocc["blocks_per_sm"], "grid": gocc["grid"],
         "registers": gocc["registers"], "local_bytes": gocc["local_bytes"],
         "bytes_by_phase": {k: v["bytes"] for k, v in gphases.items()},
         "us_by_phase": {k: v["us"] for k, v in gphases.items()}},
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
         "launches_after_3d_remesh": phase13["test_size"][REMESH_3D][
             "launches"],
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
        {"name": "fused3d_step_multimat", "route": "cuda", "source": src3,
         "replaces": "dynearthsol_tpu/ops/pallas3d.py:1583",
         "form": "the mixed instances of phases A, C, E and G (two "
                 "materials: the const pack's weights, the mixtures where "
                 "each phase reads them): the flagship3d_multimat path "
                 "(pallas3d)",
         "launches": launches3m["fused3d_step"], "max_abs_err": mm_err,
         "err_metric": "max |kernel - plain| / max |plain| over the State "
                       "fields of one two-material maxwell step and one "
                       "EVP step (128 x 16 x 8 cells) and one "
                       "flagship3d_multimat EVP step, the plain version "
                       "on the CPU (the small EVP step away from what its "
                       "ties of rounding reach), and over every plane "
                       "(viscosity aside) of one flagship3d_multimat "
                       "maxwell step, the plain version on the card",
         "ms": mstep_ms, "plain_ms": mstep_plain_ms,
         "timed_as": f"chunk form: a CUDA graph of {NCH} steps, their "
                     f"dt_refresh calls and one finalize, over {NCH}",
         "ms_one_step_form": mstep_one_ms,
         "finalize_launches": launches3m["fused3d_finalize"],
         "bound_ms": mbound[0], "bound_by": mbound[1],
         "bound_bytes": mbound[2], "bound_ops": mbound[3],
         "bound_ms_one_step_form": mbound_one[0],
         "bytes_by_phase": phases3m, "library_ms": None},
        {"name": "fused3d_step_production", "route": "cuda", "source": src3,
         "replaces": "dynearthsol_tpu/ops/pallas3d.py:1583",
         "form": "the boundary-process instances of phases E, F, G and H "
                 "(the Winkler and water facet tractions, surface process "
                 "1) and the top-lane pass S, with the two-material "
                 "mixtures: the production3d path (pallas3d)",
         "launches": launches3p["fused3d_step"], "max_abs_err": prod_err,
         "err_metric": "max |kernel - plain| / max |plain| over the State "
                       "fields, dhacc and edvacc_surf of a 10-step maxwell "
                       "chunk with the tractions and surface process 1 and "
                       "over the State fields of one production3d EVP step "
                       "(128 x 16 x 8 cells, the plain version on the CPU; "
                       "the EVP step away from what its ties of rounding "
                       "reach), and over every plane (viscosity aside) of "
                       "one full-size production3d maxwell step, the plain "
                       "version on the card; a 20-step EVP chunk at full "
                       "size equals 20 complete steps bit for bit",
         "ms": pstep_ms, "plain_ms": pstep_plain_ms,
         "timed_as": f"chunk form: a CUDA graph of {NCH} steps, their "
                     f"dt_refresh calls and one finalize, over {NCH}",
         "ms_one_step_form": pstep_one_ms,
         "finalize_launches": launches3p["fused3d_finalize"],
         "bound_ms": pbound[0], "bound_by": pbound[1],
         "bound_bytes": pbound[2], "bound_ops": pbound[3],
         "bound_ms_one_step_form": pbound_one[0],
         "bytes_by_phase": phases3p, "library_ms": None},
    ]
    # phase 15a's subduction-2d runs on the resident runner, or on the
    # tiled one where the 8-material instance misses the resident gate
    sub = phase15["subduction"]["phase_change_option_1"]
    sub_name = ("fused2d_chunk" if sub["step_path"] == "pallas2d_res"
                else "fused2d_step")
    for k in kernels:
        if k["name"] == sub_name:
            k["launches_by_path"][
                f"subduction-2d, 8 materials, phase changes "
                f"({sub['step_path']}, phase 15a), per step"] = \
                sub["launches_per_step"].get("fused2d_chunk", 0)
    rsf = phase15["rsf_cycle"]["full"]["launches_per_step"]
    srcb = "dynearthsol_tpu_torch/csrc/band2d.cu"
    for name, main_site, line in (
            ("asm_gather", "asm_gather k=2 kg=1", 519),
            ("cgather", "cgather k=6", 663),
            ("asm_pack", "asm_pack k=5", 795)):
        r = band_t[main_site]
        kernels.append({
            "name": name, "route": "cuda", "source": srcb,
            "replaces": f"dynearthsol_tpu/ops/band2d.py:{line}",
            "launches": launches_u[name],
            "launches_goldens_f64": {
                case: g["launches"][name]
                for case, g in phase10["goldens"].items()},
            "launches_features": {
                path: r["launches"][name]
                for path, r in phase11["paths"].items()},
            "launches_golden_evp_winkler_2d":
                phase11["golden"]["launches"][name],
            "launches_flat3d": {
                path: r["launches"][name]
                for path, r in phase12["paths"].items()},
            "launches_goldens_3d": {
                case: g["launches"][name]
                for case, g in phase12["goldens"].items()},
            "launches_postremesh_before_the_remesh":
                phase13["postremesh"]["launches_before"][name],
            "launches_after_option_11_remesh": phase13["test_size"][
                REMESH_11]["launches"][name],
            "launches_golden_evp_remesh_3d":
                phase14["golden"]["launches"][name],
            "launches_after_metric_remesh_3d": phase14["remesh"][
                METRIC_3D]["launches"][name],
            "launches_after_option_100_3d_fallback": phase14["remesh"][
                FALLBACK_3D]["launches"][name],
            "launches_per_step_rsf_cycle_2d": rsf.get(name, 0),
            "launches_isostasy": {
                label: r["launches"][name]
                for label, r in phase16["isostasy"].items()},
            "launches_body_force_2d": phase16["body_force_2d"]["launches"][
                name],
            "launches_generic3d": phase16["generic3d"]["launches"][name],
            "launches_golden_ep_remesh_2d": phase16["golden_ep_remesh_2d"][
                "launches"][name],
            "launches_halo": phase18["launches_halo"][name],
            "launches_halo_per_shard_per_step": phase18["rates_f32"][
                "by_layout"]["4 shards"][
                "band_launches_per_shard_per_step"][name],
            "max_abs_err": band_err[name],
            "err_metric": "max |kernel - plain| over random inputs at a "
                          "small Delaunay mesh, a tet mesh, the "
                          "277k-triangle mesh and the 680,794-tet "
                          "flagship3d-unstructured mesh, f32 and f64, every "
                          "call site's k (torch.equal required)",
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "bound_bytes": r["bound"][2], "bound_ops": r["bound"][3],
            "library_ms": r["library_ms"],
            "ms_issued_from_python": r["issue_ms"],
            "timed_at": main_site + ", 277k-triangle mesh, f32, L2 flushed "
                        "before each call",
            **({"gather_tiles": utiles} if name != "asm_pack" else {}),
            "call_sites": {
                site: {"ms": v["ms"], "ms_l2_warm": v["warm_ms"],
                       "ms_issued_from_python": v["issue_ms"],
                       "plain_ms": v["plain_ms"],
                       "library_ms": v["library_ms"],
                       "library_two_calls_ms":
                           v.get("library_two_calls_ms"),
                       "bound_ms": v["bound"][0],
                       "bound_bytes": v["bound"][2]}
                for site, v in band_t.items() if site.startswith(name)},
            **({"gather_tiles_flat3d": u3tiles} if name != "asm_pack"
               else {}),
            "call_sites_flat3d": {
                site: {"ms": v["ms"], "ms_l2_warm": v["warm_ms"],
                       "ms_issued_from_python": v["issue_ms"],
                       "plain_ms": v["plain_ms"],
                       "library_ms": v["library_ms"],
                       "library_two_calls_ms":
                           v.get("library_two_calls_ms"),
                       "bound_ms": v["bound"][0],
                       "bound_by": v["bound"][1],
                       "bound_bytes": v["bound"][2]}
                for site, v in band_t3.items() if site.startswith(name)}})
    # phase 17's models run on grid2d / grid3d: no hand-written kernel
    # (each instance counted by its wrapper's count)
    wrapper_of = {"fused2d_step": "fused2d_chunk",
                  "fused2d_chunk_production": "fused2d_chunk",
                  "fused3d_step_multimat": "fused3d_step",
                  "fused3d_step_production": "fused3d_step"}
    for k in kernels:
        w = wrapper_of.get(k["name"], k["name"])
        k["launches_registry_models"] = {
            name: m["launches"][w] for name, m in phase17["models"].items()}
    script_s = time.perf_counter() - t_start
    print(f"chip_smoke.py: {script_s:.1f} s in all")
    print(json.dumps({"kernels": kernels,
                      "elem_steps_per_s": rate,
                      "plain_elem_steps_per_s": plain_rate,
                      "elem_steps_per_s_tiled": tiled_rate,
                      "elem_steps_per_s_production": grate,
                      "elem_steps_per_s_3d": rate3,
                      "plain_elem_steps_per_s_3d": plain_rate3,
                      "elem_steps_per_s_3d_multimat": mrate,
                      "elem_steps_per_s_production3d": prate,
                      "init_s_production3d": pinit_s,
                      "elem_steps_per_s_unstructured": urate,
                      "plain_elem_steps_per_s_unstructured": uplain_rate,
                      "init_s_unstructured": uinit_s,
                      "mesh_s_unstructured": mesh_s[0],
                      "init_s_3d": init3_s,
                      "cli": phase10,
                      "features": phase11,
                      "flat3d": phase12,
                      "remesh": phase13,
                      "grids_remesh3d": phase14,
                      "driver_features": phase15,
                      "prerelax_generic3d_poly": phase16,
                      "models_and_output": phase17,
                      "halo": phase18,
                      "init_s_flagship3d_unstructured": u3init_s,
                      "mesh_s_flagship3d_unstructured": mesh_s[1],
                      "script_s": script_s}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
