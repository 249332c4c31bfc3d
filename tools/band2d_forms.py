#!/usr/bin/env python3
"""Time other forms of the gather and assembly kernels beside the shipped
ones.

The shipped kernels are csrc/band2d.cu's (ops/band2d.py cgather; asm_pack;
asm_gather: the same assembly, then the corner gather, two launches).  The
other forms are in tools/band2d_forms.cu.  Assembly: one thread per
(node, field) walking its row (the kernel band2d.cu had before), node
blocks staged through shared memory, asm_gather as one cooperative launch
with a grid sync, and asm_gather as one launch where each node writes its
own corners.  Gather, at cgather's k = 6 and 2 and at asm_gather's kg = 1
of k = 2 and k = 1 sums: one thread per corner slot (the kernel band2d.cu
had before), one thread per element with no staging (the shipped kernel
with every tile unstaged), the staged tiles at 256, 512, 1024 and 2048
elements, int32 ids less the window base in place of the int16 relative
ids, a persistent grid that copies the next tile's window while it
reads the current one, 128 or 512 threads a block in place of 256, and
streaming stores.  Every form is first checked bit for bit against
the plain versions.  Beside them: a copy of the same element columns
(``clone``), the least a kernel that reads them takes at this size, a
count on the host of the 32-byte sectors the per-slot and per-node
kernels' warps request, the tiles' windows, and the flagship-unstructured
rate with the shipped gather, every tile unstaged and the per-slot
gather, in turns in one process.

On the 277,258-triangle Delaunay mesh of chip_smoke.py phase 9, float32,
at the flat step's call sites; device time per call from a CUDA graph, with
the 50 MB L2 flushed before each call (cold) and without (warm).  Needs one
NVIDIA GPU and nvcc; run from the root of the repository:

    python3 tools/band2d_forms.py
"""

import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import SMI_QUERY, unstructured_cfg  # noqa: E402
import dynearthsol_tpu_torch as des  # noqa: E402
from dynearthsol_tpu_torch import simulation  # noqa: E402
from dynearthsol_tpu_torch.ops import _build, band2d, flat2d  # noqa: E402

FORMS = {"field": 0, "staged": 1, "coop": 2, "owner": 3}
GATHER_FORMS = {"slot": 0, "tiles": 1, "rel32": 2, "persist": 3,
                "nt128": 4, "nt512": 5, "stcs": 6}
TILES = (256, 512, 1024, 2048)
# (site, k columns gathered, ld: the pack's row length)
GATHER_SITES = (("cgather k=6", 6, 6), ("cgather k=2", 2, 2),
                ("asm_gather's gather kg=1 of k=2", 1, 2),
                ("asm_gather's gather kg=1 of k=1", 1, 1))


def build() -> ctypes.CDLL:
    out = ROOT / "build" / "band2d_forms" / "libforms.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(out), str(Path(__file__).with_suffix(".cu"))],
                   check=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.band2d_form.argtypes = [I, I, P, P, P, P, I, I, I, I, P, P, P]
    lib.band2d_form.restype = I
    lib.band2d_gather_form.argtypes = [I, I, I, I, P, P, P, P, P, P, I, I,
                                       I, I, P, P]
    lib.band2d_gather_form.restype = I
    return lib


def tile_tables(conn_cm, tile, device="cuda"):
    """ops/band2d.tile_windows at another tile size, on the device, with
    the window statistics: {lo, w, staged, rel, ntiles, win_rows, stats}."""
    lo, w, staged, rel = band2d.tile_windows(conn_cm, tile)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype) \
            .contiguous().to(device)

    nnode = int(conn_cm.max()) + 1
    return {"lo": dev(lo, torch.int32), "w": dev(w, torch.int32),
            "staged": dev(staged, torch.bool),
            "rel": dev(rel.reshape(-1), torch.int16), "ntiles": len(lo),
            "win_rows": int(w[staged].max(initial=0)),
            "stats": {"tiles": len(lo), "staged": int(staged.sum()),
                      "window_max": int(w.max()),
                      "window_mean": float(w.mean()),
                      "windows_over_nnode": float(w[staged].sum() / nnode)}}


def sectors(bt):
    """32-byte sectors of float32 data that the warps of the shipped
    kernels request, per field plane, against the fewest that hold the
    data: asm_pack_kernel (32 nodes a warp, one load per row position d)
    reading the element columns, and gather_corners_kernel (32 slots a
    warp) reading a (nnode, 2) pack's first column, as asm_gather's second
    launch does at k = 2, kg = 1."""
    rp = bt.row_ptr.cpu().numpy().astype(np.int64)
    slots = bt.slots.cpu().numpy().astype(np.int64)
    deg = np.diff(rp)
    node = np.arange(len(deg))
    asm = 0
    for d in range(int(deg.max())):
        live = deg > d
        sec = slots[rp[:-1][live] + d] // 8
        asm += np.unique(np.stack([node[live] // 32, sec])
                         .T, axis=0).shape[0]
    conn = bt.conn_cm.cpu().numpy().astype(np.int64)
    sec = (conn * 2) // 8
    gat = np.unique(np.stack([np.arange(len(conn)) // 32, sec]).T,
                    axis=0).shape[0]
    return {"asm_pack_requested": asm, "asm_pack_fewest": len(slots) // 8,
            "gather_requested": gat,
            "gather_fewest": -(-2 * bt.nnode // 8)}


def end_to_end(lib, rounds=8, steps=100):
    """elem*steps/s of the flagship-unstructured flat step with each
    gather form, in turns in one process (one Simulation, the state fed
    forward): the shipped tiles, every tile unstaged, and the parent's
    per-slot kernel (tools form `slot`, behind cgather and asm_gather's
    gather half).  Halfway, one float64 k=6 cgather, whose windows take
    over 48 KB of shared memory (the attribute set above 48 KB), as
    chip_smoke.py's phase 8 launches before phase 9.  Returns {form:
    [rate per round]}."""
    sim = des.Simulation(des.param_from_dict(unstructured_cfg()))
    sim.run_steps(steps, chunk=steps)           # builds ctx.band
    bt = sim.ctx.band
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def slot(pack, k):
        out = torch.empty((k, bt.npe, bt.nelem), dtype=pack.dtype,
                          device=pack.device)
        rc = lib.band2d_gather_form(
            GATHER_FORMS["slot"], band2d.TILE, k, pack.shape[1],
            ctypes.c_void_p(pack.data_ptr()), *bt.c_tiles[:5],
            bt.tile_lo.numel(), bt.win_rows, bt.npe, bt.nelem,
            ctypes.c_void_p(out.data_ptr()), stream())
        if rc:
            raise RuntimeError(f"slot gather: {_build.err(rc)}")
        return out

    def runner(ctx, cgather=None, asm_gather=None):
        orig = band2d.cgather, band2d.asm_gather
        band2d.cgather = cgather or orig[0]
        band2d.asm_gather = asm_gather or orig[1]
        try:
            return flat2d.make_chunk_runner(sim.param, ctx,
                                            sim.compensation_pressure, steps)
        finally:
            band2d.cgather, band2d.asm_gather = orig

    none = dataclasses.replace(bt, tile_staged=torch.zeros_like(
        bt.tile_staged), win_rows=0)
    runs = {"shipped": runner(sim.ctx),
            "unstaged": runner(dataclasses.replace(sim.ctx, band=none)),
            "slot (parent)": runner(
                sim.ctx, lambda pack, _: slot(pack, pack.shape[1]),
                lambda cols, _, kg: (lambda s: (s, slot(s, kg)))(
                    band2d.asm_pack(cols, bt)))}
    state = sim.state
    for run in runs.values():
        state = run(sim.ctx, state)
    rates = {name: [] for name in runs}
    names = list(runs)
    for r in range(rounds):
        if r == rounds // 2:
            band2d.cgather(torch.randn((bt.nnode, 6), dtype=torch.float64,
                                       device=bt.conn_cm.device), bt)
        for name in names[r % 3:] + names[:r % 3]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = runs[name](sim.ctx, state)
            torch.cuda.synchronize()
            rates[name].append(bt.nelem * steps / (time.perf_counter() - t0))
    if not bool(torch.isfinite(state.vel).all()):
        sys.exit("non-finite velocities after the end-to-end runs")
    return rates


def issue_us(lib, calls=500, rounds=4):
    """Host µs per cgather call (k=6, f32) issued back to back from
    Python, on a mesh small enough (the 16 km x 8 km Delaunay box at 250
    m) that the card keeps up: the wrapper with the shipped tables and
    with every tile unstaged, and the per-slot kernel's bare C call (no
    Python wrapper).  Returns {form: [µs per round]}."""
    from dynearthsol_tpu_torch.mesh.generate import (renumber_mesh,
                                                     unstructured_box_2d)
    m = unstructured_box_2d(16e3, 8e3, 250.0)
    coord, conn = renumber_mesh(m.coord, m.connectivity)
    bt = band2d.build_tables(conn, coord.shape[0], "cuda")
    none = dataclasses.replace(bt, tile_staged=torch.zeros_like(
        bt.tile_staged), win_rows=0)
    pack = torch.randn((bt.nnode, 6), device="cuda")
    out = torch.empty((6, bt.npe, bt.nelem), device="cuda")
    args = (6, 6, ctypes.c_void_p(pack.data_ptr()), *bt.c_tiles[:5],
            bt.tile_lo.numel(), bt.win_rows, bt.npe, bt.nelem,
            ctypes.c_void_p(out.data_ptr()))
    forms = {"shipped": lambda: band2d.cgather(pack, bt),
             "unstaged": lambda: band2d.cgather(pack, none),
             "slot (parent)": lambda: lib.band2d_gather_form(
                 GATHER_FORMS["slot"], band2d.TILE, *args, ctypes.c_void_p(
                     torch.cuda.current_stream().cuda_stream))}
    us = {name: [] for name in forms}
    names = list(forms)
    for r in range(rounds + 1):
        for name in names[r % 3:] + names[:r % 3]:
            fn = forms[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            if r:                                   # round 0 warms up
                us[name].append((t1 - t0) / calls * 1e6)
    return us


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(SMI_QUERY, capture_output=True,
                          text=True).stdout.strip()
    lib = build()
    mesh = simulation.create_new_mesh(
        des.param_from_dict(unstructured_cfg()))
    conn = mesh.connectivity
    nnode = int(conn.max()) + 1
    bt = band2d.build_tables(conn, nnode, "cuda")
    ns = bt.npe * bt.nelem
    maxdeg = bt.g_cols.shape[0]
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(8)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    def graph_ms(body, reps):
        body()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                body()
        g.replay()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        g.replay()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    def times(fn):
        def cold():
            flush.zero_()
            fn()
        return (graph_ms(cold, 20) - graph_ms(flush.zero_, 20),
                graph_ms(fn, 50))

    def form(name, cols, kg, sums, gath):
        def fn():
            rc = lib.band2d_form(
                FORMS[name], cols.shape[0], ptr(cols), ptr(bt.row_ptr),
                ptr(bt.slots), ptr(bt.conn_cm), nnode, ns, maxdeg, kg,
                ptr(sums), ptr(gath),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if rc:
                raise RuntimeError(f"{name}: {_build.err(rc)}")
        return fn

    rows = {}
    for k in (5, 2, 1):
        cols = torch.randn((k, bt.npe, bt.nelem), generator=gen,
                           device="cuda")
        rows[f"copy of the k={k} columns"] = times(lambda: cols.clone())
    for k in (5, 2):
        cols = torch.randn((k, bt.npe, bt.nelem), generator=gen,
                           device="cuda")
        want = band2d.scatter_corners(cols, bt)
        sums = torch.empty_like(want)
        fns = {"shipped": lambda: band2d.asm_pack(cols, bt),
               "field": form("field", cols, 1, sums, sums),
               "staged": form("staged", cols, 1, sums, sums)}
        for name, fn in fns.items():
            sums.fill_(float("nan"))
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(sums if got is None else got, want):
                sys.exit(f"asm_pack {name} k={k} differs from the plain "
                         "version")
            rows[f"asm_pack k={k} {name}"] = times(fn)
    for k, kg in ((2, 1), (1, 1)):
        cols = torch.randn((k, bt.npe, bt.nelem), generator=gen,
                           device="cuda")
        want = band2d.scatter_gather_corners(cols, bt, kg)
        sums = torch.empty_like(want[0])
        gath = torch.empty_like(want[1])
        fns = {"shipped": lambda: band2d.asm_gather(cols, bt, kg),
               "coop": form("coop", cols, kg, sums, gath),
               "owner": form("owner", cols, kg, sums, gath)}
        for name, fn in fns.items():
            sums.fill_(float("nan"))
            gath.fill_(float("nan"))
            got = fn() or (sums, gath)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                sys.exit(f"asm_gather {name} k={k} kg={kg} differs from "
                         "the plain version")
            rows[f"asm_gather k={k} kg={kg} {name}"] = times(fn)
    conn_cm = bt.conn_cm.cpu().numpy().astype(np.int64) \
        .reshape(bt.npe, bt.nelem)
    tabs = {b: tile_tables(conn_cm, b) for b in TILES}
    shipped = tabs[band2d.TILE]
    if not torch.equal(shipped["rel"], bt.rel_cm):
        sys.exit("the tool's tables differ from build_tables'")
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    none = torch.zeros_like(bt.tile_staged)

    def shipped_gather(pack, k, staged, win_rows):
        args = (band2d._ptr(bt.conn_cm), band2d._ptr(bt.rel_cm),
                band2d._ptr(bt.tile_lo), band2d._ptr(bt.tile_w),
                band2d._ptr(staged), win_rows)

        def fn(out):
            rc = _build.load().des_gather_corners(
                0, ptr(pack), pack.shape[1], k, *args, bt.npe, bt.nelem,
                ptr(out), stream())
            if rc:
                raise RuntimeError(f"des_gather_corners: {_build.err(rc)}")
        return fn

    def gather_form(name, tile, pack, k):
        tb = tabs[tile]

        def fn(out):
            rc = lib.band2d_gather_form(
                GATHER_FORMS[name], tile, k, pack.shape[1], ptr(pack),
                ptr(bt.conn_cm), ptr(tb["rel"]), ptr(tb["lo"]), ptr(tb["w"]),
                ptr(tb["staged"]), tb["ntiles"], tb["win_rows"], bt.npe,
                bt.nelem, ptr(out), stream())
            if rc:
                raise RuntimeError(f"{name} B={tile}: {_build.err(rc)}")
        return fn

    for site, k, ld in GATHER_SITES:
        pack = torch.randn((nnode, ld), generator=gen, device="cuda")
        want = band2d.gather_corners(pack[:, :k].contiguous(), bt)
        out = torch.empty_like(want)
        fns = {f"shipped (tiles B={band2d.TILE})":
               shipped_gather(pack, k, bt.tile_staged, bt.win_rows),
               "element, no staging": shipped_gather(pack, k, none, 0),
               "slot (parent)": gather_form("slot", band2d.TILE, pack, k)}
        for b in TILES:
            fns[f"tiles B={b}"] = gather_form("tiles", b, pack, k)
        fns[f"rel32 B={band2d.TILE}"] = gather_form("rel32", band2d.TILE,
                                                    pack, k)
        for b in TILES[:3]:
            fns[f"persist B={b}"] = gather_form("persist", b, pack, k)
        for name in ("nt128", "nt512", "stcs"):
            fns[f"{name} B=1024"] = gather_form(name, 1024, pack, k)
        for name, fn in fns.items():
            out.fill_(float("nan"))
            fn(out)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                sys.exit(f"{site} {name} differs from the plain version")
            rows[f"{site} {name}"] = times(lambda: fn(out))
    print(f"{bt.nelem} triangles, {nnode} nodes, max degree {maxdeg}, "
          f"float32, on {card}; all forms equal the plain versions")
    for site, (cold, warm) in rows.items():
        print(f"  {site}: {cold:.4f} ms (L2 warm {warm:.4f})")
    sec = sectors(bt)
    print(f"  sectors requested per field plane: asm_pack_kernel "
          f"{sec['asm_pack_requested']} (fewest {sec['asm_pack_fewest']}), "
          f"gather_corners_kernel {sec['gather_requested']} (fewest "
          f"{sec['gather_fewest']})")
    for b, tb in tabs.items():
        st = tb["stats"]
        print(f"  tiles of {b} elements: {st['staged']} of {st['tiles']} "
              f"staged, window max {st['window_max']} rows, mean "
              f"{st['window_mean']:.0f}, staged windows "
              f"{st['windows_over_nnode']:.2f} x nnode")
    issue = issue_us(lib)
    for name, r in issue.items():
        print(f"  cgather k=6 issued from Python, {name}: us per call "
              + ", ".join(f"{x:.2f}" for x in r))
    rates = end_to_end(lib)
    for name, r in rates.items():
        h = len(r) // 2
        print(f"  flagship-unstructured, gather {name}: elem*steps/s "
              + ", ".join(f"{x:.4e}" for x in r[:h]) + " | after a "
              "float64 window over 48 KB: "
              + ", ".join(f"{x:.4e}" for x in r[h:]))
    print(json.dumps({"card": card, "ms_cold_warm": rows, "sectors": sec,
                      "tiles": {b: tb["stats"] for b, tb in tabs.items()},
                      "issue_us": issue, "elem_steps_per_s": rates}))


if __name__ == "__main__":
    main()
