#!/usr/bin/env python3
"""Time other forms of the nodal assembly beside the shipped kernels.

The shipped kernels are csrc/band2d.cu's (ops/band2d.py asm_pack, and
asm_gather: the same assembly, then the corner gather, two launches).  The
other forms are in tools/band2d_forms.cu: one thread per (node, field)
walking its row (the kernel band2d.cu had before), node blocks staged
through shared memory, asm_gather as one cooperative launch with a grid
sync, and asm_gather as one launch where each node writes its own corners.
Every form is first checked bit for bit against the plain versions.
Beside them: a copy of the same element columns (``clone``), the least a
kernel that reads them takes at this size, and a count on the host of the
32-byte sectors the shipped kernels' warps request.

On the 277,258-triangle Delaunay mesh of chip_smoke.py phase 9, float32,
at the flat step's call sites; device time per call from a CUDA graph, with
the 50 MB L2 flushed before each call (cold) and without (warm).  Needs one
NVIDIA GPU and nvcc; run from the root of the repository:

    python3 tools/band2d_forms.py
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import SMI_QUERY, unstructured_cfg  # noqa: E402
import dynearthsol_tpu_torch as des  # noqa: E402
from dynearthsol_tpu_torch import simulation  # noqa: E402
from dynearthsol_tpu_torch.ops import _build, band2d  # noqa: E402

FORMS = {"field": 0, "staged": 1, "coop": 2, "owner": 3}


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
    return lib


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
    print(f"{bt.nelem} triangles, {nnode} nodes, max degree {maxdeg}, "
          f"float32, on {card}; all forms equal the plain versions")
    for site, (cold, warm) in rows.items():
        print(f"  {site}: {cold:.4f} ms (L2 warm {warm:.4f})")
    sec = sectors(bt)
    print(f"  sectors requested per field plane: asm_pack_kernel "
          f"{sec['asm_pack_requested']} (fewest {sec['asm_pack_fewest']}), "
          f"gather_corners_kernel {sec['gather_requested']} (fewest "
          f"{sec['gather_fewest']})")
    print(json.dumps({"card": card, "ms_cold_warm": rows, "sectors": sec}))


if __name__ == "__main__":
    main()
