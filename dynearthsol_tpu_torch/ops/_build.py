"""Build and load the CUDA kernels of this package at first use.

``nvcc`` compiles every ``.cu`` source under ``csrc/`` into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), in ``build/torch_kernels/<hash>/`` at the root of the checkout,
keyed by a hash of the sources and flags: one ``nvcc -c`` per source, all
started together, then one link.  Each compile's ``-Xptxas -v`` report
(registers, stack frame and spills per kernel) is kept beside the library
as ``ptxas.txt``.  The library is loaded with ``ctypes``.  Nothing here runs
at import time; a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# No --use_fast_math: the creep law exponentiates an O(50) argument and
# __expf would move viscosity.  -fmad=false: no FMA contraction, so every
# +, -, * and / rounds as in the plain PyTorch version (and the initial
# volume from ops/shapefn.compute_volume equals the kernel's bit for bit).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]

_LIB = None
_LOAD = threading.Lock()   # shards (parallel/group.py) load from threads
_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libdes_kernels.so"


def build() -> Path:
    """Compile the sources unless the keyed library exists; return it."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmpdir = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        cu = [p for p in _sources() if p.suffix == ".cu"]
        objs = [tmpdir / (p.stem + ".o") for p in cu]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v",
                                   "-c", "-o", str(o), str(p)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(cu, objs)]
        logs = [pr.communicate()[0] for pr in procs]
        for p, pr, log in zip(cu, procs, logs):
            if pr.returncode != 0:
                raise RuntimeError(f"nvcc failed on {p.name} "
                                   f"({pr.returncode}):\n{log}")
        lib = tmpdir / out.name
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib),
                            *map(str, objs)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stderr}")
        (out.parent / "ptxas.txt").write_text("".join(logs))
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out


def ptxas_report() -> dict:
    """{kernel: (registers, stack frame bytes, spill bytes, static shared
    memory bytes)} from the ``-Xptxas -v`` report of the last build."""
    text = (library_path().parent / "ptxas.txt").read_text()
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            raw = m.group(1)
            k = re.search(r"(phase_[a-hs]|finalize|dt_refresh|"
                          r"grid_barriers|step_chunk2dIfLb[01]ELb[01]|"
                          r"gather_corners_kernelI[jy]Li\d|"
                          r"asm_pack_kernelI[fd]Li\d)", raw)
            src = re.search(r"_(fused\w+?|band2d)_cu_", raw)
            kn = k.group(1) if k else raw
            if kn.startswith("phase_"):
                # the 3D phases' bools: a single material (A, C, E, G),
                # then the facet tractions and surface process 1 (E, F,
                # G, H)
                bools = re.findall(r"Lb([01])E", raw)
                tags = []
                if kn[-1] in "aceg":
                    tags.append("uniform" if bools.pop(0) == "1"
                                else "mixed")
                if bools and bools[0] == "1":
                    tags.append("facets+sp1")
                kn += f"<{','.join(tags)}>" if tags else ""
            if kn.startswith("step_chunk2d"):
                # the bools: single material, facets and surface process 1
                kn = ("step_chunk2d<"
                      + ("uniform" if kn[-5] == "1" else "mixed")
                      + (",facets+sp1" if kn.endswith("1") else "") + ">")
            if kn.startswith(("asm_", "gather_")):
                # the value type (the gather copies 4- or 8-byte words) and
                # k
                kn = f"{kn[:-5]}<{'f32' if kn[-4] in 'fj' else 'f64'}," \
                     f"{kn[-1]}>"
            name = f"{src.group(1) if src else '?'}:{kn}"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and name:
            out[name] = [None, int(m.group(1)), int(m.group(2)), 0]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name][0] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name][3] = int(m.group(1)) if m else 0
    return {k: tuple(v) for k, v in out.items()}


def load():
    """Build if needed, load once, and declare the C entry points."""
    if _LIB is None:
        with _LOAD:
            _load()
    return _LIB


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.des_fused2d_chunk_f32.argtypes = [_P] * 15 + [_I, _I, _I, _P,
                                                          _P]
        lib.des_fused2d_chunk_f32.restype = _I
        lib.des_fused2d_chunk_occupancy.argtypes = [_I, _I, _I, _P]
        lib.des_fused2d_chunk_occupancy.restype = _I
        lib.des_grid_barriers.argtypes = [_I, _I, _P]
        lib.des_grid_barriers.restype = _I
        lib.des_dt_refresh_f32.argtypes = [_P] * 3 + [_I, _P, _P, _P, _I,
                                                      _I, _I, _P]
        lib.des_dt_refresh_f32.restype = _I
        lib.des_fused3d_step_f32.argtypes = [_P] * 16 + [_I, _I, _I, _P]
        lib.des_fused3d_step_f32.restype = _I
        lib.des_fused3d_finalize_f32.argtypes = [_P] * 8
        lib.des_fused3d_finalize_f32.restype = _I
        # the gather tables: conn_cm, rel_cm, tile_lo, tile_w,
        # tile_staged, win_rows (ops/band2d GatherTables.c_tiles)
        tiles = [_P] * 5 + [_I]
        lib.des_gather_corners.argtypes = [_I, _P, _I, _I, *tiles, _I, _I,
                                           _P, _P]
        lib.des_gather_corners.restype = _I
        lib.des_scatter_corners.argtypes = [_I, _P, _I, _P, _P, _I, _I, _I,
                                            _P, _P]
        lib.des_scatter_corners.restype = _I
        lib.des_scatter_gather_corners.argtypes = [_I, _P, _I, _I, _P, _P,
                                                   *tiles, _I, _I, _I, _P,
                                                   _P, _P]
        lib.des_scatter_gather_corners.restype = _I
        lib.des_error_string.argtypes = [_I]
        lib.des_error_string.restype = ctypes.c_char_p
        _LIB = lib


def err(code: int) -> str:
    """CUDA error text of a code returned by a C entry point."""
    return f"{code} ({load().des_error_string(code).decode()})"
