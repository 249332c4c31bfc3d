"""Runtime environment report (counterpart of
dynearthsol_tpu/runtime_info.py; runtime_info.cxx:76-176).

The reference prints CPU model / OpenMP thread count / OpenACC device at
startup; here: torch's version, the device's name and count, the CUDA
version and the compute dtype, plus the same mesh-size report."""

from __future__ import annotations

import dataclasses
import os
import platform
import subprocess
import sys
import time

import torch


def report_runtime_status(device=None, dtype=None) -> str:
    lines = ["# Runtime environment:",
             f"#   host: {platform.node()} "
             f"({platform.system()} {platform.machine()})",
             f"#   python {platform.python_version()}, torch "
             f"{torch.__version__}, CUDA {torch.version.cuda or '(none)'}"]
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        idx = dev.index if dev.index is not None else 0
        lines.append(f"#   device: {torch.cuda.get_device_name(idx)} "
                     f"({torch.cuda.device_count()} visible)")
    else:
        lines.append(f"#   device: cpu ({torch.get_num_threads()} threads)")
    if dtype is not None:
        lines.append(f"#   dtype: {str(dtype).replace('torch.', '')}")
    return "\n".join(lines)


def report_mesh_info(sim) -> str:
    """Mesh-size report (runtime_info.cxx:169-176)."""
    t = sim.topo
    nmk = sim.markers.n if sim.markers is not None else 0
    return (f"# mesh: {t.nnode} nodes, {t.nelem} elements, "
            f"{t.nseg} segments, {nmk} markers"
            + (f", structured grid {sim.ctx.sgrid}" if sim.ctx.sgrid
               else ""))


def write_provenance(param, argv_echo: str = "", device=None) -> str:
    """Archive run provenance next to the output, like the reference's
    ``snapshot.diff`` (Makefile:601-632): ``<modelname>.provenance`` with
    the command, the package's git commit, torch and the device, and the
    full resolved parameter set.  Returns the path."""
    path = param.sim.modelname + ".provenance"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def _git(*args):
        try:
            return subprocess.run(("git", "-C", repo) + args,
                                  capture_output=True, text=True,
                                  timeout=10).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            return ""

    lines = [
        f"# dynearthsol_tpu_torch provenance  "
        f"{time.strftime('%Y-%m-%d %H:%M:%S')}",
        f"command: {argv_echo or ' '.join(sys.argv)}",
        f"python: {sys.version.split()[0]}",
        f"git commit: {_git('rev-parse', 'HEAD') or '(not a git repo)'}",
        f"git status: {'dirty' if _git('status', '--porcelain') else 'clean'}",
        f"torch: {torch.__version__} CUDA {torch.version.cuda or '(none)'} "
        f"device={device}",
        "",
        "# resolved parameters",
    ]
    for sec_field in dataclasses.fields(param):
        sec = getattr(param, sec_field.name)
        if not dataclasses.is_dataclass(sec):
            continue
        lines.append(f"[{sec_field.name}]")
        lines.extend(f"{f.name} = {getattr(sec, f.name)}"
                     for f in dataclasses.fields(sec))
        lines.append("")
    with open(path, "w") as fh:
        fh.write("\n".join(lines))
    return path
