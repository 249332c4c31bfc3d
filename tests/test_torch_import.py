"""The PyTorch port imports without JAX (and without h5py, which only its
VTKHDF frames need) and never names the JAX package."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "dynearthsol_tpu_torch"


def test_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['dynearthsol_tpu'] = None; "
            "sys.modules['h5py'] = None; "
            "import dynearthsol_tpu_torch as d; "
            "from dynearthsol_tpu_torch.ops import "
            "fused2d, fused3d, eig3, _build, band2d, flat2d, fields; "
            "from dynearthsol_tpu_torch.mesh import refine2d; "
            "from dynearthsol_tpu_torch import (compare, postproc, "
            "remeshing, runtime_info, __main__); "
            "from dynearthsol_tpu_torch.io import (output, restart, tagged, "
            "vtkhdf); "
            "from dynearthsol_tpu_torch.utils import (glibc_rand, geotherm, "
            "gravity, terrigenous); "
            "from dynearthsol_tpu_torch.models import REGISTRY; "
            "from dynearthsol_tpu_torch.parallel import (group, halo_step, "
            "shard_step, sharding); "
            "assert d.Simulation.step_once; "
            "print(d.Simulation.__name__)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "Simulation"


def test_no_jax_in_sources():
    files = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    assert files
    for p in files + [ROOT / "chip_smoke.py"]:
        text = p.read_text()
        assert "import jax" not in text, p
        assert "dynearthsol_tpu." not in text, p
        assert "from dynearthsol_tpu " not in text, p
