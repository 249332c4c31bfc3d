"""The port's model registry (dynearthsol_tpu_torch/models/) against the JAX
package's, and ``Simulation.step_once``, on the CPU.

- The registry names, and each in-repo constructor's Param at a small width,
  field for field.
- The four constructors that load a cfg of the reference checkout raise the
  JAX constructors' FileNotFoundError (same errno, same path): that checkout
  is not in the repository.
- At a small width, each in-repo model (float32, averaged output on, as
  the registry builds it) takes the JAX package's step path (grid2d /
  grid3d: the fused gates refuse averaged output), and ``step_once``
  equals ``run_steps(1)`` bit for bit.  Its step is held to the JAX
  package's in float64: one EVP step from the state of 5 maxwell steps of
  the same model run by the JAX package, every floating field within
  1e-10 of its max (dpressure, a difference of traces, at the stress's).
  Not in float32: there the packages part by rounding amplified, not by
  their arithmetic (measured on these four models, one step): from rest,
  XLA's contracted multiply-adds move the interior forces' cancellation,
  so the velocity parts by 1.7e-5-6.4e-5 of its max in 2D, and in 3D the
  corners that have not moved tie exactly in the EVP min-select
  (rheology.cxx:869-879) and the two packages pick apart (velocity
  2.1e-3-6.9e-2, stress 5.8e-5-8.2e-4); from the maxwell state damping
  option 1 takes sign(v) of velocities at rounding (velocity 1.3e-3-6.1e-2)
  (ROADMAP.md, limits of comparison).  In float64 the same steps agree to
  1.2e-13.
"""

import dataclasses

import numpy as np
import pytest
import torch

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu import config as jconfig
from dynearthsol_tpu import models as jmodels
from dynearthsol_tpu_torch import config as tconfig
from dynearthsol_tpu_torch import models as tmodels
from dynearthsol_tpu_torch.state import FIELD_NAMES
from torch_cases import carry

SMALL = {"rifting-2d": (32, 16), "production-rifting-2d": (32, 16),
         "oblique-rift-3d": (8, 4, 4), "production-rifting-3d": (8, 4, 4)}
REFERENCE_CFG = ("rifting-2d-layered", "maxwell", "oedometer-2d",
                 "2d-consolidation")


def _fields(p):
    return {(sec.name, f.name): getattr(getattr(p, sec.name), f.name)
            for sec in dataclasses.fields(p)
            for f in dataclasses.fields(getattr(p, sec.name))}


def test_registry_names_equal_jax():
    assert list(tmodels.REGISTRY) == list(jmodels.REGISTRY)
    assert set(SMALL) | set(REFERENCE_CFG) == set(tmodels.REGISTRY)
    for name, fn in tmodels.REGISTRY.items():
        assert fn.__name__ == jmodels.REGISTRY[name].__name__
        assert fn.__doc__ == jmodels.REGISTRY[name].__doc__


def test_constructors_give_the_jax_params():
    """At the default width and at the small one, every field."""
    for name, small in SMALL.items():
        for args in ((), small):
            a = _fields(jmodels.REGISTRY[name](*args))
            b = _fields(tmodels.REGISTRY[name](*args))
            assert list(a) == list(b)
            diff = [k for k in a if a[k] != b[k]]
            assert not diff, (name, args, diff)


def test_reference_cfg_constructors_raise_as_jax():
    for name in REFERENCE_CFG:
        with pytest.raises(FileNotFoundError) as ja:
            jmodels.REGISTRY[name]()
        with pytest.raises(FileNotFoundError) as ta:
            tmodels.REGISTRY[name]()
        assert (ta.value.errno, ta.value.filename) == \
            (ja.value.errno, ja.value.filename), name


def _param(pkg_config, models, name, dtype, rheology=None):
    p = models.REGISTRY[name](*SMALL[name])
    p.sim.float_dtype = dtype
    if rheology:
        p.mat.rheology_type = rheology
    return pkg_config.validate(p)


@pytest.mark.parametrize("name", list(SMALL))
def test_small_width_path_and_step(name):
    # float32, as built: the JAX package's path; step_once is one step
    js = jdes.Simulation(jmodels.REGISTRY[name](*SMALL[name]))
    js._chunk_fn(1)  # sets the path (the runner is not called)
    ts = tdes.Simulation(tmodels.REGISTRY[name](*SMALL[name]), device="cpu")
    assert ts.param.sim.is_outputting_averaged_fields
    s0 = ts.state
    a = ts.step_once()
    ts.state = s0
    b = ts.run_steps(1)
    assert ts.step_path == js.step_path == \
        ("grid3d" if ts.param.sim.ndims == 3 else "grid2d")
    for f in FIELD_NAMES:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(a.steps) == 1

    # float64: one EVP step from the JAX package's 5-step maxwell state
    jm = jdes.Simulation(_param(jconfig, jmodels, name, "float64",
                                "maxwell"))
    jm.run_steps(5, chunk=5)
    js = jdes.Simulation(_param(jconfig, jmodels, name, "float64"))
    js.state = jm.state
    ts = tdes.Simulation(_param(tconfig, tmodels, name, "float64"),
                         device="cpu")
    carry(js, ts)
    ref = js.step_once()
    out = ts.step_once()
    assert ts.step_path == js.step_path
    for f in FIELD_NAMES:
        x, y = np.asarray(getattr(ref, f)), getattr(out, f).numpy()
        if x.dtype.kind != "f":
            assert np.array_equal(x, y), f
            continue
        scale = np.abs(np.asarray(ref.stress) if f == "dpressure"
                       else x).max()
        assert np.abs(x - y).max() <= 1e-10 * max(scale, 1e-300), f
