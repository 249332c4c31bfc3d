"""The port's node-sharded halo step (dynearthsol_tpu_torch/parallel/
halo_step.py) on 4 shards of the CPU, against the JAX package's
``run_halo`` on 4 of the 8 virtual devices of tests/conftest.py and
against the port's single-device generic step (ops/flat2d.py,
ops/flat3d.py ``make_flat_step(..., generic=True)``), all from the JAX
initial state, on tests/test_halo.py's 64 x 8-cell raster (f64) and a
32 km x 4 km x 4 km tetrahedral box.

Tolerances are tests/test_halo.py's: 1e-12 of each field's largest value,
1e-9 where facet tractions or surface process 1 run (their facet sums
group differently), between the port's halo step and its single-device
step.  Against the JAX package's halo step the distance between the two
packages' single-device generic steps adds to it: the two step
formulations round differently (1e-17 after one step), and plastic
yielding and the dynamic relaxation amplify that (2.0e-12 of the stress
after 20 EVP steps, 1.05e-10 of the velocity after 20 steps with facet
tractions, 2.2e-13 with hydraulic diffusion, 9.2e-14 in 3D;
tests/test_torch_generic2d.py holds the two steps).  That distance is
itself held first, under a fixed limit per case about 5-10 times what it
measures, so a fault of the shared generic step cannot widen the bound.
The overlap rows of neighbouring shards and the
scalars of every shard agree bit for bit; two runs give the same bits;
each shard holds about 1/N of the nodal state.

The suite keeps at most 7 items in a file (tests/test_torch_io_refusals.py
says why).
"""

from dataclasses import fields

import numpy as np
import pytest
import torch

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu_torch.ops import band2d, flat2d, flat3d
from dynearthsol_tpu_torch.parallel import ShardGroup
from dynearthsol_tpu_torch.parallel import halo_step as TH
from dynearthsol_tpu_torch.state import FIELD_NAMES, state_from_numpy
from torch_cases import (HALO_FACETS, HALO_FIELDS, HALO_HYD, flat3d_cfg,
                         halo_cfg, rel_err)

NDEV = 4

# (config, steps, tolerance, limit of the two packages' single-device
# distance, extra fields)
CASES = {
    "evp": (halo_cfg(), 20, 1e-12, 1e-11, ()),
    "maxwell_hydraulic": (halo_cfg(
        "maxwell", control={"has_hydraulic_diffusion": True},
        mat=HALO_HYD), 10, 1e-12, 1e-12, ("ppressure",)),
    "facets_surface1": (halo_cfg(**HALO_FACETS), 20, 1e-9, 1e-9,
                        ("dhacc", "edvacc_surf")),
    "box3d": (flat3d_cfg(mesh={"xlength": 32e3}), 10, 1e-12, 1e-12, ()),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Four shard threads on a CPU pool sized for one: keep each to one
    intra-op thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def devices8():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices; set "
                    "XLA_FLAGS=--xla_force_host_platform_device_count=8")
    return jax.devices()[:8]


def _start(cfg):
    """(JAX Simulation, port Simulation with the JAX initial state)."""
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    ts.state = state_from_numpy(
        {f: np.asarray(getattr(js.state, f)) for f in FIELD_NAMES},
        dtype=ts.dtype)
    return js, ts


def _single(ts, n):
    """The port's single-device generic step, n steps from ts.state."""
    from dataclasses import replace
    ctx = replace(ts.ctx, band=band2d.build_tables(
        ts.topo.connectivity, ts.topo.nnode, "cpu"))
    mod = flat3d if ctx.ndims == 3 else flat2d
    return mod.make_chunk_runner(ts.param, ctx, ts.compensation_pressure,
                                 n, generic=True)(ctx, ts.state)


@pytest.mark.parametrize("case", list(CASES))
def test_halo_matches_jax_and_single_device(case, devices8):
    from jax.sharding import Mesh
    from dynearthsol_tpu.parallel.halo_step import run_halo as jrun_halo

    import jax
    from dynearthsol_tpu.simulation import make_step_fn

    cfg, n, tol, limit, extra = CASES[case]
    js, ts = _start(cfg)
    single = _single(ts, n)
    step = jax.jit(make_step_fn(js.param, js.compensation_pressure))
    jsingle = js.state
    for _ in range(n):
        jsingle = step(js.ctx, jsingle)
    ref = jrun_halo(js, Mesh(np.asarray(devices8[:NDEV]), ("e",)), n,
                    chunk=n)
    out = TH.run_halo(ts, ShardGroup(["cpu"] * NDEV), n, chunk=n)
    for f in HALO_FIELDS + extra:
        a = getattr(out, f).numpy()
        assert rel_err(getattr(single, f).numpy(), a) < tol, (f, "single")
        steps = rel_err(np.asarray(getattr(jsingle, f)),
                        getattr(single, f).numpy())
        assert steps < limit, (f, "single devices", steps)
        assert rel_err(np.asarray(getattr(ref, f)), a) < tol + steps, \
            (f, "jax")


@pytest.fixture(scope="module")
def facet_run():
    """The facet case's per-shard states after 20 halo steps, twice."""
    cfg = CASES["facets_surface1"][0]
    _, ts = _start(cfg)
    runs = []
    for _ in range(2):
        group = ShardGroup(["cpu"] * NDEV)
        ctx_sh, st, run_chunk, plan = TH.make_halo_runner(ts, group)
        runs.append((run_chunk(ctx_sh, st, 20), plan, group))
    return ts, runs


def test_overlap_rows_and_scalars_bit_identical(facet_run):
    ts, runs = facet_run
    st, plan, group = runs[0]
    assert group.stats[0]["collectives"] > 0
    h2 = 2 * plan.h
    nodal = [f.name for f in fields(ts.state)
             if TH._field_kind(ts.state, f.name, plan) == "nodal"]
    for d in range(NDEV - 1):
        for f in nodal:
            a = getattr(st[d], f)[plan.width - h2:]
            b = getattr(st[d + 1], f)[:h2]
            assert torch.equal(a, b), (d, f)
    for f in ("dt", "time", "steps", "l2_residual", "max_global_vel_mag",
              "global_dt_min"):
        vals = [getattr(s, f) for s in st]
        assert all(torch.equal(vals[0], v) for v in vals[1:]), f


def test_two_runs_give_the_same_bits(facet_run):
    _, runs = facet_run
    (a, _, _), (b, _, _) = runs
    for d in range(NDEV):
        for f in FIELD_NAMES:
            assert torch.equal(getattr(a[d], f), getattr(b[d], f)), (d, f)


def test_halo_memory_scales(facet_run):
    """A shard's nodal window is ~nnode/ndev + 2h rows, not nnode."""
    ts, runs = facet_run
    st, plan, _ = runs[0]
    nnode = ts.topo.nnode
    assert plan.width == plan.block + 2 * plan.h
    assert plan.width < nnode / 2, (plan.width, nnode)
    nodal = [f.name for f in fields(ts.state)
             if TH._field_kind(ts.state, f.name, plan) == "nodal"]
    whole = sum(getattr(ts.state, f).nbytes for f in nodal)
    for s in st:
        assert s.coord.shape == (plan.width, 2)
        part = sum(getattr(s, f).nbytes for f in nodal)
        assert part == whole * plan.width // nnode
