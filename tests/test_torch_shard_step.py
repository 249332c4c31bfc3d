"""The port's replicated-nodal shard step
(dynearthsol_tpu_torch/parallel/shard_step.py) and placement helpers
(parallel/sharding.py) against the JAX package's (parallel/shard_step.py,
parallel/sharding.py), on the CPU: 4 shards of the CPU against 4 of the 8
virtual devices of tests/conftest.py, on tests/test_halo.py's 64 x 8-cell
raster (f64), from the JAX initial state.

The shard step is held at 1e-12 of each field's largest value against
the port's single-device generic step (the group only regroups the nodal
sums), and against the JAX package's ``run_sharded`` beyond the distance
of the two packages' single-device generic steps (tests/test_torch_halo.py
says why that distance adds), which is held first under a fixed limit
per case (2.0e-12 and 2.2e-13 measured).  The group's collectives
(parallel/group.py) are held to their definitions, and a failed or
diverged shard is shown to end a run with its exception.

The suite keeps at most 7 items in a file (tests/test_torch_io_refusals.py
says why).
"""

import numpy as np
import pytest
import torch

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.parallel import shard_step as JS
from dynearthsol_tpu_torch.parallel import ShardGroup
from dynearthsol_tpu_torch.parallel import shard_step as TS
from dynearthsol_tpu_torch.state import FIELD_NAMES
from test_torch_halo import _single, _start, devices8, one_thread  # noqa
from torch_cases import HALO_FACETS, HALO_FIELDS, HALO_HYD, halo_cfg, \
    rel_err

NDEV = 4

# (config, steps, limit of the two packages' single-device distance,
# extra fields)
CASES = {
    "evp": (halo_cfg(), 20, 1e-11, ()),
    "maxwell_hydraulic": (halo_cfg(
        "maxwell", control={"has_hydraulic_diffusion": True},
        mat=HALO_HYD), 10, 1e-12, ("ppressure",)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_shard_step_matches_jax_and_single_device(case, devices8):
    import jax
    from jax.sharding import Mesh
    from dynearthsol_tpu.simulation import make_step_fn

    cfg, n, limit, extra = CASES[case]
    js, ts = _start(cfg)
    single = _single(ts, n)
    step = jax.jit(make_step_fn(js.param, js.compensation_pressure))
    jsingle = js.state
    for _ in range(n):
        jsingle = step(js.ctx, jsingle)
    ref = JS.run_sharded(js, Mesh(np.asarray(devices8[:NDEV]), ("e",)), n,
                         chunk=n)
    out = TS.run_sharded(ts, ShardGroup(["cpu"] * NDEV), n, chunk=n)
    for f in HALO_FIELDS + extra:
        a = getattr(out, f).numpy()
        assert rel_err(getattr(single, f).numpy(), a) < 1e-12, f
        steps = rel_err(np.asarray(getattr(jsingle, f)),
                        getattr(single, f).numpy())
        assert steps < limit, (f, "single devices", steps)
        assert rel_err(np.asarray(getattr(ref, f)), a) < 1e-12 + steps, f


def test_shard_step_refusals_match_jax():
    """Surface processes and facet tractions: the JAX package's refusal,
    word for word."""
    for over in ({"control": HALO_FACETS["control"]},
                 {"bc": HALO_FACETS["bc"]}):
        js, ts = _start(halo_cfg(**over))
        with pytest.raises(NotImplementedError) as ej:
            JS._supported(js.param, js.ctx)
        with pytest.raises(NotImplementedError) as et:
            TS.make_sharded_runner(ts, ShardGroup(["cpu"] * NDEV))
        assert str(ej.value) == str(et.value)


def test_pad_for_mesh_matches_jax():
    """Padding to a multiple of the shards (1,024 elements on 3 shards),
    and back."""
    js, ts = _start(halo_cfg())
    jc, jst, jpad = JS.pad_for_mesh(js, 3)
    tc, tst, tpad = TS.pad_for_mesh(ts, 3)
    assert jpad == tpad == 2 and jc.nelem == tc.nelem
    for f in ("conn", "elem_mask"):
        assert np.array_equal(np.asarray(getattr(jc, f)),
                              getattr(tc, f).numpy()), f
    assert np.array_equal(np.asarray(jc.surf.top_elem_mask),
                          np.asarray(tc.surf.top_elem_mask, np.float64))
    for f in FIELD_NAMES:
        assert np.array_equal(np.asarray(getattr(jst, f)),
                              getattr(tst, f).numpy()), f
    back = TS.unpad_state(tst, ts.topo.nelem)
    for f in FIELD_NAMES:
        assert torch.equal(getattr(back, f), getattr(ts.state, f)), f


def test_placement_matches_jax(devices8):
    """make_device_mesh, state_shardings and shard_simulation_state: the
    element-leading fields split over the group, the rest replicated, as
    the JAX package places them."""
    from jax.sharding import Mesh, PartitionSpec as P
    from dynearthsol_tpu.parallel import state_shardings as jshardings
    from dynearthsol_tpu_torch.parallel import (make_device_mesh,
                                                shard_simulation_state)

    js, ts = _start(halo_cfg())
    nelem = ts.topo.nelem
    group = make_device_mesh(NDEV, device="cpu")
    assert group.n == NDEV
    jsh = jshardings(js.state, Mesh(np.asarray(devices8[:NDEV]),
                                    ("elem",)), nelem)
    parts, how = shard_simulation_state(ts.state, group, nelem)
    for f in FIELD_NAMES:
        split = getattr(jsh, f).spec == P("elem")
        assert (how[f] == "elem") == split, f
        whole = getattr(ts.state, f)
        if split:
            assert torch.equal(torch.cat([getattr(p, f) for p in parts]),
                               whole), f
            assert getattr(parts[0], f).shape[0] == nelem // NDEV
        else:
            assert all(torch.equal(getattr(p, f), whole) for p in parts), f


def test_group_collectives_in_shard_order():
    """ShardGroup's collectives on 4 shards of the CPU: psum adds in shard
    order, the same bits on every shard; pmin, pmax and pminmax are exact;
    exchange adds each neighbour's overlap rows (none at the edges)."""
    group = ShardGroup(["cpu"] * NDEV)
    vals = [1e16, 1.0, -1e16, 1.0]
    want = torch.tensor(vals[0], dtype=torch.float64)
    for v in vals[1:]:
        want = want + v

    def work(d):
        ax = group.axis(d)
        x = torch.tensor(vals[d], dtype=torch.float64)
        buf = torch.arange(8, dtype=torch.float64) + 100 * d
        return (ax.psum(x), ax.pmin(x), ax.pmax(x),
                ax.pminmax(x, -x), ax.exchange(buf, 2))

    out = group.run(work)
    for d, (s, lo, hi, (lo2, hi2), ex) in enumerate(out):
        assert torch.equal(s, want), d
        assert float(lo) == float(lo2) == -1e16
        assert float(hi) == 1e16 and float(hi2) == 1e16
        buf = torch.arange(8, dtype=torch.float64) + 100 * d
        if d > 0:
            buf[:2] += torch.arange(6, 8, dtype=torch.float64) \
                + 100 * (d - 1)
        if d < NDEV - 1:
            buf[6:] += torch.arange(0, 2, dtype=torch.float64) \
                + 100 * (d + 1)
        assert torch.equal(ex, buf), d
    assert all(st["collectives"] == 5 + 1 for st in group.stats)


def test_group_failure_ends_the_run():
    """A shard that raises aborts the others' wait and its exception
    reaches the caller; shards that meet at different collectives raise
    ShardsOutOfStep instead of mixing their data.  Neither hangs."""
    from dynearthsol_tpu_torch.parallel.group import ShardsOutOfStep

    group = ShardGroup(["cpu"] * NDEV)

    def fails(d):
        if d == 2:
            raise ValueError("shard 2 failed")
        return group.axis(d).pmin(torch.zeros(()))

    with pytest.raises(ValueError, match="shard 2 failed"):
        group.run(fails)

    def diverges(d):
        x = torch.zeros(())
        return group.axis(d).pmax(x) if d == 1 else group.axis(d).pmin(x)

    with pytest.raises(ShardsOutOfStep):
        group.run(diverges)
    # the group runs again after a failure
    assert [float(v) for v in group.run(
        lambda d: group.axis(d).psum(torch.ones(())))] == [4.0] * NDEV
