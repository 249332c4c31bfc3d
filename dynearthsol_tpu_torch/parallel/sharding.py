"""The device group and the placement of a state over it (counterpart of
dynearthsol_tpu/parallel/sharding.py).

``make_device_mesh`` makes the group (parallel/group.py) of the first N
cards, as the JAX package takes ``jax.devices()[:n]``, or of N shards of
the CPU.  ``state_shardings`` and ``shard_simulation_state`` place a
State over it: element-leading leaves split in contiguous slices over the
group's devices, the rest replicated on each.

The JAX package's GSPMD step, ``jax.jit(step, out_shardings=...)`` on
such a placement, has no counterpart: it leaves the partitioning of the
step to XLA's SPMD partitioner, which PyTorch does not have.  The
multi-device steps of this package are the node-sharded halo step
(halo_step.py) and the replicated-nodal shard step (shard_step.py).
"""

from __future__ import annotations

import dataclasses

import torch

from .group import ShardGroup

ELEM = "elem"            # split over the group on the leading axis
REPLICATED = "replicated"


def make_device_mesh(n_devices: int | None = None,
                     device: str = "cuda") -> ShardGroup:
    """The group of the first ``n_devices`` cards (all by default), or of
    ``n_devices`` shards of the CPU (one by default) with
    ``device="cpu"``."""
    if device == "cpu":
        return ShardGroup(["cpu"] * (n_devices or 1))
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device; pass device='cpu'")
    n = count if n_devices is None else min(n_devices, count)
    return ShardGroup([torch.device("cuda", i) for i in range(n)])


def state_shardings(state, group: ShardGroup, nelem: int) -> dict:
    """Per-field placement: ELEM for element-leading arrays, REPLICATED
    for everything else."""
    return {f.name: (ELEM if getattr(state, f.name).dim() >= 1
                     and getattr(state, f.name).shape[0] == nelem
                     else REPLICATED)
            for f in dataclasses.fields(state)}


def shard_simulation_state(state, group: ShardGroup, nelem: int):
    """(per-shard states, placements): shard d holds the d-th contiguous
    slice of every element-leading field (``torch.tensor_split``) and a
    copy of the rest, on ``group.devices[d]``."""
    shardings = state_shardings(state, group, nelem)
    out = []
    for d, dev in enumerate(group.devices):
        upd = {}
        for name, how in shardings.items():
            a = getattr(state, name)
            if how == ELEM:
                a = torch.tensor_split(a, group.n)[d]
            upd[name] = a.to(dev)
        out.append(state.replace(**upd))
    return out, shardings
