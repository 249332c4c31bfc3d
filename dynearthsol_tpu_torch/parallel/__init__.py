"""Multi-device stepping over a group of torch devices (counterpart of
dynearthsol_tpu/parallel/): the group (group.py), the node-sharded halo
step (halo_step.py), the replicated-nodal shard step (shard_step.py) and
the placement helpers (sharding.py)."""

from .group import ShardAxis, ShardGroup
from .sharding import (make_device_mesh, shard_simulation_state,
                       state_shardings)

__all__ = ["ShardAxis", "ShardGroup", "make_device_mesh",
           "shard_simulation_state", "state_shardings"]
