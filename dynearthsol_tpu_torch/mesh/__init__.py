from .generate import MeshData, create_new_mesh  # noqa: F401
from .topology import (Topology, build_topology,  # noqa: F401
                       build_topology_from_arrays)
