"""The fleet's device loop (``FleetRunner``), its device mesh
(``fleet_mesh``) and the multi-host layer (``multihost``)."""

from .fleet_mesh import (build_local_dual_update, make_mesh_dual_update,
                         shard_fleet_state)
from .fleet_runner import FleetCarry, FleetRunner
from .multihost import (hybrid_mesh, initialize, make_hybrid_dual_update,
                        process_local_batch, shard_batch, shard_hybrid_state)

__all__ = ["FleetCarry", "FleetRunner", "make_mesh_dual_update",
           "shard_fleet_state", "build_local_dual_update", "initialize",
           "hybrid_mesh", "shard_batch", "process_local_batch",
           "make_hybrid_dual_update", "shard_hybrid_state"]
