"""Multi-device (sharded) execution of the network solve."""

from . import multihost, sharding, sweep
from .multihost import ensure_distributed
from .sharding import ShardedNetworkSolver, shard_solve
from .sweep import sharded_sweep

__all__ = [
    "multihost",
    "sharding",
    "sweep",
    "ShardedNetworkSolver",
    "shard_solve",
    "sharded_sweep",
    "ensure_distributed",
]
