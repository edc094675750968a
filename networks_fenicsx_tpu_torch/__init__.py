"""networks_fenicsx_tpu_torch — hydraulic network finite elements on PyTorch and CUDA.

The PyTorch/CUDA port of :mod:`networks_fenicsx_tpu`, which stays the
reference it is tested against.  Same public names and the same function
list contract ``[flux_0..flux_{M-1}, pressure, global_flux]``, in float64.

The host layer (graph generation, mesh, dof maps, coefficient preparation,
the blocked planner) is NumPy, as in the reference.  The device work of the
solve runs in hand-written CUDA kernels (:mod:`.kernels`) on an explicit
device: ``Solver(asm, device="cuda")`` by default, ``device="cpu"`` for the
kernels' plain PyTorch versions.  This package imports neither JAX nor (on
the ``ArrayNetwork`` path) networkx.

Ported so far: the blocked forest Schur solve (uniformly-K-ary trees, scalar,
per-edge or per-cell R and f, any flux degree, DG0 pressure).  ROADMAP.md
lists what remains.
"""

from . import network_generation, post_processing
from .assembly import HydraulicNetworkAssembler
from .function import FunctionSpace, NetworkFunction
from .mesh import ArrayNetwork, NetworkMesh, color_graph
from .solver import Solver
from .utils.config import ShardingOptions, SolverOptions

__version__ = "0.1.0"
__program_name__ = "networks_fenicsx_tpu_torch"

__all__ = [
    "HydraulicNetworkAssembler",
    "NetworkMesh",
    "post_processing",
    "Solver",
    "network_generation",
    "FunctionSpace",
    "NetworkFunction",
    "ArrayNetwork",
    "color_graph",
    "SolverOptions",
    "ShardingOptions",
]
