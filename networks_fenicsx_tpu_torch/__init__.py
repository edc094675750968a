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

Ported so far: the Schur solve of every network with DG0 pressure, at any
flux degree, on the reference's routes (:mod:`.solver`): the blocked route
for uniformly-K-ary trees with scalar, per-edge or per-cell R and f; the
level route for any other forest and for callable (quadrature-mode) R and
f; the tree route for bifurcation graphs with cycles (peel rounds, then a
dense, min-degree or multifrontal cycle core); the separable-DCT route for
uniform scalar-R lattices; the CG route (``schur_method="cg"``, and
``auto``'s fallback for a large core without a sparse plan) with its
multigrid, Chebyshev-Jacobi and Jacobi preconditioners; the whole-Laplacian
``schur_method="dense"``/``"dense_f64"``; networks without bifurcations.
Continuous pressure (degree ≥ 1) solves by the reduced ``schur_p`` method;
explicit assembly returns every matrix kind (dense, sparse COO, per-block,
CSR), and the generic methods ``"dense"``, ``"minres"`` and ``"host_lu"``
solve the assembled system.  What is left (factor reuse, float32, batches,
multi-device, the distributed Schur solve, output) is listed in
ROADMAP.md.
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
