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
solve the assembled system.  Multi-device and distributed solves run through
:class:`.parallel.ShardedNetworkSolver` (shards on one or several CUDA
devices, and across processes under ``torch.distributed``).
:meth:`Solver.factorize` keeps a resistance-side factorization for
rhs-only re-solves (:mod:`.factorization`).  :func:`solve_sweep`
(:mod:`.batch`) solves a batch of coefficient scenarios: the blocked forest
route takes them in its kernels' scenario axis (the launches of one solve),
every other route a row at a time.

Differentiable: the blocked route.  ``build_schur_executor(asm, opts)`` on
a uniformly-K-ary forest returns an executor whose outputs carry PyTorch's
autograd graph back to R, f and the boundary data when an input requires
grad (:mod:`.adjoint`: hand-written transposes of K1 and K5 and the adjoint
λ solve on the stored factor); ``outputs="flat"`` gives the reference's
``(x, iters, residual, rhs_norm, finite)`` contract on public-order
inputs, so ``torch.autograd.grad`` of any functional of ``x`` works as
``jax.grad`` does in the reference.  Every other route, the sweeps and
the sharded solves raise ``NotImplementedError`` (ROADMAP A9c) for an
input that requires grad; a double backward raises.

What is left is listed in ROADMAP.md: the scenario axis on the other
routes (A9b), gradients through the other routes, the sweeps and the
factorizations (A9c-2 to A9c-4), float32 (A4b), the sharded sweeps (A9d),
and output and I/O (A11).
"""

from . import batch, network_generation, post_processing
from .assembly import HydraulicNetworkAssembler
from .batch import SweepResult, solve_sweep
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
    "batch",
    "solve_sweep",
    "SweepResult",
]
