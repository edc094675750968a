"""Post-processing: global flux extraction.

Counterpart of ``networks_fenicsx_tpu/post_processing.py``; only
:func:`extract_global_flux` is ported (file export waits for ``io/``).
"""

from __future__ import annotations

import numpy as np

from .function import FunctionSpace, NetworkFunction
from .mesh import NetworkMesh

__all__ = ["extract_global_flux"]


def extract_global_flux(
    graph_mesh: NetworkMesh, functions: list[NetworkFunction]
) -> NetworkFunction:
    """Merge per-color flux solutions into one parent-mesh DG field.

    Args:
        graph_mesh: The network mesh.
        functions: Solution list ``[flux_0, ..., flux_{M-1}, pressure, lm]``.

    Returns:
        A :class:`NetworkFunction` named ``"Global_Flux"`` whose values are
        organised per parent cell, ``(num_cells, degree + 1)`` flattened, in
        along-edge local order.
    """
    flux_functions = functions[:-2]
    degree = flux_functions[0].space.degree
    C = graph_mesh.num_cells
    global_vals = np.zeros((C, degree + 1), dtype=np.float64)
    for i, flux in enumerate(flux_functions):
        flux.name = f"Flux_{i}"
        view = graph_mesh.submeshes[flux.space.color]
        global_vals[view.cell_indices] = flux.cell_dof_values()
    space = FunctionSpace(graph_mesh, "dg", degree, None, C * (degree + 1))
    return NetworkFunction(space, global_vals.reshape(-1), name="Global_Flux")
