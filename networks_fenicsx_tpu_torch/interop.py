"""Carry a reference assembler's state into the port.

The system has no weights: its state is the mesh arrays and the
coefficient data of ``compute_forms``.  :func:`assembler_from_reference_state`
takes that state as NumPy arrays — read off a ``networks_fenicsx_tpu``
assembler, e.g. by the port's tests — and returns a port assembler in the
identical state, so both packages solve from byte-equal buffers.  Nothing
here imports the reference package.
"""

from __future__ import annotations

import numpy as np

from .assembly import HydraulicNetworkAssembler
from .mesh import ArrayNetwork, NetworkMesh

__all__ = ["STATE_KEYS", "assembler_from_reference_state"]

STATE_KEYS = (
    "pos",  # (V, gdim) float64 graph node coordinates
    "edges",  # (E, 2) int64 directed edges
    "radius",  # (E,) float64 per-edge radius, or None
    "N",  # cells per edge
    "flux_degree",
    "pressure_degree",
    "R_mode",  # 'scalar' | 'edge' | 'cell'
    "R_data",  # (1,), (E,) or (C,) float64
    "f_mode",
    "f_data",
    "edge_start_pbc",  # (E,) float64 boundary pressure at edge sources (0 at bifs)
    "edge_end_pbc",  # (E,) float64 boundary pressure at edge targets (0 at bifs)
)

_SIZES = {"scalar": lambda E, C: 1, "edge": lambda E, C: E, "cell": lambda E, C: C}


def assembler_from_reference_state(
    state: dict, color_strategy: str | None = None
) -> HydraulicNetworkAssembler:
    """Port assembler holding ``state`` (keys: :data:`STATE_KEYS`).

    ``color_strategy`` must be the one the reference mesh was built with
    (``None``, its default, or ``"fast"``); when ``state`` also holds
    ``"edge_color"`` the port's coloring is checked against it, since the
    global dof layout follows the colors.
    """
    missing = [k for k in STATE_KEYS if k not in state]
    if missing:
        raise KeyError(f"reference state lacks {missing}")
    radius = state["radius"]
    net = ArrayNetwork(
        pos=np.asarray(state["pos"], dtype=np.float64),
        edges=np.asarray(state["edges"], dtype=np.int64),
        radius=None if radius is None else np.asarray(radius, dtype=np.float64),
    )
    mesh = NetworkMesh(net, N=int(state["N"]), color_strategy=color_strategy)
    if "edge_color" in state and not np.array_equal(
        mesh.edge_color, np.asarray(state["edge_color"])
    ):
        raise ValueError("edge coloring differs from the reference state's")
    asm = HydraulicNetworkAssembler(
        mesh,
        flux_degree=int(state["flux_degree"]),
        pressure_degree=int(state["pressure_degree"]),
    )
    E, C = mesh.num_edges, mesh.num_cells
    coeffs = {}
    for name in ("R", "f"):
        mode = str(state[f"{name}_mode"])
        if mode not in _SIZES:
            raise ValueError(f"{name}_mode {mode!r} is not carried over (quad mode: ROADMAP A5)")
        data = np.array(state[f"{name}_data"], dtype=np.float64).reshape(-1)
        if data.size != _SIZES[mode](E, C):
            raise ValueError(f"{name}_data has {data.size} entries for mode {mode!r}")
        coeffs[name] = (mode, data)
    pbc = {}
    for key in ("edge_start_pbc", "edge_end_pbc"):
        arr = np.array(state[key], dtype=np.float64)
        if arr.shape != (E,):
            raise ValueError(f"{key} must have shape ({E},)")
        pbc[key] = arr
    asm._R_mode, asm._R_data = coeffs["R"]
    asm._f_mode, asm._f_data = coeffs["f"]
    asm._edge_start_pbc = pbc["edge_start_pbc"]
    asm._edge_end_pbc = pbc["edge_end_pbc"]
    asm._R_generation = 1
    asm._R_src = None
    asm._R_src_immutable = False
    asm._forms_computed = True
    return asm
