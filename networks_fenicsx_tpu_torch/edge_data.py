"""Per-edge condensed data of the general forest path, and its layouts.

Counterpart of ``networks_fenicsx_tpu/solver.py:_EdgeData`` (``:369-391``)
and of the layout dispatch in the generic ``core`` of
``build_schur_executor`` (``:4278-4326``), which picks one of four layouts:

* ``uniform`` — P1 flux, R and f scalar or per edge
  (``_make_edge_data_uniform``, ``:394-436``): closed forms in
  ``a_e = R_e h_e`` and ``F_e = f_e h_e``, no per-cell array;
* ``scalar`` — P1 flux, cellwise-constant R (``_make_edge_data_scalar``,
  ``:467-520``): the cell mass is ``a_c M̂``, only ``a_c`` is kept;
* ``scalar_k`` — the same for flux degree ≥ 2 (``_make_edge_data_scalar_k``,
  ``:523-566``), with the fixed condensed constants of
  :func:`.blocked._condensed_scalar_constants`;
* ``general`` — quadrature-mode (callable) R (``_make_edge_data``,
  ``:569-619``): per-cell condensed 2×2 mass and, for degree ≥ 2, the
  per-cell interior recovery matrix.

The port keeps the reference's fields but lays every per-cell array out
j-major — cell index first, edge last — so that one GPU thread per edge
walking down its cells touches consecutive addresses across a warp.  The
kernels that fill and read it are K8a (:mod:`.kernels.edge_data`) and K8b
(:mod:`.kernels.backsub`).
"""

from __future__ import annotations

import typing

import torch

__all__ = ["LAYOUTS", "edge_layout", "elides_source"]

LAYOUTS = ("uniform", "scalar", "scalar_k", "general")


class _EdgeData(typing.NamedTuple):
    """Per-edge condensed arrays, float64, edges in public order.

    ``mt`` is set in the general layout only, ``rh`` in the scalar ones,
    ``ua``/``uF`` in the uniform one."""

    mt: torch.Tensor | None  # (N, 2, 2, E) condensed cell endpoint mass
    cumF: torch.Tensor  # (N+1, E) cumulative ∫f at chain nodes; (1, E) = Ftot when uniform
    W: torch.Tensor  # (E,) 1ᵀM1 — total edge resistance
    g: torch.Tensor  # (E,) 1ᵀM·cumF
    start_bif: torch.Tensor  # (E,) int32 bifurcation at the source, or -1
    end_bif: torch.Tensor  # (E,) int32
    start_pbc: torch.Tensor  # (E,) boundary pressure at a boundary source
    end_pbc: torch.Tensor  # (E,) boundary pressure at a boundary target
    interior: tuple  # () | (Minv_IE (k-1, 2),) fixed | (Minv_IE (N, k-1, 2, E),) per cell
    rh: torch.Tensor | None = None  # (N, E) cell scalars a_c = R_c h_c
    ua: torch.Tensor | None = None  # (E,) a_e = R_e h_e
    uF: torch.Tensor | None = None  # (E,) F_e = f_e h_e (per-cell source integral)


def edge_layout(k: int, R_mode: str, f_mode: str) -> str:
    """The layout the reference's ``core`` picks for these coefficient modes."""
    if k == 1 and R_mode in ("scalar", "edge") and f_mode in ("scalar", "edge"):
        return "uniform"
    if R_mode == "quad":
        return "general"
    return "scalar" if k == 1 else "scalar_k"


def elides_source(layout: str, f_is_zero: bool) -> bool:
    """Whether the layout skips the source cumsums: the reference elides
    them for a zero scalar source in the scalar layouts only."""
    return f_is_zero and layout in ("scalar", "scalar_k")
