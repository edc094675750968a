"""K21a: the per-edge flux blocks of the continuous-pressure reduced solve
(``csrc/schur_p.cu``).

Replaces the ``A_blocks`` assembly, ``jnp.linalg.cholesky`` and
``apply_Ainv`` of ``networks_fenicsx_tpu/solver.py:_continuous_pressure_solve``
(``:4666-4685``, ``:4718-4724``).  Edge ``e``'s flux block is the sum of its
``N`` overlapping ``(k+1)²`` cell masses, an ``(m, m)`` SPD band of half
bandwidth ``k`` (``m = kN + 1``); its Cholesky factor keeps the band.

The flux vector is in the reference's order — edges sorted by (color, id),
each edge's ``m`` dofs contiguous — and a :class:`FluxTiles` plan, made once
per executor, cuts its ``E`` slots into tiles of :data:`TILE` edges (the last
one ragged, padded with identity blocks).  The band is stored tile-major,
``Lb (tiles, m, k+1, TILE)`` with ``Lb[t, i, d, l] = L(i, i−d)`` of slot
``t·TILE + l`` and ``d = 0`` holding the reciprocal pivot ``1 / L(i, i)``:

* :func:`schur_p_factor` — the band from the cell masses ``(E·N, k+1,
  k+1)`` (edge-id order, read through the plan's permutation), its diagonal
  ``adiag`` in flux order (the reference's ``A_diag``), then the band
  Cholesky;
* :func:`schur_p_solve` — ``A⁻¹ v`` on the flux vector, forward then back
  substitution per edge.

On CUDA each is one launch (counted in :data:`FACTOR` and :data:`SOLVE`) on
a lean path: the plan was checked once, so a call checks only its float64
tensors, reads the raw stream and enters the device only when it is not
current.  The plain versions run the same loops over the same layout,
vectorised over the slots, for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

__all__ = ["FluxTiles", "flux_tiles", "schur_p_factor", "schur_p_factor_plain", "schur_p_solve",
           "schur_p_solve_plain", "FACTOR", "SOLVE", "TILE", "MAX_K"]

FACTOR = build.Counter("schur_p_factor")
SOLVE = build.Counter("schur_p_solve")
TILE = 32  # edges a tile: one warp lane each
MAX_K = 16  # the highest flux degree whose factor stages fit in a block's shared memory


class _SchurTiles(ctypes.Structure):
    """``SchurTiles`` of ``csrc/schur_p.cu``."""

    _fields_ = [("E", ctypes.c_int), ("N", ctypes.c_int), ("k", ctypes.c_int),
                ("perm", ctypes.c_void_p)]


class FluxTiles:
    """The flux-ordered tile plan of one executor: ``perm[s]`` the edge id of
    flux slot ``s`` (int32, on the device), ``E`` slots of ``m = kN + 1``
    dofs in ``tiles`` tiles of :data:`TILE`; ``index`` the CUDA device (-1
    off CUDA).  Made by :func:`flux_tiles`."""

    __slots__ = ("E", "N", "k", "m", "tiles", "perm", "index", "_args", "_addr")

    def __init__(self, perm: torch.Tensor, N: int, k: int):
        if perm.dtype != torch.int32 or perm.dim() != 1 or not perm.is_contiguous():
            raise ValueError("FluxTiles: perm must be a contiguous 1-D int32 tensor")
        if perm.device.type == "meta":
            raise ValueError("FluxTiles: perm must hold data (a meta tensor has none)")
        if not (0 < k <= MAX_K and N > 0):
            raise ValueError(f"FluxTiles: N must be positive and k in 1..{MAX_K}, got N={N}, k={k}")
        self.E, self.N, self.k, self.m = int(perm.shape[0]), int(N), int(k), int(k) * int(N) + 1
        if self.E * self.m * (self.k + 2) >= 2**31:
            raise ValueError("FluxTiles: the flux vector is out of the kernels' int32 range")
        self.tiles = -(-self.E // TILE)
        self.perm = perm
        self.index = perm.device.index if perm.device.type == "cuda" else -1
        self._args = _SchurTiles(self.E, self.N, self.k, perm.data_ptr())
        self._addr = ctypes.addressof(self._args)

    @property
    def n_flux(self) -> int:
        return self.E * self.m

    @property
    def band_shape(self) -> tuple:
        return (self.tiles, self.m, self.k + 1, TILE)


def flux_tiles(base, edge_color, N: int, k: int, device) -> FluxTiles:
    """The plan of the reference's flux layout: ``perm = lexsort((arange(E),
    edge_color))`` (reference ``:4677-4678``), checked once against the
    assembler's first flux dof of every edge: ``base[perm[s]]`` must be
    ``s·m``.  Raises ``ValueError`` when it is not (no other layout is
    taken)."""
    base = np.asarray(base, dtype=np.int64)
    E, m = base.shape[0], k * N + 1
    perm = np.lexsort((np.arange(E), np.asarray(edge_color)))
    if not np.array_equal(base[perm], np.arange(E, dtype=np.int64) * m):
        raise ValueError("flux_tiles: the flux dofs are not the edges in (color, id) order, "
                         "m contiguous dofs each")
    return FluxTiles(torch.as_tensor(perm.astype(np.int32), device=device), N, k)


def schur_p_factor_plain(cm, tiles: FluxTiles):
    """Eager version: ``(Lb (tiles, m, k+1, TILE), adiag (E·m,))``."""
    E, N, k, m = tiles.E, tiles.N, tiles.k, tiles.m
    kk, Ep = k + 1, tiles.tiles * TILE
    dt, dev = torch.float64, cm.device
    A = torch.zeros((m, kk, Ep), dtype=dt, device=dev)
    cmv = cm.reshape(E, N, kk, kk)[tiles.perm.to(dev).long()]  # flux order
    for j in range(N):
        for a in range(kk):
            for b in range(a + 1):
                A[k * j + a, a - b, :E] = A[k * j + a, a - b, :E] + cmv[:, j, a, b]
    adiag = A[:, 0, :E].T.reshape(-1).clone()
    A[:, 0, E:] = 1.0
    for i in range(m):
        t0 = max(0, i - k)
        for j in range(t0, i):
            s = A[i, i - j]
            for t in range(t0, j):
                s = s - A[i, i - t] * A[j, j - t]
            A[i, i - j] = s * A[j, 0]
        s = A[i, 0]
        for t in range(t0, i):
            s = s - A[i, i - t] * A[i, i - t]
        A[i, 0] = 1.0 / torch.sqrt(s)
    Lb = A.reshape(m, kk, tiles.tiles, TILE).permute(2, 0, 1, 3).contiguous()
    return Lb, adiag


def schur_p_solve_plain(Lb, tiles: FluxTiles, v) -> torch.Tensor:
    E, k, m = tiles.E, tiles.k, tiles.m
    Ep = tiles.tiles * TILE
    L = Lb.permute(1, 2, 0, 3).reshape(m, k + 1, Ep)
    x = torch.zeros((m, Ep), dtype=v.dtype, device=v.device)
    x[:, :E] = v.reshape(E, m).T
    for i in range(m):
        s = x[i]
        for t in range(max(0, i - k), i):
            s = s - L[i, i - t] * x[t]
        x[i] = s * L[i, 0]
    for i in range(m - 1, -1, -1):
        s = x[i]
        for t in range(i + 1, min(m - 1, i + k) + 1):
            s = s - L[t, t - i] * x[t]
        x[i] = s * L[i, 0]
    return x[:, :E].T.reshape(-1).contiguous()


def _require_band(name: str, Lb, tiles: FluxTiles) -> None:
    if (not Lb.is_cuda or Lb.get_device() != tiles.index or Lb.dtype is not torch.float64
            or not Lb.is_contiguous() or tuple(Lb.shape) != tiles.band_shape):
        raise ValueError(f"{name}: Lb must be a contiguous float64 {tiles.band_shape} tensor on "
                         f"CUDA device {tiles.index}")


def _launch(counter, index: int, fn, *args) -> None:
    code = build.on_device(index, fn, *args)
    if code:
        build.check(code, counter.__name__)
    counter.launches += 1


def schur_p_factor(cm, tiles: FluxTiles):
    """K21a's factor on ``cm``'s device: ``cm (E·N, k+1, k+1)`` float64
    cell masses in edge-id order; returns ``(Lb, adiag)``."""
    if cm.device.type == "cpu":
        return schur_p_factor_plain(cm, tiles)
    index, E, kk = tiles.index, tiles.E, tiles.k + 1
    if not cm.is_contiguous() or tuple(cm.shape) != (E * tiles.N, kk, kk):
        raise ValueError(f"schur_p_factor: cm must be a contiguous ({E * tiles.N}, {kk}, {kk}) "
                         f"tensor, got {tuple(cm.shape)}")
    build.require_vectors("schur_p_factor", index, (cm.view(-1), E * tiles.N * kk * kk))
    Lb = cm.new_empty(tiles.band_shape)
    adiag = cm.new_empty(tiles.n_flux)
    if E:
        _launch(FACTOR, index, build.library().nxfx_schur_p_factor, tiles._addr, cm.data_ptr(),
                Lb.data_ptr(), adiag.data_ptr(), build.raw_stream(index))
    return Lb, adiag


def schur_p_solve(Lb, tiles: FluxTiles, v) -> torch.Tensor:
    """K21a's solve: ``A⁻¹ v`` for the flux vector ``v (E·m,)``."""
    if v.device.type == "cpu":
        return schur_p_solve_plain(Lb, tiles, v)
    index = tiles.index
    build.require_vectors("schur_p_solve", index, (v, tiles.n_flux))
    _require_band("schur_p_solve", Lb, tiles)
    out = v.new_empty(tiles.n_flux)
    if tiles.E:
        _launch(SOLVE, index, build.library().nxfx_schur_p_solve, tiles._addr, Lb.data_ptr(),
                v.data_ptr(), out.data_ptr(), build.raw_stream(index))
    return out
