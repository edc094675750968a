"""Batched scenario solves (parameter sweeps).

Counterpart of ``networks_fenicsx_tpu/batch.py``: :class:`SweepResult`
(``:27-96``) and :func:`solve_sweep` (``:99-292``), under the same names,
checks, routing and cache.  The reference maps its fused executor over a
scenario axis with ``jax.vmap``; here the executor's route decides how the
scenarios run:

* the blocked forest route (:class:`.solver._BlockedExecutor`) has a
  scenario axis in its kernels: K1, K2–K4 and K5 take the S scenarios in the
  launches of one solve (``_BlockedExecutor.scenarios``: the full sweep when
  R varies by scenario, else K2's factor once and K3–K4 over the S
  right-hand sides);
* so has the dense route (:class:`.solver._DenseExecutor` under
  ``schur_method="dense"``, which ``auto`` picks for every network with 0 <
  B ≤ 4,096 that is not a scalar-R lattice): K8a, the bifurcation system
  (K9's prepare kernel, K6), K11 and K8b over S (``_DenseExecutor.scenarios``:
  S factors when R varies by scenario, in chunks that bound the factors'
  memory, else one factor and S right-hand sides), and the route without
  multipliers (:class:`.solver._EdgeExecutor`: K8a and K8b over S);
* so has the lattice route, under ``auto`` (a uniform scalar-R lattice at
  any B) or ``schur_method="dct"``: on the grid route
  (:class:`.solver._GridExecutor`) K1, K17's assembly, K16's factors (S of
  them when R varies by scenario, else one) and passes with K17's stencil
  over S as their residual, and K5; on the general route
  (:class:`.solver._DctExecutor`, a callable source) K8a, the bifurcation
  system, K6's class weights, K16 with K18 over S, and K8b
  (``scenarios`` of each);
* so has the level route (:class:`.solver._LevelExecutor`: every forest
  with B > 4,096 that is not uniformly K-ary, callable R or f): K8a, K7 with
  its K6 sums and K8b over S (``_LevelExecutor.scenarios``);
* so has the tree route (:class:`.solver._TreeExecutor`, a cyclic graph with
  B > 4,096, or ``schur_method="tree"``) when its core is dense, multifrontal
  or absent: K8a, the bifurcation system, K9's peel rounds over S around the
  core over S (S multifrontal or dense factors in chunks when R varies by
  scenario, else K9's ``d`` channel and one core factor, then the ``r``
  channel and the core's apply over S), K8b (``_TreeExecutor.scenarios``);
* every other route (a min-degree core, ``dense_f64``, CG) runs its rows
  through its executor, one solve a row, into preallocated ``(S, ·)``
  device outputs (ROADMAP A9b names the routes still to batch).

Either way row ``i`` is the executor's call on row ``i`` bit for bit.  The
device is explicit, as for :class:`.solver.Solver`: ``device="cuda"`` by
default (raises without CUDA), ``"cpu"`` for the kernels' plain versions;
``devices=`` puts contiguous chunks of the scenario axis on the listed
devices, each device through its own executor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .adjoint import refuse_grad
from .assembly import HydraulicNetworkAssembler
from .blocked import _permute_coefficient_batch
from .function import NetworkFunction
from .lattice import lattice_solve_applicable
from .solver import _flatten_blocks_host, build_schur_executor, resolve_device
from .utils.config import SolverOptions

__all__ = ["SweepResult", "solve_sweep"]


class SweepResult:
    """Solutions of a coefficient sweep.

    On the device the solutions live as j-major blocks (``q_T`` (S, k·N+1,
    E), ``p_T`` (S, N, E), ``lam`` (S, B), in the executor's internal order);
    the flat ``(S, num_dofs)`` global layout ``[q_0..q_{M-1}, p, λ]`` is
    built on the host at the first ``.x`` access, one flatten over the
    scenario axis."""

    def __init__(
        self,
        assembler: HydraulicNetworkAssembler,
        x: np.ndarray | None = None,
        blocks: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
        edge_order: np.ndarray | None = None,
        bif_order: np.ndarray | None = None,
    ):
        self.assembler = assembler
        self._x = x
        self.blocks = blocks
        self._edge_order = edge_order
        self._bif_order = bif_order
        if x is None and blocks is None:
            raise ValueError("provide x or blocks")

    @property
    def x(self) -> np.ndarray:
        if self._x is None:
            q_T, p_T, lam = (t.cpu().numpy() for t in self.blocks)
            self._x = _flatten_blocks_host(
                q_T, p_T, lam, self.assembler.network.edge_color,
                edge_order=self._edge_order, bif_order=self._bif_order,
            )
        return self._x

    @property
    def num_scenarios(self) -> int:
        src = self._x if self._x is not None else self.blocks[0]
        return int(src.shape[0])

    def block(self, i: int) -> np.ndarray:
        """All scenarios of solution block ``i``: shape (S, block_size)."""
        offs = self.assembler.block_offsets
        return self.x[:, offs[i] : offs[i + 1]]

    def pressures(self) -> np.ndarray:
        return self.block(self.assembler.network.num_edge_colors)

    def multipliers(self) -> np.ndarray:
        return self.block(self.assembler.network.num_edge_colors + 1)

    def functions(self, scenario: int) -> list[NetworkFunction]:
        """The reference-style function list of one scenario."""
        asm = self.assembler
        offs = asm.block_offsets
        x = np.asarray(self.x[scenario])
        names = [f"flux_color_{i}" for i in range(asm.network.num_edge_colors)]
        names += ["pressure", "global_flux"]
        return [NetworkFunction(sp, x[offs[i] : offs[i + 1]], name=name)
                for i, (sp, name) in enumerate(zip(asm.function_spaces, names))]


def _run_scenarios(executor, args, in_axes):
    """A route with a scenario axis: every argument uploaded once (a batched
    one with its scenario axis, a shared one as one row) and the S scenarios
    in the launches of one solve."""
    del in_axes  # the shapes carry it
    q_T, p_T, lam, _, _ = executor.scenarios(*executor.upload(*args))
    return q_T, p_T, lam


def _run_rows(executor, args, in_axes):
    """A route without a scenario axis: one executor call a row, into
    preallocated ``(S, ·)`` outputs on the executor's device."""
    S = next(int(np.shape(a)[0]) for a, ax in zip(args, in_axes) if ax is not None)
    outs = None
    for i in range(S):
        row = [a[i] if ax is not None else a for a, ax in zip(args, in_axes)]
        q_T, p_T, lam, *_ = executor(*row)
        if outs is None:
            outs = tuple(torch.empty((S,) + tuple(t.shape), dtype=t.dtype, device=t.device)
                         for t in (q_T, p_T, lam))
        for out, t in zip(outs, (q_T, p_T, lam)):
            out[i].copy_(t)
    return outs


def solve_sweep(
    assembler: HydraulicNetworkAssembler,
    R: np.ndarray | None = None,
    f: np.ndarray | None = None,
    p_bc_node_values: np.ndarray | None = None,
    options: SolverOptions | None = None,
    devices=None,
    device: torch.device | str = "cuda",
) -> SweepResult:
    """Solve a batch of coefficient scenarios.

    ``compute_forms`` must have been called once with representative
    coefficients — it fixes the coefficient *kinds* (scalar / per-edge /
    per-cell / per-quadrature) and the boundary-condition structure.  Each
    batch argument stacks scenarios on a leading axis over the compact
    representation of that kind.

    Args:
        assembler: Assembler with forms computed.
        R: Optional (S, ...) resistance batch — trailing shape must match
            ``assembler.schur_arguments()[0]`` (e.g. (S, E) for per-edge R,
            (S, 1) for scalar R).
        f: Optional (S, ...) source batch, analogous.
        p_bc_node_values: Optional (S, num_graph_nodes) boundary pressure
            values per graph node (only boundary-node entries are used).
        options: Solver options (schur path; default auto).
        devices: Optional device list — contiguous chunks of the scenario
            axis, one a listed device, each device through its own executor
            (a device may repeat: ``["cuda:0"] * D``).  Requires the batch
            size to be divisible by the device count.
        device: The device when ``devices`` is not given: ``"cuda"``
            (default; raises without CUDA) or ``"cpu"``.

    Returns:
        :class:`SweepResult` with ``x`` of shape (S, num_dofs).
    """
    asm = assembler
    opts = options or SolverOptions()
    if asm.network.has_floating_component():
        raise RuntimeError("network has a component with no boundary node")
    refuse_grad("solve_sweep", R, f, p_bc_node_values)  # ROADMAP A9c-4

    sizes = [int(np.shape(a)[0]) for a in (R, f, p_bc_node_values) if a is not None]
    if not sizes:
        raise ValueError("provide at least one batched coefficient")
    S = sizes[0]
    if any(s != S for s in sizes):
        raise ValueError(f"inconsistent batch sizes: {sizes}")

    mesh = asm.network
    in_axes = (
        0 if R is not None else None,
        0 if f is not None else None,
        0 if p_bc_node_values is not None else None,
        0 if p_bc_node_values is not None else None,
    )

    # The reference's routing: under auto with 0 < B <= 4,096 a uniform
    # lattice takes the DCT solve and anything else the dense Schur solve;
    # the lattice probe (host planning, O(E)) is cached per coefficient-kind
    # signature.
    B = mesh.num_multipliers
    if opts.schur_method == "auto" and 0 < B <= 4096:
        probe_key = asm.coefficient_modes()
        cached = getattr(asm, "_lattice_probe", None)
        if cached is None or cached[0] != probe_key:
            cached = (probe_key, lattice_solve_applicable(asm))
            asm._lattice_probe = cached
        opts = dataclasses.replace(opts, schur_method="dct" if cached[1] else "dense")

    devs = [resolve_device(d) for d in (devices if devices is not None else [device])]
    if len(devs) > 1 and S % len(devs) != 0:
        raise ValueError(f"batch size {S} not divisible by device count {len(devs)}")

    # EVERY option field keys the cache; an entry holds the runner, the
    # executor it was first built with, and one executor a device.  An
    # options set that raises (float32) leaves no entry behind.
    key = (in_axes, dataclasses.astuple(opts), asm.coefficient_modes())
    cache = getattr(asm, "_sweep_cache", None)
    if cache is None:
        cache = asm._sweep_cache = {}

    def build(dev):
        # a batched f must flow through the executor's f argument
        return build_schur_executor(asm, opts, device=dev, elide_zero_f=(f is None))

    entry = cache.get(key)
    if entry is None:
        executor = build(devs[0])
        run = _run_scenarios if executor.has_scenario_axis else _run_rows
        entry = cache[key] = (run, executor, {str(devs[0]): executor})
    run, executor, by_device = entry
    for dev in devs:
        if str(dev) not in by_device:
            by_device[str(dev)] = build(dev)
    edge_order = executor.edge_order
    bif_order = executor.bif_order

    base_R, base_f, base_sp, base_ep = asm.schur_arguments()
    # Kind check: a batch whose trailing shape disagrees with the
    # compute_forms representative would solve the wrong problem.
    for name, batch, base in (("R", R, base_R), ("f", f, base_f)):
        if batch is not None and tuple(np.shape(batch)[1:]) != tuple(np.shape(base)):
            raise ValueError(
                f"{name} batch trailing shape {tuple(np.shape(batch)[1:])} does "
                f"not match the coefficient kind fixed by compute_forms "
                f"(expected {tuple(np.shape(base))}); recompute forms with a "
                f"representative {name} of the batched kind"
            )
    base_R, base_f, base_sp, base_ep = executor.prepare_args(base_R, base_f, base_sp, base_ep)

    if p_bc_node_values is not None:
        # boundary-pressure expansion in the executor's edge order: each
        # boundary end's node value, 0 at a bifurcation end (only the
        # boundary columns are gathered: a lattice has two of 523,266)
        pbv = np.asarray(p_bc_node_values, dtype=np.float64)
        edges = mesh.edges if edge_order is None else mesh.edges[edge_order]
        sb = np.asarray(asm._edge_start_bif)
        eb = np.asarray(asm._edge_end_bif)
        if edge_order is not None:
            sb, eb = sb[edge_order], eb[edge_order]
        sp_batch, ep_batch = (np.zeros((pbv.shape[0], edges.shape[0])) for _ in range(2))
        for out, bif, end in ((sp_batch, sb, 0), (ep_batch, eb, 1)):
            cols = np.flatnonzero(bif < 0)
            out[:, cols] = pbv[:, edges[cols, end]]
    else:
        sp_batch = ep_batch = None

    R_mode, f_mode, _ = asm.coefficient_modes()
    args = (
        _permute_coefficient_batch(R, R_mode, edge_order) if R is not None else base_R,
        _permute_coefficient_batch(f, f_mode, edge_order) if f is not None else base_f,
        sp_batch if sp_batch is not None else base_sp,
        ep_batch if ep_batch is not None else base_ep,
    )
    chunk = S // len(devs)
    parts = []
    for c, dev in enumerate(devs):
        rows = slice(c * chunk, (c + 1) * chunk)
        part_args = tuple(a[rows] if ax is not None else a for a, ax in zip(args, in_axes))
        parts.append(run(by_device[str(dev)], part_args, in_axes))
    if len(parts) == 1:
        blocks = parts[0]
    else:
        blocks = tuple(torch.cat([p[i].to(devs[0]) for p in parts]) for i in range(3))
    return SweepResult(asm, blocks=blocks, edge_order=edge_order, bif_order=bif_order)
