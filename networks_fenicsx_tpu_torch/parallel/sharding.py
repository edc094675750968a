"""Edge-partitioned multi-device execution.

Counterpart of ``networks_fenicsx_tpu/parallel/sharding.py``: the network's
edge axis is split over the D shards of a :class:`.mesh.ShardMesh`.  Every
per-edge quantity lives on the shard that owns the edge; the only coupling
between shards is the bifurcation Schur system, whose per-shard partials
one K22-reduce sums (the ``psum`` that replaces the FEniCSx code's ghost
updates).  The replicated λ solve runs once per distinct device; the
back-substitution is again per shard.

:class:`ShardedNetworkSolver` dispatches as the reference's does
(``:334-665``): the blocked forest route (:mod:`.blocked_sharded`, K22a)
when the plan admits D shards, else under ``auto`` the lattice strips
(:mod:`.grid_sharded`, K22b); then the distributed tree elimination
(:mod:`.distributed_tree`, K22c) when forced or above 4,096 multipliers
with D > 1; else the general pipeline (:class:`ShardedGeneralExecutor`,
K22d) with a replicated ``tree``, ``dense`` or ``cg`` λ solve.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import adjoint
from .. import assembly as _assembly
from ..blocked import _condensed_scalar_constants
from ..edge_data import _EdgeData
from ..function import NetworkFunction
from ..kernels import (
    backsub, dense_core, krylov, level_eliminate, shard_general,
)
from ..levels import (
    _build_lambda_plan, _cached_tree_plan, _plan_level_elimination, device_level_plan,
)
from ..ops.krylov import cg
from ..solver import SolveInfo
from ..tree import device_tree_plan, tree_solve_system
from ..utils.timing import timed
from .distributed_tree import DistTreeExecutor, ShardEdges
from .mesh import ShardMesh, default_devices

__all__ = ["ShardedNetworkSolver", "shard_solve", "make_device_mesh"]

# distributed λ elimination kicks in automatically above this multiplier count
_DIST_LAMBDA_THRESHOLD = 4096


def make_device_mesh(devices=None, axis_name: str = "edges") -> ShardMesh:
    """1-D mesh over which the edge axis is partitioned (default: every
    visible CUDA device; raises without one)."""
    return ShardMesh(default_devices() if devices is None else list(devices), axis_name)


def _to_host(x, mesh: ShardMesh | None = None) -> np.ndarray:
    """Device → host pull: a replicated tensor directly, per-shard tensors
    (a list, one per owned shard) gathered over the mesh — across the
    processes of a process group, the counterpart of ``process_allgather``."""
    if isinstance(x, (list, tuple)):
        return mesh.gather(x)
    return x.detach().cpu().numpy()


def _scatter_blocks_to_x(asm, q_edge, p_cells, lam) -> np.ndarray:
    """Public-layout global vector(s) from per-edge solution rows (the
    reference's ``:79-101``): ``q_edge (..., E, k·N+1)``, ``p_cells (..., E,
    N)``, ``lam (..., B)`` → ``x (..., num_dofs)`` in the block layout
    ``[q_color_0.. | p | λ]``."""
    net = asm.network
    q_edge = np.asarray(q_edge)
    batch = q_edge.shape[:-2]
    x = np.zeros(batch + (asm.num_dofs,))
    dofs_per_edge = asm.flux_degree * net.N + 1
    idx = asm._edge_flux_base[:, None] + np.arange(dofs_per_edge)[None, :]
    x[..., idx.reshape(-1)] = q_edge.reshape(batch + (-1,))
    p_off = int(asm.block_offsets[net.num_edge_colors])
    x[..., p_off : p_off + net.num_cells] = np.asarray(p_cells).reshape(batch + (-1,))
    x[..., asm._lm_offset :] = np.asarray(lam)
    return x


def _pad_edge_data(ed: _EdgeData, n_pad: int, n_cells: int = 1) -> _EdgeData:
    """Append ``n_pad`` inert edges (reference ``:118-185``, on the port's
    edges-last layout): unit resistance, no source, no bifurcation, zero
    boundary pressure — each layout's identities kept (W = Σa, g = 0,
    cumF = 0), so the rows solve to zero and add nothing to the Schur
    system."""
    if n_pad == 0:
        return ed
    N = ed.cumF.shape[0] - 1 if ed.ua is None else n_cells
    dt, dev = ed.W.dtype, ed.W.device

    def cat(a, b):
        return torch.cat([a, b], dim=-1)

    interior = ed.interior
    k = 1
    if interior:
        (Minv,) = interior
        if Minv.dim() == 4:  # per cell (N, k-1, 2, E)
            k = Minv.shape[1] + 1
            interior = (cat(Minv, torch.zeros(Minv.shape[:3] + (n_pad,), dtype=dt, device=dev)),)
        else:  # the fixed scale-free (k-1, 2) matrix, shared by the pad edges
            k = Minv.shape[0] + 1
    mt = rh = ua = uF = None
    if ed.ua is not None:
        ua = cat(ed.ua, torch.ones(n_pad, dtype=dt, device=dev))
        uF = cat(ed.uF, torch.zeros(n_pad, dtype=dt, device=dev))
        W_pad = torch.full((n_pad,), float(N), dtype=dt, device=dev)
        cumF_pad = torch.zeros((ed.cumF.shape[0], n_pad), dtype=dt, device=dev)
    else:
        if ed.mt is not None:
            eye = 0.5 * torch.eye(2, dtype=dt, device=dev)
            mt = cat(ed.mt, eye[None, :, :, None].expand(N, 2, 2, n_pad))
        else:
            rh = cat(ed.rh, torch.full((N, n_pad), 1.0 / N, dtype=dt, device=dev))
        wt = _condensed_scalar_constants(k)[2] if mt is None and k > 1 else 1.0
        W_pad = torch.full((n_pad,), float(wt), dtype=dt, device=dev)
        cumF_pad = torch.zeros((N + 1, n_pad), dtype=dt, device=dev)
    minus = -torch.ones(n_pad, dtype=ed.start_bif.dtype, device=dev)
    zero = torch.zeros(n_pad, dtype=dt, device=dev)
    return _EdgeData(
        mt=mt, cumF=cat(ed.cumF, cumF_pad), W=cat(ed.W, W_pad), g=cat(ed.g, zero),
        start_bif=cat(ed.start_bif, minus), end_bif=cat(ed.end_bif, minus),
        start_pbc=cat(ed.start_pbc, zero), end_pbc=cat(ed.end_pbc, zero),
        interior=interior, rh=rh, ua=ua, uF=uF,
    )


class ShardedGeneralExecutor:
    """The general sharded pipeline (reference ``_sharded_schur_pipeline``,
    ``:224-331``) on a mesh.

    Shard ``d`` owns the edges ``[d·E_loc, (d+1)·E_loc)`` of the edge array
    padded to a multiple of D.  Per shard: K8a on its edges (padded), K22d's
    partials; K22-reduce; the replicated λ solve — ``tree``: K7 from the
    reduced system on a forest (:func:`..kernels.level_eliminate.level_eliminate_system`),
    else the peel rounds and the core (:func:`..tree.tree_solve_system`);
    ``dense``: K11 from the reduced diagonal and pair conductances; ``cg``:
    K19a with Jacobi at rtol 1e-13 on ``diag·λ`` plus the reduce of every
    shard's K22d off-diagonal apply; then per shard K8b.  Without
    bifurcations only K8a and K8b run."""

    method_name = "schur_sharded"

    def __init__(self, asm, mesh: ShardMesh, schur_method: str, tree_plan, level_plan,
                 modes: tuple):
        net = asm.network
        B = net.num_multipliers
        E = net.num_edges
        if schur_method == "auto":
            if tree_plan is not None and (tree_plan.core_size <= 4096
                                          or tree_plan.core_plan is not None):
                schur_method = "tree"
            else:
                schur_method = "dense" if B <= 4096 else "cg"
        if schur_method == "dense" and B > dense_core.MAX_CORE:
            raise ValueError(f"schur_method='dense' factors the B×B Laplacian densely: at most "
                             f"{dense_core.MAX_CORE} bifurcations, got {B}")
        self.schur_method = schur_method
        self.mesh = mesh
        self._N, self._k, self._modes = net.N, asm.flux_degree, modes
        self.B = B
        self.E_loc = -(-E // mesh.D)
        self.level_plan = level_plan if schur_method == "tree" else None
        # the pairs' conductances feed the tree and dense solves, not CG's
        P, edge_pair = 0, np.full(E, -1, np.int64)
        if B > 0 and schur_method != "cg":
            tree_plan = tree_plan if tree_plan is not None else _cached_tree_plan(asm)
            pairs = np.asarray(tree_plan.pair_nodes)
            P, edge_pair = pairs.shape[0], np.asarray(tree_plan.edge_pair)
        self.replicated = {}
        for dev in mesh.local_devices:
            if B == 0:
                state = None
            elif schur_method == "tree" and self.level_plan is not None:
                state = device_level_plan(self.level_plan, tree_plan, dev)
            elif schur_method == "tree":
                state = device_tree_plan(tree_plan, _build_lambda_plan(asm), asm, dev)
            elif schur_method == "dense":
                state = tuple(torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=dev)
                              for a in (pairs[:, 0], pairs[:, 1], np.arange(P)))
            else:
                state = None
            self.replicated[dev] = state
        sb = np.asarray(asm._edge_start_bif, np.int64)
        eb = np.asarray(asm._edge_end_bif, np.int64)
        self.shards = []
        for d in mesh.owned:
            dev = mesh.devices[d]
            lo, hi = min(d * self.E_loc, E), min((d + 1) * self.E_loc, E)
            eids = np.arange(lo, hi)
            pad = self.E_loc - eids.size

            def padded(a, fill=-1):
                return np.concatenate([a[eids], np.full(pad, fill, np.int64)])

            self.shards.append(dict(
                device=dev,
                edges=ShardEdges(asm, eids, sb[eids], eb[eids], self.E_loc, dev),
                tables=(shard_general.shard_lambda_tables(
                    padded(sb), padded(eb), padded(edge_pair), B, P, dev,
                    matvec=schur_method == "cg") if B > 0 else None),
            ))

    def prepare_args(self, R_data, f_data, start_pbc, end_pbc):
        R_mode, f_mode, _ = self._modes
        return [sh["edges"].args(self._N, R_data, f_data, start_pbc, end_pbc, R_mode, f_mode)
                for sh in self.shards]

    def forward(self, i: int, args, plain: bool = False):
        """Shard ``i``'s padded edge data and, with bifurcations, its K22d
        partials and ``w = 1/W``: ``(ed, part, w)``."""
        sh = self.shards[i]
        ed = sh["edges"].edge_data(self._N, self._k, args, self._modes, plain)
        if self.B == 0:
            return ed, None, None
        run = shard_general.partials_plain if plain else shard_general.partials
        part, w_edges = run(sh["tables"], ed)
        return ed, part, w_edges

    def solve_lambda(self, fws, plain: bool = False) -> dict:
        """The reduce and the replicated λ solve: ``{device: λ}``."""
        B, mesh = self.B, self.mesh
        if B == 0:
            return {dev: torch.zeros(0, dtype=torch.float64, device=dev)
                    for dev in mesh.local_devices}
        total = mesh.reduce(mesh.stack([fw[1] for fw in fws]), plain=plain)
        if self.schur_method == "cg":
            return {mesh.home: self._cg(fws, total, plain)}

        def run(tot):
            state = self.replicated[tot.device]
            dr, w_pairs = tot[: 2 * B].view(B, 2), tot[2 * B :]
            if self.schur_method == "dense":
                solve = dense_core.dense_core_plain if plain else dense_core.dense_core
                return solve(*state, dr[:, 0].contiguous(), dr[:, 1].contiguous(), w_pairs)
            if self.level_plan is not None:
                elim = (level_eliminate.level_eliminate_system_plain if plain
                        else level_eliminate.level_eliminate_system)
                return elim(state, dr.contiguous(), w_pairs)[0]
            return tree_solve_system(state, dr.contiguous(), w_pairs, plain)

        return mesh.replicate(run, total)

    def _cg(self, fws, total, plain: bool):
        """Jacobi CG, rtol 1e-13, on the sharded matvec."""
        B, mesh = self.B, self.mesh
        diag = total[: 2 * B : 2].contiguous()
        rhs = total[1 : 2 * B : 2].contiguous()
        apply = shard_general.offdiag_plain if plain else shard_general.offdiag
        zeros = {}

        def matvec(x):
            parts = []
            for i, (d, sh) in enumerate(zip(mesh.owned, self.shards)):
                dev = sh["device"]
                if d == 0:
                    dg = diag.to(dev)
                else:
                    dg = zeros.setdefault(dev, torch.zeros(B, dtype=torch.float64, device=dev))
                parts.append(apply(sh["tables"], fws[i][2], dg, x.to(dev)))
            return mesh.reduce(mesh.stack(parts), plain=plain)

        return cg(matvec, rhs, precond=krylov.Jacobi(diag), rtol=1e-13, plain=plain).x

    def back(self, i: int, ed, lam, plain: bool = False):
        """Shard ``i``'s K8b: ``(q_T, p_T, finite)``."""
        expand_lam = backsub.backsub_plain if plain else backsub.backsub
        return expand_lam(ed, lam, self._N, self._k)

    def __call__(self, shard_args, plain: bool = False):
        adjoint.refuse_grad(type(self).__name__, *(t for args in shard_args for t in args))
        fws = [self.forward(i, args, plain) for i, args in enumerate(shard_args)]
        lam = self.solve_lambda(fws, plain)
        lam_home = lam[self.mesh.home]
        outs = [self.back(i, fw[0], lam.get(sh["device"], lam_home).to(sh["device"]), plain)
                for i, (fw, sh) in enumerate(zip(fws, self.shards))]
        finite = self.mesh.all_finite([o[2] for o in outs], plain)
        return [o[0] for o in outs], [o[1] for o in outs], lam_home, finite

    def plain(self, shard_args):
        return self(shard_args, plain=True)


class ShardedNetworkSolver:
    """Multi-device Schur solver with the edge axis partitioned over a mesh.

    Usage mirrors :class:`..solver.Solver`:

    >>> solver = ShardedNetworkSolver(assembler, devices=["cuda:0"] * 8)
    >>> solver.assemble()
    >>> functions = solver.solve()

    ``devices=None`` takes every visible CUDA device and raises without one;
    ``devices=["cpu"] * D`` runs the kernels' plain versions on the CPU.
    Requires discontinuous (degree-0) pressure, like the serial Schur path.
    """

    def __init__(
        self,
        assembler: _assembly.HydraulicNetworkAssembler,
        devices=None,
        axis_name: str = "edges",
        schur_method: str = "auto",
    ):
        if assembler.pressure_degree != 0:
            raise ValueError("sharded solver requires degree-0 pressure")
        self._assembler = assembler
        self._mesh = make_device_mesh(devices, axis_name)
        self._schur_method = schur_method
        self._coeff_args = None
        self._pipeline = None
        self._dist_plan = None
        self._dist_exec = None
        self._blocked_exec = None
        self._blocked_checked: tuple | None = None
        self._asm_modes_key: tuple | None = None
        self._modes_key: tuple | None = None
        self._info: SolveInfo | None = None

    @property
    def device_mesh(self) -> ShardMesh:
        return self._mesh

    @property
    def info(self) -> SolveInfo | None:
        return self._info

    def assemble(self, lhs: bool = True, rhs: bool = True) -> None:
        """Snapshot the coefficients and their kinds: as in the reference
        (``:376-393``), solve() uses the state captured here; a later
        compute_forms() takes effect at the next assemble()."""
        del lhs, rhs
        self._coeff_args = tuple(
            np.array(a, copy=True) for a in self._assembler.schur_arguments(device=False)
        )
        self._asm_modes_key = self._assembler.coefficient_modes()

    @timed("nxfx:ShardedSolver:solve", block=True)
    def solve(self, functions: list[NetworkFunction] | None = None) -> list[NetworkFunction]:
        asm = self._assembler
        net = asm.network
        if net.has_floating_component():
            raise RuntimeError(
                "Solver did not converge: network has a component with no "
                "boundary node — the system is singular"
            )
        if self._coeff_args is None:
            self.assemble()
        D = self._mesh.D

        # executors follow the ASSEMBLE-time coefficient kinds (the snapshot's)
        modes_key = self._asm_modes_key
        if self._modes_key != modes_key:
            self._modes_key = modes_key
            self._pipeline = None
            self._dist_exec = None
        if self._blocked_checked != modes_key and self._schur_method in ("auto", "blocked"):
            self._blocked_checked = modes_key
            self._blocked_exec = None
            R_mode, f_mode, _ = modes_key
            if R_mode in ("scalar", "edge", "cell") and f_mode in ("scalar", "edge", "cell"):
                from .blocked_sharded import build_sharded_blocked_executor, plan_sharded_blocked

                plan = plan_sharded_blocked(asm, D)
                if plan is not None:
                    self._blocked_exec = build_sharded_blocked_executor(
                        asm, plan, self._mesh, modes=modes_key)
                elif self._schur_method == "auto":
                    from .grid_sharded import build_sharded_grid_executor, plan_sharded_grid

                    gplan = plan_sharded_grid(asm, D, modes=modes_key)
                    if gplan is not None:
                        self._blocked_exec = build_sharded_grid_executor(
                            asm, gplan, self._mesh, modes=modes_key)
        if self._blocked_exec is None and self._schur_method == "blocked":
            # on EVERY solve: a forced 'blocked' never falls through
            raise ValueError(
                "schur_method='blocked' requires a uniformly-K-ary "
                "forest with per-edge coefficients and a level width "
                "divisible by the device count"
            )
        if self._blocked_exec is not None:
            return self._solve_blocked(functions)

        # distributed λ elimination (multiplier axis sharded too)
        if self._dist_plan is None and self._schur_method in ("auto", "tree_dist"):
            B = net.num_multipliers
            forced = self._schur_method == "tree_dist"
            want = forced or (B > _DIST_LAMBDA_THRESHOLD and D > 1)
            if want and B > 0:
                from .distributed_tree import plan_distributed_tree

                self._dist_plan = plan_distributed_tree(asm, _cached_tree_plan(asm), D)
                if self._dist_plan is None and forced:
                    raise ValueError(
                        "tree_dist requires a forest bifurcation graph with "
                        "a bounded top tree (chain-like or cyclic networks "
                        "fall back to schur_method='auto')"
                    )
        if self._dist_plan is not None:
            return self._solve_distributed(functions)

        if self._pipeline is None:
            tree_plan = level_plan = None
            if self._schur_method in ("auto", "tree") and net.num_multipliers > 0:
                tree_plan = _cached_tree_plan(asm)
                if tree_plan is not None and tree_plan.core_size > 512:
                    tree_plan = _cached_tree_plan(asm, attach=True)
                level_plan = _plan_level_elimination(asm, tree_plan)
            method = self._schur_method if self._schur_method != "tree_dist" else "auto"
            self._pipeline = ShardedGeneralExecutor(asm, self._mesh, method, tree_plan,
                                                    level_plan, modes_key)
        ex = self._pipeline
        q_T, p_T, lam, finite = ex(ex.prepare_args(*self._coeff_args))
        E = net.num_edges
        q_edge = _rows(_to_host(q_T, self._mesh))[:E]
        p_cells = _rows(_to_host(p_T, self._mesh))[:E]
        self._info = SolveInfo(ex.method_name, 0, 0.0, bool(finite))
        return self._scatter_solution(q_edge, p_cells, _to_host(lam), functions)

    def _solve_blocked(self, functions):
        """The blocked forest and lattice strip routes."""
        ex = self._blocked_exec
        plan = ex.plan
        out = ex(ex.prepare_args(*self._coeff_args))
        if ex.method_name == "schur_sharded_grid":
            q_T, p_T, lam, res, finite = out
            residual = float(res)
            lam_flat = _to_host(lam)
        else:
            q_T, p_T, lam_loc, lam_T, _rhs_norm, finite = out
            residual = 0.0
            lam_flat = np.concatenate([_to_host(lam_loc, self._mesh).reshape(-1),
                                       _to_host(lam_T)])
        q = _rows(_to_host(q_T, self._mesh))  # (D*E_loc, k*N+1)
        p = _rows(_to_host(p_T, self._mesh))
        ok = bool(finite)
        self._info = SolveInfo(ex.method_name, 0, residual, ok)
        if not ok:
            raise RuntimeError(
                "Solver did not converge: sharded blocked solve produced non-finite values"
            )
        return self._scatter_solution(q[plan.edge_flat], p[plan.edge_flat],
                                      lam_flat[plan.lam_src], functions)

    def _solve_distributed(self, functions):
        """The distributed tree elimination: edges follow the node partition."""
        if self._dist_exec is None:
            self._dist_exec = DistTreeExecutor(self._assembler, self._dist_plan, self._mesh,
                                               self._modes_key)
        ex = self._dist_exec
        plan = self._dist_plan
        q_T, p_T, lam_loc, lam_T, finite = ex(ex.prepare_args(*self._coeff_args))
        inv = plan.edge_inv
        q_edge = _rows(_to_host(q_T, self._mesh))[inv]
        p_cells = _rows(_to_host(p_T, self._mesh))[inv]
        lam_flat = np.concatenate([_to_host(lam_loc, self._mesh).reshape(-1), _to_host(lam_T)])
        self._info = SolveInfo(ex.method_name, 0, 0.0, bool(finite))
        return self._scatter_solution(q_edge, p_cells, lam_flat[plan.lam_src], functions)

    def _scatter_solution(self, q_edge, p_cells, lam, functions):
        asm = self._assembler
        if functions is None:
            functions = [
                NetworkFunction(sp, name=f"flux_color_{i}")
                for i, sp in enumerate(asm.flux_spaces)
            ]
            functions.append(NetworkFunction(asm.pressure_space, name="pressure"))
            functions.append(NetworkFunction(asm.lm_space, name="global_flux"))
        x = _scatter_blocks_to_x(asm, q_edge, p_cells, lam)
        offs = asm.block_offsets
        for i, fn in enumerate(functions):
            fn.values[...] = x[offs[i] : offs[i + 1]]
        return functions


def _rows(blocks: np.ndarray) -> np.ndarray:
    """``(D, m, E_loc)`` shard blocks → ``(D·E_loc, m)`` rows."""
    D, m, E_loc = blocks.shape
    return np.ascontiguousarray(np.transpose(blocks, (0, 2, 1)).reshape(D * E_loc, m))


def shard_solve(
    assembler: _assembly.HydraulicNetworkAssembler,
    devices=None,
    functions: list[NetworkFunction] | None = None,
) -> list[NetworkFunction]:
    """One-shot sharded assemble + solve."""
    solver = ShardedNetworkSolver(assembler, devices=devices)
    solver.assemble()
    return solver.solve(functions)
