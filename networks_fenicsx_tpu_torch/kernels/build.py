"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled for Hopper (``sm_90a``) at first
use by :func:`torch.utils.cpp_extension.load` (ninja) into
``kernels/_build/<hash>/``, keyed on a hash of the sources and flags, and
bound through their plain C launchers with :mod:`ctypes`: the sources include
no PyTorch header, so the build takes seconds.  Each launcher takes device
pointers and the current CUDA stream, launches, and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.

Nothing here is imported by the CPU path: the library is built only when a
wrapper is given a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import pathlib

import numpy as np
import torch

__all__ = [
    "library", "check", "require_cuda", "require_vectors", "require_coefficients", "on_device",
    "stream_handle", "raw_stream", "Counter", "BUILD_ROOT", "scenarios", "batched", "scenario_row",
    "scenario_stride", "norm_scratch",
]

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).parent / "_build"
# -fmad=false: every product is rounded before it is added, as in the plain
# versions' separate PyTorch operations, so a kernel and its plain version
# agree to the last bit where they add in the same order
CUDA_FLAGS = ("-O3", "-std=c++17", "-fmad=false", "-gencode=arch=compute_90a,code=sm_90a")

_p, _i, _d, _l = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
_SIGNATURES = {
    "nxfx_condense": [_p, _p, _p],  # CondenseArgs, out (5, rows, E), stream
    "nxfx_condense_scen": [_p, _p, _p],  # CondenseScenArgs, out (5, S, E), stream
    "nxfx_tree_sweep": [
        _i, _i, _i, _i, _i, _i, _i, _i, _i,  # mode, Kmax, L, cut, group, blocks, threads, nodes, smem
        _i, _i, _p,  # top nodes, top threads, level table
        _p, _p, _p,  # bif_in, bif_out, bif_parent
        _p, _p, _p,  # w, const, Ftot
        _p, _p, _p, _p, _p, _p, _p,  # d, r, wn, lam, factor, partials, norm or sum r^2
        _i, _l, _l, _l, _l, _p,  # scenarios, strides (w; const, Ftot; d, wn, factor; r, lam), stream
    ],
    "nxfx_expand": [
        _i, _i, _i, _i,  # E, B, N, k
        _p, _p, _p, _p, _p,  # lam, edge_src, edge_tgt, start_pbc, end_pbc
        _p, _p, _p, _p, _p,  # W, w, g, Ftot, h_e
        _p, _i, _p, _i,  # R, mode, f, mode
        _d, _d, _d, _d, _p,  # condensed matrix, Minv
        _p, _p, _p, _p,  # q_T, p_T, finite, stream
    ],
    "nxfx_expand_scen": [_p, _p],  # ExpandArgs, stream
    "nxfx_condense_vjp": [_p, _p],  # CondenseVjpArgs, stream
    "nxfx_expand_vjp": [_p, _p],  # ExpandVjpArgs, stream
    "nxfx_expand_vjp_fold": [
        _i, _i, _i, _p, _p, _p,  # E, B, K_max, bif_in, bif_out, edge_tgt
        _p, _p, _p, _p, _p,  # lam_bar, bars, rho, Ftot_adj, stream
    ],
    "nxfx_segsum_plan": [
        _p, _i,  # SumPlanArgs, n
        _p, _p, _p, _p, _p, _p, _p, _p, _p,  # four value arrays, four outputs, stream
    ],
    "nxfx_fold": [
        _i, _p, _p, _p, _i, _i,  # L, host level pointers, rows, widths, C, n
        _p, _p, _p,  # vals, out, stream
    ],
    "nxfx_fold_scen": [
        _i, _p, _p, _p, _i, _i, _i,  # L, host level pointers, rows, widths, C, n, S
        _p, _p, _p,  # vals (S, n, C), out (S, rows, C), stream
    ],
    "nxfx_edge_data": [
        _i, _i, _i, _i, _i,  # layout, E, N, k, nq
        _i, _i, _i, _i, _i, _i, _i,  # the tile: cells, rows, R width, pitch, f width, pitch, shared
        _p, _p, _i, _p, _i, _i,  # h_e, R, mode, f, mode, elide_f
        _p, _p, _d, _d, _d,  # wq, phi, wt, cs0, cs1
        _p, _p, _p, _p, _p, _p,  # mt, minv, work, cumF, W, g
        _p, _p, _p, _p,  # rh, ua, uF, stream
    ],
    "nxfx_edge_data_scen": [
        _i, _i, _i, _i, _i,  # layout, E, N, k, nq
        _i, _i, _i, _i, _i, _i, _i,  # the tile: cells, rows, R width, pitch, f width, pitch, shared
        _p, _p, _i, _p, _i, _i,  # h_e, R, mode, f, mode, elide_f
        _p, _p, _d, _d, _d,  # wq, phi, wt, cs0, cs1
        _p, _p, _p, _p, _p, _p,  # mt, minv, work, cumF, W, g
        _p, _p, _p,  # rh, ua, uF
        _i, _i, _l, _l, _p,  # S, rows of blocks, R stride, f stride, stream
    ],
    "nxfx_level_prepare": [
        _i, _p, _p, _p,  # E, W, g, Ftot
        _p, _p, _p, _p,  # start_pbc, end_pbc, start_bif, end_bif
        _p, _p, _p, _p,  # w, vt, vs, stream
    ],
    "nxfx_level_eliminate": [
        _p, _p, _p, _p,  # LevelWalkArgs, w_pairs, dt_t, dt_s
        _p, _p, _p, _p, _p, _p, _p,  # d, r, wn, lam_perm, lam, rhs_norm, stream
    ],
    "nxfx_level_prepare_scen": [
        _i, _i, _l, _l, _l,  # E, S, Ftot, start_pbc, end_pbc strides
        _p, _p, _p, _p, _p, _p, _p,  # W, g, Ftot, start_pbc, end_pbc, start_bif, end_bif
        _p, _p, _p, _p,  # w, vt, vs, stream
    ],
    "nxfx_level_eliminate_scen": [
        _p, _i, _l, _p, _p, _p,  # LevelWalkArgs, S, w_pairs stride, w_pairs, dt_t, dt_s
        _p, _p, _p, _p, _p, _p, _p,  # d, r, wn, lam_perm, lam, rhs_norm, stream
    ],
    "nxfx_level_eliminate_system": [
        _p, _p, _p,  # LevelWalkArgs, w_pairs, dr
        _p, _p, _p, _p, _p, _p, _p,  # d, r, wn, lam_perm, lam, rhs_norm, stream
    ],
    "nxfx_backsub": [
        _i, _i, _i, _i, _i,  # layout, E, B, N, k
        _p, _p, _p, _p, _p,  # lam, start_bif, end_bif, start_pbc, end_pbc
        _p, _p, _p,  # W, g, cumF
        _p, _p, _p, _i, _p, _p,  # mt, rh, minv, per_cell, ua, uF
        _d, _d, _d, _d,  # condensed matrix
        _p, _p, _p, _p,  # q_T, p_T, finite, stream
    ],
    "nxfx_backsub_scen": [
        _i, _i, _i, _i, _i, _i, _p,  # layout, E, B, N, k, S, host strides (10)
        _p, _p, _p, _p, _p,  # lam, start_bif, end_bif, start_pbc, end_pbc
        _p, _p, _p,  # W, g, cumF
        _p, _p, _p, _i, _p, _p,  # mt, rh, minv, per_cell, ua, uF
        _d, _d, _d, _d,  # condensed matrix
        _p, _p, _p, _p,  # q_T, p_T, finite (S,), stream
    ],
    "nxfx_lambda_prepare_scen": [
        _i, _i, _l, _l, _l,  # E, S, Ftot, start_pbc, end_pbc strides
        _p, _p, _p, _p, _p, _p, _p,  # W, g, Ftot, start_pbc, end_pbc, start_bif, end_bif
        _p, _p, _p, _p,  # w, vt, vs, stream
    ],
    "nxfx_segsum_plan_scen": [
        _p, _i, _i,  # SumPlanArgs, n, S
        _p, _p, _p, _p, _p, _p, _p, _p, _p,  # four value arrays, four outputs, stream
    ],
    "nxfx_lambda_prepare": [
        _i, _p, _p, _p,  # E, W, g, Ftot
        _p, _p, _p, _p,  # start_pbc, end_pbc, start_bif, end_bif
        _p, _p, _p, _p,  # w, vt, vs, stream
    ],
    "nxfx_rhs_norm": [_i, _p, _p, _p],  # B, dr, out, stream
    "nxfx_rhs_norm_scen": [_i, _i, _p, _p, _p],  # B, S, dr (S, B, 2), out (S,), stream
    "nxfx_peel_forward": [_p, _p, _p],  # PeelArgs, host table, stream
    "nxfx_peel_back": [_p, _p, _p],  # PeelArgs, host table, stream
    "nxfx_dense_core": [
        _i, _i, _i, _p, _p, _p, _p,  # n, P0, n_refine, ci, cj, pid, w_pairs
        _p, _p, _p, _p, _p, _p, _p, _p, _p, _p,  # dc, rc, Lc, C, s, v, y, x, ok, stream
    ],
    "nxfx_dense_factor": [
        _i, _i, _p, _p, _p, _p,  # n, P0, ci, cj, pid, w_pairs
        _p, _p, _p, _p, _p,  # dc, Lc, C, s, stream
    ],
    "nxfx_dense_gate": [_i, _p, _p, _p],  # n, C, ok, stream
    "nxfx_dense_solve": [
        _i, _i, _p, _p, _p, _p,  # n, n_refine, Lc, C, s, ok
        _p, _p, _p, _p, _p,  # rc, v, y, x, stream
    ],
    "nxfx_dense_factor_scen": [
        _i, _i, _i, _l, _p, _p, _p, _p,  # n, S, P0, P, ci, cj, pid, w_pairs (S, P)
        _p, _p, _p, _p, _p,  # dc (S, n), Lc, C (S, n, n), s (S, n), stream
    ],
    "nxfx_dense_gate_scen": [_i, _i, _p, _p, _p],  # n, S, C (S, n, n), ok (S,), stream
    "nxfx_dense_solve_scen": [
        _i, _i, _i, _i, _p, _p, _p, _p,  # n, S, n_refine, shared, Lc, C, s, ok
        _p, _p, _p, _p, _p,  # rc (S, n), v, y, x, stream
    ],
    "nxfx_core_forward": [_p, _p],  # CoreArgs, stream
    "nxfx_core_factor": [_p, _p],  # CoreArgs, stream
    "nxfx_core_apply": [_p, _p],  # CoreArgs, stream
    "nxfx_core_back": [_p, _p],  # CoreArgs, stream
    "nxfx_core_grid_blocks": [_i, _i, _i, _i],  # device, header words, staged, kernel
    "nxfx_front_factor": [
        _i, _i, _i, _i, _i, _p, _p,  # w, b, ns, P0, first, nodes, d
        _p, _p, _p, _p, _p, _p,  # slot_i, slot_j, f_init, init_slot, w_pairs, sf (or null)
        _i, _p, _p, _p, _l, _p, _p,  # n_cons, host cons table, lminv, fbuf, f_off, ok, stream
    ],
    "nxfx_front_forward": [_i, _i, _p, _p, _p, _l, _p, _p, _p, _p],  # w, b, nodes, bnd, fbuf, f_off, r, t, y
    "nxfx_front_back": [_i, _i, _p, _p, _p, _l, _p, _p, _p, _p, _p],  # ..., y, t, u, lam, stream
    "nxfx_front_nan_gate": [_i, _p, _p, _p],  # n, ok, lam, stream
    "nxfx_mf_factor": [
        _i, _p, _i, _i, _i,  # n_levels, host level table, n_core, P0, assemble_only
        _p, _p,  # device group and front tables
        _p, _p, _p,  # init_slot, w_pairs, dc
        _p, _p, _p, _p,  # nodes_all, cval_all, ccol_all, rel_all
        _p, _p, _p,  # xadd_ptr, xadd, pools_in
        _p, _p, _p, _p, _p,  # vals, fac, pools, ok, stream
    ],
    "nxfx_mf_factor_scen": [
        _i, _p, _i, _i, _i,  # n_levels, host level table, n_core, P0, S
        _p, _p,  # device group and front tables
        _p, _l, _p, _l, _p,  # init_slot, w_pairs stride, w_pairs, dc stride, dc
        _p, _p, _p, _p,  # nodes_all, cval_all, ccol_all, rel_all
        _p, _p,  # xadd_ptr, xadd
        _p, _l, _p, _l, _p, _p, _p,  # vals, fac stride, fac, pool stride, pools, ok, stream
    ],
    "nxfx_mf_sweep_scen": [
        _i, _p, _i, _i, _i,  # n_levels, host level table, n_core, lam_len, S
        _p, _p,  # device group and front tables
        _l, _p, _p, _p, _p, _p, _p,  # rc stride, rc, nodes_all, bndpos_all, xadd_ptr, xadd, lam_pos
        _l, _p, _l, _p, _p, _p, _p, _i, _p,  # fac stride, fac, vpool stride, vpools, ys, lam, x, accumulate
    ],
    "nxfx_mf_terms_scen": [_i, _i, _i, _l, _p, _p, _p, _p, _p, _p, _p],  # P0, n, S, vals stride, ...
    "nxfx_mf_residual_scen": [
        _i, _i, _l, _p, _l, _p, _p,  # n, S, rc stride, rc, dc stride, dc, x
        _p, _i, _p, _p, _i, _p,  # inv_i, n_i, si, inv_j, n_j, sj
        _p, _p,  # r, stream
    ],
    "nxfx_mf_gate_scen": [_i, _i, _l, _p, _p, _p],  # n, S, ok stride, ok, x, stream
    "nxfx_mf_sweep": [
        _i, _p, _i, _i,  # n_levels, host level table, n_core, lam_len
        _p, _p,  # device group and front tables
        _p, _p, _p, _p, _p, _p,  # rc, nodes_all, bndpos_all, xadd_ptr, xadd, lam_pos
        _p, _p, _p, _p, _p, _i, _p,  # fac, vpools, ys, lam, x, accumulate, stream
    ],
    "nxfx_mf_terms": [_i, _p, _p, _p, _p, _p, _p, _p],  # P0, vals, pci, pcj, x, ti, tj, stream
    "nxfx_mf_residual": [
        _i, _p, _p, _p,  # n, rc, dc, x
        _p, _i, _p, _p, _i, _p,  # inv_i, n_i, si, inv_j, n_j, sj
        _p, _p,  # r, stream
    ],
    "nxfx_mf_gate": [_i, _p, _p, _p],  # n, ok, x, stream
    "nxfx_dct_gemm": [
        _i, _i, _i,  # M, N, K
        _p, _i, _p, _i,  # A, transA, B, transB
        _p, _p, _i, _p,  # S (or null), C, split, stream
    ],
    "nxfx_dct_factor": [_p, _p, _p, _p, _p, _p],  # DctArgs, w, inv, g, Minv, stream
    "nxfx_dct_lplus": [_p, _p, _p, _p, _p],  # DctArgs, inv, b, z, stream
    "nxfx_dct_pass": [_p, _p, _p, _p, _i, _p],  # DctArgs, w (or null), b, lam, accumulate, stream
    "nxfx_dct_apply": [_p, _p, _p, _p, _p, _p, _i, _p],  # DctArgs, inv, g, Minv, b, lam, accumulate, stream
    "nxfx_dct_factor_scen": [_p, _i, _p, _l, _p, _p, _p, _p],  # DctArgs, S, w, row stride, inv, g, Minv, stream
    "nxfx_dct_apply_scen": [
        _p, _p, _i, _i,  # DctArgs, DctScen, S, shared
        _p, _p, _p, _p, _p, _i, _p,  # inv, g, Minv, b, lam, accumulate, stream
    ],
    "nxfx_dct_matrix": [_i, _d, _d, _p, _p],  # n, scale, scale0, D, stream
    "nxfx_grid_assemble": [_p, _p, _p, _p, _p, _p, _p, _p],  # GridArgs, w, const, Ftot, rhs, diag, norm, stream
    "nxfx_grid_residual": [_p, _p, _p, _p, _p, _p, _p, _p],  # GridArgs, w, diag, lam, rhs, res, norm (or null), stream
    "nxfx_grid_assemble_scen": [
        _p, _i, _p, _p, _p, _p,  # GridArgs, S, GridStrides, w, const, Ftot
        _p, _p, _p, _p, _p, _p,  # rhs, diag, norms (or null), partials, tickets, stream
    ],
    "nxfx_grid_residual_scen": [
        _p, _i, _p, _p, _p, _p, _p,  # GridArgs, S, GridStrides, w, diag, lam, rhs
        _p, _p, _p, _p, _p,  # res, norms (or null), partials, tickets, stream
    ],
    "nxfx_shift_matvec": [_p, _p, _p, _p, _p, _p, _p, _p],  # ShiftArgs, cw, diag, x, b, out, norm, stream
    "nxfx_shift_matvec_scen": [
        _p, _i, _l, _l, _l,  # ShiftArgs, S, strides of cw, diag and b
        _p, _p, _p, _p, _p, _p, _p, _p, _p,  # cw, diag, x, b, out, norms, partials, tickets, stream
    ],
    "nxfx_shift_cheb": [
        _p, _p, _p, _p, _p, _p, _p, _p,  # ShiftArgs, cw, diag, s, rs, dvec, x_in, x_out
        _d, _d, _p, _p, _p,  # c1, c2, z (or null), base (or null), stream
    ],
    "nxfx_krylov_cg_start": [_i, _p, _p, _p, _p, _p, _d, _d, _d, _p],  # n, b, r, z, part, st, rtol, atol, maxiter
    "nxfx_krylov_cg_step": [_p, _p, _p],  # CgArgs, Ap, stream
    "nxfx_krylov_cg_direction": [_p, _p, _p],  # CgArgs, z (or null with Jacobi), stream
    "nxfx_krylov_cheb_start": [_i, _p, _p, _d, _p, _p, _p, _p, _p, _p],  # n, s, r, theta, rs, dvec, x, z, base
    "nxfx_krylov_jacobi": [_i, _p, _p, _p, _p],  # n, v, diag, z, stream
    "nxfx_krylov_inv_sqrt": [_i, _p, _p, _p],  # n, d, s, stream
    "nxfx_gather_apply": [
        _i, _i, _p, _p, _p, _p,  # B, K, edge table, neighbour table, w, diag
        _p, _p, _p, _p, _p, _p,  # x, b (or null), out, partial (or null), norm (or null), stream
    ],
    "nxfx_gather_values": [_i, _i, _p, _p, _p, _p],  # B, K, edge table, w, values, stream
    "nxfx_gather_plan_apply": [
        _i, _i, _p, _p, _p,  # B, K, neighbour table, values, diag
        _p, _p, _p, _p, _p, _p,  # x, b (or null), out, partial (or null), norm (or null), stream
    ],
    "nxfx_gather_cheb_blocks": [_i],  # device
    "nxfx_gather_cheb_apply": [_p, _p, _p, _p, _p],  # GatherChebArgs, r, z, base (or null), stream
    "nxfx_mg2d_level0": [_i, _p, _i, _i, _i, _i, _p, _p, _p],  # m, cw, E W S N classes, diag0, lev
    "nxfx_mg2d_coarsen": [_i, _i, _p, _i, _i, _p, _p],  # nyf, nxf, fine, nyc, nxc, coarse, stream
    "nxfx_mg2d_stencil": [_i, _i, _p, _p, _p, _p, _p],  # ny, nx, lev, x, b (or null), out, stream
    "nxfx_mg2d_cheb_first": [
        _i, _i, _p, _p, _d, _d, _d,  # ny, nx, lev, r, 1 / theta, c1, c2
        _p, _p, _p, _p, _p, _p,  # rs, dvec, x_out, z (or null), base (or null), stream
    ],
    "nxfx_mg2d_residual_restrict": [_i, _i, _p, _p, _p, _i, _i, _p, _p],  # nyf, nxf, lev, x, b, nyc, nxc, rc
    "nxfx_mg2d_prolong_residual": [
        _i, _i, _p, _p, _i, _p, _d,  # ny, nx, lev, x, nxc, ec, overcorrect
        _p, _p, _p, _p,  # b, xp, res, stream
    ],
    "nxfx_mg2d_down": [_p, _p, _p],  # Mg2dCycle, r0, stream
    "nxfx_mg2d_up": [_p, _p, _p, _p, _p],  # Mg2dCycle, r0, e_bottom, out0, stream
    "nxfx_mg_coarse_factor": [_i, _i, _p, _p, _p, _p, _p],  # m, C, host offsets, cw, diag, A, stream
    "nxfx_mg_coarse_solve": [_i, _p, _p, _p, _p, _p, _p],  # m, A, r, v, y, x, stream
    "nxfx_mg1d_level0": [_i, _i, _p, _p, _p, _p, _p],  # m, C, cw, diag, extra, dis, stream
    "nxfx_mg1d_coarsen": [
        _i, _i, _p, _p, _i,  # m, mc, cw_f, extra_f, Cc
        _p, _p, _p,  # map_ptr, map_ci, map_p
        _p, _p, _p, _p, _p,  # cw_c, extra_c, diag_c, dis_c, stream
    ],
    "nxfx_mg1d_cheb_first": [
        _p, _p, _d, _d, _d,  # Mg1dLevelArgs, r, 1 / theta, c1, c2
        _p, _p, _p, _p, _p, _p,  # rs, dvec, x_out, z (or null), base (or null), stream
    ],
    "nxfx_mg1d_residual_restrict": [_p, _p, _p, _p, _p],  # Mg1dLevelArgs, x, b, rc, stream
    "nxfx_mg1d_prolong_residual": [_p, _p, _p, _d, _p, _p, _p, _p],  # level, x, ec, oc, b, xp, res
    "nxfx_mg1d_down": [_p, _p, _p],  # Mg1dCycle, r0, stream
    "nxfx_mg1d_up": [_p, _p, _p, _p, _p],  # Mg1dCycle, r0, e_bottom, out0, stream
    "nxfx_krylov_minres_start": [
        _i, _p, _p, _p, _p, _p, _p, _d, _d, _d, _p,  # n, b, r, y, v, part, ms, rtol, atol, maxiter
    ],
    "nxfx_krylov_minres_step": [_p, _p, _p, _p, _p, _p, _p],  # MinresArgs, yv, r1, r2, w, w2, stream
    "nxfx_krylov_minres_finish": [_p, _p, _p, _p, _p, _p],  # MinresArgs, yv, y, w, w2, stream
    "nxfx_csr_fold": [_l, _i, _l, _p, _p, _p, _p, _p],  # nnz, max_dup, nraw, perm, idx, vals, data
    "nxfx_csr_spmv": [_i, _p, _p, _p, _p, _p, _p, _p],  # n, indptr, indices, data, v, signs, out
    "nxfx_csr_rows": [_i, _i, _p, _p, _p, _p, _p, _p],  # n, mode, indptr, indices, data, adiag, out
    "nxfx_schur_p_factor": [_p, _p, _p, _p, _p],  # SchurTiles, cell masses, Lb, adiag, stream
    "nxfx_schur_p_solve": [_p, _p, _p, _p, _p],  # SchurTiles, Lb, v, out, stream
    "nxfx_lu_factor": [_i, _p, _p, _p, _p],  # n, A, piv, host launch count, stream
    "nxfx_lu_solve": [_i, _p, _p, _p, _p, _p, _p],  # n, LU, piv, b, x, tile flags, stream
    "nxfx_trsv": [_i, _p, _i, _i, _i, _p, _p, _p],  # n, A, lower, trans, unit, x, tile flags, stream
    "nxfx_shard_reduce": [_i, _l, _l, _l, _p, _p, _p],  # D, n, stride, offset, parts, out, stream
    "nxfx_shard_reduce_placed": [
        _i, _i, _i, _i, _i, _i, _l,  # D, d0, C, h, nx, ny, stride
        _p, _p, _p,  # parts, out, stream
    ],
    "nxfx_shard_all": [_i, _p, _p, _p],  # D, flags, out, stream
    "nxfx_t_solve": [
        _i, _p,  # Tn, the plan's table
        _p, _p, _p, _p,  # dT, rT, wT, sq_extra (or null)
        _p, _p, _p,  # lam, norm (or null), stream
    ],
    "nxfx_shard_blocked_partials": [
        _p, _i, _i,  # ShardBlockedArgs, first shard, Tn
        _i, _i, _i, _i,  # Kt, Ks, Kp, Kr
        _p, _p, _p, _p,  # tfold, sfold, pfold, rfold
        _p, _p,  # part, stream
    ],
    "nxfx_shard_blocked_lambda": [
        _p, _i, _i, _i, _i, _p,  # ShardBlockedArgs, first shard, c, B_sub, Tn, root_T
        _p, _p, _p,  # lam_T, lam, stream
    ],
    "nxfx_dist_folds": [
        _p, _i, _i, _i,  # DistFoldArgs, first shard, B_loc, Tn
        _p, _i, _p, _i, _p, _i,  # t, s, w edge tables and widths
        _p, _i, _p, _i, _p, _i,  # tT, sT, wT
        _p, _p, _p, _p, _p,  # d, r, wn, part, stream
    ],
    "nxfx_dist_forward": [
        _i, _i, _i, _i, _i,  # S, L, B_loc, Tn, widest level
        _p, _p, _p, _i,  # level table, runs of children, rfold, Kr
        _p, _p, _p, _p, _p, _p,  # wn, d, r, part, scratch (or null), stream
    ],
    "nxfx_dist_back": [
        _i, _i, _i, _i, _i,  # S, L, B_loc, Tn, widest level
        _p, _p, _p,  # level table, parent_pos, root_T
        _p, _p, _p, _p, _p, _p, _p,  # d, r, wn, lam_T, lam, scratch (or null), stream
    ],
    "nxfx_shard_grid_window": [
        _i, _i, _i, _i, _i, _i, _i, _i, _i, _i,  # S, h, nx, U, Kc, r, Kg, E_loc, st_len, first
        _p, _p, _p, _p,  # w, const, Ftot, valid
        _p, _p, _p, _p,  # cell_map, st_fold, grp_fold, st_sb
        _p, _p,  # part, stream
    ],
    "nxfx_shard_grid_fill": [_l, _l, _l, _p, _p, _p],  # Ex, Ey, E, wxy, w_grid, stream
}


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def source_digest() -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(CUDA_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    from torch.utils.cpp_extension import load

    digest = source_digest()
    build_dir = BUILD_ROOT / digest
    build_dir.mkdir(parents=True, exist_ok=True)
    path = load(
        name=f"nxfx_kernels_{digest}",
        sources=[str(s) for s in sources()],
        build_directory=str(build_dir),
        extra_cuda_cflags=list(CUDA_FLAGS),
        is_python_module=False,
        verbose=False,
    )
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


class Counter:
    """The launch count of a kernel whose wrappers are several functions:
    named like the kernel and counted as a wrapper's ``launches`` is."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


def check(code: int, name: str) -> None:
    """Raise when a launcher reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as a handle, without a
    Python ``Stream`` object (the lean launch path)."""
    return torch._C._cuda_getCurrentRawStream(index)


def require_cuda(name: str, *tensors: torch.Tensor, dtype=torch.float64,
                 contiguous: bool = True) -> None:
    """Validate what a kernel takes: CUDA, one device, ``dtype``, and
    contiguous unless the kernel reads them at a stride."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def require_vectors(name: str, index: int, *pairs) -> None:
    """The one-pass check of a lean launch path: raise unless every
    ``(tensor, n)`` is a contiguous 1-D float64 tensor on CUDA device
    ``index`` with ``n`` entries (at least ``-n`` for a negative ``n``)."""
    for t, n in pairs:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"{name}: tensors must be on CUDA device {index}")
        if (t.dtype is not torch.float64 or t.dim() != 1 or not t.is_contiguous()
                or (t.shape[0] != n if n >= 0 else t.shape[0] < -n)):
            size = n if n >= 0 else f"at least {-n}"
            raise ValueError(f"{name}: expected a contiguous 1-D float64 tensor of {size} entries, "
                             f"got {t.dtype} {tuple(t.shape)}")


def on_device(index: int, fn, *args):
    """``fn(*args)`` with CUDA device ``index`` current, entering it only
    when it is not already."""
    if index == torch._C._cuda_getDevice():
        return fn(*args)
    with torch.cuda.device(index):
        return fn(*args)


def scenarios(name: str, *pairs, S: int | None = None) -> int:
    """The scenario count of a call over a scenario axis: each ``(tensor,
    base shape)`` is either batched, ``(S,) + base`` (contiguous), or shared
    by every scenario, ``base`` itself.  Raise on any other shape, on
    batched inputs of different counts, and when nothing is batched and
    ``S`` is not given."""
    for t, base in pairs:
        base = tuple(base)
        if tuple(t.shape) == base:
            continue
        if t.dim() != len(base) + 1 or tuple(t.shape[1:]) != base or not t.is_contiguous():
            raise ValueError(f"{name}: expected {base} or a contiguous (S,) + {base}, "
                             f"got {tuple(t.shape)}")
        if S is not None and t.shape[0] != S:
            raise ValueError(f"{name}: batched inputs of {S} and {t.shape[0]} scenarios")
        S = int(t.shape[0])
    if S is None:
        raise ValueError(f"{name}: no input carries a scenario axis")
    return S


def batched(t: torch.Tensor, base) -> bool:
    """Whether ``t`` carries a scenario axis over ``base`` (see :func:`scenarios`)."""
    return t.dim() == len(tuple(base)) + 1


def scenario_row(t: torch.Tensor, base, i: int) -> torch.Tensor:
    """Scenario ``i``'s row of ``t``: ``t[i]`` when batched, ``t`` when shared."""
    return t[i] if batched(t, base) else t


def scenario_stride(t: torch.Tensor, base) -> int:
    """Elements between two scenarios' rows of ``t``: 0 when shared."""
    return int(np.prod(tuple(base), dtype=np.int64)) if batched(t, base) else 0


def norm_scratch(store: dict, stream: int, index: int, S: int, blocks: int) -> tuple[int, int]:
    """``(partials, tickets)`` addresses of the scenario norms' scratch of a
    kernel on CUDA stream ``stream`` (``ticket_norm.cuh`` over S scenarios):
    ``S`` rows of ``blocks`` float64 partial sums, then ``S`` ticket words,
    in one buffer zeroed on the stream and kept in ``store`` under
    ``("scen", stream)``.  It is made anew for more scenarios than it holds
    once the stream has drained (its launches may still use the old one);
    the kernels leave every ticket at 0."""
    key = ("scen", stream)
    entry = store.get(key)
    if entry is None or entry[0] < S:
        if entry is not None:
            torch.cuda.current_stream(index).synchronize()
        buf = torch.zeros(S * blocks + -(-S // 2), dtype=torch.float64, device=f"cuda:{index}")
        entry = store[key] = (S, buf, buf.data_ptr(), buf.data_ptr() + 8 * S * blocks)
    return entry[2], entry[3]


def require_coefficients(name: str, N: int, E: int, *coeffs: tuple) -> None:
    """Validate ``(label, tensor, mode)`` coefficients: ``scalar`` is (1,),
    ``edge`` (E,) and ``cell`` the j-major (N, E) block."""
    expect = {"scalar": (1,), "edge": (E,), "cell": (N, E)}
    for label, t, mode in coeffs:
        if mode not in expect or tuple(t.shape) != expect[mode]:
            raise ValueError(f"{name}: {label} of mode {mode!r} has shape {tuple(t.shape)}")
