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

import torch

__all__ = [
    "library", "check", "require_cuda", "require_coefficients", "stream_handle", "Counter", "BUILD_ROOT",
]

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).parent / "_build"
# -fmad=false: every product is rounded before it is added, as in the plain
# versions' separate PyTorch operations, so a kernel and its plain version
# agree to the last bit where they add in the same order
CUDA_FLAGS = ("-O3", "-std=c++17", "-fmad=false", "-gencode=arch=compute_90a,code=sm_90a")

_p, _i, _d, _l = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
_SIGNATURES = {
    "nxfx_condense": [
        _i, _i, _p, _p, _i, _p, _i, _p, _p, _p, _p,  # E, N, h_e, R, mode, f, mode, pbc, bifs
        _d, _d, _d, _d,  # wt, cs0, cs1, g_closed
        _p, _p, _p, _p, _p, _p,  # W, w, g, Ftot, const, stream
    ],
    "nxfx_tree_sweep": [
        _i, _i, _i, _p,  # B, Kmax, L, host level offsets
        _p, _p, _p, _p,  # bif_in, bif_out, bif_child, bif_parent
        _p, _p, _p,  # w, const, Ftot
        _p, _p, _p, _p, _p, _p,  # d, r, wn, lam, rhs_norm, stream
    ],
    "nxfx_expand": [
        _i, _i, _i, _i,  # E, B, N, k
        _p, _p, _p, _p, _p,  # lam, edge_src, edge_tgt, start_pbc, end_pbc
        _p, _p, _p, _p, _p,  # W, w, g, Ftot, h_e
        _p, _i, _p, _i,  # R, mode, f, mode
        _d, _d, _d, _d, _p,  # condensed matrix, Minv
        _p, _p, _p, _p,  # q_T, p_T, finite, stream
    ],
    "nxfx_segsum": [
        _i, _i, _i, _i,  # S, K, C, n
        _p, _p, _p, _p,  # idx, vals, out, stream
    ],
    "nxfx_segsum_into": [
        _i, _i, _i, _i,  # S, K, C, n
        _p, _p, _p, _p, _p,  # idx, vals, bins, out, stream
    ],
    "nxfx_edge_data": [
        _i, _i, _i, _i, _i,  # layout, E, N, k, nq
        _p, _p, _i, _p, _i, _i,  # h_e, R, mode, f, mode, elide_f
        _p, _p, _d, _d, _d,  # wq, wphi, wt, cs0, cs1
        _p, _p, _p, _p, _p, _p,  # mt, minv, work, cumF, W, g
        _p, _p, _p, _p,  # rh, ua, uF, stream
    ],
    "nxfx_level_prepare": [
        _i, _p, _p, _p,  # E, W, g, Ftot
        _p, _p, _p, _p,  # start_pbc, end_pbc, start_bif, end_bif
        _p, _p, _p, _p,  # w, vt, vs, stream
    ],
    "nxfx_level_eliminate": [
        _i, _i, _p,  # B, L, host level offsets
        _p, _p, _p, _p,  # parent_pos, parent_pair, child_ptr, perm
        _p, _p, _p,  # w_pairs, dt_t, dt_s
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
    "nxfx_lambda_prepare": [
        _i, _p, _p, _p,  # E, W, g, Ftot
        _p, _p, _p, _p,  # start_pbc, end_pbc, start_bif, end_bif
        _p, _p, _p, _p,  # w, vt, vs, stream
    ],
    "nxfx_rhs_norm": [_i, _p, _p, _p],  # B, dr, out, stream
    "nxfx_peel_forward": [
        _i, _p, _p, _p, _i,  # n, elim, parents, pair_ids, has_pairs
        _p, _p,  # w_pairs, dr
        _p, _p, _p, _p, _p,  # w, db, rb, terms, stream
    ],
    "nxfx_peel_parents": [_i, _p, _p, _p, _p],  # U, upar, s, dr, stream
    "nxfx_core_gather": [_i, _p, _p, _p, _p, _p],  # n, nodes, dr, dc, rc, stream
    "nxfx_core_scatter": [_i, _p, _p, _p, _p],  # n, nodes, x, lam, stream
    "nxfx_peel_back": [
        _i, _p, _p,  # n, elim, parents
        _p, _p, _p, _p, _p,  # w, db, rb, lam, stream
    ],
    "nxfx_dense_core": [
        _i, _i, _i, _p, _p, _p, _p,  # n, P0, n_refine, ci, cj, pid, w_pairs
        _p, _p, _p, _p, _p, _p, _p, _p, _p, _p,  # dc, rc, Lc, C, s, v, y, x, ok, stream
    ],
    "nxfx_dense_factor": [
        _i, _i, _p, _p, _p, _p,  # n, P0, ci, cj, pid, w_pairs
        _p, _p, _p, _p, _p,  # dc, Lc, C, s, stream
    ],
    "nxfx_core_round_terms": [
        _i, _i, _i, _p, _p, _p, _p,  # S, K, P0, elim, init_idx, init_slot, w_pairs
        _p, _p, _p, _p, _p, _p,  # ur (or null), d, a, inv, t, stream
    ],
    "nxfx_core_round_update": [
        _i, _i, _i, _i, _p, _p, _p,  # n_core, U1, M2, K, d_inv, sd, d
        _p, _p, _p, _p, _p, _p,  # u_src_i, u_src_j, a, inv, contrib, stream
    ],
    "nxfx_core_apply_terms": [_i, _i, _p, _p, _p, _p, _p, _p, _p],  # S, K, elim, a, inv, r, rv, t
    "nxfx_core_apply_update": [_i, _i, _p, _p, _p, _p],  # n_core, U1, d_inv, sr, r, stream
    "nxfx_core_back": [_i, _i, _p, _p, _p, _p, _p, _p, _p],  # S, K, elim, nbr, a, inv, rv, lam
    "nxfx_core_tail_gather": [
        _i, _i, _i, _p, _p, _p,  # Bd, Pd, P0, dense nodes, d, r
        _p, _p, _p, _p, _p, _p, _p, _p,  # dp_init, init_slot, w_pairs, dpf (or null), dd, rr, -ov, stream
    ],
    "nxfx_core_scatter_nodes": [_i, _p, _p, _p, _p],  # n, nodes, x, lam, stream
    "nxfx_front_factor": [
        _i, _i, _i, _i, _i, _p, _p,  # w, b, ns, P0, first, nodes, d
        _p, _p, _p, _p, _p, _p,  # slot_i, slot_j, f_init, init_slot, w_pairs, sf (or null)
        _i, _p, _p, _p, _l, _p, _p,  # n_cons, host cons table, lminv, fbuf, f_off, ok, stream
    ],
    "nxfx_front_forward": [_i, _i, _p, _p, _p, _l, _p, _p, _p, _p],  # w, b, nodes, bnd, fbuf, f_off, r, t, y
    "nxfx_front_back": [_i, _i, _p, _p, _p, _l, _p, _p, _p, _p, _p],  # ..., y, t, u, lam, stream
    "nxfx_front_nan_gate": [_i, _p, _p, _p],  # n, ok, lam, stream
    "nxfx_mf_factor": [
        _i, _p, _p, _i, _i,  # G, host group table, consume table, n_core, P0
        _p, _p, _p,  # init_slot, w_pairs, dc
        _p, _p, _p, _p, _p,  # nodes_all, cval_all, ccol_all, cidx_all, lminv_all
        _p, _p, _p, _p, _p,  # vals, fac, pools, ok, stream
    ],
    "nxfx_mf_sweep": [
        _i, _p, _p, _i, _i,  # G, host group table, consume table, n_core, lam_len
        _p, _p, _p, _p, _p, _p,  # rc, nodes_all, bndpos_all, cidx_all, lminv_all, lam_pos
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
        _p, _p, _i, _p, _p,  # S (or null), C, split, work (or null), stream
    ],
    "nxfx_dct_scale": [
        _i, _i, _i, _i,  # s, ny, r, B
        _p, _i, _i, _d,  # w, rep_x, rep_y, len_x
        _p, _p, _p,  # lamx, lamy, g_geo
        _p, _p, _p,  # inv, g, stream
    ],
    "nxfx_dct_minv": [
        _i, _i, _i, _p,  # r, n_stub, B, w
        _p, _p, _p,  # stub_edge, stub_group, stub_rows
        _p, _p, _p,  # g, Minv, stream
    ],
    "nxfx_dct_border": [
        _i, _i, _p, _p, _p, _p,  # B, r, b, z, rows, Minv
        _p, _p, _p,  # partial, sol, stream
    ],
    "nxfx_dct_correct": [_i, _i, _p, _p, _p, _p, _p, _p],  # B, r, z, g, sol, lam_in, out, stream
    "nxfx_dct_matrix": [_i, _d, _d, _p, _p],  # n, scale, scale0, D, stream
    "nxfx_grid_assemble": [
        _i, _i, _i,  # nx, ny, n_stub
        _p, _p, _p, _p, _p,  # w, const, Ftot, stub_rows, stub_s_bif
        _p, _p, _p, _p, _p,  # rhs, diag, partial, rhs_norm, stream
    ],
    "nxfx_grid_residual": [
        _i, _i, _p, _p, _p, _p,  # nx, ny, w, diag, lam, rhs
        _p, _p, _p, _p,  # res, partial (or null), norm (or null), stream
    ],
    "nxfx_shift_matvec": [
        _i, _i, _p,  # B, C, host offsets
        _p, _p, _i, _p, _p, _i,  # cw, diag, its stride, x, b (or null), its stride
        _p, _p, _p, _p,  # out, partial (or null), norm (or null), stream
    ],
    "nxfx_shift_cheb": [
        _i, _i, _p,  # B, C, host offsets
        _p, _p, _p, _p, _p, _p, _p,  # cw, diag, s, rs, dvec, x_in, x_out
        _d, _d, _p, _p, _p,  # c1, c2, z (or null), base (or null), stream
    ],
    "nxfx_krylov_cg_start": [_i, _p, _p, _p, _p, _p, _d, _d, _d, _p],  # n, b, r, z, part, st, rtol, atol, maxiter
    "nxfx_krylov_cg_update_x": [_i, _p, _p, _p, _p, _p, _p, _p],  # n, p, Ap, x, r, part, st, stream
    "nxfx_krylov_cg_update_p": [_i, _p, _p, _p, _p, _p, _p],  # n, r, z, p, part, st, stream
    "nxfx_krylov_cheb_start": [_i, _p, _p, _d, _p, _p, _p, _p, _p, _p],  # n, s, r, theta, rs, dvec, x, z, base
    "nxfx_krylov_jacobi": [_i, _p, _p, _p, _p],  # n, v, diag, z, stream
    "nxfx_krylov_inv_sqrt": [_i, _p, _p, _p],  # n, d, s, stream
    "nxfx_gather_apply": [
        _i, _i, _p, _p, _p, _p,  # B, K, edge table, neighbour table, w, diag
        _p, _p, _p, _p, _p, _p,  # x, b (or null), out, partial (or null), norm (or null), stream
    ],
    "nxfx_gather_cheb": [
        _i, _i, _p, _p, _p, _p,  # B, K, edge table, neighbour table, w, diag
        _p, _p, _p, _p, _p,  # s, rs, dvec, x_in, x_out
        _d, _d, _p, _p, _p,  # c1, c2, z (or null), base (or null), stream
    ],
    "nxfx_mg2d_level0": [_i, _p, _i, _i, _i, _i, _p, _p, _p],  # m, cw, E W S N classes, diag0, lev
    "nxfx_mg2d_coarsen": [_i, _i, _p, _i, _i, _p, _p],  # nyf, nxf, fine, nyc, nxc, coarse, stream
    "nxfx_mg2d_stencil": [_i, _i, _p, _p, _p, _p, _p],  # ny, nx, lev, x, b (or null), out, stream
    "nxfx_mg2d_cheb": [
        _i, _i, _p, _p, _p, _p, _p,  # ny, nx, lev, rs, dvec, x_in, x_out
        _d, _d, _p, _p, _p,  # c1, c2, z (or null), base (or null), stream
    ],
    "nxfx_mg2d_restrict": [_i, _i, _p, _i, _i, _p, _p],  # nyf, nxf, res, nyc, nxc, rc, stream
    "nxfx_mg2d_prolong": [_i, _i, _p, _i, _p, _d, _p],  # nyf, nxf, x, nxc, ec, overcorrect, stream
    "nxfx_mg_coarse_factor": [_i, _i, _p, _p, _p, _p, _p],  # m, C, host offsets, cw, diag, A, stream
    "nxfx_mg_coarse_solve": [_i, _p, _p, _p, _p, _p, _p],  # m, A, r, v, y, x, stream
    "nxfx_mg1d_level0": [_i, _i, _p, _p, _p, _p, _p],  # m, C, cw, diag, extra, dis, stream
    "nxfx_mg1d_coarsen": [
        _i, _i, _p, _p, _i,  # m, mc, cw_f, extra_f, Cc
        _p, _p, _p,  # map_ptr, map_ci, map_p
        _p, _p, _p, _p, _p,  # cw_c, extra_c, diag_c, dis_c, stream
    ],
    "nxfx_mg1d_restrict": [_i, _i, _p, _p, _p],  # m, mc, res, rc, stream
    "nxfx_mg1d_prolong": [_i, _p, _p, _d, _p],  # m, x, ec, overcorrect, stream
    "nxfx_krylov_minres_start": [
        _i, _p, _p, _p, _p, _p, _p, _d, _d, _d, _p,  # n, b, r, y, v, part, ms, rtol, atol, maxiter
    ],
    "nxfx_krylov_minres_alpha": [_i, _p, _p, _p, _p, _p, _p, _p],  # n, v, yv, r1, r2, part, ms
    "nxfx_krylov_minres_update": [_i, _p, _p, _p, _p, _p, _p, _p, _p, _p],  # n, yv, y, v, w, w2, x, part, ms
    "nxfx_csr_fold": [_l, _i, _l, _p, _p, _p, _p, _p],  # nnz, max_dup, nraw, perm, idx, vals, data
    "nxfx_csr_spmv": [_i, _p, _p, _p, _p, _p, _p, _p],  # n, indptr, indices, data, v, signs, out
    "nxfx_csr_rows": [_i, _i, _p, _p, _p, _p, _p, _p],  # n, mode, indptr, indices, data, adiag, out
    "nxfx_schur_p_factor": [_i, _i, _i, _p, _p, _p, _p, _p],  # E, N, k, cell masses, base, Lb, adiag
    "nxfx_schur_p_solve": [_i, _i, _i, _p, _p, _p, _p, _p, _p],  # E, N, k, Lb, base, v, Y, out
    "nxfx_lu_factor": [_i, _p, _p, _p],  # n, A, piv, stream
    "nxfx_lu_solve": [_i, _p, _p, _p, _p, _p],  # n, LU, piv, b, x, stream
    "nxfx_trsv": [_i, _p, _i, _i, _i, _p, _p],  # n, A, lower, trans, unit, x, stream
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


def require_coefficients(name: str, N: int, E: int, *coeffs: tuple) -> None:
    """Validate ``(label, tensor, mode)`` coefficients: ``scalar`` is (1,),
    ``edge`` (E,) and ``cell`` the j-major (N, E) block."""
    expect = {"scalar": (1,), "edge": (E,), "cell": (N, E)}
    for label, t, mode in coeffs:
        if mode not in expect or tuple(t.shape) != expect[mode]:
            raise ValueError(f"{name}: {label} of mode {mode!r} has shape {tuple(t.shape)}")
