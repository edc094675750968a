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

__all__ = ["library", "check", "require_cuda", "require_coefficients", "stream_handle", "BUILD_ROOT"]

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).parent / "_build"
CUDA_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a")

_p, _i, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
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
}


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(CUDA_FLAGS).encode())
    for src in sources():
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


def check(code: int, name: str) -> None:
    """Raise when a launcher reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor, dtype=torch.float64) -> None:
    """Validate what a kernel takes: CUDA, one device, ``dtype``, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def require_coefficients(name: str, N: int, E: int, *coeffs: tuple) -> None:
    """Validate ``(label, tensor, mode)`` coefficients: ``scalar`` is (1,),
    ``edge`` (E,) and ``cell`` the j-major (N, E) block."""
    expect = {"scalar": (1,), "edge": (E,), "cell": (N, E)}
    for label, t, mode in coeffs:
        if mode not in expect or tuple(t.shape) != expect[mode]:
            raise ValueError(f"{name}: {label} of mode {mode!r} has shape {tuple(t.shape)}")
