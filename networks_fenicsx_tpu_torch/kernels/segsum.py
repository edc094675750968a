"""K6: exact sorted-segment sums (``csrc/segsum.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_segsum_sorted`` (``:2058-2128``):
``out[s, c] = Σ_j vals[idx[s, j], c]`` over a host-built ``(S, K)`` gather
matrix (:func:`..levels.segsum_matrix`) whose padding names the zero slot
``n = vals.shape[0]``.  ``vals`` is ``(n,)`` or ``(n, C)`` float64.
Given ``bins`` (sorted, unique) and ``out``, the sums are added into rows
``out[bins[s]]`` instead, in place — the sorted-unique scatter-add of
``_lambda_system_sorted`` (``:700-737``).

:func:`segsum` launches the kernel for CUDA tensors and runs
:func:`segsum_plain` — the reference's padded gather and row sum, in eager
PyTorch — for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["segsum", "segsum_plain"]


def segsum_plain(
    idx: torch.Tensor, vals: torch.Tensor, bins: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Eager version: ``cat([vals, 0])[idx]`` summed over the K columns in
    ascending order, shape ``(S,) + vals.shape[1:]`` (with ``bins``: added
    into ``out[bins]``, which is returned).

    The columns are added one by one rather than by ``torch.sum``, whose
    order is the backend's: the sum is then the kernel's to the last bit,
    and a deep elimination downstream cannot amplify a rounding difference
    between the two."""
    pad = torch.zeros((1,) + tuple(vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    vp = torch.cat([vals, pad])
    idx = idx.long()
    if idx.shape[1] == 0:
        sums = torch.zeros((idx.shape[0],) + tuple(vals.shape[1:]), dtype=vals.dtype,
                           device=vals.device)
    else:
        sums = vp[idx[:, 0]]
        for j in range(1, idx.shape[1]):
            sums = sums + vp[idx[:, j]]
    if bins is None:
        return sums
    b = bins.long()
    out[b] = out[b] + sums
    return out


def segsum(
    idx: torch.Tensor, vals: torch.Tensor, bins: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """K6 on ``vals``' device: ``(S,) + vals.shape[1:]`` segment sums, or
    with ``bins`` (S,) the sums added into ``out[bins]`` in place."""
    if vals.device.type == "cpu":
        return segsum_plain(idx, vals, bins, out)
    build.require_cuda("segsum", vals)
    build.require_cuda("segsum", idx, dtype=torch.int32)
    if vals.dim() not in (1, 2) or idx.dim() != 2:
        raise ValueError("segsum: vals must be (n,) or (n, C) and idx (S, K)")
    S = idx.shape[0]
    if bins is None:
        out = torch.empty((S,) + tuple(vals.shape[1:]), dtype=torch.float64, device=vals.device)
    else:
        build.require_cuda("segsum", out)
        build.require_cuda("segsum", bins, dtype=torch.int32)
        if tuple(bins.shape) != (S,) or tuple(out.shape[1:]) != tuple(vals.shape[1:]):
            raise ValueError("segsum: bins must be (S,) and out (B,) + vals.shape[1:]")
    if launch(idx, vals, out, bins, "segsum"):
        segsum.launches += 1
    return out


segsum.launches = 0


def launch(idx, vals, out, bins=None, name: str = "segsum") -> bool:
    """One ``nxfx_segsum`` (or, with ``bins``, ``nxfx_segsum_into``) launch on
    validated CUDA tensors, uncounted; False when there was nothing to sum.
    :func:`segsum` and the sharded partials share it and count their own
    launches.  The lean path of K10: the stream handle without a Python
    ``Stream``, no device switch when ``vals`` is on the current device."""
    S, K = idx.shape
    C = 1 if vals.dim() == 1 else vals.shape[1]
    if S * C == 0:
        return False
    index = vals.get_device()
    if index == torch._C._cuda_getDevice():
        code = _launch(S, K, C, idx, vals, out, bins, index)
    else:
        with torch.cuda.device(index):
            code = _launch(S, K, C, idx, vals, out, bins, index)
    build.check(code, name)
    return True


def _launch(S, K, C, idx, vals, out, bins, index: int) -> int:
    lib, stream = build.library(), build.raw_stream(index)
    if bins is None:
        return lib.nxfx_segsum(S, K, C, vals.shape[0], idx.data_ptr(), vals.data_ptr(), out.data_ptr(),
                               stream)
    return lib.nxfx_segsum_into(S, K, C, vals.shape[0], idx.data_ptr(), vals.data_ptr(), bins.data_ptr(),
                                out.data_ptr(), stream)
