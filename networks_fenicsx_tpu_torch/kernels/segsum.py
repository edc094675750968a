"""K6: exact sorted-segment sums (``csrc/segsum.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_segsum_sorted`` (``:2058-2128``):
``out[s, c] = Σ_j vals[idx[s, j], c]`` over a host-built ``(S, K)`` gather
matrix (:func:`..levels.segsum_matrix`) whose padding names the zero slot
``n = vals.shape[0]``.  ``vals`` is ``(n,)`` or ``(n, C)`` float64.

:func:`segsum` launches the kernel for CUDA tensors and runs
:func:`segsum_plain` — the reference's padded gather and row sum, in eager
PyTorch — for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["segsum", "segsum_plain"]


def segsum_plain(idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Eager version: ``cat([vals, 0])[idx]`` summed over the K columns in
    ascending order, shape ``(S,) + vals.shape[1:]``.

    The columns are added one by one rather than by ``torch.sum``, whose
    order is the backend's: the sum is then the kernel's to the last bit,
    and a deep elimination downstream cannot amplify a rounding difference
    between the two."""
    pad = torch.zeros((1,) + tuple(vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    vp = torch.cat([vals, pad])
    idx = idx.long()
    if idx.shape[1] == 0:
        return torch.zeros((idx.shape[0],) + tuple(vals.shape[1:]), dtype=vals.dtype,
                           device=vals.device)
    out = vp[idx[:, 0]]
    for j in range(1, idx.shape[1]):
        out = out + vp[idx[:, j]]
    return out


def segsum(idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """K6 on ``vals``' device: ``(S,) + vals.shape[1:]`` segment sums."""
    if vals.device.type == "cpu":
        return segsum_plain(idx, vals)
    build.require_cuda("segsum", vals)
    build.require_cuda("segsum", idx, dtype=torch.int32)
    if vals.dim() not in (1, 2) or idx.dim() != 2:
        raise ValueError("segsum: vals must be (n,) or (n, C) and idx (S, K)")
    S, K = idx.shape
    n = vals.shape[0]
    C = 1 if vals.dim() == 1 else vals.shape[1]
    out = torch.empty((S,) + tuple(vals.shape[1:]), dtype=torch.float64, device=vals.device)
    if out.numel() == 0:
        return out  # nothing to launch
    with torch.cuda.device(vals.device):
        code = build.library().nxfx_segsum(
            S, K, C, n, idx.data_ptr(), vals.data_ptr(), out.data_ptr(),
            build.stream_handle(vals.device),
        )
    build.check(code, "segsum")
    segsum.launches += 1
    return out


segsum.launches = 0
