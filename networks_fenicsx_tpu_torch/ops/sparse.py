"""CSR matrix with static sparsity.

Counterpart of ``networks_fenicsx_tpu/ops/sparse.py``: the structure
(``indptr``, ``indices``) stays on the host, fixed per mesh and degree;
``data`` lives on the device.  The products run on K20b
(:mod:`..kernels.csr`), whose device copies of the structure are made once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import csr as K20

__all__ = ["CSRMatrix"]


@dataclasses.dataclass
class CSRMatrix:
    data: torch.Tensor  # (nnz,) float64, on the device
    indices: np.ndarray  # (nnz,) column ids (host, static)
    indptr: np.ndarray  # (nrows+1,) (host, static)
    shape: tuple[int, int]

    def __post_init__(self) -> None:
        dev = self.data.device
        self._indptr = torch.as_tensor(np.asarray(self.indptr, dtype=np.int64), device=dev)
        self._indices = torch.as_tensor(np.asarray(self.indices, dtype=np.int32), device=dev)

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def device_arrays(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(indptr int64, indices int32, data)`` on the data's device."""
        return self._indptr, self._indices, self.data

    def __matmul__(self, v: torch.Tensor) -> torch.Tensor:
        return K20.csr_spmv(*self.device_arrays, v)

    def row_ids(self) -> torch.Tensor:
        return K20.row_ids(self._indptr)

    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.data.dtype, device=self.data.device)
        out[self.row_ids(), self._indices.long()] = self.data
        return out

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.data.cpu().numpy(), np.asarray(self.indices), np.asarray(self.indptr)),
            shape=self.shape,
        )
