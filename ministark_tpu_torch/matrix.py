"""Column-major trace matrices on torch tensors (reference: src/matrix.rs).

A ``Matrix`` holds every column stacked as one (ncols, n) int64 tensor, in
natural domain order; bit-reversed order appears only at commitment and
query time, as in ``ministark_tpu.matrix``.
"""

from __future__ import annotations

import numpy as np
import torch

from .fields import device as fd
from .fields.scalar import Fp
from .ntt import Domain, bit_reverse_index


class Matrix:
    """Fp matrix: values (ncols, n) int64."""

    def __init__(self, values: torch.Tensor):
        assert values.ndim == 2 and values.dtype == torch.int64
        self.values = values

    @staticmethod
    def from_columns_np(columns, device="cpu") -> "Matrix":
        """columns: (ncols, n) array-like of canonical u64 values."""
        arr = np.ascontiguousarray(np.asarray(columns, dtype=np.uint64))
        return Matrix(torch.from_numpy(arr.view(np.int64).copy()).to(device))

    @property
    def num_cols(self) -> int:
        return self.values.shape[0]

    @property
    def num_rows(self) -> int:
        return self.values.shape[1]

    @property
    def device(self):
        return self.values.device

    def interpolate(self, domain: Domain) -> "Matrix":
        """Evaluations over `domain` -> coefficients (per-column iNTT)."""
        return Matrix(domain.ifft(self.values))

    def evaluate(self, domain: Domain) -> "Matrix":
        """Coefficients -> evaluations over `domain`, natural order."""
        return Matrix(domain.fft(self.values))

    def get_bit_reversed_rows(self, positions: list[int]) -> list[list[Fp]]:
        """Rows at bit-reversed `positions`: one gather, one transfer."""
        n = self.num_rows
        idx = torch.tensor([bit_reverse_index(n, p) for p in positions],
                           dtype=torch.int64, device=self.device)
        block = self.values.index_select(1, idx).T.cpu()
        return [[Fp(v) for v in fd.to_ints(row)] for row in block]
