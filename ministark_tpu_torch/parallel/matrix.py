"""A rank's share of an LDE matrix and of a FRI layer's rows.

Rank r holds the rows j = r (mod d) of a natural-order LDE (the cyclic
layout the commit's all_to_all hands it, ``parallel.executor``) and the
leaves s = r (mod d), in tree-bitrev storage, of a FRI layer.  Queried
rows come from their owners in one gather (``tree.fetch``).
"""

from __future__ import annotations

import torch

from ..fields import device as fd
from ..fields.scalar import Fp
from ..ntt import bit_reverse_index
from .sharded import Mesh
from .tree import fetch


class ShardedMatrix:
    """This rank's rows j = rank (mod d) of an (ncols, n) Fp or (ncols, 3,
    n) Fq3 natural-order matrix: values (ncols, n / d) or (ncols, 3, n /
    d), local row i the matrix's row rank + i d.  `ce`, where the commit
    made it, is the rank's block of the CE-domain values with the halo
    after it (``ShardedExecutor.lde_commit``), for constraint evaluation."""

    def __init__(self, mesh: Mesh, values: torch.Tensor,
                 ce: torch.Tensor | None = None):
        self.mesh = mesh
        self.values = values
        self.ce = ce

    @property
    def ext(self) -> bool:
        return self.values.ndim == 3

    def take_ce(self) -> torch.Tensor:
        """The CE block, handed over once (the matrix lets it go)."""
        ce, self.ce = self.ce, None
        return ce

    @property
    def num_cols(self) -> int:
        return self.values.shape[0]

    @property
    def num_rows(self) -> int:
        return self.values.shape[-1] * self.mesh.d

    @property
    def device(self):
        return self.values.device

    def get_bit_reversed_rows(self, positions: list[int]) -> list[list]:
        """Rows at bit-reversed `positions` (``Matrix``'s), from their
        owners in one gather."""
        n = self.num_rows
        rows = fetch(self.mesh, [(self.values, [bit_reverse_index(n, p)
                                                for p in positions])],
                     dim=self.values.ndim - 1).cpu()  # (q, ncols[, 3])
        if self.ext:
            return [fd.ext3_to_scalars(row.T) for row in rows]
        return [[Fp(v) for v in fd.to_ints(row)] for row in rows]


class ShardedLayerRows:
    """This rank's rows of a FRI layer of M leaves of N elements: the
    leaves s = rank (mod d) of tree-bitrev storage, (M / d, N) Fp or (N, 3,
    M / d) Fq3 (``ShardedExecutor.fri_commit_layer``); leaf p is storage
    bitrev_M(p)."""

    def __init__(self, mesh: Mesh, local: torch.Tensor):
        self.mesh = mesh
        self.local = local

    @property
    def num_leaves(self) -> int:
        return self.local.shape[0 if self.local.ndim == 2 else 2] * self.mesh.d

    def rows_at(self, positions: list[int]) -> list:
        """The rows at leaf `positions`, flattened (``fri._Layer``'s)."""
        M, ext = self.num_leaves, self.local.ndim == 3
        rows = fetch(self.mesh, [(self.local, [bit_reverse_index(M, p)
                                               for p in positions])],
                     dim=2 if ext else 0)  # (q, N) or (q, N, 3)
        if not ext:
            return [Fp(v) for v in fd.to_ints(rows)]
        return fd.ext3_to_scalars(rows.permute(2, 0, 1).reshape(3, -1))
