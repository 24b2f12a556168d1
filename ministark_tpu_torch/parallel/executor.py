"""The sharded hot phases of the prover (mirrors
``ministark_tpu.parallel.executor``).

The prover hands a ``ShardedExecutor`` the phases it can run sharded, and
only when the trees hash with SHA-256 (``prover.default_prove``,
``fri.FriProver``):

* **LDE + commit**: each rank takes its block of the (zero-padded)
  columns through the iNTT and the coset NTT (``ntt.Domain``: kernels B
  and C) with no communication.  One all_to_all gives rank r the rows
  j = r (mod d) of the natural-order LDE, and it hashes them (kernel D)
  and builds its subtree.  In the tree-bitrev storage of ``merkle`` (each
  level merges its two contiguous halves) the subtree under storage node
  r of the d-wide level holds exactly the storage rows j = r (mod d) of
  every level below, so the full level is the ranks' levels interleaved,
  full[r + i d] = local_r[i], and the tip is built from the d subtree
  roots.
* **FRI layer commit**: leaf p of a layer's storage is the row
  (evals[bitrev_N(t) M + p])_t, M = n / N leaves, so rank r commits the
  evaluations j = r (mod d): a strided slice of the replicated DEEP
  vector, or one all_to_all of a contiguous block.
* **FRI fold**: the distributed six-step (``parallel.ntt``) on contiguous
  blocks, three all_to_alls of n / d elements each way; the chunks of N
  coefficients are whole in each block.

For now the executor hands the prover whole tensors on every rank: the
LDE by an all_gather of the column blocks, a tree whose levels are the
gathered and interleaved subtree levels plus the replicated tip, each FRI
layer's rows gathered for the decommit, and the last fold's coefficients
gathered for the remainder.  The phases it does not run (constraint
evaluation, the composition commit, DEEP, the grind, the decommit) run
unchanged on every rank.
"""

from __future__ import annotations

import torch

from .. import merkle
from ..fri import fold_chunks
from ..matrix import Matrix, MatrixExt3
from ..ntt import permute_bitrev
from ..ops import ntt as kntt
from ..ops import sha256 as ksha
from .ntt import ShardedDomain
from .sharded import Mesh, shard_columns


class ShardedExecutor:
    """The sharded phases on one rank of `mesh`."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.d = mesh.d
        self._domains: dict = {}

    # -- support predicates (executor.py:104-117 of the JAX package) --------

    def commit_supported(self, lde_n: int) -> bool:
        return lde_n % self.d == 0 and lde_n // self.d >= 1

    def fri_commit_supported(self, n: int, N: int) -> bool:
        d = self.d
        return n % (d * d) == 0 and (n // d) % N == 0

    def fri_fold_supported(self, n: int, N: int) -> bool:
        d = self.d
        return (n % (d * d) == 0 and (n // N) % (d * d) == 0
                and (n // d) % N == 0)

    # -- helpers -------------------------------------------------------------

    def _domain(self, n: int) -> ShardedDomain:
        if n not in self._domains:
            self._domains[n] = ShardedDomain(self.mesh, n)
        return self._domains[n]

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """Contiguous (..., k) blocks -> the replicated (..., d k) vector."""
        g = self.mesh.all_gather(local)  # (d, ..., k)
        return g.movedim(0, -2).reshape(*local.shape[:-1], -1)

    def _block(self, evals: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's contiguous block of a replicated (..., n) vector."""
        m = n // self.d
        return evals[..., self.mesh.rank * m:(self.mesh.rank + 1) * m]

    def _strided(self, evals: torch.Tensor, n: int,
                 local: bool) -> torch.Tensor:
        """The evaluations j = rank (mod d), (..., n / d): a slice of the
        replicated vector, or one all_to_all of contiguous blocks."""
        d = self.d
        if not local:
            return evals[..., self.mesh.rank::d].contiguous()
        m = n // d
        t = evals.reshape(-1, m // d, d).permute(2, 0, 1)  # [dst, b, j']
        t = self.mesh.all_to_all(t)  # [src block, b, j'] -> q = src m/d + j'
        return t.transpose(0, 1).reshape(*evals.shape[:-1], m)

    def _tree(self, digests: torch.Tensor) -> merkle.CommittedMerkleTree:
        """The whole tree from this rank's leaf digests in local storage
        order (storage rows rank + i d): one all_gather of every local
        level, interleaved, and the tip over the d subtree roots."""
        local = merkle.tree_levels(digests, merkle.H)
        sizes = [int(lv.shape[0]) for lv in local]
        g = self.mesh.all_gather(torch.cat(local))  # (d, 2m - 1, 32)
        levels, start = [], 0
        for s in sizes:
            levels.append(g[:, start:start + s].transpose(0, 1)
                          .reshape(s * self.d, 32))
            start += s
        levels += merkle.tree_levels(levels[-1], merkle.H)[1:]
        return merkle.CommittedMerkleTree(levels, merkle.H)

    # -- LDE + commit --------------------------------------------------------

    def lde_commit(self, values: torch.Tensor, trace_dom, lde_dom):
        """iNTT + coset LDE + Merkle commit of a replicated (ncols, n) Fp or
        (ncols, 3, n) Fq3 trace matrix: (the natural-order LDE on every
        rank, the tree)."""
        d, ncols, n = self.d, values.shape[0], lde_dom.size
        mine = shard_columns(self.mesh, values)
        lde = lde_dom.fft(trace_dom.ifft(mine))  # (cpd, [3,] n)
        cpd, m = mine.shape[0], n // d
        # rows j = rank (mod d): [dst, c, k, i] of row j = i d + dst
        rows = self.mesh.all_to_all(
            lde.reshape(cpd, -1, m, d).permute(3, 0, 1, 2))
        rows = rows.reshape(d * cpd, -1, m)[:ncols]  # (ncols, 1 or 3, m)
        if values.ndim == 3:
            digests = ksha.hash_rows_ext3(rows.contiguous())
        else:
            digests = ksha.hash_rows(rows.reshape(ncols, m).T)
        tree = self._tree(digests)
        full = self.mesh.all_gather(lde).reshape(d * cpd, *lde.shape[1:])
        return full[:ncols], tree

    def lde_commit_fp(self, matrix: Matrix, trace_dom, lde_dom):
        lde, tree = self.lde_commit(matrix.values, trace_dom, lde_dom)
        return Matrix(lde), tree

    def lde_commit_ext3(self, matrix: MatrixExt3, trace_dom, lde_dom):
        lde, tree = self.lde_commit(matrix.values, trace_dom, lde_dom)
        return MatrixExt3(lde), tree

    # -- FRI -----------------------------------------------------------------

    def fri_commit_layer(self, evals: torch.Tensor, n: int, N: int,
                         local: bool = False):
        """A layer's tree and its rows in leaf order, as
        ``fri.FriProver._commit_layer`` gives them, from the replicated
        (n,) / (3, n) evaluations or (local=True) this rank's contiguous
        block of them."""
        d, M = self.d, n // N
        x = self._strided(evals, n, local)
        br = kntt.bitrev_index(N, x.device)
        if x.ndim == 1:  # [i, t] = x[bitrev_N(t) M/d + i]
            rows = x.reshape(N, M // d).index_select(0, br).T.contiguous()
            digests = ksha.hash_rows(rows)
            full = self.mesh.all_gather(rows).transpose(0, 1).reshape(M, N)
            full = permute_bitrev(full, dim=0)
        else:  # (N, 3, M/d): element t of the rows, Fq3 components
            rows = (x.reshape(3, N, M // d).index_select(1, br)
                    .permute(1, 0, 2).contiguous())
            digests = ksha.hash_rows_ext3(rows)
            full = self.mesh.all_gather(rows).permute(1, 2, 3, 0)
            full = permute_bitrev(full.reshape(N, 3, M), dim=2)
        return self._tree(digests), full

    def fri_fold(self, evals: torch.Tensor, n: int, N: int,
                 powers: torch.Tensor, local: bool = False,
                 last: bool = False) -> torch.Tensor:
        """One fold (``fri.fold_coeffs`` with ``fri.alpha_powers``' powers)
        of the replicated evaluations or (local=True) this rank's block:
        this rank's block of the folded evaluations, or (last=True) the
        folded coefficients, gathered."""
        x = evals if local else self._block(evals, n)
        acc = fold_chunks(self._domain(n).ifft(x), N, powers)
        if last:
            return self.gather(acc)
        return self._domain(n // N).fft(acc)
