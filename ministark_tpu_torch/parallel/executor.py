"""The sharded phases of the prover (mirrors
``ministark_tpu.parallel.executor``).

The prover hands a ``ShardedExecutor`` the phases it can run sharded where
the support predicates hold (``prover.default_prove``, ``fri.FriProver``),
whatever the tree hash: the executor hashes rows and merges nodes with the
Stark's ``merkle_hash`` (``merkle.device_hash``: SHA-256, kernel D, or
RPO-256, kernel G).  A rank then holds its 1/d share of every LDE-sized
tensor from the base commit to the decommit:

* **LDE + commit**: each rank takes its block of the (zero-padded)
  columns through the iNTT and the coset NTT (``ntt.Domain``: kernels B
  and C) with no communication.  One all_to_all a column gives rank r the
  rows j = r (mod d) of the natural-order LDE (the cyclic layout, a
  ``ShardedMatrix``), and it hashes them (kernel D or G) and builds its
  subtree.  In the tree-bitrev storage of ``merkle`` the subtree under
  storage node r of the d-wide level holds exactly the storage rows j = r
  (mod d) of every level below, so the rank keeps it and the tip is built
  from the d gathered subtree roots (``ShardedMerkleTree``).
* **CE values**: before that exchange each rank strides its column block
  down to the CE domain (CE point j is LDE row j r, r = lde_n / ce_n) and
  one more all_to_all a column hands rank q the contiguous block of CE
  points [q m, (q + 1) m); one all_gather of every block's first points
  gives each rank the halo of ``eval.trace_halo`` points after its block
  (the last block's wraps to the first): constraint evaluation reads
  neighbours, so it runs on blocks (kernel E's block entry).
* **Composition commit**: the ranks' blocks of the composition are
  gathered (the one CE-sized vector a rank holds whole), interpolated,
  and its cb interleaved coefficient columns committed as the trace is.
* **DEEP**: pointwise on the cyclic rows (``ShardedDeepPolyComposer``):
  the OOD sums' partials of every rank gathered and added in the field,
  the DEEP vector left cyclic.
* **FRI layer commit**: leaf p of a layer's storage is the row
  (evals[bitrev_N(t) M + p])_t, M = n / N leaves, so rank r commits the
  evaluations j = r (mod d) with no communication where they are cyclic
  (the first layer, from DEEP), after one all_to_all where they are a
  contiguous block (after a fold), or by a strided slice of a whole
  vector; it keeps its rows (``ShardedLayerRows``).
* **FRI fold**: the distributed six-step (``parallel.ntt``) on contiguous
  blocks, three all_to_alls of n / d elements each way (a cyclic layer is
  made contiguous by one more); the chunks of N coefficients are whole in
  each block.  The last fold's coefficients are gathered for the
  remainder.
* **Decommit**: queried rows and tree nodes come from their owners, one
  gather a tree and one a matrix.

Layouts of an (n,) / (3, n) vector: "whole" (every rank holds it),
"block" (rank r holds [r n / d, (r + 1) n / d)), "cyclic" (rank r holds
j = r (mod d), local index j // d).
"""

from __future__ import annotations

import torch

from .. import merkle
from ..eval import trace_halo
from ..fields import device as fd
from ..fields.scalar import P
from ..fri import fold_chunks
from ..ntt import _cached, powers
from ..ops import ntt as kntt
from .matrix import ShardedLayerRows, ShardedMatrix
from .ntt import ShardedDomain
from .sharded import Mesh, shard_columns
from .tree import ShardedMerkleTree

WHOLE, BLOCK, CYCLIC = "whole", "block", "cyclic"


class ShardedExecutor:
    """The sharded phases on one rank of `mesh`, its trees hashing with
    `hashfn` (the host hash module, ``hash`` or ``hash_rpo``)."""

    def __init__(self, mesh: Mesh, hashfn=merkle.H):
        self.mesh = mesh
        self.d = mesh.d
        self.hashfn = hashfn
        self._dh = merkle.device_hash(hashfn)
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

    def phases_supported(self, air) -> bool:
        """Whether the prove's phases from the commits to the decommit run
        sharded: the LDE splits into d cyclic shares, the CE domain into d
        blocks, and no constraint reads a row before its own or past the
        next block's start (a block's halo comes from the next rank)."""
        ce_n, halo = air.ce_domain().size, trace_halo(air)
        return (self.commit_supported(air.lde_domain().size)
                and ce_n % self.d == 0 and halo is not None
                and halo <= ce_n // self.d)

    # -- layouts -------------------------------------------------------------

    def _domain(self, n: int) -> ShardedDomain:
        if n not in self._domains:
            self._domains[n] = ShardedDomain(self.mesh, n)
        return self._domains[n]

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """Contiguous (..., k) blocks -> the replicated (..., d k) vector."""
        g = self.mesh.all_gather(local)  # (d, ..., k)
        return g.movedim(0, -2).reshape(*local.shape[:-1], -1)

    def whole(self, evals: torch.Tensor, layout: str) -> torch.Tensor:
        """The replicated vector from any layout (one all_gather)."""
        if layout == WHOLE:
            return evals
        if layout == BLOCK:
            return self.gather(evals)
        g = self.mesh.all_gather(evals)  # (d, ..., k): [r, i] = j = i d + r
        return g.movedim(0, -1).reshape(*evals.shape[:-1], -1)

    def _block(self, evals: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's contiguous block of a replicated (..., n) vector."""
        m = n // self.d
        return evals[..., self.mesh.rank * m:(self.mesh.rank + 1) * m]

    def _cyclic(self, evals: torch.Tensor, n: int,
                layout: str) -> torch.Tensor:
        """The evaluations j = rank (mod d), (..., n / d): as they are, a
        slice of the replicated vector, or one all_to_all of contiguous
        blocks."""
        d = self.d
        if layout == CYCLIC:
            return evals
        if layout == WHOLE:
            return evals[..., self.mesh.rank::d].contiguous()
        m = n // d
        t = evals.reshape(-1, m // d, d).permute(2, 0, 1)  # [dst, b, j']
        t = self.mesh.all_to_all(t)  # [src block, b, j'] -> q = src m/d + j'
        return t.transpose(0, 1).reshape(*evals.shape[:-1], m)

    def _to_block(self, evals: torch.Tensor, n: int) -> torch.Tensor:
        """Cyclic (..., n / d) -> this rank's contiguous block: one
        all_to_all (``_cyclic``'s reversed).  Rank r's local k = q m / d +
        k' is element q m + k' d + r of block q."""
        d, m = self.d, n // self.d
        t = evals.reshape(-1, d, m // d).transpose(0, 1)  # [dst q, b, k']
        t = self.mesh.all_to_all(t)  # [src r, b, k']
        return t.permute(1, 2, 0).reshape(*evals.shape[:-1], m)

    def _tree(self, digests: torch.Tensor) -> ShardedMerkleTree:
        """The sharded tree of this rank's leaf digests in local storage
        order (storage rows rank + i d)."""
        return ShardedMerkleTree(
            self.mesh, merkle.tree_levels(digests, self.hashfn), self.hashfn)

    # -- LDE + commit --------------------------------------------------------

    def _commit(self, lde: torch.Tensor, ncols: int, ce: tuple | None):
        """Commit this rank's (cpd, [3,] n) column block of an LDE (the
        columns past ncols zero padding): (ShardedMatrix, tree).  With ce =
        (r, ce_n, halo) the rank's CE block comes along (see the module
        docstring)."""
        d, cpd, n = self.d, lde.shape[0], lde.shape[-1]
        m, planes = n // d, (3 if lde.ndim == 3 else 1)
        ce_block = None
        if ce is not None:
            r, ce_n, halo = ce
            mc = ce_n // d
            ce_block = torch.empty((d, cpd, planes, mc), dtype=lde.dtype,
                                   device=lde.device)
            for c in range(cpd):  # [dst, p, point] -> [src, p, point]
                col = lde[c].reshape(planes, n)[:, ::r]
                ce_block[:, c] = self.mesh.all_to_all(
                    col.reshape(planes, d, mc).transpose(0, 1))
            # column src cpd + c; the halo: the next rank's first points
            ce_block = ce_block.reshape(d * cpd, planes, mc)[:ncols]
            if halo:
                heads = self.mesh.all_gather(ce_block[..., :halo])
                ce_block = torch.cat(
                    [ce_block, heads[(self.mesh.rank + 1) % d]], -1)
        # rows j = rank (mod d): [dst, p, i] of row j = i d + dst
        rows = torch.empty((d, cpd, planes, m), dtype=lde.dtype,
                           device=lde.device)
        for c in range(cpd):
            rows[:, c] = self.mesh.all_to_all(
                lde[c].reshape(planes, m, d).permute(2, 0, 1))
        del lde
        rows = rows.reshape(d * cpd, planes, m)[:ncols]
        if planes == 3:
            digests = self._dh.hash_rows_ext3(rows)
        else:
            rows = rows.reshape(ncols, m)
            digests = self._dh.hash_rows(rows.T)
            if ce_block is not None:
                ce_block = ce_block.reshape(ncols, -1)
        return ShardedMatrix(self.mesh, rows, ce_block), self._tree(digests)

    def lde_commit(self, values: torch.Tensor, trace_dom, lde_dom,
                   ce_dom=None, halo: int = 0):
        """iNTT + coset LDE + Merkle commit of a replicated (ncols, n) Fp or
        (ncols, 3, n) Fq3 trace matrix: (this rank's ShardedMatrix, the
        ShardedMerkleTree).  Given the CE domain, the matrix carries the
        rank's block of the CE values with `halo` points after it."""
        lde = lde_dom.fft(trace_dom.ifft(shard_columns(self.mesh, values)))
        ce = (None if ce_dom is None else
              (lde_dom.size // ce_dom.size, ce_dom.size, halo))
        return self._commit(lde, values.shape[0], ce)

    def commit_coeffs(self, coeffs: torch.Tensor, lde_dom):
        """The coset LDE + commit of replicated (ncols, [3,] k <= n)
        coefficient columns (the composition's): (ShardedMatrix, tree)."""
        return self._commit(lde_dom.fft(shard_columns(self.mesh, coeffs)),
                            coeffs.shape[0], None)

    def ce_points(self, ce_dom, device) -> torch.Tensor:
        """This rank's block of the CE domain's points, (ce_n / d,)."""
        m = ce_dom.size // self.d
        return domain_points(ce_dom, self.mesh.rank * m, 1, m, device)[0]

    # -- FRI -----------------------------------------------------------------

    def fri_commit_layer(self, evals: torch.Tensor, n: int, N: int,
                         layout: str = WHOLE):
        """A layer's tree and this rank's rows (``ShardedLayerRows``), as
        ``fri.FriProver._commit_layer`` gives them whole, from the (n,) /
        (3, n) evaluations in `layout`."""
        d, M = self.d, n // N
        x = self._cyclic(evals, n, layout)
        br = kntt.bitrev_index(N, x.device)
        if x.ndim == 1:  # [i, t] = x[bitrev_N(t) M/d + i]
            rows = x.reshape(N, M // d).index_select(0, br).T.contiguous()
            digests = self._dh.hash_rows(rows)
        else:  # (N, 3, M/d): element t of the rows, Fq3 components
            rows = (x.reshape(3, N, M // d).index_select(1, br)
                    .permute(1, 0, 2).contiguous())
            digests = self._dh.hash_rows_ext3(rows)
        return self._tree(digests), ShardedLayerRows(self.mesh, rows)

    def fri_fold(self, evals: torch.Tensor, n: int, N: int,
                 powers: torch.Tensor, layout: str = WHOLE,
                 last: bool = False) -> torch.Tensor:
        """One fold (``fri.fold_coeffs`` with ``fri.alpha_powers``' powers)
        of the evaluations in `layout`: this rank's block of the folded
        evaluations, or (last=True) the folded coefficients, gathered."""
        if layout == WHOLE:
            x = self._block(evals, n)
        elif layout == CYCLIC:
            x = self._to_block(evals, n)
        else:
            x = evals
        acc = fold_chunks(self._domain(n).ifft(x), N, powers)
        if last:
            return self.gather(acc)
        return self._domain(n // N).fft(acc)


def domain_points(dom, start: int, stride: int, count: int,
                  device) -> tuple:
    """(offset g^j, g^j) for j = start + i stride, i < count, of the
    (coset) domain `dom` (cached, as ``ntt.Domain.elements`` is)."""
    def build():
        g = dom.group_gen
        gpow = fd.mul(powers(pow(g, stride, P), count, device),
                      pow(g, start, P))
        return fd.mul(gpow, dom.offset), gpow
    return _cached(("points", dom.size, dom.offset, start, stride, count,
                    str(device)), build)
