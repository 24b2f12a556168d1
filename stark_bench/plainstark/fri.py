"""FRI commit/fold/query over Fp codewords (fib) and Fq3 codewords
(brainfuck) (reference: src/fri.rs).

Protocol facts replicated exactly (they affect proof bytes):

* folding uses PLAIN (offset-1) domains regardless of the LDE coset;
* after each iNTT the coefficients are scaled by the folding factor N;
* evaluations are committed in bit-reversed order, chunked into rows of N;
* query positions live in bit-reversed space and fold as p -> p // N;
* the remainder is the iNTT of the last layer; coefficients above
  size/blowup must be zero and are not sent.

An Fq3 codeword is a (3, n) tensor; its layer rows of N elements
serialize each element as c0 || c1 || c2, so a layer is kept as an
(N, 3, n/N) Fq3 matrix and hashed as one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import merkle
from .fields import device as fd
from .fields.scalar import Fp
from .merkle import MerkleView
from .ntt import Domain, permute_bitrev
from .ops import sha256 as ksha


@dataclass(frozen=True)
class FriOptions:
    folding_factor: int
    max_remainder_coeffs: int
    blowup_factor: int

    def num_layers(self, domain_size: int) -> int:
        n, layers = domain_size, 0
        while n > self.max_remainder_coeffs * self.blowup_factor:
            n //= self.folding_factor
            layers += 1
        return layers


@dataclass
class LayerProof:
    flattened_rows: list  # Fq values (row-major, N per row)
    merkle_proof: MerkleView
    commitment: bytes

    def serialize(self, w, fq):
        w.field_vec(self.flattened_rows)
        self.merkle_proof.serialize(w)
        w.digest(self.commitment)

    @staticmethod
    def deserialize(r, fq) -> "LayerProof":
        rows = r.field_vec(fq)
        proof = MerkleView.deserialize(r)
        return LayerProof(rows, proof, r.digest())


@dataclass
class FriProof:
    layers: list  # [LayerProof]
    remainder_coeffs: list  # [Fq]

    def serialize(self, w, fq):
        w.vec(self.layers, lambda w2, l: l.serialize(w2, fq))
        w.field_vec(self.remainder_coeffs)

    @staticmethod
    def deserialize(r, fq) -> "FriProof":
        layers = r.vec(lambda r2: LayerProof.deserialize(r2, fq))
        return FriProof(layers, r.field_vec(fq))


class _Layer:
    """A committed layer: its Merkle tree and its rows, both on the device
    until decommit.  rows: (n/N, N) Fp values, or an (N, 3, n/N) Fq3
    matrix whose column j holds element j of every row."""

    def __init__(self, tree, rows: torch.Tensor):
        self.tree = tree
        self.rows = rows

    def rows_at(self, positions: list[int]) -> list:
        """The rows at `positions`, flattened (N values per row)."""
        idx = torch.tensor(positions, dtype=torch.int64,
                           device=self.rows.device)
        if self.rows.ndim == 2:
            return [Fp(v) for v in fd.to_ints(self.rows.index_select(0, idx))]
        block = self.rows.index_select(2, idx).permute(1, 2, 0)  # (3, q, N)
        return fd.ext3_to_scalars(block.reshape(3, -1))


class FriProver:
    """Builds FRI layers from the DEEP composition LDE, natural order: (n,)
    in Fp or (3, n) in Fq3, with the host coin between the layers."""

    def __init__(self, options: FriOptions):
        self.options = options
        self.layers: list[_Layer] = []
        self.remainder_coeffs: list = []

    def build_layers(self, channel, evals: torch.Tensor):
        """Commit every layer and the remainder."""
        assert not self.layers
        n = evals.shape[-1]
        N = self.options.folding_factor
        for _ in range(self.options.num_layers(n)):
            tree, rows = self._commit_layer(evals, n, N)
            channel.commit_fri_layer(tree.root())
            self.layers.append(_Layer(tree, rows))
            powers = alpha_powers(channel.draw_fri_alpha(), N, evals.device)
            evals = fold_evals(evals, n, N, powers)
            n //= N
        self._set_remainder(channel, Domain(n).ifft(evals), n)

    def _commit_layer(self, evals, n: int, N: int):
        """The layer's tree and rows: bit-reversed evals chunked into rows
        of N, a leaf a row."""
        bitrev = permute_bitrev(evals)
        if evals.ndim == 1:
            rows = bitrev.reshape(n // N, N)
            digests = ksha.hash_rows(rows)
        else:
            rows = bitrev.reshape(3, n // N, N).permute(2, 0, 1).contiguous()
            digests = ksha.hash_rows_ext3(rows)
        return merkle.CommittedMerkleTree.from_leaf_digests(digests), rows

    def _set_remainder(self, channel, coeffs, n: int):
        vals = (fd.ext3_to_scalars(coeffs) if coeffs.ndim == 2
                else [Fp(v) for v in fd.to_ints(coeffs)])
        max_coeffs = n // self.options.blowup_factor
        remainder, zero_tail = vals[:max_coeffs], vals[max_coeffs:]
        assert all(v.is_zero() for v in zero_tail), "remainder degree too high"
        channel.commit_remainder(remainder)
        self.remainder_coeffs = remainder

    def into_proof(self, positions: list[int]) -> FriProof:
        N = self.options.folding_factor
        proof_layers = []
        pos = list(positions)
        for layer in self.layers:
            pos = fold_positions(pos, N)
            proof_layers.append(LayerProof(layer.rows_at(pos),
                                           layer.tree.prove(pos),
                                           layer.tree.root()))
        return FriProof(proof_layers, self.remainder_coeffs)


def alpha_powers(alpha, N: int, device) -> torch.Tensor:
    """alpha^j for j < N of a host-drawn alpha, as the fold takes them:
    (1, N) for Fp, (3, N) component planes for Fq3, on `device`."""
    p, out = type(alpha).one(), []
    for _ in range(N):
        out.append([p.v] if isinstance(p, Fp) else [p.c0.v, p.c1.v, p.c2.v])
        p = p * alpha
    return torch.tensor([[fd.to_i64(v) for v in col] for col in zip(*out)],
                        dtype=torch.int64, device=device)


def fold_coeffs(evals: torch.Tensor, n: int, N: int,
                powers: torch.Tensor) -> torch.Tensor:
    """One degree-respecting projection up to the smaller domain's
    coefficients: iNTT, each chunk of N coefficients weighed by the
    powers of alpha and summed, scaled by N.  evals: (n,) with (1, N) Fp
    powers, or (3, n) with (3, N) Fq3 powers, on evals' device."""
    return fold_chunks(Domain(n).ifft(evals), N, powers)


def fold_chunks(coeffs: torch.Tensor, N: int,
                powers: torch.Tensor) -> torch.Tensor:
    """(..., m) coefficients -> (..., m / N): each chunk of N weighed by
    the powers of alpha and summed, scaled by N."""
    coeffs = coeffs.reshape(*coeffs.shape[:-1], coeffs.shape[-1] // N, N)
    if coeffs.ndim == 3:  # (n/N, 3, N): components on axis -2
        acc = fd.sum_mod(fd.ext3_mul(coeffs.permute(1, 0, 2), powers),
                         -1).T.contiguous()
    else:
        acc = fd.sum_mod(fd.mul(coeffs, powers[0]), -1)
    # N made on the device (a fill, not a copy that waits for the stream)
    return fd.mul(acc, fd.full((), N, acc.device))


def fold_evals(evals: torch.Tensor, n: int, N: int,
               powers: torch.Tensor) -> torch.Tensor:
    """``fold_coeffs`` evaluated on the smaller plain domain (plain NTT)."""
    return Domain(n // N).fft(fold_coeffs(evals, n, N, powers))


def fold_positions(positions: list[int], N: int) -> list[int]:
    out = []
    for p in positions:
        q = p // N
        if not out or out[-1] != q:
            out.append(q)
    return out
