"""FRI commit/fold/query over Fp codewords (fib) and Fq3 codewords
(brainfuck) (reference: src/fri.rs; mirrors ``ministark_tpu.fri``).

Protocol facts replicated exactly (they affect proof bytes):

* folding uses PLAIN (offset-1) domains regardless of the LDE coset;
* after each iNTT the coefficients are scaled by the folding factor N;
* evaluations are committed in bit-reversed order, chunked into rows of N;
* query positions live in bit-reversed space and fold as p -> p // N;
* the remainder is the iNTT of the last layer; coefficients above
  size/blowup must be zero and are not sent.

The commit phase runs on the device with the coin between layers on the
device too (``ops.coin``, mirrors the JAX package's fused FRI pipeline):
commit layer 0, one coin launch reseeds with its root (read in place) and
draws alpha and its first N powers, fold with them, commit layer 1, ..,
the last fold, which gives the remainder coefficients directly.  Then ONE copy brings
the L roots, the L alphas and the remainder to the host, and the host
coin replays the transcript from the roots and raises if any device draw
differs.  The device coin speaks SHA-256 over SHA-256 or RPO-256 trees,
and RPO-256 over RPO-256 trees; an RPO-256 coin over SHA-256 trees
(whose roots are arbitrary bytes, possibly >= p) keeps the host coin
between layers, each root copied to the host before the next fold.  NTTs
run through kernels B and C, the fold in plain PyTorch, row hashes and
tree levels through kernel D (SHA-256 trees) or G (RPO-256 trees).  An
Fq3 codeword is a (3, n) tensor; its layer rows of N elements serialize
each element as c0 || c1 || c2, so a layer is kept as an (N, 3, n/N) Fq3
matrix and hashed as one.  Given a ``parallel.executor.ShardedExecutor``
(SHA-256 trees), a layer's commit and fold run over the ranks where it
supports the layer's size, on each rank's share of the codeword: the
first layer's cyclic share (rows j = rank mod d, from the sharded DEEP
composition), a later layer's contiguous block; each rank keeps its
share of the layer's tree and rows, and the decommit fetches the queried
ones from their owners.  Where the executor does not support a layer,
the codeword is gathered whole first.  The verifier half is exact host
scalar math.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import hash as H
from . import hash_rpo, merkle
from .fields import device as fd
from .fields.scalar import Fp, Fq3, P, get_root_of_unity
from .merkle import MerkleView
from .ntt import Domain, bit_reverse_index, permute_bitrev
from .ops import coin as kcoin


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


class VerificationError(Exception):
    pass


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------

class _Layer:
    """A committed layer: its Merkle tree and its rows, both on the device
    until decommit.  rows: (n/N, N) Fp values, or an (N, 3, n/N) Fq3
    matrix whose column j holds element j of every row."""

    def __init__(self, tree, rows: torch.Tensor):
        self.tree = tree
        self.rows = rows

    def rows_at(self, positions: list[int]) -> list:
        """The rows at `positions`, flattened (N values per row)."""
        if not isinstance(self.rows, torch.Tensor):  # a rank's share
            return self.rows.rows_at(positions)
        idx = torch.tensor(positions, dtype=torch.int64,
                           device=self.rows.device)
        if self.rows.ndim == 2:
            return [Fp(v) for v in fd.to_ints(self.rows.index_select(0, idx))]
        block = self.rows.index_select(2, idx).permute(1, 2, 0)  # (3, q, N)
        return fd.ext3_to_scalars(block.reshape(3, -1))


class FriProver:
    """Builds FRI layers from the DEEP composition LDE, natural order: (n,)
    in Fp or (3, n) in Fq3; `hashfn` is the layer trees' hash."""

    def __init__(self, options: FriOptions, hashfn=merkle.H, executor=None):
        self.options = options
        self.hashfn = hashfn
        # parallel.executor.ShardedExecutor: commits and folds run sharded
        # where it supports the layer, whatever the tree hash
        if executor is not None and executor.hashfn is not hashfn:
            raise ValueError(f"the executor's trees hash with "
                             f"{executor.hashfn.__name__}, the layers' with "
                             f"{hashfn.__name__}")
        self.executor = executor
        self.layers: list[_Layer] = []
        self.remainder_coeffs: list = []

    def build_layers(self, channel, evals: torch.Tensor,
                     cyclic: bool = False):
        """Commit every layer and the remainder.  evals: the whole codeword,
        or (`cyclic`, with an executor) this rank's share of it, the
        evaluations j = rank (mod d)."""
        assert not self.layers
        layout = "cyclic" if cyclic else "whole"
        n = evals.shape[-1] * (self.executor.d if cyclic else 1)
        N = self.options.folding_factor
        L = self.options.num_layers(n)
        step = device_coin_step(channel.public_coin.hashfn, self.hashfn)
        if L >= 1 and step is not None:
            return self._build_layers_device_coin(channel, evals, n, N, L,
                                                  step, layout)
        for _ in range(L):
            tree, rows = self._commit_layer(evals, n, N, layout)
            channel.commit_fri_layer(tree.root())
            self.layers.append(_Layer(tree, rows))
            powers = alpha_powers(channel.draw_fri_alpha(), N, evals.device)
            evals, layout = self._fold(evals, n, N, powers, layout, False)
            n //= N
        if layout != "whole":
            evals = self.executor.whole(evals, layout)
        self._set_remainder(channel, Domain(n).ifft(evals), n)

    def _build_layers_device_coin(self, channel, evals, n: int, N: int,
                                  L: int, step, layout: str = "whole"):
        """Every layer's commit, coin step and fold queued on the device
        with no transfer in between; then one copy of the roots, the
        alphas and the remainder, and the host coin's replay."""
        k = 3 if evals.ndim == 2 else 1
        seed = kcoin.seed_tensor(channel.public_coin.seed, evals.device)
        roots, alphas = [], []
        for i in range(L):
            tree, rows = self._commit_layer(evals, n, N, layout)
            self.layers.append(_Layer(tree, rows))
            root = tree.levels[-1][0]
            seed, alpha, powers = step(seed, root, k, N)
            roots.append(root)
            alphas.append(alpha)
            # the last fold is the remainder's coefficients: no forward NTT
            # (the host path's fft is inverted straight back)
            evals, layout = self._fold(evals, n, N, powers, layout,
                                       i == L - 1)
            n //= N
        coeffs = evals
        blob = torch.cat([torch.stack(roots).view(torch.int64).reshape(-1),
                          torch.stack(alphas).reshape(-1),
                          coeffs.reshape(-1)]).cpu()
        root_words, alpha_vals = blob[:4 * L], blob[4 * L:4 * L + k * L]
        for i in range(L):
            root = root_words[4 * i:4 * i + 4].numpy().tobytes()
            self.layers[i].tree._root = root
            channel.commit_fri_layer(root)
            host = channel.draw_fri_alpha()
            host = [host.v] if k == 1 else [host.c0.v, host.c1.v, host.c2.v]
            dev = fd.to_ints(alpha_vals[k * i:k * i + k])
            if dev != host:
                raise AssertionError(
                    f"device coin diverged from host replay at FRI layer "
                    f"{i}: {dev} != {host}")
        self._set_remainder(channel, blob[4 * L + k * L:].reshape(
            coeffs.shape), n)

    def _commit_layer(self, evals, n: int, N: int, layout: str = "whole"):
        """The layer's tree and rows: bit-reversed evals chunked into rows
        of N, a leaf a row.  `layout` (``parallel.executor``): evals is
        the whole layer, or this rank's contiguous block of it (after a
        sharded fold) or its cyclic share (from a sharded DEEP)."""
        ex = self.executor
        if ex is not None and ex.fri_commit_supported(n, N):
            return ex.fri_commit_layer(evals, n, N, layout)
        if layout != "whole":
            evals = ex.whole(evals, layout)
        bitrev = permute_bitrev(evals)
        dh = merkle.device_hash(self.hashfn)
        if evals.ndim == 1:
            rows = bitrev.reshape(n // N, N)
            digests = dh.hash_rows(rows)
        else:
            rows = bitrev.reshape(3, n // N, N).permute(2, 0, 1).contiguous()
            digests = dh.hash_rows_ext3(rows)
        tree = merkle.CommittedMerkleTree.from_leaf_digests(digests,
                                                            self.hashfn)
        return tree, rows

    def _fold(self, evals, n: int, N: int, powers, layout: str, last: bool):
        """One fold: (the folded evaluations, or with `last` the folded
        coefficients, and their layout: this rank's block, or whole),
        sharded where the executor supports the layer."""
        ex = self.executor
        if ex is not None and ex.fri_fold_supported(n, N):
            return (ex.fri_fold(evals, n, N, powers, layout, last),
                    "whole" if last else "block")
        if layout != "whole":
            evals = ex.whole(evals, layout)
        fold = fold_coeffs if last else fold_evals
        return fold(evals, n, N, powers), "whole"

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


def device_coin_step(coin_hash, tree_hash):
    """The device coin step for a coin hashing with `coin_hash` over trees
    hashing with `tree_hash` (``ops.coin.coin_sha`` or ``coin_rpo``), or
    None: an RPO-256 coin absorbs a root as four field elements, so over
    SHA-256 trees (roots of arbitrary bytes) it stays on the host."""
    if coin_hash is H and tree_hash in (H, hash_rpo):
        return kcoin.coin_sha
    if coin_hash is hash_rpo and tree_hash is hash_rpo:
        return kcoin.coin_rpo
    return None


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
    coefficients: plain iNTT, each chunk of N coefficients weighed by the
    powers of alpha and summed, scaled by N.  evals: (n,) with (1, N) Fp
    powers, or (3, n) with (3, N) Fq3 powers, on evals' device.  The
    chunks are weighed in one product and summed by pairwise halving: a
    layer's plain torch launches do not grow with N (a product a power
    took a few hundred launches an Fq3 layer)."""
    return fold_chunks(Domain(n).ifft(evals), N, powers)


def fold_chunks(coeffs: torch.Tensor, N: int,
                powers: torch.Tensor) -> torch.Tensor:
    """(..., m) coefficients -> (..., m / N): each chunk of N weighed by
    the powers of alpha and summed, scaled by N (``fold_coeffs`` after its
    iNTT; the sharded fold runs it on each rank's block)."""
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


def get_query_values(rows: list, positions: list[int], folded_positions: list[int], N: int):
    lookup = {fp: i for i, fp in enumerate(folded_positions)}
    return [rows[lookup[p // N]][p % N] for p in positions]


# ---------------------------------------------------------------------------
# verifier (host scalar)
# ---------------------------------------------------------------------------

class FriVerifier:
    def __init__(self, public_coin, options: FriOptions, proof: FriProof,
                 max_poly_degree: int, hashfn=merkle.H):
        self.options = options
        self.proof = proof
        self.hashfn = hashfn
        domain_size = _next_pow2(max_poly_degree + 1) * options.blowup_factor
        self.domain_size = domain_size
        self.domain_generator = get_root_of_unity(domain_size).v

        self.layer_alphas = []
        self.layer_commitments = []
        codeword_len = domain_size
        N = options.folding_factor
        for i, layer in enumerate(proof.layers):
            public_coin.reseed_with_digest(layer.commitment)
            self.layer_alphas.append(public_coin.draw())
            self.layer_commitments.append(layer.commitment)
            if i != len(proof.layers) - 1 and codeword_len % N != 0:
                raise VerificationError(
                    f"codeword length {codeword_len} not divisible by {N}")
            codeword_len //= N
        public_coin.reseed_with_field_element_vector(proof.remainder_coeffs)

    def verify(self, positions: list[int], evaluations: list) -> None:
        if len(positions) != len(evaluations):
            raise VerificationError("positions/evaluations length mismatch")
        N = self.options.folding_factor
        domain_size = self.domain_size
        g = self.domain_generator
        positions = list(positions)
        evaluations = list(evaluations)

        num_layers = self.options.num_layers(domain_size)
        if len(self.proof.layers) != num_layers:
            raise VerificationError(
                f"expected {num_layers} FRI layers, got {len(self.proof.layers)}")
        for i in range(num_layers):
            folded = fold_positions(positions, N)
            alpha = self.layer_alphas[i]
            commitment = self.layer_commitments[i]
            layer = self.proof.layers[i]
            rows = [layer.flattened_rows[k * N:(k + 1) * N]
                    for k in range(len(layer.flattened_rows) // N)]
            if len(rows) != len(folded):
                raise VerificationError(f"row count mismatch in layer {i}")

            try:
                merkle.verify_rows(commitment, folded, rows,
                                   layer.merkle_proof, self.hashfn)
            except merkle.InvalidProof as e:
                raise VerificationError(f"layer {i} commitment invalid") from e

            query_values = get_query_values(rows, positions, folded, N)
            if evaluations != query_values:
                raise VerificationError(
                    f"degree-respecting projection invalid in layer {i}")

            # next-layer evals: per coset, iNTT (on coset g^bitrev(pos) of the
            # plain folding domain), coefficients *N, Horner at alpha
            offsets = [pow(g, bit_reverse_index(domain_size // N, p), P)
                       for p in folded]
            from . import native
            triples = native.fri_fold_rows(
                layer.flattened_rows[:len(rows) * N], N, offsets,
                get_root_of_unity(N).v, alpha)
            if triples is not None:
                is_ext = isinstance(alpha, Fq3) or isinstance(
                    layer.flattened_rows[0], Fq3)
                evaluations = [Fq3(*t) if is_ext else Fp(t[0])
                               for t in triples]
            else:
                evaluations = []
                for row, offset in zip(rows, offsets):
                    chunk = [row[bit_reverse_index(N, j)] for j in range(N)]
                    coeffs = _small_coset_ifft(chunk, N, offset)
                    acc = _fq_zero(chunk[0])
                    for c in reversed(coeffs):
                        acc = acc * alpha + c * N
                    evaluations.append(acc)
            positions = folded
            g = pow(g, N, P)
            domain_size //= N

        self._verify_remainder(positions, evaluations, g, domain_size)

    def _verify_remainder(self, positions, evaluations, g, domain_size):
        coeffs = list(self.proof.remainder_coeffs)
        while coeffs and coeffs[-1].is_zero():
            coeffs.pop()
        expected_degree = domain_size // self.options.blowup_factor - 1
        if len(coeffs) - 1 > expected_degree:
            raise VerificationError(
                f"remainder is not a degree {expected_degree} polynomial")
        for p, e in zip(positions, evaluations):
            x = Fp(pow(g, bit_reverse_index(domain_size, p), P))
            acc = _fq_zero(e)
            for c in reversed(self.proof.remainder_coeffs):
                acc = acc * x + c
            if acc != e:
                raise VerificationError("remainder mismatch")


def _small_coset_ifft(values: list, N: int, offset: int):
    """Naive size-N inverse NTT over coset {offset * w^i} (N <= 16)."""
    w = get_root_of_unity(N).v
    n_inv = pow(N, P - 2, P)
    off_inv = pow(offset, P - 2, P)
    coeffs = []
    for k in range(N):
        acc = _fq_zero(values[0])
        for i, v in enumerate(values):
            wexp = pow(w, (N - (i * k) % N) % N, P)  # w^{-ik}
            acc = acc + v * Fp(wexp)
        coeffs.append(acc * Fp(n_inv) * Fp(pow(off_inv, k, P)))
    return coeffs


def _fq_zero(like):
    return type(like).zero()


def _next_pow2(v: int) -> int:
    return 1 << (v - 1).bit_length() if v > 1 else 1

