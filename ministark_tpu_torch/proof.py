"""Proof object + queries + security accounting (reference: src/proof.rs,
src/trace.rs:38-157).  Serialization is ark-compatible byte-for-byte."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from . import serde
from .air import ProofOptions
from .fields.scalar import Fp, Fq3
from .fri import FriProof
from .hash import COLLISION_RESISTANCE
from .merkle import MerkleView


@dataclass
class Queries:
    """Per-query trace rows + the three Merkle multi-proofs
    (src/trace.rs:38-45)."""
    base_trace_values: list       # [Fp] flattened rows
    extension_trace_values: list  # [Fq]
    composition_trace_values: list  # [Fq]
    base_trace_proof: MerkleView
    extension_trace_proof: Optional[MerkleView]
    composition_trace_proof: MerkleView

    def serialize(self, w: serde.Writer, fq):
        w.field_vec(self.base_trace_values)
        w.field_vec(self.extension_trace_values)
        w.field_vec(self.composition_trace_values)
        self.base_trace_proof.serialize(w)
        w.option(self.extension_trace_proof, lambda w2, p: p.serialize(w2))
        self.composition_trace_proof.serialize(w)

    @staticmethod
    def deserialize(r: serde.Reader, fp, fq) -> "Queries":
        return Queries(
            base_trace_values=r.field_vec(fp),
            extension_trace_values=r.field_vec(fq),
            composition_trace_values=r.field_vec(fq),
            base_trace_proof=MerkleView.deserialize(r),
            extension_trace_proof=r.option(lambda r2: MerkleView.deserialize(r2)),
            composition_trace_proof=MerkleView.deserialize(r),
        )


@dataclass
class Proof:
    options: ProofOptions
    trace_len: int
    base_trace_commitment: bytes
    extension_trace_commitment: Optional[bytes]
    composition_trace_commitment: bytes
    fri_proof: FriProof
    pow_nonce: int
    trace_queries: Queries
    execution_trace_ood_evals: list
    composition_trace_ood_evals: list

    def serialize(self, w: serde.Writer, fq):
        self.options.serialize(w)
        w.usize(self.trace_len)
        w.digest(self.base_trace_commitment)
        w.option(self.extension_trace_commitment, lambda w2, d: w2.digest(d))
        w.digest(self.composition_trace_commitment)
        self.fri_proof.serialize(w, fq)
        w.u64(self.pow_nonce)
        self.trace_queries.serialize(w, fq)
        w.field_vec(self.execution_trace_ood_evals)
        w.field_vec(self.composition_trace_ood_evals)

    def to_bytes(self, fq) -> bytes:
        w = serde.Writer()
        self.serialize(w, fq)
        return w.bytes()

    @staticmethod
    def deserialize(r: serde.Reader, fp, fq) -> "Proof":
        return Proof(
            options=ProofOptions.deserialize(r),
            trace_len=r.usize(),
            base_trace_commitment=r.digest(),
            extension_trace_commitment=r.option(lambda r2: r2.digest()),
            composition_trace_commitment=r.digest(),
            fri_proof=FriProof.deserialize(r, fq),
            pow_nonce=r.u64(),
            trace_queries=Queries.deserialize(r, fp, fq),
            execution_trace_ood_evals=r.field_vec(fq),
            composition_trace_ood_evals=r.field_vec(fq),
        )

    @staticmethod
    def from_bytes(data: bytes, fp, fq) -> "Proof":
        return Proof.deserialize(serde.Reader(data), fp, fq)

    def security_level_bits(self, fq=None, merkle_security: int | None = None,
                            coin_security: int | None = None) -> int:
        """min(field, query, merkle, coin) security (src/proof.rs:122-148,
        per ethSTARK / eprint 2020/654 §7.2).

        The reference asks the configured tree/coin types for their own
        security (src/merkle.rs:52, src/random.rs:58-60); callers that know
        the Stark config pass ``merkle_security``/``coin_security`` from it
        (the verifier does); bare calls default to SHA-256's 128."""
        fq = fq or (type(self.execution_trace_ood_evals[0])
                    if self.execution_trace_ood_evals else Fp)
        ext_degree = 3 if fq is Fq3 else 1
        base_field_bits = 64
        lde_domain_size = self.trace_len * self.options.lde_blowup_factor
        field_security = ext_degree * base_field_bits - (lde_domain_size.bit_length() - 1)
        query_security = (
            (self.options.lde_blowup_factor.bit_length() - 1) * self.options.num_queries
            + self.options.grinding_factor)
        if merkle_security is None:
            merkle_security = COLLISION_RESISTANCE
        if coin_security is None:
            coin_security = COLLISION_RESISTANCE
        return min(field_security, query_security,
                   merkle_security, coin_security)
