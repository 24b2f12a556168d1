"""Proof object + queries + security accounting (reference: src/proof.rs,
src/trace.rs:38-157).  Serialization is ark-compatible byte-for-byte."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from . import serde
from .air import ProofOptions
from .fri import FriProof
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

