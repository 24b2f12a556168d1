"""Prover channel: records commitments while driving the public coin
(reference: src/channel.rs)."""

from __future__ import annotations

from .random import PublicCoin


class ProverChannel:
    def __init__(self, air, public_coin: PublicCoin):
        self.air = air
        self.public_coin = public_coin
        self.base_trace_commitment = None
        self.extension_trace_commitment = None
        self.composition_trace_commitment = None
        self.fri_layer_commitments = []
        self.fri_remainder_coeffs = []
        self.execution_trace_ood_evals = []
        self.composition_trace_ood_evals = []
        self.pow_nonce = 0

    # -- trace commitments ---------------------------------------------------

    def commit_base_trace(self, root: bytes):
        self.public_coin.reseed_with_digest(root)
        self.base_trace_commitment = root

    def commit_extension_trace(self, root: bytes):
        self.public_coin.reseed_with_digest(root)
        self.extension_trace_commitment = root

    def commit_composition_trace(self, root: bytes):
        self.public_coin.reseed_with_digest(root)
        self.composition_trace_commitment = root

    # -- OOD phase -----------------------------------------------------------

    def get_ood_point(self):
        return self.public_coin.draw()

    def send_ood_evals(self, execution_trace_oods, composition_trace_oods):
        self.public_coin.reseed_with_field_elements(
            list(execution_trace_oods) + list(composition_trace_oods))
        self.execution_trace_ood_evals = list(execution_trace_oods)
        self.composition_trace_ood_evals = list(composition_trace_oods)

    # -- FRI prover channel (src/channel.rs:124-142) -------------------------

    def commit_fri_layer(self, root: bytes):
        self.public_coin.reseed_with_digest(root)
        self.fri_layer_commitments.append(root)

    def commit_remainder(self, remainder_coeffs):
        self.public_coin.reseed_with_field_element_vector(remainder_coeffs)
        self.fri_remainder_coeffs = list(remainder_coeffs)

    def draw_fri_alpha(self):
        return self.public_coin.draw()

    # -- grind + queries -----------------------------------------------------

    def grind_fri_commitments(self, grinder):
        """grinder(seed, bits): the smallest valid nonce (the device grind
        of the coin's hash)."""
        bits = self.air.options.grinding_factor
        if bits == 0:
            return
        nonce = grinder(self.public_coin.seed, bits)
        assert self.public_coin.verify_proof_of_work(bits, nonce)
        self.pow_nonce = nonce
        self.public_coin.reseed_with_int(nonce)

    def get_fri_query_positions(self) -> list[int]:
        lde_domain_size = self.air.trace_len * self.air.lde_blowup_factor()
        return self.public_coin.draw_queries(
            self.air.options.num_queries, lde_domain_size)
