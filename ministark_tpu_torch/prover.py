"""The proving pipeline (reference: src/prover.rs `default_prove`; mirrors
``ministark_tpu.prover._default_prove`` for Fp AIRs with SHA-256 trees).

Every matrix stays in NATURAL domain order on the device holding the
witness; bit-reversed order exists only at commitment and query time.  The
flow is one plain phase after another with the host coin between them:
the TPU package's single-dispatch programs (the fused composition commit,
the fused FRI pipeline with its on-device coin, the bundled decommit
transfer) existed because each dispatch through its remote relay cost a
round trip, and a local card has no such cost.  The bytes are the same.
"""

from __future__ import annotations

from . import hash as H
from . import merkle
from .air import Challenges, ProofOptions
from .channel import ProverChannel
from .composer import DeepPolyComposer
from .eval import eval_composition
from .fri import FriOptions, FriProver
from .matrix import Matrix
from .proof import Proof, Queries
from .utils.timer import Timer


def default_prove(stark, options: ProofOptions, witness,
                  phase_log: list | None = None) -> Proof:
    """Prove on the device of the witness's trace.  `phase_log`, when
    given, receives one {"phase", "host_ms", "device_ms"} record per phase."""
    if stark.merkle_hash is not H or stark.coin_hash is not H:
        raise NotImplementedError("only SHA-256 trees and coin are ported")

    trace = stark.generate_trace(witness)
    base_trace = trace.base_columns()
    dev = base_trace.device

    def timer(name):
        return Timer(name, dev, phase_log)

    with timer("Air init"):
        air = stark.build_air(base_trace.num_rows, options)
        channel = ProverChannel(air, stark.gen_public_coin(air))
    trace_dom = air.trace_domain()
    lde_dom = air.lde_domain()

    # -- phase 1: base trace commit (src/prover.rs:45-55) --------------------
    with timer("Base trace commitment"):
        assert air.config.NUM_BASE_COLUMNS == base_trace.num_cols
        base_polys = base_trace.interpolate(trace_dom)
        base_lde = base_polys.evaluate(lde_dom)
        base_tree = merkle.commit_matrix(base_lde.values)
        channel.commit_base_trace(base_tree.root())

    challenges = Challenges(channel.public_coin.draw_multiple(air.num_challenges()))
    hints = air.gen_hints(challenges)
    if trace.build_extension_columns(challenges) is not None:
        raise NotImplementedError("extension traces are not ported yet")

    # -- phase 3: composition trace (src/prover.rs:78-131) -------------------
    with timer("Constraint evaluation"):
        ce_dom = air.ce_domain()
        base_ce = (base_lde if ce_dom.size == lde_dom.size
                   else base_polys.evaluate(ce_dom))
        composition_coeffs = channel.public_coin.draw_multiple(
            air.num_composition_constraint_coeffs())
        comp_evals = eval_composition(
            air, composition_coeffs, challenges, hints, ce_dom.elements(dev),
            base_ce.values)

    with timer("Composition trace commitment"):
        cb = air.ce_blowup_factor
        coeffs = ce_dom.ifft(comp_evals)
        # split into cb interleaved columns: col_i[j] = coeffs[j*cb + i]
        comp_polys = Matrix(coeffs.reshape(air.trace_len, cb).T.contiguous())
        comp_lde = comp_polys.evaluate(lde_dom)
        comp_tree = merkle.commit_matrix(comp_lde.values)
        channel.commit_composition_trace(comp_tree.root())

    # -- phase 4: DEEP composition (src/prover.rs:133-149) -------------------
    with timer("DEEP composition"):
        z = channel.get_ood_point()
        composer = DeepPolyComposer(air, z, base_lde, comp_lde)
        execution_oods, composition_oods = composer.get_ood_evals()
        channel.send_ood_evals(execution_oods, composition_oods)
        deep_coeffs = stark.gen_deep_coeffs(channel.public_coin, air)
        deep_lde = composer.deep_lde(deep_coeffs)

    # -- phase 5: FRI (src/prover.rs:151-155) --------------------------------
    with timer("FRI"):
        fri_prover = FriProver(FriOptions(
            folding_factor=options.fri_folding_factor,
            max_remainder_coeffs=options.fri_max_remainder_coeffs,
            blowup_factor=options.lde_blowup_factor))
        fri_prover.build_layers(channel, deep_lde)

    # -- phase 6: PoW + queries (src/prover.rs:157-173) ----------------------
    with timer("Proof of work"):
        # the host grind (native C++ when available): smallest valid nonce
        channel.grind_fri_commitments()
    query_positions = channel.get_fri_query_positions()

    with timer("FRI decommit"):
        fri_proof = fri_prover.into_proof(query_positions)
    with timer("Queries"):
        queries = build_queries(base_lde, comp_lde, base_tree, comp_tree,
                                query_positions)

    return Proof(
        options=options,
        trace_len=air.trace_len,
        base_trace_commitment=channel.base_trace_commitment,
        extension_trace_commitment=None,
        composition_trace_commitment=channel.composition_trace_commitment,
        fri_proof=fri_proof,
        pow_nonce=channel.pow_nonce,
        trace_queries=queries,
        execution_trace_ood_evals=channel.execution_trace_ood_evals,
        composition_trace_ood_evals=channel.composition_trace_ood_evals,
    )


def build_queries(base_lde, comp_lde, base_tree, comp_tree,
                  positions) -> Queries:
    """Decommit trace rows at bit-reversed query positions
    (src/trace.rs:114-157)."""
    base_rows = base_lde.get_bit_reversed_rows(positions)
    comp_rows = comp_lde.get_bit_reversed_rows(positions)
    return Queries(
        base_trace_values=[v for row in base_rows for v in row],
        extension_trace_values=[],
        composition_trace_values=[v for row in comp_rows for v in row],
        base_trace_proof=base_tree.prove(positions),
        extension_trace_proof=None,
        composition_trace_proof=comp_tree.prove(positions),
    )
