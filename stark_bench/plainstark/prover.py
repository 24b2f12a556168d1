"""The proving pipeline (reference: src/prover.rs `default_prove`) for Fp
AIRs (fib) and AIRs over the cubic extension Fq3 (brainfuck), whose
extension trace, composition trace, OOD points and FRI codewords are Fq3.
SHA-256 trees and coin.

Every matrix stays in NATURAL domain order on the device holding the
witness; bit-reversed order exists only at commitment and query time.
The phases run one after another with the host coin between them, the
FRI layers included.
"""

from __future__ import annotations

import time

import torch

from . import hash as H
from . import merkle
from .air import Challenges, ProofOptions
from .channel import ProverChannel
from .composer import DeepPolyComposer
from .eval import eval_composition
from .fri import FriOptions, FriProver
from .fields.scalar import Fq3
from .matrix import Matrix, MatrixExt3
from .proof import Proof, Queries


def default_prove(stark, options: ProofOptions, witness,
                  phase_s: dict | None = None) -> Proof:
    """Prove on the device of the witness's trace.  `phase_s`, when given,
    receives each phase's seconds (host clock, ending in a synchronise)."""
    trace = stark.generate_trace(witness)
    base_trace = trace.base_columns()
    dev = base_trace.device
    t_last = [time.perf_counter()]

    def done(phase):
        if phase_s is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            phase_s[phase] = now - t_last[0]
            t_last[0] = now

    air = stark.build_air(base_trace.num_rows, options)
    channel = ProverChannel(air, stark.gen_public_coin(air))
    trace_dom = air.trace_domain()
    lde_dom = air.lde_domain()
    ce_dom = air.ce_domain()
    fq_is_ext = getattr(air.config, "fq_type", None) is Fq3

    # -- base trace commit (src/prover.rs:45-55) ------------------------------
    assert air.config.NUM_BASE_COLUMNS == base_trace.num_cols
    base_polys = base_trace.interpolate(trace_dom)
    base_lde = base_polys.evaluate(lde_dom)
    base_tree = merkle.commit_matrix(base_lde.values)
    channel.commit_base_trace(base_tree.root())
    done("base commit")

    challenges = Challenges(channel.public_coin.draw_multiple(air.num_challenges()))
    hints = air.gen_hints(challenges)

    # -- extension trace commit (src/prover.rs:60-72) -------------------------
    ext_trace = trace.build_extension_columns(challenges)
    num_ext = ext_trace.num_cols if ext_trace is not None else 0
    assert getattr(air.config, "NUM_EXTENSION_COLUMNS", 0) == num_ext
    ext_polys = ext_lde = ext_tree = None
    if ext_trace is not None:
        ext_polys = ext_trace.interpolate(trace_dom)
        ext_lde = ext_polys.evaluate(lde_dom)
        ext_tree = merkle.commit_matrix_ext3(ext_lde.values)
        channel.commit_extension_trace(ext_tree.root())
    del ext_trace
    done("extension commit")

    # -- composition trace (src/prover.rs:78-131) -----------------------------
    composition_coeffs = channel.public_coin.draw_multiple(
        air.num_composition_constraint_coeffs())
    r = lde_dom.size // ce_dom.size
    base_ce = base_lde if r == 1 else base_polys.evaluate(ce_dom)
    ext_ce = None
    if ext_lde is not None:
        ext_ce = (ext_lde if r == 1 else ext_polys.evaluate(ce_dom)).values
    del base_polys, ext_polys
    comp_evals = eval_composition(air, composition_coeffs, challenges, hints,
                                  ce_dom.elements(dev), base_ce.values, ext_ce)
    del base_ce, ext_ce
    done("constraint evaluation")

    cb = air.ce_blowup_factor
    coeffs = ce_dom.ifft(comp_evals)
    # split into cb interleaved columns: col_i[j] = coeffs[j*cb + i]
    if fq_is_ext:
        comp_polys = MatrixExt3(coeffs.reshape(3, air.trace_len, cb)
                                .permute(2, 0, 1).contiguous())
    else:
        comp_polys = Matrix(coeffs.reshape(air.trace_len, cb).T.contiguous())
    del coeffs, comp_evals
    comp_lde = comp_polys.evaluate(lde_dom)
    comp_tree = (merkle.commit_matrix_ext3(comp_lde.values) if fq_is_ext
                 else merkle.commit_matrix(comp_lde.values))
    del comp_polys
    channel.commit_composition_trace(comp_tree.root())
    done("composition commit")

    # -- DEEP composition (src/prover.rs:133-149) -----------------------------
    z = channel.get_ood_point()
    composer = DeepPolyComposer(air, z, base_lde, comp_lde, ext_lde)
    execution_oods, composition_oods = composer.get_ood_evals()
    channel.send_ood_evals(execution_oods, composition_oods)
    deep_coeffs = stark.gen_deep_coeffs(channel.public_coin, air)
    deep_lde = composer.deep_lde(deep_coeffs)
    del composer
    done("DEEP")

    # -- FRI (src/prover.rs:151-155) ------------------------------------------
    fri_prover = FriProver(FriOptions(
        folding_factor=options.fri_folding_factor,
        max_remainder_coeffs=options.fri_max_remainder_coeffs,
        blowup_factor=options.lde_blowup_factor))
    fri_prover.build_layers(channel, deep_lde)
    del deep_lde
    done("FRI")

    # -- PoW + queries (src/prover.rs:157-173) --------------------------------
    channel.grind_fri_commitments(grind)
    done("proof of work")
    query_positions = channel.get_fri_query_positions()
    fri_proof = fri_prover.into_proof(query_positions)
    queries = build_queries(base_lde, ext_lde, comp_lde, base_tree,
                            ext_tree, comp_tree, query_positions)
    done("decommit")

    return Proof(
        options=options,
        trace_len=air.trace_len,
        base_trace_commitment=channel.base_trace_commitment,
        extension_trace_commitment=channel.extension_trace_commitment,
        composition_trace_commitment=channel.composition_trace_commitment,
        fri_proof=fri_proof,
        pow_nonce=channel.pow_nonce,
        trace_queries=queries,
        execution_trace_ood_evals=channel.execution_trace_ood_evals,
        composition_trace_ood_evals=channel.composition_trace_ood_evals,
    )


def grind(seed: bytes, bits: int) -> int:
    """The smallest nonce >= 1 with at least `bits` leading zero bits in
    sha256(seed || nonce as 8 big-endian bytes) (src/random.rs:129-132),
    one ``hashlib`` call a nonce."""
    nonce = 1
    while H.leading_zeros(H.merge_with_int(seed, nonce)) < bits:
        nonce += 1
    return nonce


def build_queries(base_lde, ext_lde, comp_lde, base_tree, ext_tree,
                  comp_tree, positions) -> Queries:
    """Decommit trace rows at bit-reversed query positions
    (src/trace.rs:114-157); `ext_lde` and `ext_tree` are None for an AIR
    with no extension trace."""
    def flat(m):
        return [v for row in m.get_bit_reversed_rows(positions) for v in row]

    return Queries(
        base_trace_values=flat(base_lde),
        extension_trace_values=[] if ext_lde is None else flat(ext_lde),
        composition_trace_values=flat(comp_lde),
        base_trace_proof=base_tree.prove(positions),
        extension_trace_proof=None if ext_tree is None
        else ext_tree.prove(positions),
        composition_trace_proof=comp_tree.prove(positions),
    )
