"""STARK verifier — pure host scalar math (reference: src/verifier.rs;
mirrors ``ministark_tpu.verifier``).  Shares no compute
code with the prover: it re-derives everything from the proof bytes and
the public inputs."""

from __future__ import annotations

from .air import Air, Challenges
from .constraints import CompositionCoeff
from .expression import Challenge as ChallengeLeaf
from .expression import Constant, Hint as HintLeaf, Periodic, Trace as TraceLeaf, X
from . import merkle
from .fields.scalar import Fp, Fq3, P
from .fri import FriOptions, FriVerifier, VerificationError as FriError
from .ntt import bit_reverse_index
from .proof import Proof


class VerificationError(Exception):
    pass


def default_verify(stark, proof: Proof, required_security_bits: int):
    fq = stark.fq
    hashfn = stark.merkle_hash
    if proof.security_level_bits(
            fq, merkle_security=hashfn.COLLISION_RESISTANCE,
            coin_security=stark.coin_hash.COLLISION_RESISTANCE
    ) < required_security_bits:
        raise VerificationError("proof params do not satisfy security requirements")

    options = proof.options
    air = stark.build_air(proof.trace_len, options)
    coin = stark.gen_public_coin(air)

    coin.reseed_with_digest(proof.base_trace_commitment)
    challenges = Challenges(coin.draw_multiple(air.num_challenges()))
    hints = air.gen_hints(challenges)

    if proof.extension_trace_commitment is not None:
        coin.reseed_with_digest(proof.extension_trace_commitment)

    composition_coeffs = coin.draw_multiple(air.num_composition_constraint_coeffs())
    coin.reseed_with_digest(proof.composition_trace_commitment)

    z = coin.draw()
    ood_evals = list(proof.execution_trace_ood_evals) + list(proof.composition_trace_ood_evals)
    coin.reseed_with_field_elements(ood_evals)

    trace_ood_eval_map = dict(zip(air.trace_arguments(), proof.execution_trace_ood_evals))
    calculated = ood_constraint_evaluation(
        air, composition_coeffs, challenges, hints, trace_ood_eval_map, z)
    provided = _horner(proof.composition_trace_ood_evals, z)
    if calculated != provided:
        raise VerificationError(
            "constraint evaluations at the out-of-domain point are inconsistent")

    deep_coeffs = stark.gen_deep_coeffs(coin, air)
    fri_options = FriOptions(
        folding_factor=options.fri_folding_factor,
        max_remainder_coeffs=options.fri_max_remainder_coeffs,
        blowup_factor=options.lde_blowup_factor)
    fri_verifier = FriVerifier(coin, fri_options, proof.fri_proof,
                               proof.trace_len - 1, hashfn)

    if options.grinding_factor != 0:
        if not coin.verify_proof_of_work(options.grinding_factor, proof.pow_nonce):
            raise VerificationError("insufficient proof of work on fri commitments")
        coin.reseed_with_int(proof.pow_nonce)

    lde_domain_size = air.trace_len * air.lde_blowup_factor()
    query_positions = coin.draw_queries(options.num_queries, lde_domain_size)

    nb = air.config.NUM_BASE_COLUMNS
    ne = getattr(air.config, "NUM_EXTENSION_COLUMNS", 0)
    q = proof.trace_queries
    base_rows = _chunk(q.base_trace_values, nb)
    ext_rows = _chunk(q.extension_trace_values, ne) if ne else []
    comp_rows = _chunk(q.composition_trace_values, air.ce_blowup_factor)

    try:
        merkle.verify_rows(proof.base_trace_commitment, query_positions,
                           base_rows, q.base_trace_proof, hashfn)
    except merkle.InvalidProof as e:
        raise VerificationError("query does not resolve to the base trace commitment") from e

    if proof.extension_trace_commitment is not None:
        try:
            merkle.verify_rows(proof.extension_trace_commitment,
                               query_positions, ext_rows,
                               q.extension_trace_proof, hashfn)
        except merkle.InvalidProof as e:
            raise VerificationError(
                "query does not resolve to the extension trace commitment") from e

    try:
        merkle.verify_rows(proof.composition_trace_commitment, query_positions,
                           comp_rows, q.composition_trace_proof, hashfn)
    except merkle.InvalidProof as e:
        raise VerificationError(
            "query does not resolve to the composition trace commitment") from e

    deep_evaluations = deep_composition_evaluations(
        air, query_positions, deep_coeffs, base_rows, ext_rows, comp_rows,
        trace_ood_eval_map, proof.composition_trace_ood_evals, z)

    fri_alphas = list(fri_verifier.layer_alphas)
    try:
        fri_verifier.verify(query_positions, deep_evaluations)
    except FriError as e:
        raise VerificationError(f"fri verification failed: {e}") from e

    return VerifierArtifacts(
        air_challenges=challenges,
        air_hints=hints,
        fri_alphas=fri_alphas,
        query_positions=query_positions,
    )


class VerifierArtifacts:
    """What verification yields beyond accept/reject (src/channel.rs:145-151)."""

    def __init__(self, air_challenges, air_hints, fri_alphas, query_positions):
        self.air_challenges = air_challenges
        self.air_hints = air_hints
        self.fri_alphas = fri_alphas
        self.query_positions = query_positions


def ood_constraint_evaluation(air: Air, composition_coeffs, challenges, hints,
                              trace_ood_eval_map, x):
    """Single-point evaluation of the composition DAG at the OOD point z —
    the SAME symbolic definition the prover bulk-evaluates
    (src/verifier.rs:205-235)."""

    def leaf_value(leaf):
        if isinstance(leaf, X):
            return x
        if isinstance(leaf, Constant):
            return leaf.value
        if isinstance(leaf, ChallengeLeaf):
            return challenges[leaf.index]
        if isinstance(leaf, HintLeaf):
            return hints[leaf.index]
        if isinstance(leaf, TraceLeaf):
            return trace_ood_eval_map[(leaf.column, leaf.offset)]
        if isinstance(leaf, Periodic):
            point = x ** (air.trace_len // leaf.interval_size)
            return _horner(list(leaf.coeffs), point)
        if isinstance(leaf, CompositionCoeff):
            return composition_coeffs[leaf.index]
        raise TypeError(f"unknown leaf {leaf!r}")

    return air.composition_constraint.expr.graph_eval(leaf_value)


def deep_composition_evaluations(air, query_positions, deep_coeffs, base_rows,
                                 ext_rows, comp_rows, trace_ood_eval_map,
                                 composition_trace_ood_evals, z):
    """Recompute the DEEP quotient values at the query points
    (src/verifier.rs:238-297)."""
    trace_dom = air.trace_domain()
    g, g_inv = trace_dom.group_gen, trace_dom.group_gen_inv
    z_n = z ** air.ce_blowup_factor
    lde_dom = air.lde_domain()
    n = lde_dom.size
    xs = [lde_dom.element(bit_reverse_index(n, p)) for p in query_positions]

    nb = air.config.NUM_BASE_COLUMNS

    from . import native
    if native.get_lib() is not None:
        items = sorted(trace_ood_eval_map.items())
        trace_vals = [
            (base_rows[i][col] if col < nb else ext_rows[i][col - nb])
            for i in range(len(xs)) for (col, _off), _ood in items]
        zshifts = [z * Fp(pow(g if off >= 0 else g_inv, abs(off), P))
                   for (_col, off), _ood in items]
        comp_flat = [v for row in comp_rows for v in row]
        da, db = deep_coeffs.degree
        triples = native.deep_evals(
            [x.v for x in xs], len(items), trace_vals,
            [ood for _k, ood in items], deep_coeffs.execution_trace, zshifts,
            len(comp_rows[0]) if comp_rows else 0, comp_flat,
            composition_trace_ood_evals, deep_coeffs.composition_trace,
            z_n, da, db)
        is_ext = not isinstance(z, Fp)
        return [type(z)(*t) if is_ext else type(z)(t[0]) for t in triples]

    evals = []
    for i, x in enumerate(xs):
        acc = _zero_like(z)
        for j, ((column, offset), ood_eval) in enumerate(
                sorted(trace_ood_eval_map.items())):
            if column < nb:
                trace_value = base_rows[i][column]
            else:
                trace_value = ext_rows[i][column - nb]
            alpha = deep_coeffs.execution_trace[j]
            shift = Fp(pow(g if offset >= 0 else g_inv, abs(offset), P))
            acc = acc + alpha * (trace_value - ood_eval) / (x - z * shift)
        for j, value in enumerate(comp_rows[i]):
            alpha = deep_coeffs.composition_trace[j]
            acc = acc + alpha * (value - composition_trace_ood_evals[j]) / (x - z_n)
        evals.append(acc)

    da, db = deep_coeffs.degree
    return [e * (da + db * x) for x, e in zip(xs, evals)]


def _horner(coeffs, x):
    acc = _zero_like(x)
    for c in reversed(coeffs):
        acc = acc * x + c
    return acc


def _zero_like(x):
    return type(x).zero()


def _chunk(values, size):
    assert size > 0
    return [values[i:i + size] for i in range(0, len(values), size)]
