"""The proving pipeline (reference: src/prover.rs `default_prove`; mirrors
``ministark_tpu.prover._default_prove``) for Fp AIRs (fib) and AIRs over
the cubic extension Fq3 (brainfuck), whose extension trace, composition
trace, OOD points and FRI codewords are Fq3.  The Merkle trees hash with
the Stark's `merkle_hash` and the public coin with its `coin_hash`: SHA-256
(``hash``) or RPO-256 (``hash_rpo``) each.

Every matrix stays in NATURAL domain order on the device holding the
witness; bit-reversed order exists only at commitment and query time.  The
flow is one phase after another with the host coin between them; inside
the FRI commit phase the coin runs on the device between the layers
(``fri.FriProver``, ``ops.coin``) and the host coin replays it from the
roots afterwards, so the layers need no transfer in between.  A Stark
that carries a ``sharded_executor`` (``parallel.prover.prove_sharded``)
has its LDE + commit phases and FRI layers run over the ranks of a
process group, with SHA-256 trees.  The bytes are the JAX package's.
"""

from __future__ import annotations

from . import merkle
from .air import Challenges, ProofOptions
from .channel import ProverChannel
from .composer import DeepPolyComposer
from .eval import eval_composition
from .fri import FriOptions, FriProver
from .fields.scalar import Fq3
from .matrix import Matrix, MatrixExt3
from .proof import Proof, Queries
from .utils.timer import Timer


def default_prove(stark, options: ProofOptions, witness,
                  phase_log: list | None = None,
                  validate: bool = False) -> Proof:
    """Prove on the device of the witness's trace.  `phase_log`, when
    given, receives one {"phase", "host_ms", "device_ms"} record per phase.
    `validate` checks every constraint on the trace (``debug``) after the
    trace commitments and raises ``ConstraintViolation`` on the first that
    fails."""
    hashfn = stark.merkle_hash  # the reference's MerkleTree associated type
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
    fq_is_ext = getattr(air.config, "fq_type", None) is Fq3

    # The sharded executor (parallel/executor.py), when the Stark carries
    # one: the LDE + commit phases and the FRI layers run over the ranks of
    # its mesh, with SHA-256 trees only.
    executor = getattr(stark, "sharded_executor", None)
    use_ex_commit = (executor is not None and hashfn is merkle.H
                     and executor.commit_supported(lde_dom.size))

    # -- phase 1: base trace commit (src/prover.rs:45-55) --------------------
    with timer("Base trace commitment"):
        assert air.config.NUM_BASE_COLUMNS == base_trace.num_cols
        base_polys = None
        if use_ex_commit:
            base_lde, base_tree = executor.lde_commit_fp(
                base_trace, trace_dom, lde_dom)
        else:
            base_polys = base_trace.interpolate(trace_dom)
            base_lde = base_polys.evaluate(lde_dom)
            base_tree = merkle.commit_matrix(base_lde.values, hashfn)
        channel.commit_base_trace(base_tree.root())

    challenges = Challenges(channel.public_coin.draw_multiple(air.num_challenges()))
    hints = air.gen_hints(challenges)

    # -- phase 2: extension trace commit (src/prover.rs:60-72) ---------------
    with timer("Extension trace commitment"):
        ext_trace = trace.build_extension_columns(challenges)
        num_ext = ext_trace.num_cols if ext_trace is not None else 0
        assert getattr(air.config, "NUM_EXTENSION_COLUMNS", 0) == num_ext
        ext_polys = ext_lde = ext_tree = None
        if ext_trace is not None:
            if use_ex_commit:
                ext_lde, ext_tree = executor.lde_commit_ext3(
                    ext_trace, trace_dom, lde_dom)
            else:
                ext_polys = ext_trace.interpolate(trace_dom)
                ext_lde = ext_polys.evaluate(lde_dom)
                ext_tree = merkle.commit_matrix_ext3(ext_lde.values, hashfn)
            channel.commit_extension_trace(ext_tree.root())

    if validate:
        stark.validate_constraints(air, challenges, hints, base_trace,
                                   ext_trace)

    # -- phase 3: composition trace (src/prover.rs:78-131) -------------------
    with timer("Constraint evaluation"):
        ce_dom = air.ce_domain()
        r = lde_dom.size // ce_dom.size

        def on_ce(lde, polys):
            if r == 1:
                return lde
            if polys is not None:
                return polys.evaluate(ce_dom)
            # the executor's LDE came without its coefficients: the CE
            # domain's point j is the LDE's point j r (the same coset)
            return type(lde)(lde.values[..., ::r].contiguous())

        base_ce = on_ce(base_lde, base_polys)
        ext_ce = None
        if ext_lde is not None:
            ext_ce = on_ce(ext_lde, ext_polys).values
        composition_coeffs = channel.public_coin.draw_multiple(
            air.num_composition_constraint_coeffs())
        comp_evals = eval_composition(
            air, composition_coeffs, challenges, hints, ce_dom.elements(dev),
            base_ce.values, ext_ce)

    with timer("Composition trace commitment"):
        cb = air.ce_blowup_factor
        coeffs = ce_dom.ifft(comp_evals)
        # split into cb interleaved columns: col_i[j] = coeffs[j*cb + i]
        if fq_is_ext:
            comp_polys = MatrixExt3(coeffs.reshape(3, air.trace_len, cb)
                                    .permute(2, 0, 1).contiguous())
            comp_lde = comp_polys.evaluate(lde_dom)
            comp_tree = merkle.commit_matrix_ext3(comp_lde.values, hashfn)
        else:
            comp_polys = Matrix(coeffs.reshape(air.trace_len, cb).T.contiguous())
            comp_lde = comp_polys.evaluate(lde_dom)
            comp_tree = merkle.commit_matrix(comp_lde.values, hashfn)
        channel.commit_composition_trace(comp_tree.root())

    # -- phase 4: DEEP composition (src/prover.rs:133-149) -------------------
    with timer("DEEP composition"):
        z = channel.get_ood_point()
        composer = DeepPolyComposer(air, z, base_lde, comp_lde, ext_lde)
        execution_oods, composition_oods = composer.get_ood_evals()
        channel.send_ood_evals(execution_oods, composition_oods)
        deep_coeffs = stark.gen_deep_coeffs(channel.public_coin, air)
        deep_lde = composer.deep_lde(deep_coeffs)

    # -- phase 5: FRI (src/prover.rs:151-155) --------------------------------
    with timer("FRI"):
        fri_prover = FriProver(FriOptions(
            folding_factor=options.fri_folding_factor,
            max_remainder_coeffs=options.fri_max_remainder_coeffs,
            blowup_factor=options.lde_blowup_factor), hashfn, executor)
        fri_prover.build_layers(channel, deep_lde)

    # -- phase 6: PoW + queries (src/prover.rs:157-173) ----------------------
    with timer("Proof of work"):
        # smallest valid nonce, searched on the device
        grind = merkle.device_hash(channel.public_coin.hashfn).grind
        channel.grind_fri_commitments(
            lambda seed, bits: grind(seed, bits, dev))
    query_positions = channel.get_fri_query_positions()

    with timer("FRI decommit"):
        fri_proof = fri_prover.into_proof(query_positions)
    with timer("Queries"):
        queries = build_queries(base_lde, ext_lde, comp_lde, base_tree,
                                ext_tree, comp_tree, query_positions)

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
