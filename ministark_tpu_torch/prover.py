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
runs its phases from the commits to the decommit over the ranks of a
process group, whatever the tree hash, where the executor's predicates
hold (``phases_supported``): each rank holds its share of
every LDE, tree and FRI layer, evaluates the constraints on its block of
the CE domain and DEEP on its rows (``parallel.executor``).  The bytes
are the JAX package's.
"""

from __future__ import annotations

from . import merkle
from .air import Challenges, ProofOptions
from .channel import ProverChannel
from .composer import DeepPolyComposer
from .eval import eval_composition, eval_composition_block, trace_halo
from .fri import FriOptions, FriProver
from .fields.scalar import Fq3
from .matrix import Matrix, MatrixExt3
from .parallel.composer import ShardedDeepPolyComposer
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
    # one: where its predicates hold, the phases from the commits to the
    # decommit run over the ranks of its mesh on each rank's share (the
    # grind stays replicated).
    executor = getattr(stark, "sharded_executor", None)
    sharded = executor is not None and executor.phases_supported(air)
    ce_dom = air.ce_domain()
    halo = trace_halo(air)

    # -- phase 1: base trace commit (src/prover.rs:45-55) --------------------
    with timer("Base trace commitment"):
        assert air.config.NUM_BASE_COLUMNS == base_trace.num_cols
        base_polys = None
        if sharded:
            base_lde, base_tree = executor.lde_commit(
                base_trace.values, trace_dom, lde_dom, ce_dom, halo)
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
            if sharded:
                ext_lde, ext_tree = executor.lde_commit(
                    ext_trace.values, trace_dom, lde_dom, ce_dom, halo)
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
        composition_coeffs = channel.public_coin.draw_multiple(
            air.num_composition_constraint_coeffs())
        if sharded:
            # this rank's block of the CE domain with its halo (from the
            # commits' exchange); the blocks gathered: the one CE-sized
            # vector a rank holds whole
            comp_evals = executor.gather(eval_composition_block(
                air, composition_coeffs, challenges, hints,
                executor.ce_points(ce_dom, dev), base_lde.take_ce(),
                None if ext_lde is None else ext_lde.take_ce()))
        else:
            r = lde_dom.size // ce_dom.size
            base_ce = base_lde if r == 1 else base_polys.evaluate(ce_dom)
            ext_ce = None
            if ext_lde is not None:
                ext_ce = (ext_lde if r == 1
                          else ext_polys.evaluate(ce_dom)).values
            comp_evals = eval_composition(
                air, composition_coeffs, challenges, hints,
                ce_dom.elements(dev), base_ce.values, ext_ce)

    with timer("Composition trace commitment"):
        cb = air.ce_blowup_factor
        coeffs = ce_dom.ifft(comp_evals)
        # split into cb interleaved columns: col_i[j] = coeffs[j*cb + i]
        if fq_is_ext:
            comp_polys = MatrixExt3(coeffs.reshape(3, air.trace_len, cb)
                                    .permute(2, 0, 1).contiguous())
        else:
            comp_polys = Matrix(coeffs.reshape(air.trace_len, cb).T.contiguous())
        del coeffs, comp_evals
        if sharded:
            comp_lde, comp_tree = executor.commit_coeffs(comp_polys.values,
                                                         lde_dom)
        elif fq_is_ext:
            comp_lde = comp_polys.evaluate(lde_dom)
            comp_tree = merkle.commit_matrix_ext3(comp_lde.values, hashfn)
        else:
            comp_lde = comp_polys.evaluate(lde_dom)
            comp_tree = merkle.commit_matrix(comp_lde.values, hashfn)
        del comp_polys
        channel.commit_composition_trace(comp_tree.root())

    # -- phase 4: DEEP composition (src/prover.rs:133-149) -------------------
    with timer("DEEP composition"):
        z = channel.get_ood_point()
        composer = (ShardedDeepPolyComposer(executor.mesh, air, z, base_lde,
                                            comp_lde, ext_lde)
                    if sharded else
                    DeepPolyComposer(air, z, base_lde, comp_lde, ext_lde))
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
        if sharded:  # deep_lde: this rank's rows j = rank (mod d)
            fri_prover.build_layers(channel, deep_lde, cyclic=True)
        else:
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
