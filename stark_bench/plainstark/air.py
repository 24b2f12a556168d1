"""AIR: options, challenges/hints containers, and the Air 'constraint
compiler' (reference: src/lib.rs:86-132, src/challenges.rs, src/hints.rs,
src/air.rs)."""

from __future__ import annotations

import inspect
from dataclasses import dataclass

from .constraints import (
    CompositionCoeff,
    CompositionConstraint,
    Constraint,
    expr_sum,
)
from .expression import Challenge, Expr
from .fields.scalar import GENERATOR
from .ntt import Domain
from . import serde


@dataclass(frozen=True)
class ProofOptions:
    """Proof parameters (src/lib.rs:86-122); all fields are u8-bounded."""

    num_queries: int
    lde_blowup_factor: int
    grinding_factor: int
    fri_folding_factor: int
    fri_max_remainder_coeffs: int

    MIN_NUM_QUERIES = 1
    MAX_NUM_QUERIES = 128
    MAX_BLOWUP_FACTOR = 128
    MAX_GRINDING_FACTOR = 50

    def __post_init__(self):
        assert self.MIN_NUM_QUERIES <= self.num_queries <= self.MAX_NUM_QUERIES
        b = self.lde_blowup_factor
        assert b & (b - 1) == 0 and 1 <= b <= self.MAX_BLOWUP_FACTOR
        assert 0 <= self.grinding_factor <= self.MAX_GRINDING_FACTOR
        # FRI parameter shapes fri.py actually supports: fold by per-coset
        # iNTT of size N in {2,4,8,16} (src/fri.rs:526-567 structure), and a
        # power-of-two remainder coefficient bound (remainder = iNTT of the
        # final layer, a radix-2 domain).
        assert self.fri_folding_factor in (2, 4, 8, 16), (
            f"fri_folding_factor must be 2/4/8/16, got {self.fri_folding_factor}")
        r = self.fri_max_remainder_coeffs
        assert r >= 1 and r & (r - 1) == 0, (
            f"fri_max_remainder_coeffs must be a power of two, got {r}")

    def serialize(self, w: serde.Writer):
        w.u8(self.num_queries)
        w.u8(self.lde_blowup_factor)
        w.u8(self.grinding_factor)
        w.u8(self.fri_folding_factor)
        w.u8(self.fri_max_remainder_coeffs)

    @staticmethod
    def deserialize(r: serde.Reader) -> "ProofOptions":
        return ProofOptions(r.u8(), r.u8(), r.u8(), r.u8(), r.u8())

    def to_bytes(self) -> bytes:
        w = serde.Writer()
        self.serialize(w)
        return w.bytes()


class Challenges(list):
    """Verifier randomness, indexable by challenge id (src/challenges.rs)."""
    pass


class Hints(list):
    """Prover-supplied values bound into constraints (src/hints.rs).
    Constructed from (index, value) pairs that must densely cover 0..n."""

    @staticmethod
    def new(pairs) -> "Hints":
        pairs = sorted(pairs, key=lambda p: p[0])
        for expected, (i, _) in enumerate(pairs):
            assert i == expected, "hints must be densely indexed from 0"
        return Hints(v for _, v in pairs)


_CONSTRAINT_CACHE: dict = {}


class Air:
    """Caches the compiled constraint system for (config, trace_len, options).

    `config` is any object/class exposing:
      NUM_BASE_COLUMNS, NUM_EXTENSION_COLUMNS,
      fp_type / fq_type (scalar field classes),
      constraints(trace_len) -> list[Constraint],
      gen_hints(trace_len, public_inputs, challenges) -> Hints  (optional),
      domain_offset() -> int  (defaults to the field generator).
    """

    def __init__(self, config, trace_len: int, public_inputs, options: ProofOptions):
        self.config = config
        self.trace_len = trace_len
        self.public_inputs = public_inputs
        self.options = options

        # Constraint DAGs depend only on (config class, trace_len)
        # (AirConfig.constraints is a staticmethod of trace_len,
        # src/air.rs:32), so the symbolic build + CSE — tens of ms of host
        # Python per Air — is shared across proves/verifies.  Expression
        # DAGs are immutable after construction (graph_eval memoizes by id
        # without rewriting), so sharing is safe.
        ckey = (type(config) if not isinstance(config, type) else config,
                trace_len)
        hit = _CONSTRAINT_CACHE.get(ckey)
        if hit is None:
            # the cache is only sound while constraints() depends on
            # trace_len alone: hold every config to the staticmethod contract
            if not isinstance(inspect.getattr_static(ckey[0], "constraints"),
                              staticmethod):
                raise TypeError(f"{ckey[0].__qualname__}.constraints must be "
                                "a staticmethod of trace_len")
            constraints = config.constraints(trace_len)
            hit = (constraints, compose_constraints(trace_len, constraints))
            if len(_CONSTRAINT_CACHE) >= 32:
                _CONSTRAINT_CACHE.pop(next(iter(_CONSTRAINT_CACHE)))
            _CONSTRAINT_CACHE[ckey] = hit
        self.constraints, self.composition_constraint = hit
        self.ce_blowup_factor = self.composition_constraint.blowup_factor(trace_len)
        assert self.ce_blowup_factor <= options.lde_blowup_factor, (
            f"ce blowup {self.ce_blowup_factor} exceeds lde blowup "
            f"{options.lde_blowup_factor}")

    # -- domains ------------------------------------------------------------

    def domain_offset(self) -> int:
        fn = getattr(self.config, "domain_offset", None)
        return fn() if fn else GENERATOR

    def trace_domain(self) -> Domain:
        return Domain(self.trace_len)

    def lde_domain(self) -> Domain:
        return Domain(self.trace_len * self.options.lde_blowup_factor,
                      self.domain_offset())

    def ce_domain(self) -> Domain:
        return Domain(self.trace_len * self.ce_blowup_factor, self.domain_offset())

    def lde_blowup_factor(self) -> int:
        return self.options.lde_blowup_factor

    def composition_degree(self) -> int:
        return self.trace_len * self.ce_blowup_factor - 1

    # -- constraint metadata -------------------------------------------------

    def num_challenges(self) -> int:
        n = 0
        for c in self.constraints:
            for leaf in c.expr.leaves():
                if isinstance(leaf, Challenge):
                    n = max(n, leaf.index + 1)
        return n

    def num_composition_constraint_coeffs(self) -> int:
        return self.composition_constraint.num_composition_coeffs()

    def trace_arguments(self) -> list[tuple[int, int]]:
        """Sorted (column, offset) pairs across all constraints — matches the
        reference's BTreeSet<(usize, isize)> iteration order (src/air.rs:241-246)."""
        args = set()
        for c in self.constraints:
            args |= c.trace_arguments()
        return sorted(args)

    def gen_hints(self, challenges: Challenges) -> Hints:
        fn = getattr(self.config, "gen_hints", None)
        if fn is None:
            return Hints()
        return fn(self.trace_len, self.public_inputs, challenges)


def compose_constraints(trace_len: int, constraints: list[Constraint]) -> CompositionConstraint:
    """Combine constraints into ONE degree-adjusted expression with symbolic
    composition coefficients, then CSE (src/air.rs:50-82):

        sum_i  c_i * (x^adj_i * alpha_i + beta_i)

    where adj_i normalizes every term to composition_degree."""
    ce_blowup = max(c.blowup_factor(trace_len) for c in constraints)
    composition_degree = trace_len * ce_blowup - 1
    trace_degree = trace_len - 1
    xx = Expr.x()
    terms = []
    coeff_idx = 0
    for c in constraints:
        num, den = c.degree(trace_degree)
        evaluation_degree = num - den
        assert evaluation_degree <= composition_degree
        degree_adjustment = composition_degree - evaluation_degree
        alpha = Expr.from_leaf(CompositionCoeff(coeff_idx))
        beta = Expr.from_leaf(CompositionCoeff(coeff_idx + 1))
        coeff_idx += 2
        terms.append(c.expr * (xx.pow(degree_adjustment) * alpha + beta))
    return CompositionConstraint(expr_sum(terms).cse())
