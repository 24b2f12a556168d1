"""Constraint layer: wrappers and helpers over expression DAGs
(reference: src/constraints.rs)."""

from __future__ import annotations

from .expression import (
    Challenge,
    CompositionCoeff,
    Constant,
    Degree,
    Expr,
    Hint,
    Periodic,
    Trace,
    X,
    expr_sum,
    leaf_degree,
)


def ceil_power_of_two(v: int) -> int:
    """Round up to the nearest power of two (src/utils.rs:76-82)."""
    if v == 0:
        return 0
    return 1 << (v - 1).bit_length()


class Constraint:
    """A single AIR constraint (rational expression that must vanish on its
    domain). Wraps an Expr over AlgebraicItem leaves."""

    def __init__(self, expr: Expr):
        self.expr = expr

    def degree(self, trace_degree: int) -> tuple[int, int]:
        d = self.expr.degree(trace_degree)
        return (d.num, d.den)

    def blowup_factor(self, trace_len: int) -> int:
        """Power-of-2 blowup needed to evaluate this constraint over trace
        polys (src/constraints.rs:160-166, 340-347)."""
        trace_degree = trace_len - 1
        num, den = self.degree(trace_degree)
        degree = max(num - den, 0)
        return ceil_power_of_two(degree) // trace_degree

    def trace_arguments(self) -> set[tuple[int, int]]:
        args = set()
        self.expr.traverse_leaves(
            lambda leaf: args.add((leaf.column, leaf.offset))
            if isinstance(leaf, Trace) else None)
        return args

    def check(self, leaf_fn):
        """0/0-tolerant evaluation (the prover's trace sanity heuristic,
        src/constraints.rs:172-249 / OpenZKP). Returns the value, or None if
        a nonzero/0 division makes the result undefined."""

        class Checked:
            __slots__ = ("v",)

            def __init__(self, v):
                self.v = v  # field value or None

            def __neg__(self):
                return Checked(None if self.v is None else -self.v)

            def __add__(self, o):
                if self.v is None or o.v is None:
                    return Checked(None)
                return Checked(self.v + o.v)

            def __mul__(self, o):
                a, b = self.v, o.v
                if a is None and b is None:
                    return Checked(None)
                if a is None or b is None:
                    x = a if a is not None else b
                    return Checked(x if x.is_zero() else None)
                return Checked(a * b)

            def __truediv__(self, o):
                a, b = self.v, o.v
                if a is not None and b is not None:
                    if b.is_zero() and a.is_zero():
                        return Checked(_zero_like(a))
                    if b.is_zero():
                        return Checked(None)
                    return Checked(a / b)
                if a is not None or b is not None:
                    x = a if a is not None else b
                    return Checked(_zero_like(x) if x.is_zero() else None)
                return Checked(None)

            def __pow__(self, e):
                return Checked(None if self.v is None else self.v ** e)

        res = self.expr.graph_eval(lambda leaf: Checked(leaf_fn(leaf)))
        return res.v


def _zero_like(x):
    return type(x).zero()


class CompositionConstraint:
    """The single combined constraint with symbolic composition coefficients
    (src/constraints.rs:306-328)."""

    def __init__(self, expr: Expr):
        self.expr = expr

    def degree(self, trace_degree: int) -> tuple[int, int]:
        d = self.expr.graph_eval(lambda leaf: _composition_leaf_degree(leaf, trace_degree))
        return (d.num, d.den)

    def blowup_factor(self, trace_len: int) -> int:
        trace_degree = trace_len - 1
        num, den = self.degree(trace_degree)
        degree = max(num - den, 0)
        return ceil_power_of_two(degree) // trace_degree

    def num_composition_coeffs(self) -> int:
        n = 0
        for leaf in self.expr.leaves():
            if isinstance(leaf, CompositionCoeff):
                n = max(n, leaf.index + 1)
        return n


def _composition_leaf_degree(leaf, trace_degree: int) -> Degree:
    if isinstance(leaf, CompositionCoeff):
        return Degree(0, 0)
    return leaf_degree(leaf, trace_degree)


# ---------------------------------------------------------------------------
# DSL helpers (src/constraints.rs:349-405)
# ---------------------------------------------------------------------------

def curr(column: int) -> Expr:
    return Expr.from_leaf(Trace(column, 0))


def next(column: int) -> Expr:
    return Expr.from_leaf(Trace(column, 1))


def trace_offset(column: int, offset: int) -> Expr:
    return Expr.from_leaf(Trace(column, offset))


def challenge(index: int) -> Expr:
    return Expr.from_leaf(Challenge(index))


def hint(index: int) -> Expr:
    return Expr.from_leaf(Hint(index))


def constant(value) -> Expr:
    return Expr.constant(value)


def x() -> Expr:
    return Expr.x()


def periodic(coeffs, interval_size: int) -> Expr:
    return Expr.from_leaf(Periodic(tuple(coeffs), interval_size))


__all__ = [
    "Constraint",
    "CompositionConstraint",
    "ceil_power_of_two",
    "curr",
    "next",
    "trace_offset",
    "challenge",
    "hint",
    "constant",
    "x",
    "periodic",
    "Challenge",
    "CompositionCoeff",
    "Constant",
    "Expr",
    "Hint",
    "Periodic",
    "Trace",
    "X",
    "expr_sum",
]
