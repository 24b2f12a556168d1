"""Symbolic expression DAGs for AIR constraints.

Python redesign of the reference's `Expr` (src/expression.rs:29-40, itself
adapted from OpenZKP's RationalExpression): nodes are Leaf / Neg / Add / Mul /
Div / Pow(usize).  Sub is sugar for ``a + (-b)`` (same as the reference's
operator impls), so DAG shapes match.

Differences from the Rust version, deliberate:

* nodes are plain Python objects; sharing is by object identity;
* ``cse()`` (the analogue of ``reuse_shared_nodes``, src/expression.rs:183-357)
  hash-conses on exact structural tuples instead of 64-bit hashes — no
  collision risk;
* ``graph_eval`` memoizes by node identity instead of mutating nodes in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------

class AlgebraicItem:
    """Namespace for leaf constructors (src/constraints.rs:21-28)."""
    pass


@dataclass(frozen=True)
class X(AlgebraicItem):
    """The evaluation-domain point."""

    def key(self):
        return ("x",)


@dataclass(frozen=True)
class Constant(AlgebraicItem):
    value: Any  # scalar Fp or Fq3

    def key(self):
        return ("const", type(self.value).__name__, self.value)


@dataclass(frozen=True)
class Challenge(AlgebraicItem):
    index: int

    def key(self):
        return ("challenge", self.index)


@dataclass(frozen=True)
class Hint(AlgebraicItem):
    index: int

    def key(self):
        return ("hint", self.index)


@dataclass(frozen=True)
class Trace(AlgebraicItem):
    column: int
    offset: int = 0

    def key(self):
        return ("trace", self.column, self.offset)


@dataclass(frozen=True)
class Periodic(AlgebraicItem):
    """Periodic column: `coeffs` (power-of-two count) repeating every
    `interval_size` rows (src/constraints.rs:106-142)."""
    coeffs: tuple
    interval_size: int

    def __post_init__(self):
        n = len(self.coeffs)
        assert n & (n - 1) == 0
        assert self.interval_size & (self.interval_size - 1) == 0
        assert n <= self.interval_size

    def key(self):
        return ("periodic", self.coeffs, self.interval_size)

    def degree(self, trace_degree: int):
        trace_len = trace_degree + 1
        return Degree((len(self.coeffs) - 1) * (trace_len // self.interval_size), 0)


@dataclass(frozen=True)
class CompositionCoeff:
    """Symbolic composition-coefficient leaf (src/constraints.rs:283-287)."""
    index: int

    def key(self):
        return ("ccoeff", self.index)


def leaf_degree(leaf, trace_degree: int) -> "Degree":
    if isinstance(leaf, (Constant, Challenge, Hint, CompositionCoeff)):
        return Degree(0, 0)
    if isinstance(leaf, Trace):
        return Degree(trace_degree, 0)
    if isinstance(leaf, Periodic):
        return leaf.degree(trace_degree)
    if isinstance(leaf, X):
        return Degree(1, 0)
    raise TypeError(f"unknown leaf {leaf!r}")


# ---------------------------------------------------------------------------
# degree algebra (src/constraints.rs:407-455)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Degree:
    """(numerator_degree, denominator_degree) upper bound."""
    num: int
    den: int

    def __add__(self, o):
        return Degree(max(self.num + o.den, o.num + self.den), self.den + o.den)

    def __mul__(self, o):
        return Degree(self.num + o.num, self.den + o.den)

    def __truediv__(self, o):
        return Degree(self.num + o.den, self.den + o.num)

    def __neg__(self):
        return self

    def pow(self, e: int):
        return Degree(self.num * e, self.den * e)

    def __pow__(self, e: int):
        return self.pow(e)


# ---------------------------------------------------------------------------
# expression nodes
# ---------------------------------------------------------------------------

class Expr:
    __slots__ = ("op", "a", "b", "leaf", "exp")

    def __init__(self, op, a=None, b=None, leaf=None, exp=None):
        self.op = op  # 'leaf' | 'neg' | 'add' | 'mul' | 'div' | 'pow'
        self.a = a
        self.b = b
        self.leaf = leaf
        self.exp = exp

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_leaf(leaf) -> "Expr":
        return Expr("leaf", leaf=leaf)

    @staticmethod
    def constant(value) -> "Expr":
        return Expr.from_leaf(Constant(value))

    @staticmethod
    def x() -> "Expr":
        return Expr.from_leaf(X())

    # -- operators ----------------------------------------------------------

    @staticmethod
    def _wrap(o) -> "Expr":
        if isinstance(o, Expr):
            return o
        if isinstance(o, AlgebraicItem) or isinstance(o, CompositionCoeff):
            return Expr.from_leaf(o)
        return Expr.constant(o)

    def __add__(self, o):
        return Expr("add", a=self, b=Expr._wrap(o))

    def __radd__(self, o):
        return Expr("add", a=Expr._wrap(o), b=self)

    def __sub__(self, o):
        return Expr("add", a=self, b=Expr("neg", a=Expr._wrap(o)))

    def __rsub__(self, o):
        return Expr("add", a=Expr._wrap(o), b=Expr("neg", a=self))

    def __mul__(self, o):
        return Expr("mul", a=self, b=Expr._wrap(o))

    def __rmul__(self, o):
        return Expr("mul", a=Expr._wrap(o), b=self)

    def __truediv__(self, o):
        return Expr("div", a=self, b=Expr._wrap(o))

    def __rtruediv__(self, o):
        return Expr("div", a=Expr._wrap(o), b=self)

    def __neg__(self):
        return Expr("neg", a=self)

    def __pow__(self, e: int):
        assert isinstance(e, int) and e >= 0
        return Expr("pow", a=self, exp=e)

    def pow(self, e: int):
        return self.__pow__(e)

    # -- traversal ----------------------------------------------------------

    def children(self):
        if self.op == "leaf":
            return ()
        if self.op in ("neg", "pow"):
            return (self.a,)
        return (self.a, self.b)

    def postorder_unique(self):
        """Yield each distinct node once, children before parents
        (iterative to survive deep DAGs)."""
        seen = set()
        out = []
        stack = [(self, False)]
        while stack:
            node, expanded = stack.pop()
            if id(node) in seen:
                continue
            if expanded:
                seen.add(id(node))
                out.append(node)
            else:
                stack.append((node, True))
                for c in node.children():
                    if id(c) not in seen:
                        stack.append((c, False))
        return out

    def traverse_leaves(self, f: Callable):
        for node in self.postorder_unique():
            if node.op == "leaf":
                f(node.leaf)

    def leaves(self):
        return [n.leaf for n in self.postorder_unique() if n.op == "leaf"]

    # -- evaluation ---------------------------------------------------------

    def graph_eval(self, leaf_fn: Callable):
        """Memoized bottom-up evaluation (src/expression.rs:384-429).

        `leaf_fn(leaf)` supplies leaf values; shared nodes evaluate once.
        Values must support + * / unary- and .pow(int) or ** int."""
        memo = {}
        for node in self.postorder_unique():
            nid = id(node)
            if node.op == "leaf":
                memo[nid] = leaf_fn(node.leaf)
            elif node.op == "neg":
                memo[nid] = -memo[id(node.a)]
            elif node.op == "add":
                memo[nid] = memo[id(node.a)] + memo[id(node.b)]
            elif node.op == "mul":
                memo[nid] = memo[id(node.a)] * memo[id(node.b)]
            elif node.op == "div":
                memo[nid] = memo[id(node.a)] / memo[id(node.b)]
            elif node.op == "pow":
                v = memo[id(node.a)]
                memo[nid] = v ** node.exp
            else:
                raise ValueError(node.op)
        return memo[id(self)]


    def cse(self) -> "Expr":
        """Hash-consing: structurally identical subtrees become one shared
        node (analogue of reuse_shared_nodes, src/expression.rs:183-357)."""
        by_key = {}
        node_key = {}

        def intern(key, build):
            if key in by_key:
                return by_key[key]
            n = build()
            by_key[key] = n
            return n

        memo = {}
        for node in self.postorder_unique():
            nid = id(node)
            if node.op == "leaf":
                key = ("leaf", node.leaf.key())
                memo[nid] = intern(key, lambda: Expr.from_leaf(node.leaf))
            elif node.op == "neg":
                ka = node_key[id(memo[id(node.a)])]
                key = ("neg", ka)
                memo[nid] = intern(key, lambda: Expr("neg", a=memo[id(node.a)]))
            elif node.op == "pow":
                ka = node_key[id(memo[id(node.a)])]
                key = ("pow", ka, node.exp)
                memo[nid] = intern(key, lambda: Expr("pow", a=memo[id(node.a)], exp=node.exp))
            else:
                ka = node_key[id(memo[id(node.a)])]
                kb = node_key[id(memo[id(node.b)])]
                key = (node.op, ka, kb)
                memo[nid] = intern(
                    key, lambda: Expr(node.op, a=memo[id(node.a)], b=memo[id(node.b)]))
            node_key[id(memo[nid])] = key
        return memo[id(self)]

    def num_nodes(self) -> int:
        return len(self.postorder_unique())

    def degree(self, trace_degree: int) -> Degree:
        return self.graph_eval(lambda leaf: leaf_degree(leaf, trace_degree))

    def __repr__(self):
        if self.op == "leaf":
            return f"Expr({self.leaf!r})"
        return f"Expr<{self.op}, {self.num_nodes()} nodes>"


def expr_sum(exprs) -> Expr:
    """Left fold sum matching the reference's Sum impl (zero if empty)."""
    exprs = list(exprs)
    if not exprs:
        from .fields.scalar import Fp
        return Expr.constant(Fp(0))
    acc = exprs[0]
    for e in exprs[1:]:
        acc = acc + e
    return acc
