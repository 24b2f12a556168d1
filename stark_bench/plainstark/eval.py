"""Constraint evaluation over the CE domain (Fp and Fq3 AIRs), in plain
PyTorch straight from the AIR's composition DAG.

The composition expression is evaluated node by node, a block of CE
points at a time: a Trace(col, offset) leaf reads the CE-domain column at
(i + ce_blowup * offset) mod n, X and the periodic columns are computed
at the block's points, constant subtrees fold on the host, and every Div
multiplies by the Fermat inverse of its denominator.  Field arithmetic is
exact, so the values are those of any other order of evaluation.
"""

from __future__ import annotations

import torch

from .expression import (
    Challenge,
    CompositionCoeff,
    Constant,
    Hint,
    Periodic,
    Trace,
    X,
)
from .fields import device as fd
from .fields.scalar import Fp, Fq3

# bytes the live values of one block may take, and the words of the
# temporaries of one operation counted for each live value
BLOCK_BYTES = 12 << 30
TEMP_FACTOR = 2


def _scalar(v) -> int:
    return v.v if isinstance(v, Fp) else int(v)


def _host_op(op, a, b, exp):
    """A DAG operation on host scalars (Fp, or Fq3 when one operand is)."""
    if op == "neg":
        return -a
    if op == "pow":
        return a ** exp
    if isinstance(a, Fq3) or isinstance(b, Fq3):
        a, b = Fq3.from_base(a), Fq3.from_base(b)
    return {"add": lambda: a + b, "mul": lambda: a * b,
            "div": lambda: a / b}[op]()


def _promote(v: torch.Tensor) -> torch.Tensor:
    """An Fp tensor ((n,) or 0-d) as Fq3 ((3, n) or (3, 1))."""
    return fd.ext3_from_base(v.reshape(-1))


def _tagged_op(op: str, a, b, exp):
    """One DAG operation on (kind, tensor) values: a value is Fq3 ("fq",
    (3, n) or (3, 1)) or Fp ("fp", (n,) or 0-d); an operation is Fq3 iff
    one operand is."""
    kind, v = a
    if op == "neg":
        return kind, fd.neg(v)
    if op == "pow":
        return kind, (fd.pow_const(v, exp) if kind == "fp"
                      else fd.ext3_pow_const(v, exp))
    kb, w = b
    if kind == kb == "fp":
        return "fp", (fd.add(v, w) if op == "add" else fd.mul(v, w))
    if op == "add":
        return "fq", fd.add(v if kind == "fq" else _promote(v),
                            w if kb == "fq" else _promote(w))
    if kind == kb:
        return "fq", fd.ext3_mul(v, w)
    if kind == "fp":
        v, w = w, v
    return "fq", fd.ext3_mul_base(v, w.reshape(-1))


def periodic_values(leaf, x, trace_len: int):
    """Periodic column at x: P_coeffs(x^(trace_len / interval_size))
    (src/verifier.rs:221-230 semantics)."""
    base = fd.pow_const(x, trace_len // leaf.interval_size)
    acc = fd.full(x.shape, _scalar(leaf.coeffs[-1]), x.device)
    for c in reversed(leaf.coeffs[:-1]):
        acc = fd.add(fd.mul(acc, base), _scalar(c))
    return acc


class _Schedule:
    """The DAG's structurally distinct nodes in evaluation order (a node
    that repeats another's structure is evaluated once), each with its
    children's keys and the step after which its value is no longer
    needed."""

    def __init__(self, expr):
        key_of, self.nodes, self.children = {}, {}, {}
        order = []
        for node in expr.postorder_unique():
            if node.op == "leaf":
                k = ("leaf", node.leaf.key())
                kids = ()
            else:
                kids = (key_of[id(node.a)],) + (
                    (key_of[id(node.b)],) if node.op in ("add", "mul", "div")
                    else ())
                k = (node.op, node.exp if node.op == "pow" else None) + kids
            key_of[id(node)] = k
            if k not in self.nodes:
                self.nodes[k] = node
                self.children[k] = kids
                order.append(k)
        self.order = order
        self.root = key_of[id(expr)]
        self.last_use = {}
        for i, k in enumerate(order):
            for c in self.children[k]:
                self.last_use[c] = i
        # the most values alive at once, as if every node were a tensor
        alive, width = set(), 0
        for i, k in enumerate(order):
            alive.add(k)
            width = max(width, len(alive))
            alive -= {c for c in self.children[k] if self.last_use[c] == i}
        self.width = width


def _evaluate_block(sched, ctx, pos):
    """The DAG at CE points `pos` -> (kind, tensor)."""
    x = ctx["x"].index_select(0, pos)
    n = ctx["x"].shape[0]
    nb = ctx["trace"].shape[0]

    def leaf_value(leaf):
        if isinstance(leaf, X):
            return "fp", x
        if isinstance(leaf, Constant):
            return leaf.value
        if isinstance(leaf, Challenge):
            return ctx["challenges"][leaf.index]
        if isinstance(leaf, Hint):
            return ctx["hints"][leaf.index]
        if isinstance(leaf, CompositionCoeff):
            return ctx["composition_coeffs"][leaf.index]
        if isinstance(leaf, Trace):
            idx = (pos + ctx["ce_blowup"] * leaf.offset) % n
            if leaf.column < nb:
                return "fp", ctx["trace"][leaf.column].index_select(0, idx)
            return "fq", ctx["ext"][leaf.column - nb].index_select(-1, idx)
        if isinstance(leaf, Periodic):
            return "fp", periodic_values(leaf, x, ctx["trace_len"])
        raise TypeError(f"unknown leaf {leaf!r}")

    def tagged(v):
        if isinstance(v, tuple):
            return v
        if isinstance(v, Fq3):
            return "fq", fd.ext3_scalar(v, x.device)
        return "fp", torch.tensor(fd.to_i64(_scalar(v)), dtype=torch.int64,
                                  device=x.device)

    memo, inverses = {}, {}
    for i, k in enumerate(sched.order):
        node = sched.nodes[k]
        if node.op == "leaf":
            memo[k] = leaf_value(node.leaf)
        else:
            kids = sched.children[k]
            a = memo[kids[0]]
            b = memo[kids[1]] if len(kids) > 1 else None
            if not isinstance(a, tuple) and not isinstance(b, tuple):
                memo[k] = _host_op(node.op, a, b, node.exp)
            elif node.op == "div":
                if kids[1] not in inverses:  # one inverse a denominator
                    kind, v = tagged(b)
                    inverses[kids[1]] = (kind, fd.batch_inv(v) if kind == "fp"
                                         else fd.ext3_batch_inv(v))
                memo[k] = _tagged_op("mul", tagged(a), inverses[kids[1]],
                                     None)
            else:
                memo[k] = _tagged_op(node.op, tagged(a),
                                     None if b is None else tagged(b),
                                     node.exp)
            for c in kids:
                if sched.last_use[c] == i and c != sched.root:
                    del memo[c]
    kind, v = tagged(memo[sched.root])
    m = pos.shape[0]
    return kind, v.expand(*v.shape[:-1], m) if v.shape[-1:] != (m,) else v


def eval_composition(air, composition_coeffs, challenges, hints, x, trace,
                     ext=None):
    """The air's composition constraint over the CE domain.

    x: (n,) CE-domain points, natural order; trace: (nbase, n) CE-domain
    base-trace values; ext: (next, 3, n) extension-trace values, or None.
    Returns the (n,) composition evaluations of an Fp AIR, (3, n) of an
    Fq3 one."""
    sched = _Schedule(air.composition_constraint.expr)
    n, dev = x.shape[0], x.device
    ext_air = getattr(air.config, "fq_type", Fp) is Fq3
    per_point = 3 * 8 * TEMP_FACTOR * sched.width
    block = min(n, 1 << max(10, (BLOCK_BYTES // per_point).bit_length() - 1))
    ctx = {"x": x, "trace": trace, "ext": ext, "ce_blowup":
           air.ce_blowup_factor, "trace_len": air.trace_len,
           "challenges": challenges, "hints": hints,
           "composition_coeffs": composition_coeffs}
    out = torch.empty((3, n) if ext_air else (n,), dtype=torch.int64,
                      device=dev)
    for a in range(0, n, block):
        pos = torch.arange(a, min(a + block, n), device=dev)
        kind, v = _evaluate_block(sched, ctx, pos)
        if ext_air and kind == "fp":
            v = _promote(v)
        out[..., a:a + pos.shape[0]] = v
    return out
