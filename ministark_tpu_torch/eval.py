"""Constraint evaluation over the CE domain (Fp AIRs).

Mirrors ``ministark_tpu.eval``: every Div denominator is deduplicated
structurally and batch-inverted once (kernel A on the card), then the
composition sum is evaluated by the kernel generated from the AIR's DAG
(``ops/eval.py``, kernel E).  Denominators, like the periodic columns, are
evaluated with plain PyTorch field ops, as the JAX package leaves them to
XLA.  Field arithmetic is exact, so the values equal the JAX package's.
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
from .ops import eval as keval


def _structural_key(node, memo):
    """Structural hash key of a DAG node (for cross-term denominator dedup)."""
    nid = id(node)
    if nid in memo:
        return memo[nid]
    if node.op == "leaf":
        k = ("leaf", node.leaf.key())
    elif node.op in ("neg",):
        k = ("neg", _structural_key(node.a, memo))
    elif node.op == "pow":
        k = ("pow", _structural_key(node.a, memo), node.exp)
    else:
        k = (node.op, _structural_key(node.a, memo), _structural_key(node.b, memo))
    memo[nid] = k
    return k


def _top_sum_terms(expr):
    """Split the composition expression at its top-level Add spine: one term
    per constraint (air.compose_constraints builds a left-fold sum)."""
    terms = []
    stack = [expr]
    while stack:
        node = stack.pop()
        if node.op == "add":
            stack.append(node.a)
            stack.append(node.b)
        else:
            terms.append(node)
    return terms


def _scalar(v) -> int:
    if isinstance(v, Fq3):
        raise NotImplementedError("extension-field AIRs are not ported yet")
    return v.v if isinstance(v, Fp) else int(v)


def evaluate_dag(expr, ctx):
    """Plain PyTorch evaluation of a DAG over the CE domain.  Values are
    Python ints (constants, folded exactly) or int64 tensors.  ctx: x,
    trace (ncols, n), ce_blowup, trace_len, challenges, hints,
    composition_coeffs."""
    x = ctx["x"]

    def leaf_value(leaf):
        if isinstance(leaf, X):
            return x
        if isinstance(leaf, Constant):
            return _scalar(leaf.value)
        if isinstance(leaf, Challenge):
            return _scalar(ctx["challenges"][leaf.index])
        if isinstance(leaf, Hint):
            return _scalar(ctx["hints"][leaf.index])
        if isinstance(leaf, CompositionCoeff):
            return _scalar(ctx["composition_coeffs"][leaf.index])
        if isinstance(leaf, Trace):
            shift = ctx["ce_blowup"] * leaf.offset
            return torch.roll(ctx["trace"][leaf.column], -shift)
        if isinstance(leaf, Periodic):
            return periodic_values(leaf, x, ctx["trace_len"])
        raise TypeError(f"unknown leaf {leaf!r}")

    def as_tensor(v):
        return v if isinstance(v, torch.Tensor) else fd.full(x.shape, v, x.device)

    memo = {}
    for node in expr.postorder_unique():
        nid = id(node)
        if node.op == "leaf":
            memo[nid] = leaf_value(node.leaf)
            continue
        a = memo[id(node.a)]
        b = memo[id(node.b)] if node.op in ("add", "mul", "div") else None
        const = not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor)
        if const:
            fa = Fp(a)
            memo[nid] = {"neg": lambda: -fa,
                         "pow": lambda: fa ** node.exp,
                         "add": lambda: fa + Fp(b),
                         "mul": lambda: fa * Fp(b),
                         "div": lambda: fa / Fp(b)}[node.op]().v
        elif node.op == "neg":
            memo[nid] = fd.neg(a)
        elif node.op == "pow":
            memo[nid] = fd.pow_const(a, node.exp)
        elif node.op == "add":
            memo[nid] = fd.add(as_tensor(a), as_tensor(b))
        elif node.op == "mul":
            memo[nid] = fd.mul(as_tensor(a), as_tensor(b))
        elif node.op == "div":
            memo[nid] = fd.mul(as_tensor(a), fd.batch_inv(as_tensor(b)))
        else:
            raise ValueError(node.op)
    return as_tensor(memo[id(expr)])


def periodic_values(leaf, x, trace_len: int):
    """Periodic column at x: P_coeffs(x^(trace_len / interval_size))
    (src/verifier.rs:221-230 semantics)."""
    base = fd.pow_const(x, trace_len // leaf.interval_size)
    acc = fd.full(x.shape, _scalar(leaf.coeffs[-1]), x.device)
    for c in reversed(leaf.coeffs[:-1]):
        acc = fd.add(fd.mul(acc, base), _scalar(c))
    return acc


_PLAN_CACHE: dict = {}


def _plan_for(air):
    """(plan, generated source, denominators) per AIR config and shape."""
    cfg = air.config if isinstance(air.config, type) else type(air.config)
    key = (cfg.__qualname__, air.trace_len, air.ce_blowup_factor)
    if key not in _PLAN_CACHE:
        expr = air.composition_constraint.expr
        raw_memo, key_memo, denom_by_key = {}, {}, {}
        for node in expr.postorder_unique():
            if node.op == "div":
                k = repr(_structural_key(node.b, raw_memo))
                key_memo[id(node.b)] = k
                denom_by_key.setdefault(k, node.b)
        plan = keval.build_plan(_top_sum_terms(expr), key_memo,
                                air.config.NUM_BASE_COLUMNS)
        source = keval.generate_source(plan, air.ce_blowup_factor)
        _PLAN_CACHE[key] = (plan, source, denom_by_key)
    return _PLAN_CACHE[key]


def eval_composition(air, composition_coeffs, challenges, hints, x, trace):
    """The air's composition constraint over the CE domain.

    x: (n,) CE-domain points, natural order; trace: (ncols, n) CE-domain
    base-trace values.  Returns the (n,) composition evaluations."""
    if getattr(air.config, "fq_type", Fp) is not Fp:
        raise NotImplementedError("extension-field AIRs are not ported yet")
    plan, source, denom_by_key = _plan_for(air)
    ctx = {"x": x, "trace": trace, "ce_blowup": air.ce_blowup_factor,
           "trace_len": air.trace_len, "challenges": challenges,
           "hints": hints, "composition_coeffs": composition_coeffs}
    n = x.shape[0]
    empty = torch.zeros((0, n), dtype=torch.int64, device=x.device)
    inv = (torch.stack([fd.batch_inv(evaluate_dag(denom_by_key[k], ctx))
                        for k in plan.inv_keys]) if plan.inv_keys else empty)
    per = (torch.stack([periodic_values(p, x, air.trace_len)
                        for p in plan.periodic]) if plan.periodic else empty)
    s = keval.scalar_table(plan, challenges, hints, composition_coeffs,
                           x.device)
    return keval.eval_terms(plan, source, air.ce_blowup_factor, trace, x,
                            per, inv, s)
