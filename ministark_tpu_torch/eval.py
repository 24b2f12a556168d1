"""Constraint evaluation over the CE domain (Fp and Fq3 AIRs).

Mirrors ``ministark_tpu.eval``: every Div denominator is deduplicated
structurally and batch-inverted once (kernel A on the card: in Fp when the
denominator is Fp, in Fq3 when it is Fq3), then the composition sum is
evaluated by the kernels generated from the AIR's DAG (``ops/eval.py``,
kernel E).  Denominators, like the periodic columns, are evaluated with
plain PyTorch field ops, as the JAX package leaves them to XLA.  Field
arithmetic is exact, so the values equal the JAX package's.

``eval_composition_block`` evaluates a contiguous block of the CE domain
(the multi-process prover's, ``parallel``) from trace columns that hold
the block's points and the halo after them (``trace_halo``): the block's
x gives the periodic columns, the denominators and the shared powers of X
the values the whole domain's x gives at those points.
"""

from __future__ import annotations

import torch

from .air import compose_constraints
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


def _fq_is_ext(air) -> bool:
    return getattr(air.config, "fq_type", Fp) is Fq3


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


def evaluate_dag(expr, ctx):
    """Plain PyTorch evaluation of a DAG over the CE domain -> (kind,
    tensor): (n,) for "fp", (3, n) for "fq".  Constant subtrees fold on the
    host.  ctx: x, trace (nbase, n), ext (next, 3, n), ce_blowup, trace_len,
    challenges, hints, composition_coeffs, and block: where true, trace and
    ext hold the n points of x and a halo after them, read with no wrap."""
    x = ctx["x"]
    nb = ctx["trace"].shape[0]
    n = x.shape[0]

    def shifted(col, shift):
        if ctx.get("block"):
            return col[..., -shift:n - shift]
        return torch.roll(col, shift, dims=-1)

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
            shift = -ctx["ce_blowup"] * leaf.offset
            if leaf.column < nb:
                return "fp", shifted(ctx["trace"][leaf.column], shift)
            return "fq", shifted(ctx["ext"][leaf.column - nb], shift)
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

    memo = {}
    for node in expr.postorder_unique():
        nid = id(node)
        if node.op == "leaf":
            memo[nid] = leaf_value(node.leaf)
            continue
        a = memo[id(node.a)]
        b = memo[id(node.b)] if node.op in ("add", "mul", "div") else None
        if not isinstance(a, tuple) and not isinstance(b, tuple):
            memo[nid] = _host_op(node.op, a, b, node.exp)
        elif node.op == "div":
            kind, v = tagged(b)
            inv = fd.batch_inv(v) if kind == "fp" else fd.ext3_batch_inv(v)
            memo[nid] = keval.tagged_op("mul", tagged(a), (kind, inv), None)
        else:
            memo[nid] = keval.tagged_op(node.op, tagged(a),
                                        None if b is None else tagged(b),
                                        node.exp)
    kind, v = tagged(memo[id(expr)])
    return kind, v.expand(*v.shape[:-1], n) if v.shape[-1:] != (n,) else v


def periodic_values(leaf, x, trace_len: int):
    """Periodic column at x: P_coeffs(x^(trace_len / interval_size))
    (src/verifier.rs:221-230 semantics)."""
    base = fd.pow_const(x, trace_len // leaf.interval_size)
    acc = fd.full(x.shape, _scalar(leaf.coeffs[-1]), x.device)
    for c in reversed(leaf.coeffs[:-1]):
        acc = fd.add(fd.mul(acc, base), _scalar(c))
    return acc


def _x_pow_exps(terms) -> list[int]:
    """The exponents of the terms' powers of X, in walk order."""
    return [node.exp for t in terms for node in t.postorder_unique()
            if node.op == "pow" and node.a.op == "leaf"
            and isinstance(node.a.leaf, X)]


_PLAN_CACHE: dict = {}


def _plan_for(air):
    """(plan, generated source, denominators) per AIR config and shape."""
    cfg = air.config if isinstance(air.config, type) else type(air.config)
    key = (cfg.__qualname__, air.trace_len, air.ce_blowup_factor)
    if key not in _PLAN_CACHE:
        expr = air.composition_constraint.expr
        nb, ext = air.config.NUM_BASE_COLUMNS, _fq_is_ext(air)
        raw_memo, key_memo, denom_by_key = {}, {}, {}
        for node in expr.postorder_unique():
            if node.op == "div":
                k = repr(_structural_key(node.b, raw_memo))
                key_memo[id(node.b)] = k
                denom_by_key.setdefault(k, node.b)
        inv_kind = {k: keval.expr_kind(d, nb, ext)
                    for k, d in denom_by_key.items()}
        terms = _top_sum_terms(expr)
        # the powers of X as linear functions of N: the same AIR at 2N
        n2 = 2 * air.trace_len
        twice = compose_constraints(n2, air.config.constraints(n2)).expr
        period = max((p.interval_size for p in expr.leaves()
                      if isinstance(p, Periodic)), default=1)
        keys = keval.power_keys(_x_pow_exps(terms),
                                _x_pow_exps(_top_sum_terms(twice)),
                                air.trace_len, period)
        plan = keval.build_plan(terms, key_memo, nb, ext, inv_kind,
                                air.trace_len, keys)
        source = keval.generate_source(plan, air.ce_blowup_factor)
        _PLAN_CACHE[key] = (plan, source, denom_by_key)
    return _PLAN_CACHE[key]


def trace_halo(air) -> int | None:
    """CE points a block reads past its end: ce_blowup times the largest
    trace offset of the air's constraints, or None where one offset is
    negative (a block would read before its start)."""
    offsets = [off for _col, off in air.trace_arguments()] or [0]
    if min(offsets) < 0:
        return None
    return air.ce_blowup_factor * max(offsets)


def eval_composition(air, composition_coeffs, challenges, hints, x, trace,
                     ext=None):
    """The air's composition constraint over the CE domain.

    x: (n,) CE-domain points, natural order; trace: (nbase, n) CE-domain
    base-trace values; ext: (next, 3, n) extension-trace values, or None.
    Returns the (n,) composition evaluations of an Fp AIR, (3, n) of an
    Fq3 one."""
    return _eval(air, composition_coeffs, challenges, hints, x, trace, ext,
                 False)


def eval_composition_block(air, composition_coeffs, challenges, hints, x,
                           trace, ext=None):
    """The composition constraint at a contiguous block of m CE points.

    x: (m,) the block's points; trace: (nbase, m + h) the base-trace values
    at the block's points and at the h = ``trace_halo(air)`` points after
    it (wrapping round the domain); ext: (next, 3, m + h) the same of the
    extension trace, or None.  Returns (m,) or (3, m): the slice of
    ``eval_composition``'s values at the block."""
    return _eval(air, composition_coeffs, challenges, hints, x, trace, ext,
                 True)


def _eval(air, composition_coeffs, challenges, hints, x, trace, ext, block):
    plan, source, denom_by_key = _plan_for(air)
    n, dev = x.shape[0], x.device
    if ext is None:
        ext = torch.zeros((0, 3, trace.shape[-1]), dtype=torch.int64,
                          device=dev)
    ctx = {"x": x, "trace": trace, "ext": ext, "block": block,
           "ce_blowup": air.ce_blowup_factor, "trace_len": air.trace_len,
           "challenges": challenges, "hints": hints,
           "composition_coeffs": composition_coeffs}
    invs = {"fp": [], "fq": []}
    for k in plan.inv_keys:
        kind, d = evaluate_dag(denom_by_key[k], ctx)
        invs[kind].append(fd.batch_inv(d) if kind == "fp"
                          else fd.ext3_batch_inv(d))
    inv = (torch.stack(invs["fp"]) if invs["fp"]
           else torch.zeros((0, n), dtype=torch.int64, device=dev))
    inv3 = (torch.stack(invs["fq"]) if invs["fq"]
            else torch.zeros((0, 3, n), dtype=torch.int64, device=dev))
    per = (torch.stack([periodic_values(p, x, air.trace_len)
                        for p in plan.periodic]) if plan.periodic
           else torch.zeros((0, n), dtype=torch.int64, device=dev))
    s = keval.scalar_table(plan, challenges, hints, composition_coeffs, dev)
    run = keval.eval_terms_block if block else keval.eval_terms
    return run(plan, source, air.ce_blowup_factor, trace, ext, x, per, inv,
               inv3, s)
