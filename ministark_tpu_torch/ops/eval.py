"""Fused constraint evaluation: kernel E, generated from the AIR's
composition DAG, beside its plain PyTorch version.

Replaces ministark_tpu/ops/eval_pallas.py `_kernel_factory` (Fp branch).
The plan is the JAX package's (``eval_pallas.build_plan``): every Div(a, b)
becomes Mul(a, inverse input) with the batch inverse of each structurally
distinct denominator computed once outside; Trace(col, offset) leaves read
the CE-domain trace at (i + ce_blowup * offset) mod n, so no rolled copies
are made; X, periodic columns and inverses are input vectors; constants,
challenges, hints and composition coefficients sit in one scalar table, so
a new transcript reuses the compiled kernel.

``generate_source`` emits one translation unit: a ``GL_HD`` per-point
function of straight-line ``goldilocks.cuh`` code (every structurally
distinct node once, across all terms), a CUDA kernel that runs it with one
thread per CE point, and a host loop that g++ builds for the CPU tests.

Bound on the card: memory traffic for the fib AIR (one read of each of
~17 input vectors and one write per point, against ~100 field multiplies);
arithmetic for larger AIRs.  Design: all terms in one kernel, every input
read once per point, no intermediate leaves the registers.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..expression import (
    Challenge,
    CompositionCoeff,
    Constant,
    Expr,
    Hint,
    Periodic,
    Trace,
    X,
)
from ..fields import device as fd
from ..fields.scalar import Fp
from . import build

KERNEL = build.register(
    "eval", None,
    replaces="ministark_tpu/ops/eval_pallas.py:151 _kernel_factory")


@dataclass(frozen=True)
class _InvInput:
    """Leaf standing for a precomputed denominator-inverse input."""
    key: str

    def key_(self):
        return ("invinput", self.key)


def _leaf_key(leaf):
    if isinstance(leaf, _InvInput):
        return leaf.key_()
    return leaf.key()


def _rewrite_divs(expr: Expr, key_memo: dict) -> Expr:
    """Replace Div(a, b) with Mul(a, InvInput(structural_key(b)))."""
    memo = {}
    for node in expr.postorder_unique():
        nid = id(node)
        if node.op == "leaf":
            memo[nid] = node
        elif node.op == "neg":
            memo[nid] = Expr("neg", a=memo[id(node.a)])
        elif node.op == "pow":
            memo[nid] = Expr("pow", a=memo[id(node.a)], exp=node.exp)
        elif node.op == "div":
            inv_leaf = Expr.from_leaf(_InvInput(key_memo[id(node.b)]))
            memo[nid] = Expr("mul", a=memo[id(node.a)], b=inv_leaf)
        else:
            memo[nid] = Expr(node.op, a=memo[id(node.a)], b=memo[id(node.b)])
    return memo[id(expr)]


@dataclass
class Plan:
    terms: list            # rewritten term DAGs (no Div nodes)
    inv_keys: list         # denominator keys, in inverse-input order
    periodic: list         # Periodic leaves, in periodic-input order
    scalars: list          # ('const' | 'challenge' | 'hint' | 'ccoeff', v)
    slot: dict             # leaf key -> index into its input list / scalar table


def build_plan(terms, key_memo, num_base: int) -> Plan:
    """Assign every leaf to an input vector or a scalar-table slot."""
    rewritten = [_rewrite_divs(t, key_memo) for t in terms]
    plan = Plan(rewritten, [], [], [], {})
    for t in rewritten:
        for leaf in t.leaves():
            k = _leaf_key(leaf)
            if k in plan.slot:
                continue
            if isinstance(leaf, (X, Trace)):
                if isinstance(leaf, Trace) and leaf.column >= num_base:
                    raise NotImplementedError(
                        "extension-trace columns are not ported yet")
                plan.slot[k] = None
            elif isinstance(leaf, Periodic):
                plan.slot[k] = len(plan.periodic)
                plan.periodic.append(leaf)
            elif isinstance(leaf, _InvInput):
                plan.slot[k] = len(plan.inv_keys)
                plan.inv_keys.append(leaf.key)
            elif isinstance(leaf, Constant):
                plan.slot[k] = len(plan.scalars)
                plan.scalars.append(("const", leaf.value))
            elif isinstance(leaf, Challenge):
                plan.slot[k] = len(plan.scalars)
                plan.scalars.append(("challenge", leaf.index))
            elif isinstance(leaf, Hint):
                plan.slot[k] = len(plan.scalars)
                plan.scalars.append(("hint", leaf.index))
            elif isinstance(leaf, CompositionCoeff):
                plan.slot[k] = len(plan.scalars)
                plan.scalars.append(("ccoeff", leaf.index))
            else:
                raise TypeError(leaf)
    return plan


def scalar_table(plan: Plan, challenges, hints, composition_coeffs,
                 device) -> torch.Tensor:
    vals = []
    for kind, v in plan.scalars:
        if kind == "challenge":
            v = challenges[v]
        elif kind == "hint":
            v = hints[v]
        elif kind == "ccoeff":
            v = composition_coeffs[v]
        if not isinstance(v, (Fp, int)):
            raise NotImplementedError("extension-field scalars are not "
                                      "ported yet")
        vals.append(fd.to_i64(v.v if isinstance(v, Fp) else v))
    return torch.tensor(vals or [0], dtype=torch.int64, device=device)


def _node_key(node, memo):
    """Structural key of a rewritten node (CSE across terms)."""
    nid = id(node)
    if nid not in memo:
        if node.op == "leaf":
            memo[nid] = ("leaf", _leaf_key(node.leaf))
        elif node.op == "neg":
            memo[nid] = ("neg", _node_key(node.a, memo))
        elif node.op == "pow":
            memo[nid] = ("pow", _node_key(node.a, memo), node.exp)
        else:
            memo[nid] = (node.op, _node_key(node.a, memo),
                         _node_key(node.b, memo))
    return memo[nid]


def _walk(plan: Plan, leaf_fn, op_fn):
    """Evaluate every term once over a global structural memo; returns the
    per-term results in order."""
    keys, vals, outs = {}, {}, []
    for term in plan.terms:
        for node in term.postorder_unique():
            k = _node_key(node, keys)
            if k in vals:
                continue
            if node.op == "leaf":
                vals[k] = leaf_fn(node.leaf)
            elif node.op in ("neg", "pow"):
                vals[k] = op_fn(node.op, vals[_node_key(node.a, keys)],
                                None, node.exp)
            else:
                vals[k] = op_fn(node.op, vals[_node_key(node.a, keys)],
                                vals[_node_key(node.b, keys)], None)
        outs.append(vals[_node_key(term, keys)])
    return outs


def generate_source(plan: Plan, ce_blowup: int) -> str:
    """One translation unit evaluating the composition sum at a CE point."""
    lines = []
    counter = [0]

    def var(expr: str) -> str:
        name = f"v{counter[0]}"
        counter[0] += 1
        lines.append(f"    const uint64_t {name} = {expr};")
        return name

    def leaf_fn(leaf):
        if isinstance(leaf, X):
            return var("x[i]")
        if isinstance(leaf, Trace):
            shift = ce_blowup * leaf.offset
            return var(f"trace[{leaf.column}LL * n + ((i + ({shift}LL)) & mask)]")
        if isinstance(leaf, Periodic):
            return var(f"per[{plan.slot[_leaf_key(leaf)]}LL * n + i]")
        if isinstance(leaf, _InvInput):
            return var(f"inv[{plan.slot[_leaf_key(leaf)]}LL * n + i]")
        return var(f"s[{plan.slot[_leaf_key(leaf)]}]")

    def op_fn(op, a, b, exp):
        if op == "neg":
            return var(f"gl_neg({a})")
        if op == "pow":
            return var(f"gl_pow({a}, {exp}ULL)")
        return var(f"gl_{op}({a}, {b})")

    outs = _walk(plan, leaf_fn, op_fn)
    body = "\n".join(lines)
    acc = "\n".join(f"    acc = gl_add(acc, {o});" for o in outs)
    args = ("const uint64_t* __restrict__ trace, const uint64_t* __restrict__ x, "
            "const uint64_t* __restrict__ per, const uint64_t* __restrict__ inv, "
            "const uint64_t* __restrict__ s")
    return f"""// Generated by ministark_tpu_torch/ops/eval.py: the composition sum of
// {len(plan.terms)} constraint terms at one CE-domain point.
#include "goldilocks.cuh"

GL_HD uint64_t ms_eval_point(int64_t i, int64_t n, {args}) {{
    const int64_t mask = n - 1;
{body}
    uint64_t acc = 0;
{acc}
    return acc;
}}

#ifdef __CUDACC__
#include "launch.cuh"

__global__ void ms_eval_kernel({args}, uint64_t* __restrict__ out,
                               int64_t n) {{
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x)
        out[i] = ms_eval_point(i, n, trace, x, per, inv, s);
}}

MS_API int ms_eval({args}, uint64_t* out, int64_t n, cudaStream_t stream) {{
    if (n > 0)
        ms_eval_kernel<<<ms_blocks(n, 128), 128, 0, stream>>>(
            trace, x, per, inv, s, out, n);
    return ms_last_error();
}}
#else
extern "C" void ms_eval_host({args}, uint64_t* out, int64_t n) {{
    for (int64_t i = 0; i < n; i++)
        out[i] = ms_eval_point(i, n, trace, x, per, inv, s);
}}
#endif
"""


def eval_terms_plain(plan: Plan, ce_blowup: int, trace, x, per, inv, s):
    """The same sum in plain PyTorch over the whole CE domain."""
    n = x.shape[0]
    svals = s.tolist()

    def leaf_fn(leaf):
        if isinstance(leaf, X):
            return x
        if isinstance(leaf, Trace):
            return torch.roll(trace[leaf.column], -ce_blowup * leaf.offset)
        if isinstance(leaf, Periodic):
            return per[plan.slot[_leaf_key(leaf)]]
        if isinstance(leaf, _InvInput):
            return inv[plan.slot[_leaf_key(leaf)]]
        return torch.tensor(svals[plan.slot[_leaf_key(leaf)]],
                            dtype=torch.int64, device=x.device)

    def op_fn(op, a, b, exp):
        if op == "neg":
            return fd.neg(a)
        if op == "pow":
            return fd.pow_const(a, exp)
        return fd.add(a, b) if op == "add" else fd.mul(a, b)

    acc = torch.zeros(n, dtype=torch.int64, device=x.device)
    for t in _walk(plan, leaf_fn, op_fn):
        acc = fd.add(acc, t)
    return acc


def eval_terms(plan: Plan, source: str, ce_blowup: int, trace, x, per, inv,
               s):
    """Composition sum over the CE domain: trace (ncols, n), x (n,),
    per (nper, n), inv (ninv, n), s (S,) scalar table.  CUDA tensors launch
    the generated kernel; CPU tensors take the plain version."""
    if not x.is_cuda:
        return eval_terms_plain(plan, ce_blowup, trace, x, per, inv, s)
    n = x.shape[0]
    args = []
    for name, t in (("trace", trace), ("x", x), ("per", per), ("inv", inv),
                    ("s", s)):
        t = t.contiguous()
        build.check_cuda(t, name=name)
        args.append(t)
    out = torch.empty(n, dtype=torch.int64, device=x.device)
    KERNEL.launch("ms_eval", *[build.ptr(t) for t in args], build.ptr(out),
                  build.i64(n), source_text=source)
    return out
