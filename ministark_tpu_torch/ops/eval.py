"""Fused constraint evaluation: kernel E, generated from the AIR's
composition DAG, beside its plain PyTorch version.

Replaces ministark_tpu/ops/eval_pallas.py `_kernel_factory`, both its Fp
branch (fib) and its Fq3 branch (brainfuck).  The plan is the JAX
package's (``eval_pallas.build_plan``): every Div(a, b) becomes
Mul(a, inverse input) with the batch inverse of each structurally distinct
denominator computed once outside; Trace(col, offset) leaves read the
CE-domain trace at (i + ce_blowup * offset) mod n, so no rolled copies are
made; X, periodic columns and inverses are input vectors; constants,
challenges, hints, composition coefficients and the exponents of Pow
nodes sit in one scalar table, so a new transcript or a new trace length
reuses the compiled kernel.

Every value has a kind, "fp" or "fq" (Fq3 when the AIR's Fq is the cubic
extension), by the JAX package's promotion rules: a trace leaf is Fq3 iff
its column is an extension column; challenges, hints and composition
coefficients are Fq3 scalars; X, periodic columns and base columns are Fp;
an inverse input has its denominator's kind; an operation is Fq3 iff one
operand is, and the Fp operand is promoted only there.

``generate_source`` emits one translation unit for the whole sum.  The
terms go GROUP_SIZE to a group (an Fp AIR's all in one), each group a
``GL_HD`` function of straight-line ``goldilocks.cuh`` code (every
structurally distinct node of the group once) and a kernel instantiation
of its own, so that each group's registers are its own.  From GROUPS_FROM
CE points a launch a group adds into the output; below, one launch runs
every group (a grid row a group) into parts that a second launch sums.  A
host loop lets g++ build the same code for the CPU tests.

Two entries share the source.  The whole-domain entry (``eval_terms``)
reads a trace column of n points at (i + s) & (n - 1).  The block entry
(``eval_terms_block``) evaluates m points of a contiguous block of the CE
domain from trace columns of m + halo points (the block's and the halo
after it, halo = ce_blowup * the largest offset): it reads (i + s) with
no wrap, the columns' stride ld = m + halo and the mask all ones, so the
same group functions serve both.  X, the periodic columns and the
inverses are the block's own m points.

Powers of X.  The degree adjustments x^e grow with the trace length N:
at N = 2^20 brainfuck's are e = a N + b with a < 16 and b < 12, or b =
N - 1; a periodic column of interval d adds multiples of N/d (the Rescue
AIR's e = N + N/16 + 5).  Each exponent is read as a linear function of
N from the AIR's composition at N and at 2N (``power_keys``), so that
its form, and with it the source, does not depend on N.  One chain of
log2 N squarings gives y = x^N (and, where some e = a N + N - 1, the
running product r = x^(N - 1), or where some e = a N + c N/d + b, r =
x^(N/d), the chain's value as it passes): before the launches a group, a
pass of its own computes it once a point; in the one launch each group
computes it (at 2^15 points that ran faster than a third launch).  Each
group then takes its powers as y^a x^b, y^a r or y^a r^c x^b by short
chains with a, b and c in the source; N itself sits in the scalar table,
so one compiled kernel serves every trace length.  Any other power keeps
a runtime exponent from the table (``gl_pow``).

Bound on the card: integer operations for both AIRs (chip_smoke.py's
model, which counts the powers of X once a point).  Design: every input
read once per point by each group that uses it, no intermediate leaves
the registers.
"""

from __future__ import annotations

from dataclasses import dataclass, field

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
from ..fields.scalar import Fp, Fq3
from . import build

KERNEL = build.register(
    "eval", None,
    replaces="ministark_tpu/ops/eval_pallas.py:151 _kernel_factory")
KERNEL_EXT3 = build.register(
    "eval_ext3", None,
    replaces="ministark_tpu/ops/eval_pallas.py:151 _kernel_factory (Fq3)")

GROUP_SIZE = 6  # Fq3 terms a group (eval_pallas.py:47)
# CE points from which kernel E runs a launch a group (see eval_launch)
GROUPS_FROM = 1 << 20


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


def leaf_kind(leaf, num_base: int, fq_is_ext: bool) -> str:
    """A source leaf's kind (the promotion rules above)."""
    if isinstance(leaf, Trace):
        return "fq" if fq_is_ext and leaf.column >= num_base else "fp"
    if isinstance(leaf, Constant):
        return "fq" if isinstance(leaf.value, Fq3) else "fp"
    if isinstance(leaf, (Challenge, Hint, CompositionCoeff)):
        return "fq" if fq_is_ext else "fp"
    return "fp"  # X, Periodic


def expr_kind(expr: Expr, num_base: int, fq_is_ext: bool) -> str:
    """The kind of a DAG's value (of a denominator, say)."""
    kinds = {}
    for node in expr.postorder_unique():
        if node.op == "leaf":
            k = leaf_kind(node.leaf, num_base, fq_is_ext)
        elif node.op in ("neg", "pow"):
            k = kinds[id(node.a)]
        else:
            k = "fq" if "fq" in (kinds[id(node.a)], kinds[id(node.b)]) else "fp"
        kinds[id(node)] = k
    return kinds[id(expr)]


@dataclass
class Plan:
    terms: list            # rewritten term DAGs (no Div nodes)
    groups: list           # (start, stop) term ranges, one kernel each
    fq_is_ext: bool
    num_base: int
    inv_keys: list         # denominator keys, in inverse-input order
    inv_kind: dict         # denominator key -> "fp" | "fq"
    periodic: list         # Periodic leaves, in periodic-input order
    scalars: list          # ('const' | 'challenge' | 'hint' | 'ccoeff' | 'exp',
                           #  v, kind)
    slot: dict             # leaf key -> index into its input list / scalar table
    num_slots: int         # scalar-table length (3 slots per Fq3 scalar)
    trace_len: int | None = None
    powers: list = field(default_factory=list)  # shared powers of X, by key
    power_of: dict = field(default_factory=dict)  # exponent -> its key
    period: int | None = None  # d where r = x^(N/d) (the "per" keys' d)


SMALL_POW = 32  # a and b of a shared power x^(a N + b) stay below this


def power_keys(exps, exps_2n, trace_len: int, period: int = 1) -> dict:
    """Shared-prologue keys of the powers of X (exponent -> key), read as
    linear functions of N, e = alpha N + beta with alpha d an integer (d =
    `period`, the AIR's largest periodic interval, 1 without one): `exps`
    are the exponents in walk order at N = `trace_len`, `exps_2n` the same
    nodes' at 2N.  ("small", a, b) for e = a N + b, ("nm1", a) for e = a N
    + N - 1, ("per", a, c, b, d) for e = a N + c N/d + b with 0 < c < d;
    a, b < SMALL_POW.  The keys do not depend on N, so neither does the source.
    An exponent of any other form, or whose node has no one twin at 2N, is
    left out (a runtime exponent); so are the "per" keys where an "nm1"
    key needs r."""
    n, d = trace_len, period
    twin: dict = {}
    for e, e2 in zip(exps, exps_2n):
        twin.setdefault(e, set()).add(e2)
    keys = {}
    for e, e2s in twin.items():
        if len(e2s) != 1 or len(exps) != len(exps_2n):
            continue
        slope = next(iter(e2s)) - e  # alpha N
        if slope < 0 or (slope * d) % n:
            continue
        a, c = divmod(slope * d // n, d)
        b = e - slope
        if c == 0 and 0 <= b < SMALL_POW and a < SMALL_POW:
            keys[e] = ("small", a, b)
        elif c == 0 and b == -1 and 0 < a <= SMALL_POW:
            keys[e] = ("nm1", a - 1)
        elif c and 0 <= b < SMALL_POW and a < SMALL_POW:
            keys[e] = ("per", a, c, b, d)
    if any(k[0] == "nm1" for k in keys.values()):
        keys = {e: k for e, k in keys.items() if k[0] != "per"}
    return keys


def build_plan(terms, key_memo, num_base: int, fq_is_ext: bool = False,
               inv_kind: dict | None = None,
               trace_len: int | None = None,
               keys: dict | None = None) -> Plan:
    """Assign every leaf to an input vector or a scalar-table slot.  Fp and
    Fq3 inverse inputs are numbered apart (two input stacks).  With the
    trace length, the powers of X that `keys` (``power_keys``) names go to
    the shared prologue."""
    rewritten = [_rewrite_divs(t, key_memo) for t in terms]
    step = GROUP_SIZE if fq_is_ext else max(len(rewritten), 1)
    groups = [(g, min(g + step, len(rewritten)))
              for g in range(0, len(rewritten), step)]
    plan = Plan(rewritten, groups, fq_is_ext, num_base, [], dict(inv_kind or {}),
                [], [], {}, 0)
    n_inv = {"fp": 0, "fq": 0}
    for t in rewritten:
        for leaf in t.leaves():
            k = _leaf_key(leaf)
            if k in plan.slot:
                continue
            if isinstance(leaf, (X, Trace)):
                if (isinstance(leaf, Trace) and leaf.column >= num_base
                        and not fq_is_ext):
                    raise ValueError("an extension column in an AIR whose Fq "
                                     "is Fp")
                plan.slot[k] = None
            elif isinstance(leaf, Periodic):
                plan.slot[k] = len(plan.periodic)
                plan.periodic.append(leaf)
            elif isinstance(leaf, _InvInput):
                kind = plan.inv_kind.setdefault(leaf.key, "fp")
                plan.slot[k] = n_inv[kind]
                n_inv[kind] += 1
                plan.inv_keys.append(leaf.key)
            else:
                kind = leaf_kind(leaf, num_base, fq_is_ext)
                if isinstance(leaf, Constant):
                    entry = ("const", leaf.value, kind)
                elif isinstance(leaf, Challenge):
                    entry = ("challenge", leaf.index, kind)
                elif isinstance(leaf, Hint):
                    entry = ("hint", leaf.index, kind)
                elif isinstance(leaf, CompositionCoeff):
                    entry = ("ccoeff", leaf.index, kind)
                else:
                    raise TypeError(leaf)
                plan.slot[k] = plan.num_slots
                plan.scalars.append(entry)
                plan.num_slots += 3 if kind == "fq" else 1
    # Pow exponents (the degree adjustments x^k, which grow with the trace
    # length) stay out of the source, so one compiled kernel serves every
    # trace length: the shared powers of X take N from the table, any other
    # power its exponent.
    plan.trace_len = trace_len
    raw = []
    for t in rewritten:
        for node in t.postorder_unique():
            if node.op != "pow":
                continue
            key = None
            if (trace_len and node.a.op == "leaf"
                    and isinstance(node.a.leaf, X)):
                key = (keys or {}).get(node.exp)
            if key is None:
                raw.append(node.exp)
            elif node.exp not in plan.power_of:
                plan.power_of[node.exp] = key
    plan.powers = sorted(set(plan.power_of.values()))
    plan.period = next((k[4] for k in plan.powers if k[0] == "per"), None)
    if _chain(plan)[0]:
        raw.insert(0, trace_len)
    for e in raw:
        if ("exp", e) not in plan.slot:
            plan.slot[("exp", e)] = plan.num_slots
            plan.scalars.append(("exp", e, "raw"))
            plan.num_slots += 1
    return plan


def scalar_table(plan: Plan, challenges, hints, composition_coeffs,
                 device) -> torch.Tensor:
    vals = []
    for what, v, kind in plan.scalars:
        if what == "challenge":
            v = challenges[v]
        elif what == "hint":
            v = hints[v]
        elif what == "ccoeff":
            v = composition_coeffs[v]
        if kind == "raw":
            vals.append(v)
        elif kind == "fq":
            q = Fq3.from_base(v)
            vals += [q.c0.v, q.c1.v, q.c2.v]
        elif isinstance(v, Fq3):
            raise TypeError("an Fq3 scalar in an AIR whose Fq is Fp")
        else:
            vals.append(v.v if isinstance(v, Fp) else int(v))
    return torch.tensor([fd.to_i64(v) for v in vals] or [0],
                        dtype=torch.int64, device=device)


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


def _walk(terms, leaf_fn, op_fn):
    """Evaluate every term once over a structural memo shared by `terms`;
    values are (kind, value) pairs.  Returns the per-term results."""
    keys, vals, outs = {}, {}, []
    for term in terms:
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


_ARGS = ("const uint64_t* __restrict__ trace, const uint64_t* __restrict__ ext, "
         "const uint64_t* __restrict__ x, const uint64_t* __restrict__ per, "
         "const uint64_t* __restrict__ inv, const uint64_t* __restrict__ inv3, "
         "const uint64_t* __restrict__ s")
_ARG_NAMES = "trace, ext, x, per, inv, inv3, s"


def _c_op(op: str, a, b):
    """C expression of a binary op on (kind, name) operands -> (kind, expr)."""
    (ka, va), (kb, vb) = a, b
    mul = "_cc" if op == "mul" else ""
    if ka == kb == "fp":
        return "fp", f"gl_{op}{mul}({va}, {vb})"
    if ka == kb:
        return "fq", f"gl3_{op}{mul}({va}, {vb})"
    if ka == "fp":  # both ops commute: put the Fq3 operand first
        va, vb = vb, va
    return "fq", f"gl3_{op}_base{mul}({va}, {vb})"


def _pow_var(base: str, k: int, memo: dict, emit) -> str:
    """The name of base^k, built from memo's powers: the square of
    base^(k/2) for k a power of two, else base^(k - 2^j) * base^(2^j) with
    2^j the top bit of k; each new power one product (emit)."""
    if k == 0:
        return "1ULL"
    if k not in memo:
        top = 1 << (k.bit_length() - 1)
        if top == k:
            h = _pow_var(base, k // 2, memo, emit)
            memo[k] = emit(h, h)
        else:
            memo[k] = emit(_pow_var(base, k - top, memo, emit),
                           _pow_var(base, top, memo, emit))
    return memo[k]


def _chain(plan: Plan) -> tuple[bool, bool]:
    """(whether the powers need the chain, y = x^N and r, whether r is the
    running product x^(N - 1), a product a squaring; else r is x^(N/d)
    where a "per" power needs it, or 1)."""
    running = any(k[0] == "nm1" for k in plan.powers)
    return (running or plan.period is not None
            or any(k[1] for k in plan.powers)), running


def _chain_source(plan: Plan) -> str:
    """The body of ms_eval_chain: y = x^N by log2 N squarings, N from the
    scalar table, and where a power needs it the running product r =
    x^(N - 1) (one more product a squaring) or r = x^(N/d), the chain's
    value where m = d."""
    chain, running = _chain(plan)
    if not chain:
        return "    (void)s;\n    *y = x;\n    *r = 1;"
    slot = plan.slot[("exp", plan.trace_len)]
    lines = ["    uint64_t yy = x, rr = 1;",
             f"    for (uint64_t m = s[{slot}]; m > 1; m >>= 1) {{  // N"]
    if running:
        lines.append("        rr = gl_mul_cc_lazy(rr, yy);")
    elif plan.period is not None:
        lines.append(f"        if (m == {plan.period}) rr = yy;  // x^(N/d)")
    lines += ["        yy = gl_mul_cc_lazy(yy, yy);", "    }",
              "    *y = gl_canon(yy);", "    *r = gl_canon(rr);"]
    return "\n".join(lines)


def _powers_source(plan: Plan, ks) -> tuple[str, int]:
    """A body that sets pw[k] for each k in ks from x, y and r (short
    chains, shared where the powers share a factor), and its products."""
    lines, count = ["    (void)x; (void)y; (void)r;"], [0]

    def emit(a: str, b: str) -> str:
        name = f"p{count[0]}"
        count[0] += 1
        lines.append(f"    const uint64_t {name} = gl_mul_cc({a}, {b});")
        return name

    xs, ys, rs = {1: "x"}, {1: "y"}, {1: "r"}
    for k in ks:
        key = plan.powers[k]
        if key[0] == "nm1":
            parts = [_pow_var("y", key[1], ys, emit), "r"]
        elif key[0] == "per":
            parts = [_pow_var("y", key[1], ys, emit),
                     _pow_var("r", key[2], rs, emit),
                     _pow_var("x", key[3], xs, emit)]
        else:
            parts = [_pow_var("y", key[1], ys, emit),
                     _pow_var("x", key[2], xs, emit)]
        parts = [v for v in parts if v != "1ULL"] or ["1ULL"]
        value = parts[0]
        for v in parts[1:]:
            value = emit(value, v)
        lines.append(f"    pw[{k}] = {value};")
    return "\n".join(lines), count[0]


def power_products(plan: Plan) -> tuple[int, int]:
    """The products of the shared powers of X at their least, once a
    point: (products a squaring of the chain takes, products after it)."""
    chain, running = _chain(plan)
    return ((2 if running else 1) * chain,
            _powers_source(plan, range(len(plan.powers)))[1])


def _generate_group(plan: Plan, ce_blowup: int, g: int) -> str:
    """Group g's per-point function, and the function of the shared powers
    it reads."""
    start, stop = plan.groups[g]
    lines, used = [], []
    counter = [0]

    def var(kind: str, expr: str):
        name = f"v{counter[0]}"
        counter[0] += 1
        ctype = "uint64_t" if kind == "fp" else "gl3"
        lines.append(f"    const {ctype} {name} = {expr};")
        return kind, name

    def leaf_fn(leaf):
        slot = plan.slot.get(_leaf_key(leaf))
        if isinstance(leaf, X):
            return "fp", "xi"
        if isinstance(leaf, Trace):  # columns of ld points
            idx = f"(i + ({ce_blowup * leaf.offset}LL)) & mask"
            if leaf.column < plan.num_base:
                return var("fp", f"trace[{leaf.column}LL * ld + ({idx})]")
            e = leaf.column - plan.num_base
            return var("fq", f"gl3_load(ext + {3 * e}LL * ld, {idx}, ld)")
        if isinstance(leaf, Periodic):
            return var("fp", f"per[{slot}LL * n + i]")
        if isinstance(leaf, _InvInput):
            if plan.inv_kind[leaf.key] == "fq":
                return var("fq", f"gl3_load(inv3 + {3 * slot}LL * n, i, n)")
            return var("fp", f"inv[{slot}LL * n + i]")
        if leaf_kind(leaf, plan.num_base, plan.fq_is_ext) == "fq":
            return var("fq", f"gl3_load(s, {slot}, 1)")
        return var("fp", f"s[{slot}]")

    def op_fn(op, a, b, exp):
        kind, v = a
        pre = "gl" if kind == "fp" else "gl3"
        if op == "neg":
            return var(kind, f"{pre}_neg({v})")
        if op == "pow":
            if v == "xi" and exp in plan.power_of:
                k = plan.powers.index(plan.power_of[exp])
                used.append(k)
                return "fp", f"pw[{k}]"
            return var(kind, f"{pre}_pow({v}, s[{plan.slot[('exp', exp)]}])")
        return var(*_c_op(op, a, b))

    outs = _walk(plan.terms[start:stop], leaf_fn, op_fn)
    body = "\n".join(lines)
    ext = plan.fq_is_ext
    ctype = "gl3" if ext else "uint64_t"
    acc = "\n".join(
        f"    acc = {_c_op('add', ('fq' if ext else 'fp', 'acc'), o)[1]};"
        for o in outs)
    zero = "gl3_from_base(0)" if ext else "0"
    used = sorted(set(used))
    powers, _n = _powers_source(plan, used)
    return f"""
// terms {start}..{stop - 1}
GL_HD {ctype} ms_eval_group{g}(int64_t i, int64_t n, int64_t ld,
                               int64_t mask, {_ARGS}, const uint64_t* pw) {{
    const uint64_t xi = x[i];
    (void)mask; (void)xi; (void)pw;
{body}
    {ctype} acc = {zero};
{acc}
    return acc;
}}

// the shared powers group {g} reads
GL_HD void ms_eval_powers{g}(uint64_t x, uint64_t y, uint64_t r,
                             uint64_t* pw) {{
{powers}
}}
"""


def generate_source(plan: Plan, ce_blowup: int) -> str:
    """The translation unit of the whole sum (see the module docstring)."""
    ext = plan.fq_is_ext
    ctype = "gl3" if ext else "uint64_t"
    zero = "gl3_from_base(0)" if ext else "0"
    add = "gl3_add" if ext else "gl_add"
    planes = 3 if ext else 1

    def load(p, i="i"):
        return f"gl3_load({p}, {i}, n)" if ext else f"{p}[{i}]"

    def store(p, v, i="i"):
        return f"gl3_store({p}, {i}, n, {v});" if ext else f"{p}[{i}] = {v};"

    G = len(plan.groups)
    groups = "".join(_generate_group(plan, ce_blowup, g) for g in range(G))
    all_powers, _n = _powers_source(plan, range(len(plan.powers)))
    one = "\n    else ".join(
        f"if constexpr (G == {g}) {{\n"
        f"        ms_eval_powers{g}(xi, y, r, pw);\n"
        f"        v = ms_eval_group{g}(i, n, ld, mask, {_ARG_NAMES}, pw);"
        f"\n    }}"
        for g in range(G))

    def cases(indent, fmt):
        return "\n".join(f"{indent}case {g}: {fmt.format(g=g)} break;"
                         for g in range(G))

    return f"""// Generated by ministark_tpu_torch/ops/eval.py: the sum of the
// {len(plan.terms)} constraint terms at one CE-domain point, in {G}
// group(s), and the shared powers of X.
#include "goldilocks.cuh"

#define MS_EVAL_GROUPS {G}
#define MS_EVAL_POWERS {max(len(plan.powers), 1)}
#define MS_EVAL_PLANES {planes}

// y = x^N, and r = x^(N - 1) or x^(N/d) where a power reads it (N, the
// trace length, from the table)
GL_HD void ms_eval_chain(uint64_t x, const uint64_t* __restrict__ s,
                         uint64_t* y, uint64_t* r) {{
{_chain_source(plan)}
}}

// every shared power, pw[k] = x^e for plan.powers[k]
GL_HD void ms_eval_powers(uint64_t x, uint64_t y, uint64_t r, uint64_t* pw) {{
{all_powers}
}}
{groups}
// group G at point i, its powers from y and r; the trace columns hold ld
// points, read at (i + offset) & mask
template <int G>
GL_HD {ctype} ms_eval_one(int64_t i, int64_t n, int64_t ld, int64_t mask,
                          {_ARGS}, uint64_t y, uint64_t r) {{
    const uint64_t xi = x[i];
    uint64_t pw[MS_EVAL_POWERS];
    {ctype} v = {zero};
    {one}
    return v;
}}

// group g at point i (g at run time)
GL_HD {ctype} ms_eval_any(int g, int64_t i, int64_t n, int64_t ld,
                          int64_t mask, {_ARGS}, uint64_t y, uint64_t r) {{
    switch (g) {{
{cases("    ", "return ms_eval_one<{g}>(i, n, ld, mask, " + _ARG_NAMES + ", y, r);")}
    }}
    return {zero};
}}

#ifdef __CUDACC__
#include "launch.cuh"

#define MS_EVAL_THREADS 128

// a launch a group: y and r from the chain pass (yr, (2, n)) or, where
// yr is null, from the chain at each point; adds into out when accumulate
template <int G>
__global__ void __launch_bounds__(MS_EVAL_THREADS)
    ms_eval_group_kernel({_ARGS}, const uint64_t* __restrict__ yr,
                         uint64_t* __restrict__ out, int64_t n, int64_t ld,
                         int64_t mask, int accumulate) {{
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {{
        uint64_t y, r;
        if (yr) {{
            y = yr[i];
            r = yr[n + i];
        }} else {{
            ms_eval_chain(x[i], s, &y, &r);
        }}
        {ctype} v = ms_eval_one<G>(i, n, ld, mask, {_ARG_NAMES}, y, r);
        if (accumulate) v = {add}(v, {load("out")});
        {store("out", "v")}
    }}
}}

// every group in one launch, group blockIdx.y into its part of `part`
// ((groups, planes, n)), the chain at each point
__global__ void __launch_bounds__(MS_EVAL_THREADS)
    ms_eval_grid_kernel({_ARGS}, uint64_t* __restrict__ part, int64_t n,
                        int64_t ld, int64_t mask) {{
    const int g = blockIdx.y;
    uint64_t* dst = part + (int64_t)g * MS_EVAL_PLANES * n;
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {{
        uint64_t y, r;
        ms_eval_chain(x[i], s, &y, &r);
        const {ctype} v = ms_eval_any(g, i, n, ld, mask, {_ARG_NAMES}, y, r);
        {store("dst", "v")}
    }}
}}

__global__ void ms_eval_sum_kernel(const uint64_t* __restrict__ part,
                                   uint64_t* __restrict__ out, int64_t n) {{
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {{
        {ctype} v = {load("part")};
        for (int g = 1; g < MS_EVAL_GROUPS; g++)
            v = {add}(v, {load("(part + (int64_t)g * MS_EVAL_PLANES * n)")});
        {store("out", "v")}
    }}
}}

__global__ void ms_eval_chain_kernel(const uint64_t* __restrict__ x,
                                     const uint64_t* __restrict__ s,
                                     uint64_t* __restrict__ yr, int64_t n) {{
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x)
        ms_eval_chain(x[i], s, yr + i, yr + n + i);
}}

MS_API int ms_eval_chain_pass(const uint64_t* x, const uint64_t* s,
                              uint64_t* yr, int64_t n, cudaStream_t stream) {{
    if (n > 0)
        ms_eval_chain_kernel<<<ms_blocks(n, 256), 256, 0, stream>>>(x, s, yr,
                                                                   n);
    return ms_last_error();
}}

static int ms_eval_group_at(int g, {_ARGS}, const uint64_t* yr,
                            uint64_t* out, int64_t n, int64_t ld,
                            int64_t mask, int accumulate,
                            cudaStream_t stream) {{
    if (n <= 0) return ms_last_error();
    const unsigned grid = ms_blocks(n, MS_EVAL_THREADS);
    switch (g) {{
{cases("    ", "ms_eval_group_kernel<{g}><<<grid, MS_EVAL_THREADS, 0, stream>>>(" + _ARG_NAMES + ", yr, out, n, ld, mask, accumulate);")}
    default: return (int)cudaErrorInvalidValue;
    }}
    return ms_last_error();
}}

static int ms_eval_grid_at({_ARGS}, uint64_t* part, int64_t n, int64_t ld,
                           int64_t mask, cudaStream_t stream) {{
    if (n > 0)
        ms_eval_grid_kernel<<<dim3(ms_blocks(n, MS_EVAL_THREADS),
                                   MS_EVAL_GROUPS), MS_EVAL_THREADS, 0,
                              stream>>>({_ARG_NAMES}, part, n, ld, mask);
    return ms_last_error();
}}

// the whole CE domain: columns of n points, read modulo n
MS_API int ms_eval_group(int g, {_ARGS}, const uint64_t* yr, uint64_t* out,
                         int64_t n, int accumulate, cudaStream_t stream) {{
    return ms_eval_group_at(g, {_ARG_NAMES}, yr, out, n, n, n - 1,
                            accumulate, stream);
}}

MS_API int ms_eval_grid({_ARGS}, uint64_t* part, int64_t n,
                        cudaStream_t stream) {{
    return ms_eval_grid_at({_ARG_NAMES}, part, n, n, n - 1, stream);
}}

// a block of n points: columns of ld = n + halo points, read with no wrap
MS_API int ms_eval_group_block(int g, {_ARGS}, const uint64_t* yr,
                               uint64_t* out, int64_t n, int64_t ld,
                               int accumulate, cudaStream_t stream) {{
    return ms_eval_group_at(g, {_ARG_NAMES}, yr, out, n, ld, -1, accumulate,
                            stream);
}}

MS_API int ms_eval_grid_block({_ARGS}, uint64_t* part, int64_t n, int64_t ld,
                              cudaStream_t stream) {{
    return ms_eval_grid_at({_ARG_NAMES}, part, n, ld, -1, stream);
}}

MS_API int ms_eval_sum(const uint64_t* part, uint64_t* out, int64_t n,
                       cudaStream_t stream) {{
    if (n > 0)
        ms_eval_sum_kernel<<<ms_blocks(n, 256), 256, 0, stream>>>(part, out,
                                                                 n);
    return ms_last_error();
}}
#else
// the launch-a-group kernels' sum (groups = 1), or the one launch's parts
// and their sum (groups = 0): the chain at each point; trace columns of ld
// points read at (i + offset) & mask
static void ms_eval_host_at({_ARGS}, uint64_t* part, uint64_t* out,
                            int64_t n, int64_t ld, int64_t mask,
                            int groups) {{
    for (int g = 0; g < MS_EVAL_GROUPS; g++) {{
        uint64_t* dst = groups ? out : part + (int64_t)g * MS_EVAL_PLANES * n;
        for (int64_t i = 0; i < n; i++) {{
            uint64_t y, r;
            ms_eval_chain(x[i], s, &y, &r);
            {ctype} v = ms_eval_any(g, i, n, ld, mask, {_ARG_NAMES}, y, r);
            if (groups && g > 0) v = {add}(v, {load("out")});
            {store("dst", "v")}
        }}
    }}
    if (!groups)
        for (int64_t i = 0; i < n; i++) {{
            {ctype} v = {load("part")};
            for (int g = 1; g < MS_EVAL_GROUPS; g++)
                v = {add}(v, {load("(part + (int64_t)g * MS_EVAL_PLANES * n)")});
            {store("out", "v")}
        }}
}}

// the whole CE domain (ms_eval_group / ms_eval_grid)
extern "C" void ms_eval_host({_ARGS}, uint64_t* part, uint64_t* out,
                             int64_t n, int groups) {{
    ms_eval_host_at({_ARG_NAMES}, part, out, n, n, n - 1, groups);
}}

// a block of n points from columns of ld points (the _block entries)
extern "C" void ms_eval_host_block({_ARGS}, uint64_t* part, uint64_t* out,
                                   int64_t n, int64_t ld, int groups) {{
    ms_eval_host_at({_ARG_NAMES}, part, out, n, ld, -1, groups);
}}

// pw[k m + j] = the k-th shared power of x[j]
extern "C" void ms_eval_powers_host(const uint64_t* x, const uint64_t* s,
                                    int64_t m, uint64_t* pw) {{
    for (int64_t j = 0; j < m; j++) {{
        uint64_t y, r, v[MS_EVAL_POWERS];
        ms_eval_chain(x[j], s, &y, &r);
        ms_eval_powers(x[j], y, r, v);
        for (int k = 0; k < MS_EVAL_POWERS; k++) pw[k * m + j] = v[k];
    }}
}}
#endif
"""


# -- the plain version ---------------------------------------------------------

def promote(v: torch.Tensor) -> torch.Tensor:
    """An Fp tensor ((n,) or 0-d) as Fq3 ((3, n) or (3, 1))."""
    return fd.ext3_from_base(v.reshape(-1))


def tagged_op(op: str, a, b, exp):
    """One DAG operation on (kind, tensor) values, by the promotion rules.
    Fq3 tensors are (3, n) or (3, 1); Fp tensors (n,) or 0-d."""
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
        return "fq", fd.add(v if kind == "fq" else promote(v),
                            w if kb == "fq" else promote(w))
    if kind == kb:
        return "fq", fd.ext3_mul(v, w)
    if kind == "fp":
        v, w = w, v
    return "fq", fd.ext3_mul_base(v, w.reshape(-1))


def eval_terms_plain(plan: Plan, ce_blowup: int, trace, ext, x, per, inv,
                     inv3, s, points: tuple[int, int] | None = None,
                     block: bool = False):
    """The same sum in plain PyTorch over the CE domain, or over the CE
    points [start, stop) when `points` is given (the same values as that
    slice of the whole, for less memory).  With `block`, x, per, inv and
    inv3 are a block's n points and the trace columns hold them and the
    halo after them, read with no wrap (``eval_terms_block``)."""
    n = x.shape[0]
    a, b = points if points is not None else (0, n)
    pos = torch.arange(a, b, device=x.device)
    mask = -1 if block else n - 1
    svals = s.tolist()

    def leaf_fn(leaf):
        slot = plan.slot.get(_leaf_key(leaf))
        if isinstance(leaf, X):
            return "fp", x[a:b]
        if isinstance(leaf, Trace):
            idx = (pos + ce_blowup * leaf.offset) & mask
            if leaf.column < plan.num_base:
                return "fp", trace[leaf.column].index_select(0, idx)
            return "fq", ext[leaf.column - plan.num_base].index_select(1, idx)
        if isinstance(leaf, Periodic):
            return "fp", per[slot, a:b]
        if isinstance(leaf, _InvInput):
            if plan.inv_kind[leaf.key] == "fq":
                return "fq", inv3[slot, :, a:b]
            return "fp", inv[slot, a:b]
        if leaf_kind(leaf, plan.num_base, plan.fq_is_ext) == "fq":
            return "fq", s[slot:slot + 3].reshape(3, 1)
        return "fp", torch.tensor(svals[slot], dtype=torch.int64,
                                  device=x.device)

    m = b - a
    acc = ("fq" if plan.fq_is_ext else "fp",
           torch.zeros((3, m) if plan.fq_is_ext else (m,), dtype=torch.int64,
                       device=x.device))
    for t in _walk(plan.terms, leaf_fn, tagged_op):
        acc = tagged_op("add", acc, t, None)
    return acc[1]


def eval_launch(n: int) -> str:
    """How kernel E runs over n CE points: "groups", the chain pass and a
    launch a group adding into the output, from GROUPS_FROM points; below,
    "grid", every group in one launch (a grid row a group, each computing
    the chain) and a launch that sums the groups' parts."""
    return "groups" if n >= GROUPS_FROM else "grid"


def eval_terms(plan: Plan, source: str, ce_blowup: int, trace, ext, x, per,
               inv, inv3, s, launch: str | None = None):
    """Composition sum over the CE domain: trace (nbase, n), ext (next, 3,
    n), x (n,), per (nper, n), inv (ninv, n), inv3 (ninv3, 3, n), s (S,)
    scalar table.  Returns (n,) for an Fp AIR, (3, n) for an Fq3 one.  CUDA
    tensors launch the generated kernels (as `launch` says, by default
    ``eval_launch(n)``); CPU tensors take the plain version."""
    if not x.is_cuda:
        return eval_terms_plain(plan, ce_blowup, trace, ext, x, per, inv,
                                inv3, s)
    return _launch(plan, source, trace, ext, x, per, inv, inv3, s, launch,
                   None)


def eval_terms_block(plan: Plan, source: str, ce_blowup: int, trace, ext, x,
                     per, inv, inv3, s, launch: str | None = None):
    """The block entry: the composition sum at m points of a contiguous
    block of the CE domain, x (m,), per (nper, m), inv (ninv, m), inv3
    (ninv3, 3, m) the block's own, trace (nbase, m + halo) and ext (next,
    3, m + halo) the block's points and the halo after them, read with no
    wrap.  Returns (m,) or (3, m).  CUDA tensors launch the kernels of the
    same generated source; CPU tensors take the plain version."""
    m = x.shape[0]
    ld = trace.shape[-1] if trace.shape[0] else ext.shape[-1]
    if ld < m or (ext.shape[0] and ext.shape[-1] != ld):
        raise ValueError(f"eval_terms_block: trace columns of {ld} points "
                         f"for a block of {m}")
    if not x.is_cuda:
        return eval_terms_plain(plan, ce_blowup, trace, ext, x, per, inv,
                                inv3, s, block=True)
    return _launch(plan, source, trace, ext, x, per, inv, inv3, s, launch,
                   ld)


def _launch(plan, source, trace, ext, x, per, inv, inv3, s, launch, ld):
    """Kernel E over x's n points: the whole-domain entry (ld None) or the
    block entry of trace columns of ld points."""
    n = x.shape[0]
    args = []
    for name, t in (("trace", trace), ("ext", ext), ("x", x), ("per", per),
                    ("inv", inv), ("inv3", inv3), ("s", s)):
        t = t.contiguous()
        build.check_cuda(t, name=name)
        args.append(t)
    kernel = KERNEL_EXT3 if plan.fq_is_ext else KERNEL
    shape = (3, n) if plan.fq_is_ext else (n,)
    out = torch.empty(shape, dtype=torch.int64, device=x.device)
    ptrs = [build.ptr(t) for t in args]
    block = () if ld is None else (build.i64(ld),)
    suffix = "" if ld is None else "_block"
    G = len(plan.groups)
    if (launch or eval_launch(n)) == "grid":
        part = (out if G == 1 else
                torch.empty((G, *shape), dtype=torch.int64, device=x.device))
        kernel.launch("ms_eval_grid" + suffix, *ptrs, build.ptr(part),
                      build.i64(n), *block, source_text=source)
        if G > 1:
            kernel.launch("ms_eval_sum", build.ptr(part), build.ptr(out),
                          build.i64(n), source_text=source)
        return out
    yr = None
    if _chain(plan)[0]:
        yr = torch.empty((2, n), dtype=torch.int64, device=x.device)
        kernel.launch("ms_eval_chain_pass", ptrs[2], ptrs[6], build.ptr(yr),
                      build.i64(n), source_text=source)
    for g in range(G):
        kernel.launch("ms_eval_group" + suffix, build.c_int(g), *ptrs,
                      build.ptr_or_null(yr), build.ptr(out), build.i64(n),
                      *block, build.c_int(int(g > 0)), source_text=source)
    return out
