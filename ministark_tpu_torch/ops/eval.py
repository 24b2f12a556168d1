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

``generate_sources`` emits one translation unit per group of terms: a
``GL_HD`` per-point function of straight-line ``goldilocks.cuh`` code
(every structurally distinct node of the group once), a CUDA kernel that
runs it with one thread per CE point and adds its sum into the output, and
a host loop that g++ builds for the CPU tests.  An Fp AIR's terms form one
group; an Fq3 AIR's terms go GROUP_SIZE to a kernel, as on the TPU, which
bounds each kernel's registers and nvcc's time on its source.

Bound on the card: integer operations for both AIRs (chip_smoke.py's
model: ~1.7k 32-bit instructions per point for fib against ~100 bytes,
~36k for brainfuck against ~400 bytes, most of them in the x^k degree
adjustments).  Design: a group's terms in one kernel, every
input read once per point by that group, no intermediate leaves the
registers; the groups add into one output in device memory.
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
from ..fields.scalar import Fp, Fq3
from . import build

KERNEL = build.register(
    "eval", None,
    replaces="ministark_tpu/ops/eval_pallas.py:151 _kernel_factory")
KERNEL_EXT3 = build.register(
    "eval_ext3", None,
    replaces="ministark_tpu/ops/eval_pallas.py:151 _kernel_factory (Fq3)")

GROUP_SIZE = 6  # Fq3 terms per generated kernel (eval_pallas.py:47)


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


def build_plan(terms, key_memo, num_base: int, fq_is_ext: bool = False,
               inv_kind: dict | None = None) -> Plan:
    """Assign every leaf to an input vector or a scalar-table slot.  Fp and
    Fq3 inverse inputs are numbered apart (two input stacks)."""
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
    # length) are table entries too, so one compiled kernel serves every
    # trace length.
    for t in rewritten:
        for node in t.postorder_unique():
            if node.op == "pow" and ("exp", node.exp) not in plan.slot:
                plan.slot[("exp", node.exp)] = plan.num_slots
                plan.scalars.append(("exp", node.exp, "raw"))
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
    if ka == kb == "fp":
        return "fp", f"gl_{op}({va}, {vb})"
    if ka == kb:
        return "fq", f"gl3_{op}({va}, {vb})"
    if ka == "fp":  # both ops commute: put the Fq3 operand first
        va, vb = vb, va
    return "fq", f"gl3_{op}_base({va}, {vb})"


def _generate_group(plan: Plan, ce_blowup: int, start: int, stop: int) -> str:
    lines = []
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
            return var("fp", "x[i]")
        if isinstance(leaf, Trace):
            idx = f"(i + ({ce_blowup * leaf.offset}LL)) & mask"
            if leaf.column < plan.num_base:
                return var("fp", f"trace[{leaf.column}LL * n + ({idx})]")
            e = leaf.column - plan.num_base
            return var("fq", f"gl3_load(ext + {3 * e}LL * n, {idx}, n)")
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
            return var(kind, f"{pre}_pow({v}, s[{plan.slot[('exp', exp)]}])")
        return var(*_c_op(op, a, b))

    outs = _walk(plan.terms[start:stop], leaf_fn, op_fn)
    body = "\n".join(lines)
    ext = plan.fq_is_ext
    ctype = "gl3" if ext else "uint64_t"
    acc = "\n".join(
        f"    acc = {_c_op('add', ('fq' if ext else 'fp', 'acc'), o)[1]};"
        for o in outs)
    if ext:
        zero = "gl3_from_base(0)"
        load = "if (accumulate) r = gl3_add(r, gl3_load(out, i, n));"
        store = "gl3_store(out, i, n, r);"
    else:
        zero = "0"
        load = "if (accumulate) r = gl_add(r, out[i]);"
        store = "out[i] = r;"
    return f"""// Generated by ministark_tpu_torch/ops/eval.py: the sum of constraint
// terms {start}..{stop - 1} of {len(plan.terms)} at one CE-domain point.
#include "goldilocks.cuh"

GL_HD {ctype} ms_eval_point(int64_t i, int64_t n, {_ARGS}) {{
    const int64_t mask = n - 1;
{body}
    {ctype} acc = {zero};
{acc}
    return acc;
}}

GL_HD void ms_eval_store(int64_t i, int64_t n, {_ARGS},
                         uint64_t* out, int accumulate) {{
    {ctype} r = ms_eval_point(i, n, {_ARG_NAMES});
    {load}
    {store}
}}

#ifdef __CUDACC__
#include "launch.cuh"

__global__ void ms_eval_kernel({_ARGS}, uint64_t* __restrict__ out,
                               int64_t n, int accumulate) {{
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x)
        ms_eval_store(i, n, {_ARG_NAMES}, out, accumulate);
}}

MS_API int ms_eval({_ARGS}, uint64_t* out, int64_t n, int accumulate,
                   cudaStream_t stream) {{
    if (n > 0)
        ms_eval_kernel<<<ms_blocks(n, 128), 128, 0, stream>>>(
            {_ARG_NAMES}, out, n, accumulate);
    return ms_last_error();
}}
#else
extern "C" void ms_eval_host({_ARGS}, uint64_t* out, int64_t n,
                             int accumulate) {{
    for (int64_t i = 0; i < n; i++)
        ms_eval_store(i, n, {_ARG_NAMES}, out, accumulate);
}}
#endif
"""


def generate_sources(plan: Plan, ce_blowup: int) -> list[str]:
    """One translation unit per term group (see the module docstring)."""
    return [_generate_group(plan, ce_blowup, a, b) for a, b in plan.groups]


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
                     inv3, s, points: tuple[int, int] | None = None):
    """The same sum in plain PyTorch over the CE domain, or over the CE
    points [start, stop) when `points` is given (the same values as that
    slice of the whole, for less memory)."""
    n = x.shape[0]
    a, b = points if points is not None else (0, n)
    pos = torch.arange(a, b, device=x.device)
    svals = s.tolist()

    def leaf_fn(leaf):
        slot = plan.slot.get(_leaf_key(leaf))
        if isinstance(leaf, X):
            return "fp", x[a:b]
        if isinstance(leaf, Trace):
            idx = (pos + ce_blowup * leaf.offset) & (n - 1)
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


def eval_terms(plan: Plan, sources: list[str], ce_blowup: int, trace, ext, x,
               per, inv, inv3, s):
    """Composition sum over the CE domain: trace (nbase, n), ext (next, 3,
    n), x (n,), per (nper, n), inv (ninv, n), inv3 (ninv3, 3, n), s (S,)
    scalar table.  Returns (n,) for an Fp AIR, (3, n) for an Fq3 one.  CUDA
    tensors launch the generated kernels, one per term group, each adding
    into the output; CPU tensors take the plain version."""
    if not x.is_cuda:
        return eval_terms_plain(plan, ce_blowup, trace, ext, x, per, inv,
                                inv3, s)
    n = x.shape[0]
    args = []
    for name, t in (("trace", trace), ("ext", ext), ("x", x), ("per", per),
                    ("inv", inv), ("inv3", inv3), ("s", s)):
        t = t.contiguous()
        build.check_cuda(t, name=name)
        args.append(t)
    kernel = KERNEL_EXT3 if plan.fq_is_ext else KERNEL
    out = torch.empty((3, n) if plan.fq_is_ext else (n,), dtype=torch.int64,
                      device=x.device)
    for g, source in enumerate(sources):
        kernel.launch("ms_eval", *[build.ptr(t) for t in args],
                      build.ptr(out), build.i64(n), build.c_int(int(g > 0)),
                      source_text=source)
    return out
