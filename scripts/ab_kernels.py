#!/usr/bin/env python3
"""Kernels A (batch inverse), B (column NTT), C (transpose), D (SHA-256),
E (constraint evaluation), F (DEEP), the multi-pass NTT and G (RPO-256)
against an earlier version of their sources, on one card, at the shapes
of chip_smoke.py's paths.

    git show <commit>:ministark_tpu_torch/csrc/ntt.cu > DIR/ntt.cu
    git show <commit>:ministark_tpu_torch/csrc/transpose.cu > DIR/transpose.cu
    git show <commit>:ministark_tpu_torch/csrc/inv.cu > DIR/inv.cu
    git show <commit>:ministark_tpu_torch/csrc/rpo256.cu > DIR/rpo256.cu
    git show <commit>:ministark_tpu_torch/csrc/sha256.cu > DIR/sha256.cu
    git show <commit>:ministark_tpu_torch/csrc/deep.cu > DIR/deep.cu
    git show <commit>:ministark_tpu_torch/csrc/goldilocks.cuh > DIR/goldilocks.cuh
    git show <commit>:ministark_tpu_torch/csrc/bigfield.cu > DIR/bigfield.cu
    git show <commit>:ministark_tpu_torch/csrc/bigfield.cuh > DIR/bigfield.cuh
    git archive <commit> | tar -x -C DIR/parent
    python3 scripts/ab_kernels.py DIR [--reps N] [--turns N]
                                      [--paths F,B,W,L,R,H,S,D]
                                      [--inv-variants] [--rpo-sweep]
                                      [--old-tree DIR/parent]
                                      [--ood] [--coin] [--ood-variants]
                                      [--big]

Builds each of the sources found in DIR with the port's nvcc flags into
DIR, its includes looked up in DIR before csrc/ (so an old inv.cu takes
its own goldilocks.cuh, an old ntt.cu its own ntt_sched.cuh), and loads
it beside the current kernels (the old entry points: ``ms_col_ntt``,
``ms_col_ntt_stage``, one launch a stage, ``ms_transpose``, ``ms_inv_fp``,
``ms_inv_ext3``, ``ms_rpo_hash_rows``, ``ms_rpo_merge``, ``ms_rpo_grind``,
``ms_hash_rows``, ``ms_merge``).
For every shape it checks that old and new give the same values, then
times them in turns (old, new, new, old; CUDA events over ``reps``
launches each, after a warm-up), ``--turns`` rounds of them, and prints
the mean of each version's turns with the range of the rounds' means; one
JSON line at the end.  Paths as in chip_smoke.py: F (fib 2^24
values: the 2^23-point 8-column LDE, one 2^23-value inverse), B
(brainfuck 2^20 rows: 2^24-point LDEs of 17, 27 and 48 planes, the three
Fp denominators and the three Fq3 DEEP rows of 2^24 values to invert), W
(hello_world: the same at 2^15 points), L (the 2^29-point LDE's three
kernel-B passes, two transposes and the multi-pass NTT's 2^15-row pass;
no inverse; the multi-pass NTT also at n1 = 2^12 and 2^16), R (the fully
algebraic fib: its rpo256 row's four parts, a whole 2^23-leaf tree, the
8-bit grind's 1024 nonces) and H (hello_world RPO: its rpo256 row's five
parts, a whole 2^15-leaf tree, the 20-bit grind's 2^20 nonces).  With an
old sha256.cu, on F, B and W: the sha256 row's row hashes and one tree
level of merges, the sha256_ext3 row's three Fq3 matrices (B, W), and a
whole SHA-256 tree of the path's LDE leaves (the old kernel one merge
launch a level; the new one its merges and the tops launch); on W also
the tops launch from TOPS_LEAVES = 0 (none), 16, .., 1024 leaves, each in
turns with the others (the sweep that sets ``ops/sha256.py``'s value).

With an old deep.cu, on F, B, W and H: kernel F's DEEP sum at the
prove's terms (the old pointer tables against the new plan), and the new
kernel at 1, 2, 4 and 8 lanes a point on F, B and W.  With ``--old-tree``
(a whole older tree): kernel E, the old tree's generated evaluator (one
launch a term group) against the new one as ``eval_terms`` launches it,
each with its own scalar table (the same values; the Pow exponents, or
the trace length, in each plan's slots), on F, B, W and H, and on B and W
the new one's launches each way (``ops.eval.eval_launch``), and on
gl_mul's C++ products in place of the carry-chain ones.

With an old rpo256.cu, ``--rpo-sweep`` also times kernel G's layouts
against the old kernel, each in turns with the others (every variant,
then again in reverse order): one tree level of n merges for n = 1 ..
2^22, the R and H proves' row hashes and both grind batches, by the old
kernel and by the new one with E = 1 and 3 elements of a state a lane
(the crossover ``ops/rpo256.py`` takes), and a 2^15-leaf tree with the
tops launch taking the last 16 .. 64 leaves or none.

``--ood`` times kernel F's OOD sums against the grouped kernel they
replaced (scripts/ood_grouped.cu, kept in the repository; DIR only holds
its build) in turns at F, R, S, D, B, W and H's shapes.  ``--coin`` times
the device coin steps against the single-thread SHA-256 step and the
RPO-256 step that handed the whole state around (scripts/coin_single.cu)
at each prove's (k, N), a launch each, device time alone too, and prints
both RPO-256 steps' parts from clock64() stamps.  ``--ood-variants``
builds csrc/deep.cu with an entry point for each OOD sums variant (pairs a
group, threads a block, an Fq3 column's products in Karatsuba or
schoolbook form; OOD_VARIANTS), prints
ptxas's registers, and times them in turns with the shipped kernel at F's,
S's, B's and W's shapes.  ``--ood-staged`` times the shipped OOD kernel against
the staged design of scripts/ood_staged.cu (a block stages the weights of
a tile of points in shared memory once for all its groups, a group a
warp) at 2, 4 and 8 pairs a group, in turns, at the same shapes.

``--big`` (with an old bigfield.cu and its bigfield.cuh in DIR) times
the BIG path's big_ntt on each of its eight 2^18-point transforms and
big_mul on 2^18 pairs of each field against the old kernels, in turns,
by events and by the device time alone, and prints ptxas's registers and
spills of both sources' kernels.  big_mul reads copies of its inputs in
turn that together take four times the card's L2
(``chip_smoke.l2_copies``), so that its inputs come from device memory.

``--inv-variants`` also builds csrc/inv.cu with one entry point for each
kernel A variant (the group size K, the group kept in registers or read
again, T threads a block, the PTX carry-chain product with the prefix
products and the chain lazy or every product canonical, or gl_mul's C++),
prints ptxas's registers and spills for each, checks each against the
current kernel and times them in turns (every variant, then again in
reverse order) at F's and B's shapes.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


PROTOS = {"ntt": ("ms_col_ntt", "ms_col_ntt_stage"),
          "transpose": ("ms_transpose",),
          "inv": ("ms_inv_fp", "ms_inv_ext3"),
          "rpo256": ("ms_rpo_hash_rows", "ms_rpo_merge", "ms_rpo_grind"),
          "sha256": ("ms_hash_rows", "ms_merge"),
          "deep": ("ms_deep", "ms_deep_ext3"),
          "bigfield": ("ms_big_mul", "ms_big_ntt")}

# the old tree's generated evaluators: the sources of each term group and
# the Pow exponents of its scalar table, in slot order
_OLD_EVAL = """
import json
from ministark_tpu_torch import eval as teval
from ministark_tpu_torch.air import Air, ProofOptions
from ministark_tpu_torch.fields.scalar import Fp
from ministark_tpu_torch.models.brainfuck import (BrainfuckAirConfig,
                                                  BrainfuckClaim)
from ministark_tpu_torch.models.fib import FibAirConfig
out = {"fib": {"exps": {}}, "bf": {"exps": {}}}
for name, rows in (("fib", 1 << 21), ("bf", 1 << 20), ("bf", 1 << 11)):
    if name == "fib":
        air = Air(FibAirConfig, rows, Fp(0), ProofOptions(32, 4, 8, 8, 64))
    else:
        air = Air(BrainfuckAirConfig, rows, BrainfuckClaim("", b"", b""),
                  ProofOptions(19, 16, 20, 16, 16))
    plan, sources, _ = teval._plan_for(air)
    out[name]["sources"] = sources
    out[name]["slots"] = plan.num_slots
    out[name]["exps"][rows] = [v for what, v, _k in plan.scalars
                               if what == "exp"]
print(json.dumps(out))
"""


def _nvcc(src, out, include, *extra):
    from ministark_tpu_torch.ops import build

    return subprocess.Popen(
        [build.find_nvcc(), *build.NVCC_FLAGS, *extra, "-I", include, "-I",
         build.CSRC, "-o", out, src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def build_old(old_dir):
    """{name: CDLL} of the old sources found in old_dir, built at once with
    the port's nvcc flags."""
    jobs = {}
    for name in PROTOS:
        src = os.path.join(old_dir, f"{name}.cu")
        if os.path.exists(src):
            out = os.path.join(old_dir, f"{name}_old.so")
            jobs[name] = out, _nvcc(src, out, old_dir)
    libs = {}
    for name, (out, p) in jobs.items():
        _, err = p.communicate(timeout=600)
        if p.returncode:
            raise RuntimeError(f"building the old {name}.cu failed:\n{err}")
        libs[name] = ctypes.CDLL(out)
        for fn in PROTOS[name]:
            if hasattr(libs[name], fn):
                getattr(libs[name], fn).restype = ctypes.c_int
    return libs


def ptxas_lines(p, src):
    """The registers and spills of each kernel from a running nvcc
    -Xptxas -v (`p`, from _nvcc)."""
    _, err = p.communicate(timeout=900)
    if p.returncode:
        raise RuntimeError(f"building {src} failed:\n{err}")
    lines, kernel = [], None
    for line in err.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        elif kernel and ("registers" in line or "spill" in line):
            lines.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
    return lines


# kernel A variants: (K, keep, T, product) for Fp and for Fq3.  The
# products: "cc" the kernel's (PTX carry chains, the prefix products and
# the chain lazy), "cc_eager" the same with every product canonical,
# "cpp" gl_mul's C++ (canonical).
MULS = {"cc": "gl_mul_cc_fn", "cc_eager": "ab_mul_cc_eager_fn",
        "cpp": "gl_mul_fn"}
MUL_EAGER = """struct ab_mul_cc_eager_fn {
    GL_FN uint64_t operator()(uint64_t a, uint64_t b) const {
        return gl_mul_cc(a, b);
    }
    GL_FN uint64_t lazy(uint64_t a, uint64_t b) const {
        return gl_mul_cc(a, b);
    }
};"""
INV_FP_VARIANTS = [(k, keep, 256, m) for m in MULS for k in (8, 16, 32)
                   for keep in (True, False)] + [(16, True, 128, "cc"),
                                                 (16, False, 128, "cc"),
                                                 (32, False, 128, "cc")]
INV_EXT3_VARIANTS = [(k, keep, 256, m) for m in MULS for k in (4, 8, 16)
                     for keep in (True, False)] + [(32, False, 256, "cc"),
                                                   (8, True, 128, "cc")]


def variant_name(field, v):
    k, keep, t, m = v
    return f"ab_{field}_k{k}_{'keep' if keep else 'reload'}_t{t}_{m}"


def build_inv_variants(out_dir):
    """csrc/inv.cu with one entry point for each variant, built with
    ptxas's report: (CDLL, the report's lines)."""
    lines = ['#include "inv.cu"', MUL_EAGER]
    for v in INV_FP_VARIANTS:
        k, keep, t, m = v
        lines.append(
            f"MS_API int {variant_name('fp', v)}(const uint64_t* in, "
            f"uint64_t* out, int64_t n, cudaStream_t s) {{ return "
            f"launch_inv_fp<{k}, {str(keep).lower()}, {t}, {MULS[m]}>"
            f"(in, out, n, s); }}")
    for v in INV_EXT3_VARIANTS:
        k, keep, t, m = v
        lines.append(
            f"MS_API int {variant_name('ext3', v)}(const uint64_t* in, "
            f"uint64_t* out, int64_t B, int64_t n, cudaStream_t s) {{ "
            f"return launch_inv_ext3<{k}, {str(keep).lower()}, {t}, "
            f"{MULS[m]}>(in, out, B, n, s); }}")
    from ministark_tpu_torch.ops import build

    # in a directory of its own: "inv.cu" is csrc/'s, not an old one
    work = os.path.join(out_dir, "inv_variants")
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, "inv_variants.cu")
    with open(src, "w") as f:
        f.write("\n".join(lines) + "\n")
    out = os.path.join(work, "inv_variants.so")
    report = ptxas_lines(_nvcc(src, out, build.CSRC, "-Xptxas", "-v"), src)
    lib = ctypes.CDLL(out)
    for field, vs in (("fp", INV_FP_VARIANTS), ("ext3", INV_EXT3_VARIANTS)):
        for v in vs:
            getattr(lib, variant_name(field, v)).restype = ctypes.c_int
    return lib, report


def rpo_ab(args, paths, old, rand, stream, record, record_variants, dev,
           results):
    """Kernel G, old against new, at R's and H's shapes (see the module
    docstring)."""
    import torch

    from ministark_tpu_torch import hash_rpo, merkle
    from ministark_tpu_torch.ops import build
    from ministark_tpu_torch.ops import pow as kpow
    from ministark_tpu_torch.ops import rpo256 as krpo

    def elems(d):
        return d.contiguous().view(torch.int64)

    def old_merge(left, right):
        le, ri = elems(left), elems(right)
        out = torch.empty_like(le)
        rc = old.ms_rpo_merge(build.ptr(le), build.ptr(ri), build.ptr(out),
                              build.i64(le.shape[0]), stream())
        assert rc == 0, rc
        return out.view(torch.uint8)

    def new_merge(left, right, e):
        """The kernel with e elements of a state a lane."""
        le, ri = elems(left), elems(right)
        out = torch.empty_like(le)
        krpo.KERNEL.launch("ms_rpo_merge", le.data_ptr(), ri.data_ptr(),
                           out.data_ptr(), le.shape[0], e)
        return out.view(torch.uint8)

    def old_hash(x, n, ncols, rs, cs):
        out = torch.empty((n, 4), dtype=torch.int64, device=dev)
        rc = old.ms_rpo_hash_rows(build.ptr(x), build.ptr(out), build.i64(n),
                                  build.i64(ncols), build.i64(rs),
                                  build.i64(cs), stream())
        assert rc == 0, rc
        return out.view(torch.uint8)

    def new_hash(x, n, ncols, rs, cs, e):
        out = torch.empty((n, 4), dtype=torch.int64, device=dev)
        krpo.KERNEL.launch("ms_rpo_hash_rows", x.data_ptr(), out.data_ptr(),
                           n, ncols, rs, cs, e)
        return out.view(torch.uint8)

    def old_tree(leaves):
        levels, cur = [leaves], leaves
        while cur.shape[0] > 1:
            h = cur.shape[0] // 2
            cur = old_merge(cur[:h], cur[h:])
            levels.append(cur)
        return levels

    def old_grind(seed, n, bits):
        best = torch.full((1,), n, dtype=torch.int32, device=dev)
        rc = old.ms_rpo_grind(build.ptr(seed), build.i64(1), build.i64(n),
                              build.i64(bits), build.ptr(best), None,
                              stream())
        assert rc == 0, rc
        return best

    def new_grind(seed, n, bits, e):
        best = torch.full((1,), n, dtype=torch.int32, device=dev)
        kpow.KERNEL.launch("ms_rpo_grind", seed.data_ptr(), 1, n, bits,
                           best.data_ptr(), None, e)
        return best

    def digests(n):
        return rand(n, 4).view(torch.uint8)

    def strided(x):
        """A hash_rows input: (tensor, n, ncols, rs, cs)."""
        n, ncols = x.shape
        return (x, n, ncols) + tuple(x.stride())

    def ext3(m):
        C, _, n = m.shape
        return (m, n, 3 * C, 1, n)

    def tree_fn(leaves):
        return lambda: torch.cat(merkle.tree_levels(leaves, hash_rpo))

    def old_tree_fn(leaves):
        return lambda: torch.cat(old_tree(leaves))

    seed = kpow.seed_elements(bytes(range(7, 39)), dev)
    for path in ("R", "H"):
        if path not in paths:
            continue
        n = 1 << 23 if path == "R" else 1 << 15
        if path == "R":
            from ministark_tpu_torch.air import Air, ProofOptions
            from ministark_tpu_torch.fields.scalar import Fp
            from ministark_tpu_torch.models.fib import FibAirConfig

            cb = Air(FibAirConfig, n // 4, Fp(0),
                     ProofOptions(32, 4, 8, 8, 64)).ce_blowup_factor
            rows = [strided(rand(8, n).T), strided(rand(cb, n).T),
                    strided(rand(n // 8, 8))]
        else:
            rows = [strided(rand(17, n).T), ext3(rand(9, 3, n)),
                    ext3(rand(16, 3, n)), ext3(rand(16, 3, n // 16))]
        level = digests(n)
        half = n // 2
        parts = [({"old": lambda r=r: old_hash(*r),
                   "new": lambda r=r: krpo._hash_strided(*r)}, r[1])
                 for r in rows]
        parts.append(({"old": lambda: old_merge(level[:half], level[half:]),
                       "new": lambda: krpo.merge(level[:half], level[half:])},
                      half))
        record("rpo256", path, parts)
        record("rpo256_tree", path,
               [({"old": old_tree_fn(level), "new": tree_fn(level)}, n)])
        bits = 8 if path == "R" else 20
        batch = min(kpow.BATCH_CUDA, 1 << (bits + 2))
        e = krpo.lane_elems(batch)  # the wrapper's layout for this batch
        record("rpo256_grind", path,
               [({"old": lambda: old_grind(seed, batch, bits),
                  "new": lambda: new_grind(seed, batch, bits, e)}, batch)])
        del rows, parts
        torch.cuda.empty_cache()

        del level
        torch.cuda.empty_cache()
    if args.rpo_sweep:
        rpo_sweep(old_merge, new_merge, old_hash, new_hash, old_grind,
                  new_grind, old_tree, digests, strided, ext3, rand, seed,
                  record_variants)


def sha_ab(paths, old, rand, stream, record, record_variants, dev):
    """Kernel D, old against new, at F's, B's and W's shapes (see the
    module docstring)."""
    import torch

    from ministark_tpu_torch import hash as H
    from ministark_tpu_torch import merkle
    from ministark_tpu_torch.ops import build
    from ministark_tpu_torch.ops import sha256 as ksha

    def old_hash(x, n, ncols, rs, cs):
        out = torch.empty((n, 32), dtype=torch.uint8, device=dev)
        rc = old.ms_hash_rows(build.ptr(x), build.ptr(out), build.i64(n),
                              build.i64(ncols), build.i64(rs), build.i64(cs),
                              stream())
        assert rc == 0, rc
        return out

    def old_merge(left, right):
        out = torch.empty_like(left)
        rc = old.ms_merge(build.ptr(left), build.ptr(right), build.ptr(out),
                          build.i64(left.shape[0]), stream())
        assert rc == 0, rc
        return out

    # the new entry points called as the old ones are (no wrapper checks),
    # so that launch-bound shapes compare the kernels and not the wrappers
    def new_hash(x, n, ncols, rs, cs):
        out = torch.empty((n, 32), dtype=torch.uint8, device=dev)
        ksha.KERNEL.launch("ms_hash_rows", build.ptr(x), build.ptr(out),
                           build.i64(n), build.i64(ncols), build.i64(rs),
                           build.i64(cs))
        return out

    def new_merge(left, right):
        out = torch.empty_like(left)
        ksha.KERNEL.launch("ms_merge", build.ptr(left), build.ptr(right),
                           build.ptr(out), build.i64(left.shape[0]))
        return out

    def old_tree(leaves):
        levels, cur = [leaves], leaves
        while cur.shape[0] > 1:
            h = cur.shape[0] // 2
            cur = old_merge(cur[:h], cur[h:])
            levels.append(cur)
        return torch.cat(levels)

    def digests(n):
        return torch.randint(0, 256, (n, 32), dtype=torch.uint8, device=dev)

    for path, n, nb in (("F", 1 << 23, 8), ("B", 1 << 24, 17),
                        ("W", 1 << 15, 17)):
        if path not in paths:
            continue
        x = rand(nb, n).T
        level = digests(n)
        half = n // 2
        record("sha256", path, [
            ({"old": lambda: old_hash(x, n, nb, *x.stride()),
              "new": lambda: new_hash(x, n, nb, *x.stride())}, n),
            ({"old": lambda: old_merge(level[:half], level[half:]),
              "new": lambda: new_merge(level[:half], level[half:])}, half)])
        del x
        if path != "F":
            mats = [rand(9, 3, n), rand(16, 3, n), rand(16, 3, n // 16)]
            record("sha256_ext3", path, [
                ({"old": lambda m=m: old_hash(m, m.shape[2], 3 * m.shape[0],
                                              1, m.shape[2]),
                  "new": lambda m=m: new_hash(m, m.shape[2], 3 * m.shape[0],
                                              1, m.shape[2])}, m.shape[2])
                for m in mats])
            del mats
        record("sha256_tree", path, [
            ({"old": lambda: old_tree(level),
              "new": lambda: torch.cat(merkle.tree_levels(level, H))}, n)])
        if path == "W":
            keep = ksha.TOPS_LEAVES
            fns = {}
            for tops in (0, 16, 32, 64, 128, 256, 512, 1024):
                def run(tops=tops):
                    ksha.TOPS_LEAVES = tops
                    try:
                        return torch.cat(merkle.tree_levels(level, H))
                    finally:
                        ksha.TOPS_LEAVES = keep
                fns[f"tops{tops}"] = run
            record_variants("sha256_tree tops", f"{n} leaves", fns,
                            old_tree(level), n)
        del level
        torch.cuda.empty_cache()


def ef_ab(paths, old, old_tree, rand, stream, record, record_variants,
          dev):
    """Kernels E and F, old against new, at F's, B's, W's and H's shapes
    (see the module docstring)."""
    import json

    import torch

    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.air import Air, ProofOptions
    from ministark_tpu_torch.fields.scalar import Fp
    from ministark_tpu_torch.models.brainfuck import (BrainfuckAirConfig,
                                                      BrainfuckClaim)
    from ministark_tpu_torch.models.fib import FibAirConfig
    from ministark_tpu_torch.ops import build
    from ministark_tpu_torch.ops import deep as kdeep
    from ministark_tpu_torch.ops import eval as keval

    evals = {}
    if old_tree:
        dump = subprocess.run([sys.executable, "-c", _OLD_EVAL],
                              cwd=old_tree, capture_output=True, text=True,
                              check=True).stdout
        csrc = os.path.join(old_tree, "ministark_tpu_torch", "csrc")
        jobs = []
        for name, d in json.loads(dump.splitlines()[-1]).items():
            libs = []
            for g, text in enumerate(d["sources"]):
                src = os.path.join(old_tree, f"_ab_eval_{name}{g}.cu")
                with open(src, "w") as f:
                    f.write(text)
                jobs.append((libs, src, _nvcc(src, src + ".so", csrc)))
            evals[name] = (d, libs)
        for libs, src, proc in jobs:
            _, err = proc.communicate(timeout=900)
            if proc.returncode:
                raise RuntimeError(f"building {src} failed:\n{err}")
            lib = ctypes.CDLL(src + ".so")
            lib.ms_eval.restype = ctypes.c_int
            libs.append(lib)

    def old_eval(d, libs, args, s_old, n, ext):
        out = torch.empty((3, n) if ext else (n,), dtype=torch.int64,
                          device=dev)
        for g, lib in enumerate(libs):
            rc = lib.ms_eval(*[build.ptr(t) for t in args], build.ptr(s_old),
                             build.ptr(out), build.i64(n),
                             build.c_int(int(g > 0)), stream())
            assert rc == 0, rc
        return out

    def old_deep(cols, rows, s, x, ext):
        n, T = x.shape[0], len(cols)
        ptrs = torch.tensor([t.data_ptr() for t in list(cols) + list(rows)],
                            dtype=torch.int64).to(dev)
        out = torch.empty((3, n) if ext else (n,), dtype=torch.int64,
                          device=dev)
        if ext:
            kinds = torch.tensor([int(c.ndim == 2) for c in cols],
                                 dtype=torch.int64).to(dev)
            rc = old["deep"].ms_deep_ext3(
                build.ptr(ptrs), build.ptr(kinds), build.ptr(ptrs[T:]),
                build.ptr(s), build.ptr(x), build.ptr(out), build.i64(n),
                build.i64(T), stream())
        else:
            rc = old["deep"].ms_deep(
                build.ptr(ptrs), build.ptr(ptrs[T:]), build.ptr(s),
                build.ptr(x), build.ptr(out), build.i64(n), build.i64(T),
                stream())
        assert rc == 0, rc
        return out

    shapes = {"F": ("fib", 1 << 21), "B": ("bf", 1 << 20),
              "W": ("bf", 1 << 11), "H": ("bf", 1 << 11)}
    for path, (kind, rows) in shapes.items():
        if path not in paths:
            continue
        ext = kind == "bf"
        if ext:
            air = Air(BrainfuckAirConfig, rows, BrainfuckClaim("", b"", b""),
                      ProofOptions(19, 16, 20, 16, 16))
        else:
            air = Air(FibAirConfig, rows, Fp(0), ProofOptions(32, 4, 8, 8, 64))
        plan, source, _ = teval._plan_for(air)
        ce_n = air.ce_domain().size
        nb = air.config.NUM_BASE_COLUMNS
        ne = getattr(air.config, "NUM_EXTENSION_COLUMNS", 0)
        n_fp = sum(1 for k in plan.inv_keys if plan.inv_kind[k] == "fp")
        args = [rand(nb, ce_n), rand(ne, 3, ce_n),
                air.ce_domain().elements(dev),
                torch.zeros((len(plan.periodic), ce_n), dtype=torch.int64,
                            device=dev),
                rand(n_fp, ce_n), rand(len(plan.inv_keys) - n_fp, 3, ce_n)]
        s_new = rand(max(plan.num_slots, 1))
        for what, e, _k in plan.scalars:
            if what == "exp":
                s_new[plan.slot[("exp", e)]] = e
        cb = air.ce_blowup_factor

        def new_eval(launch=None):
            return keval.eval_terms(plan, source, cb, *args, s_new,
                                    launch=launch)

        if kind in evals:
            d, libs = evals[kind]
            exps = d["exps"][str(rows)]
            base = s_new[:d["slots"] - len(exps)]
            s_old = torch.cat([base, torch.tensor(exps, dtype=torch.int64,
                                                  device=dev)])
            record("eval_ext3" if ext else "eval", path,
                   [({"old": lambda: old_eval(d, libs, args[:6], s_old,
                                              ce_n, ext),
                      "new": new_eval}, ce_n)])
        if path in ("B", "W"):
            # every group in one launch (and the sum of the parts), a launch
            # a group after the chain pass, a launch a group each with the
            # chain, and the first two on gl_mul's C++ products
            cpp = (source.replace("gl3_mul_cc(", "gl3_mul(")
                   .replace("gl3_mul_base_cc(", "gl3_mul_base(")
                   .replace("gl_mul_cc(", "gl_mul("))
            kernel = keval.KERNEL_EXT3

            def groups_chain():
                out = torch.empty((3, ce_n), dtype=torch.int64, device=dev)
                ptrs = [build.ptr(t) for t in args + [s_new]]
                for g in range(len(plan.groups)):
                    kernel.launch("ms_eval_group", build.c_int(g), *ptrs,
                                  build.ptr_or_null(None), build.ptr(out),
                                  build.i64(ce_n), build.c_int(int(g > 0)),
                                  source_text=source)
                return out

            fns = {"grid": lambda: new_eval("grid"),
                   "groups": lambda: new_eval("groups"),
                   "groups_chain": groups_chain}
            for how in ("grid", "groups"):
                fns[f"{how}_cpp"] = lambda how=how: keval.eval_terms(
                    plan, cpp, cb, *args, s_new, launch=how)
            record_variants("eval_ext3 launches", path, fns,
                            keval.eval_terms_plain(plan, cb, *args, s_new)
                            if ce_n <= 1 << 16 else new_eval("groups"),
                            ce_n)
        del args
        torch.cuda.empty_cache()

        # the DEEP sum: the prove's terms, as chip_smoke.py's row
        n = air.lde_domain().size
        if ext:
            args_t = air.trace_arguments()
            offsets = sorted({off for _c, off in args_t})
            base, extc = rand(nb, n), rand(ne, 3, n)
            comp, invs = rand(cb, 3, n), rand(len(offsets) + 1, 3, n)
            # one view a column and a point, as composer.py gives them
            views = [base[c] for c in range(nb)] + [extc[e] for e in range(ne)]
            inv_rows = list(invs)
            cols = [views[c] for c, _o in args_t]
            rows_ = [inv_rows[offsets.index(o)] for _c, o in args_t]
            cols += [comp[k] for k in range(cb)]
            rows_ += [inv_rows[-1]] * cb
            s = rand(6 * len(cols) + 6)
        else:
            T = len(air.trace_arguments()) + cb
            cols = [rand(n) for _ in range(T)]
            invs = rand(3, n)
            inv_rows = list(invs)
            rows_ = [inv_rows[t % 2 if t < T - cb else 2] for t in range(T)]
            s = rand(2 * T + 2)
        x = air.lde_domain().elements(dev)
        fn = kdeep.deep_ext3 if ext else kdeep.deep
        if "deep" in old:
            record("deep_ext3" if ext else "deep", path,
                   [({"old": lambda: old_deep(cols, rows_, s, x, ext),
                      "new": lambda: fn(cols, rows_, s, x)}, n)])
        if path in ("B", "W", "F"):
            record_variants("deep lanes", path,
                            {f"lanes{k}": lambda k=k: fn(cols, rows_, s, x,
                                                         lanes=k)
                             for k in (1, 2, 4, 8)}, fn(cols, rows_, s, x), n)
        del cols, rows_, invs
        torch.cuda.empty_cache()


# kernel F's OOD sums: (Fq3, Karatsuba, P pairs a group, P0 pairs a group
# of Fp columns in an Fq3 transcript, threads a block)
OOD_VARIANTS = [(False, False, 20, 20, 128), (False, False, 16, 16, 128),
                (True, False, 4, 12, 128), (True, True, 2, 12, 128),
                (True, True, 3, 12, 128), (True, True, 4, 12, 128)]


def ood_variant_name(v):
    ext, kara, P, P0, T = v
    form = ("_kara" if kara else "_school") if ext else ""
    return f"ab_ood_{'fq3' if ext else 'fp'}{form}_p{P}_{P0}_t{T}"


def _ood_inputs(path, rand, dev):
    """The proves' OOD sums at `path`'s shapes: (cols, invs, pairs, gpow,
    ext) as chip_smoke.py's ood_sums rows give them (R is F's, H is W's;
    D rank 1's rows of two in F, the rows 1 + 2 i, so g^i starts at g)."""
    from ministark_tpu_torch.air import Air, ProofOptions
    from ministark_tpu_torch.models.brainfuck import (BrainfuckAirConfig,
                                                      BrainfuckClaim)
    from ministark_tpu_torch.ntt import Domain, powers
    from ministark_tpu_torch.parallel.executor import domain_points

    ext = path in ("B", "W", "H")
    if ext:
        rows = 1 << 20 if path == "B" else 1 << 11
        air = Air(BrainfuckAirConfig, rows, BrainfuckClaim("", b"", b""),
                  ProofOptions(19, 16, 20, 16, 16))
        n = air.lde_domain().size
        cols = [rand(n) for _ in range(17)]
        cols += [rand(3, n) for _ in range(9 + 16)]
        pairs = sorted({(off, c) for c, off in air.trace_arguments()},
                       key=lambda jc: (jc[1], jc[0]))
        pairs += [(2, 26 + k) for k in range(16)]
        return cols, rand(3, 3, n), pairs, powers(7, n, dev), True
    ncols, cb, n = (4, 8, 1 << 21) if path == "S" else (8, 1, 1 << 23)
    pairs = [(j, c) for c in range(ncols) for j in (0, 1)]
    pairs += [(2, ncols + k) for k in range(cb)]
    if path == "D":
        n //= 2
        gpow = domain_points(Domain(2 * n, 7), 1, 2, n, dev)[1]
    else:
        gpow = powers(7, n, dev)
    return ([rand(n) for _ in range(ncols + cb)], rand(3, n), pairs, gpow,
            False)


def _ood_runner(lib, fn_name, cols, invs, pairs, gpow, ext, P, dev,
                groups_fn=None, P0=None):
    """fn() running entry point fn_name of lib (new arguments: P last for
    Fp, the groups of P pairs, P0 of Fp columns in an Fq3 transcript, the
    partials' room asked of ms_ood_chunks for the shipped entry points,
    else room for one wave of 32 blocks an SM; groups_fn given: the old grouped kernel's
    records and arguments) on groups made once, the wrapper's per-call
    host work left out."""
    import torch

    from ministark_tpu_torch.ops import build
    from ministark_tpu_torch.ops import deep as kdeep

    n = gpow.shape[0]
    if groups_fn is None:
        words = kdeep.ood_groups(cols, invs, pairs, ext, P, P0)
        ngroups = len(words) // kdeep.ood_record_words(ext, P, P0)
        if fn_name.startswith("ms_ood_sums"):
            q = lib.ms_ood_chunks
            q.restype = ctypes.c_int64
            chunks = q(*(ctypes.c_int64(v) for v in (int(ext), P, n,
                                                       ngroups)))
        else:
            chunks = max(16, -(-132 * 32 // ngroups))
        extra = () if ext else (build.i64(P),)
    else:
        words, ngroups, chunks = groups_fn(cols, invs, pairs, ext)
        extra = ()
    recs = torch.tensor(words, dtype=torch.int64).to(dev)
    slots = 3 if ext else 1
    partial = torch.empty(chunks * slots * len(pairs), dtype=torch.int64,
                          device=dev)
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int

    def run():
        out = torch.empty(slots * len(pairs), dtype=torch.int64, device=dev)
        rc = fn(build.ptr(recs), build.i64(ngroups), build.ptr(gpow),
                build.ptr(partial), build.ptr(out), build.i64(n),
                build.i64(chunks), build.i64(len(pairs)), *extra,
                ctypes.c_void_p(build.current_stream()))
        assert rc == 0, rc
        return out.reshape(3, -1) if ext else out
    return run


def old_ood_groups(cols, invs, pairs, ext):
    """The grouped kernel's records (scripts/ood_grouped.cu, as
    ops/deep.py made them before the lazy design: two points, P = 8 pairs
    a group for Fp and 4 for Fq3, meta bit 0 the point's slot, bit 1 a
    reuse) with its chunks (about 132 * 16 blocks, none below 512 points);
    returns (words, groups, chunks)."""
    P, W = (4 if ext else 8), 2
    col_ptrs = {c: cols[c].data_ptr() for c in {c for _j, c in pairs}}
    row_ptrs = {j: invs[j].data_ptr() for j in {j for j, _c in pairs}}
    by_col: dict = {}
    for k, (j, c) in enumerate(pairs):
        by_col.setdefault(c, []).append((k, j))
    records, cur = [], []

    def flush():
        if not cur:
            return
        pts = list(dict.fromkeys(j for _k, j, _c, _r in cur))
        pad = [0] * (P - len(cur))
        records.extend(
            [len(cur), len(pts), int(cols[cur[0][2]].ndim == 2)]
            + [row_ptrs[j] for j in pts] + [0] * (W - len(pts))
            + [col_ptrs[c] for _k, _j, c, _r in cur] + pad
            + [pts.index(j) | r << 1 for _k, j, _c, r in cur] + pad
            + [k for k, _j, _c, _r in cur] + pad)
        cur.clear()

    for c, kjs in by_col.items():
        pts = {j for _k, j, _c, _r in cur}
        if cur and (len(cur) + len(kjs) > P
                    or len(pts | {j for _k, j in kjs}) > W
                    or cols[cur[0][2]].ndim != cols[c].ndim):
            flush()
        first = True
        for k, j in kjs:
            if len(cur) == P or len({jj for _k, jj, _c, _r in cur} | {j}) \
                    > W:
                flush()
                first = True
            cur.append((k, j, c, 0 if first else 1))
            first = False
    flush()
    groups = len(records) // (3 + W + 3 * P)
    n = cols[pairs[0][1]].shape[-1]
    chunks = max(1, min(-(-132 * 16 // groups), -(-n // 512), 65535))
    return records, groups, chunks


def _build_fixture(name, out_dir):
    """scripts/<name>.cu built with the port's nvcc flags (ptxas -v), its
    registers and stack frames printed; the loaded library."""
    from ministark_tpu_torch.ops import build

    so = os.path.join(out_dir, f"{name}.so")
    proc = _nvcc(os.path.join(ROOT, "scripts", f"{name}.cu"), so, build.CSRC,
                 "-Xptxas", "-v")
    _, err = proc.communicate(timeout=900)
    if proc.returncode:
        raise RuntimeError(f"building scripts/{name}.cu failed:\n{err}")
    print("\n".join(line for line in err.splitlines()
                    if "registers" in line or "Compiling entry" in line
                    or "stack frame" in line), flush=True)
    return ctypes.CDLL(so)


def ood_ab(paths, out_dir, rand, record, dev):
    """Kernel F's OOD sums against the grouped kernel they replaced
    (scripts/ood_grouped.cu), in turns, at each path's shapes (F, R: fib
    2^23 points, 17 pairs; S: the Rescue chain's 2^21, 16 pairs; D: a
    rank's 2^22 rows of F, from g; B: brainfuck's 2^24 points, 65 pairs;
    W, H: hello_world's 2^15), both through their entry points on groups
    made once."""
    import torch

    from ministark_tpu_torch.ops import deep as kdeep

    old = _build_fixture("ood_grouped", out_dir)
    kdeep.KERNEL_OOD.build()
    from ministark_tpu_torch.ops.build import _LIBS

    new_lib = _LIBS[kdeep.KERNEL_OOD._text(None)]
    for path in ("F", "R", "S", "D", "B", "W", "H"):
        if path not in paths:
            continue
        cols, invs, pairs, gpow, ext = _ood_inputs(path, rand, dev)
        P, P0 = kdeep.ood_pairs_a_group(ext, len(pairs))
        suffix = "_ext3" if ext else ""
        record("ood_sums" + suffix, path, [(
            {"old": _ood_runner(old, "ab_old_ood_sums" + suffix, cols, invs,
                                pairs, gpow, ext, P, dev, old_ood_groups),
             "new": _ood_runner(new_lib, "ms_ood_sums" + suffix, cols, invs,
                                pairs, gpow, ext, P, dev, P0=P0)},
            gpow.shape[0])])
        del cols, invs
        torch.cuda.empty_cache()


def ood_variants(paths, out_dir, rand, record_variants, dev):
    """Kernel F's OOD sums built at each OOD_VARIANTS entry (pairs a group,
    threads a block; csrc/deep.cu with one entry point a variant, ptxas's
    registers printed), each checked against the
    kernel as it ships and timed in turns at F's, S's, B's and W's shapes
    (the proves' pairs)."""
    import torch

    from ministark_tpu_torch.ops import build
    from ministark_tpu_torch.ops import deep as kdeep

    lines = [f'#include "{os.path.join(build.CSRC, "deep.cu")}"']
    for v in OOD_VARIANTS:
        ext, kara, P, P0, T = v
        W = kdeep.OOD_W[ext]
        lines.append(
            f"MS_API int {ood_variant_name(v)}(const int64_t* recs, "
            f"int64_t groups, const uint64_t* gpow, uint64_t* partial, "
            f"uint64_t* out, int64_t n, int64_t chunks, int64_t pairs, "
            + ("" if ext else "int64_t P, ")
            + f"cudaStream_t stream) {{ return launch_ood<"
            f"{str(ext).lower()}, {str(kara).lower()}, {P}, {P0}, {W}, {T}>("
            f"recs, groups, gpow, partial, out, n, chunks, pairs, stream); }}")
    src = os.path.join(out_dir, "ood_variants.cu")
    with open(src, "w") as f:
        f.write("\n".join(lines) + "\n")
    proc = _nvcc(src, src + ".so", build.CSRC, "-Xptxas", "-v")
    _, err = proc.communicate(timeout=1200)
    if proc.returncode:
        raise RuntimeError(f"building the OOD variants failed:\n{err}")
    print("\n".join(line for line in err.splitlines()
                    if "ood_kernel" in line or "registers" in line
                    or "stack frame" in line), flush=True)
    lib = ctypes.CDLL(src + ".so")

    for path in ("F", "S", "B", "W"):
        if path not in paths:
            continue
        cols, invs, pairs, gpow, ext = _ood_inputs(path, rand, dev)
        fn = kdeep.ood_sums_ext3 if ext else kdeep.ood_sums
        fns = {ood_variant_name(v): _ood_runner(
            lib, ood_variant_name(v), cols, invs, pairs, gpow, ext, v[2], dev,
            P0=v[3])
            for v in OOD_VARIANTS
            if v[0] == ext and (ext or v[2] >= len(pairs))}
        fns["shipped"] = lambda: fn(cols, invs, pairs, gpow)
        record_variants("ood variants", path, fns, fn(cols, invs, pairs,
                                                      gpow), gpow.shape[0])
        del cols, invs
        torch.cuda.empty_cache()


# the staged OOD design (scripts/ood_staged.cu): its entry points, pairs a
# group, for Fp and for Fq3 transcripts
OOD_STAGED = {False: (2, 4, 8), True: (2, 4)}


def _staged_groups(cols, pairs, ext, P):
    """scripts/ood_staged.cu's groups: a column's pairs in one group where
    they fit (columns of one kind a group, at most P pairs), in the order
    of the columns' first pairs; [pairs, kind, column pointers, metas
    (point << 1, bit 0 where the pair reads the column of the pair before
    it), the pairs' indices], padded to P."""
    by_col: dict = {}
    for k, (j, c) in enumerate(pairs):
        by_col.setdefault(c, []).append((j, k))
    info = {c: (cols[c].data_ptr(), int(cols[c].ndim == 2)) for c in by_col}
    words, cur = [], []

    def flush():
        if cur:
            pad = [0] * (P - len(cur))
            words.extend([len(cur), info[cur[0][0]][1]]
                         + [info[c][0] for c, _j, _k, _r in cur] + pad
                         + [j << 1 | r for _c, j, _k, r in cur] + pad
                         + [k for _c, _j, k, _r in cur] + pad)
            cur.clear()

    for c, jks in by_col.items():
        if cur and (len(cur) + len(jks) > P
                    or info[cur[0][0]][1] != info[c][1]):
            flush()
        for m, (j, k) in enumerate(jks):
            if len(cur) == P:
                flush()
                m = 0
            cur.append((c, j, k, int(m > 0)))
    flush()
    return words, len(words) // (2 + 3 * P)


def ood_staged(paths, out_dir, rand, record_variants, dev):
    """Kernel F's OOD sums as csrc/deep.cu ships them against the staged
    design (scripts/ood_staged.cu, ptxas's registers printed) at each
    OOD_STAGED pairs a group, in turns, at F's, B's and W's shapes (the
    proves' pairs).  The staged kernel's tile: 1024 points, halved down to
    128 while there are fewer than 264 tiles; its warps a block: every
    group up to 16, else evenly over the fewest blocks."""
    import torch

    from ministark_tpu_torch.ops import build
    from ministark_tpu_torch.ops import deep as kdeep

    src = os.path.join(ROOT, "scripts", "ood_staged.cu")
    so = os.path.join(out_dir, "ood_staged.so")
    proc = _nvcc(src, so, build.CSRC, "-Xptxas", "-v")
    _, err = proc.communicate(timeout=600)
    if proc.returncode:
        raise RuntimeError(f"building ood_staged.cu failed:\n{err}")
    print("\n".join(line for line in err.splitlines()
                    if "registers" in line or "Compiling entry" in line),
          flush=True)
    lib = ctypes.CDLL(so)

    def staged(cols, invs, pairs, gpow, ext, P):
        n, npts = gpow.shape[0], invs.shape[0]
        words, ngroups = _staged_groups(cols, pairs, ext, P)
        groups = torch.tensor(words, dtype=torch.int64).to(dev)
        tile = 1024
        while tile > 128 and -(-n // tile) < 264:
            tile //= 2
        batches = -(-ngroups // 16)
        warps = -(-ngroups // batches)
        blocks = min(-(-n // tile), 132 * 8)
        slots = 3 if ext else 1
        partial = torch.empty(blocks * slots * len(pairs), dtype=torch.int64,
                              device=dev)
        fn = getattr(lib, f"ab_staged_{'fq3' if ext else 'fp'}_p{P}")
        fn.restype = ctypes.c_int

        def run():
            out = torch.empty(slots * len(pairs), dtype=torch.int64,
                              device=dev)
            rc = fn(build.ptr(groups), build.i64(ngroups), build.i64(warps),
                    build.ptr(invs), build.i64(npts), build.ptr(gpow),
                    build.ptr(partial), build.ptr(out), build.i64(n),
                    build.i64(tile), build.i64(blocks), build.i64(len(pairs)),
                    ctypes.c_void_p(build.current_stream()))
            assert rc == 0, rc
            return out.reshape(3, -1) if ext else out
        return run

    for path in ("F", "B", "W"):
        if path not in paths:
            continue
        cols, invs, pairs, gpow, ext = _ood_inputs(path, rand, dev)
        fn = kdeep.ood_sums_ext3 if ext else kdeep.ood_sums
        # the shipped kernel through its own launch (its groups made once,
        # as the staged ones are), so that both are timed without the
        # wrapper's host work
        kdeep.KERNEL_OOD.build()
        from ministark_tpu_torch.ops.build import _LIBS

        fns = {"shipped": _ood_runner(
            _LIBS[kdeep.KERNEL_OOD._text(None)],
            "ms_ood_sums_ext3" if ext else "ms_ood_sums", cols, invs, pairs,
            gpow, ext, kdeep.ood_pairs_a_group(ext, len(pairs))[0], dev,
            P0=kdeep.ood_pairs_a_group(ext, len(pairs))[1])}
        for P in OOD_STAGED[ext]:
            fns[f"staged_p{P}"] = staged(cols, invs, pairs, gpow, ext, P)
        record_variants("ood staged", path, fns, fn(cols, invs, pairs, gpow),
                        gpow.shape[0])
        del cols, invs
        torch.cuda.empty_cache()


# the proves' coin steps: path -> (RPO-256, k draws, N powers of alpha)
COIN_STEPS = {"F": (False, 1, 8), "S": (False, 1, 8), "B": (False, 3, 16),
              "W": (False, 3, 16), "R": (True, 1, 8), "H": (True, 3, 16)}


def coin_ab(paths, out_dir, record, dev):
    """The device coin steps against the ones they replaced
    (scripts/coin_single.cu), in turns, at each prove's (k, N) (F, S:
    SHA-256, k = 1, N = 8; B, W: SHA-256, k = 3, N = 16; R, H: RPO-256 at
    F's and W's), a launch at a time; ptxas's registers and stack frames of
    both sources printed.  Then the RPO-256 steps' parts by their clock64()
    and %globaltimer stamps (scripts/coin_single.cu ab_rpo_parts_*), old
    and new in turns, five warm launches each at R's and H's (k, N)."""
    import hashlib

    import torch

    from ministark_tpu_torch import hash_rpo
    from ministark_tpu_torch.ops import build
    from ministark_tpu_torch.ops import coin as kcoin

    old = _build_fixture("coin_single", out_dir)
    proc = _nvcc(os.path.join(build.CSRC, "coin.cu"),
                 os.path.join(out_dir, "coin_new.so"), build.CSRC,
                 "-Xptxas", "-v")
    _, err = proc.communicate(timeout=600)
    print("\n".join(line for line in err.splitlines()
                    if "registers" in line or "Compiling entry" in line
                    or "stack frame" in line), flush=True)
    for kern in (kcoin.KERNEL_SHA, kcoin.KERNEL_RPO):
        kern.build()
    from ministark_tpu_torch.ops.build import _LIBS

    new = _LIBS[kcoin.KERNEL_SHA._text(None)]

    def runner(lib, name, seed, root, k, N):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int

        def run():
            out = torch.empty(32, dtype=torch.uint8, device=dev)
            draws = torch.empty(k, dtype=torch.int64, device=dev)
            pw = torch.empty((k, N), dtype=torch.int64, device=dev)
            rc = fn(ctypes.c_void_p(seed.data_ptr()),
                    ctypes.c_void_p(root.data_ptr()), ctypes.c_int64(k),
                    ctypes.c_int64(N), ctypes.c_void_p(out.data_ptr()),
                    ctypes.c_void_p(draws.data_ptr()),
                    ctypes.c_void_p(pw.data_ptr()),
                    ctypes.c_void_p(build.current_stream()))
            assert rc == 0, rc
            return torch.cat([out.view(torch.int64), draws, pw.reshape(-1)])
        return run

    def seeds(path, rpo):
        tag = path.encode()
        if rpo:
            return (hash_rpo.hash_elements(list(hashlib.sha256(tag).digest()
                                                [:8])),
                    hash_rpo.hash_elements(list(tag)))
        return (hashlib.sha256(tag).digest(),
                hashlib.sha256(tag + b" root").digest())

    for path, (rpo, k, N) in COIN_STEPS.items():
        if path not in paths:
            continue
        seed, root = (kcoin.seed_tensor(d, dev) for d in seeds(path, rpo))
        name = "coin_rpo" if rpo else "coin_sha"
        record(name, path, [({"old": runner(old, "ab_old_" + name, seed, root,
                                            k, N),
                              "new": runner(new, "ms_" + name, seed, root, k,
                                            N)}, 1)])
    cycles = torch.zeros(6, dtype=torch.int64, device=dev)
    vals = torch.zeros(6, dtype=torch.int64, device=dev)
    lat = old.ab_mul_latency
    lat.restype = ctypes.c_int
    for _ in range(2):  # the first launch warms up
        assert lat(ctypes.c_uint64(0x123456789ABCDEF), ctypes.c_void_p(
            cycles.data_ptr()), ctypes.c_void_p(vals.data_ptr()),
            ctypes.c_void_p(build.current_stream())) == 0
        torch.cuda.synchronize()
    forms = ("gl_mul_cc_lazy(x, x)", "gl_mul_cc_lazy(x, y)", "gl_mul(x, x)",
             "gl_mul_wide_lazy(x, x)", "gl_sqr_wide_lazy(x)",
             "gl_mul_wide_lazy(x, y)")
    print("product latency, clock64() cycles a product in a chain of 4096: "
          + ", ".join(f"{f} {c}" for f, c in zip(forms, cycles.tolist())),
          flush=True)
    parts = ("reseed", "digests", "powers")
    for path in ("R", "H"):
        if path not in paths:
            continue
        _rpo, k, N = COIN_STEPS[path]
        seed, root = (kcoin.seed_tensor(d, dev) for d in seeds(path, True))
        want = runner(new, "ms_coin_rpo", seed, root, k, N)()
        stamps = torch.zeros(8, dtype=torch.int64, device=dev)
        got: dict = {}
        variants = ("old", "new", "cc", "rounds", "squarings")
        for v in variants + variants[::-1]:
            fn = getattr(old, f"ab_rpo_parts_{v}")
            fn.restype = ctypes.c_int
            for rep in range(6):  # the first launch warms up
                out = torch.empty(32, dtype=torch.uint8, device=dev)
                draws = torch.empty(k, dtype=torch.int64, device=dev)
                pw = torch.empty((k, N), dtype=torch.int64, device=dev)
                assert fn(ctypes.c_void_p(seed.data_ptr()),
                          ctypes.c_void_p(root.data_ptr()),
                          ctypes.c_int64(k), ctypes.c_int64(N),
                          ctypes.c_void_p(out.data_ptr()),
                          ctypes.c_void_p(draws.data_ptr()),
                          ctypes.c_void_p(pw.data_ptr()),
                          ctypes.c_void_p(stamps.data_ptr()),
                          ctypes.c_void_p(build.current_stream())) == 0
                res = torch.cat([out.view(torch.int64), draws,
                                 pw.reshape(-1)])
                if not torch.equal(res, want):
                    raise SystemExit(f"ab_kernels: ab_rpo_parts_{v} differs "
                                     f"from ms_coin_rpo on {path}")
                if rep:
                    t = stamps.tolist()
                    for q, part in enumerate(parts):
                        got.setdefault(v, {}).setdefault(part, []).append(
                            (t[2 * q + 2] - t[2 * q],
                             t[2 * q + 3] - t[2 * q + 1]))
        for v in variants:
            med = {part: (sorted(c for c, _ns in xs)[len(xs) // 2],
                          sorted(ns for _c, ns in xs)[len(xs) // 2])
                   for part, xs in got[v].items()}
            print(f"coin_rpo parts ({path}, k = {k}, N = {N}) {v}, median "
                  f"of {len(got[v]['reseed'])}: "
                  + ", ".join(f"{part} {c} cycles {ns} ns"
                              for part, (c, ns) in med.items()),
                  flush=True)


def rpo_sweep(old_merge, new_merge, old_hash, new_hash, old_grind, new_grind,
              old_tree, digests, strided, ext3, rand, seed, record_variants):
    """Kernel G against the old one, each in turns with the others: "old"
    (the old kernel, one state a thread), "new_e1" and "new_e3" (1 or 3
    elements of a state a lane)."""
    import torch

    from ministark_tpu_torch import hash_rpo, merkle
    from ministark_tpu_torch.ops import rpo256 as krpo

    def routes(old_fn, new_fn):
        return {"old": old_fn, "new_e1": lambda: new_fn(1),
                "new_e3": lambda: new_fn(3)}

    # one tree level of k merges
    for k in [1 << i for i in range(23)]:
        d = digests(2 * k)
        record_variants(
            "rpo256 level", f"{k} merges",
            routes(lambda: old_merge(d[:k], d[k:]),
                   lambda e: new_merge(d[:k], d[k:], e)),
            old_merge(d[:k], d[k:]), k)
        del d
    # the proves' row hashes: R's 2^23 rows of 8 and 4 columns and FRI rows
    # (2^20 of 8), H's 2^15 rows of 17 columns, of 9 and 16 Fq3 columns
    # and FRI rows (2^11 of 16 Fq3 values)
    n, m = 1 << 23, 1 << 15
    for name, r in (("R 8 columns", lambda: strided(rand(8, n).T)),
                    ("R 4 columns", lambda: strided(rand(4, n).T)),
                    ("R FRI rows", lambda: strided(rand(n // 8, 8))),
                    ("H 17 columns", lambda: strided(rand(17, m).T)),
                    ("H 9 Fq3 columns", lambda: ext3(rand(9, 3, m))),
                    ("H 16 Fq3 columns", lambda: ext3(rand(16, 3, m))),
                    ("H FRI rows", lambda: ext3(rand(16, 3, m // 16)))):
        x = r()
        record_variants("rpo256 rows", f"{x[1]} rows, {name}",
                        routes(lambda: old_hash(*x), lambda e: new_hash(*x, e)),
                        old_hash(*x), x[1])
        del x
        torch.cuda.empty_cache()
    # grind batches: R's 8 bits (1024 nonces), H's 20 bits (2^20)
    for batch, bits in ((1 << 10, 8), (1 << 20, 20)):
        record_variants("rpo256_grind batch", f"{batch} nonces",
                        routes(lambda: old_grind(seed, batch, bits),
                               lambda e: new_grind(seed, batch, bits, e)),
                        old_grind(seed, batch, bits), batch)
    # a 2^15-leaf tree with the levels of at most `tops` leaves in one
    # launch (0: none)
    level = digests(m)
    keep = krpo.TOPS_LEAVES
    fns = {}
    for tops in (0, 16, 32, 64):
        def run(tops=tops):
            krpo.TOPS_LEAVES = tops
            try:
                return torch.cat(merkle.tree_levels(level, hash_rpo))
            finally:
                krpo.TOPS_LEAVES = keep
        fns[f"tops{tops}"] = run
    record_variants("rpo256_tree tops", f"{m} leaves", fns,
                    torch.cat(old_tree(level)), m)


def big_ab(args, old_dir, old, dev, results):
    """The BIG path's kernels against the parent's bigfield.cu (DIR), in
    turns (old, new, new, old; --turns rounds): big_ntt on each of the eight
    2^18-point transforms (Fp128 and Fp252; forward and inverse; plain and
    over the coset of the field's generator) and big_mul on 2^18 pairs of
    each field (over copies of its inputs read in turn, four times the
    L2), by CUDA events over --reps launches and by the device time alone
    (torch.profiler); ptxas's registers and spills of both sources
    first."""
    import itertools
    import time

    import torch

    import chip_smoke
    from ministark_tpu_torch.fields.bigvec import (BigDomain, Fp128Vec,
                                                   Fp252Vec)
    from ministark_tpu_torch.ops import bigfield as kbig
    from ministark_tpu_torch.ops import build

    t0 = time.perf_counter()
    procs = {}
    for k, (name, src, inc) in enumerate((
            ("old", os.path.join(old_dir, "bigfield.cu"), old_dir),
            ("new", os.path.join(build.CSRC, "bigfield.cu"), build.CSRC))):
        out = os.path.join(old_dir, f"ptxas_{k}.so")
        procs[name] = (src, _nvcc(src, out, inc, "-Xptxas", "-v"))
    for name, (src, p) in procs.items():
        lines = ptxas_lines(p, src)
        print(f"ptxas {name} bigfield.cu (built within "
              f"{time.perf_counter() - t0:.1f} s):", flush=True)
        print("\n".join(f"  {line}" for line in lines), flush=True)
    lib = old["bigfield"]
    stream = build.current_stream
    n = 1 << chip_smoke.BIG_LOG_N
    reps = args.reps or 20

    def old_ntt(x, tw, first, last, f):
        y = torch.empty_like(x)
        rc = lib.ms_big_ntt(
            build.ptr(x), build.ptr(y), build.ptr(tw),
            build.ptr_or_null(first), build.ptr_or_null(last),
            build.i64(n), ctypes.c_char_p(f.mod_desc), build.i64(f.L64),
            ctypes.c_void_p(stream()))
        assert rc == 0, rc
        return y

    def old_mul(a, b, f):
        out = torch.empty_like(a)
        rc = lib.ms_big_mul(
            build.ptr(a), build.ptr(b), build.ptr(out), build.i64(n),
            build.i64(1), ctypes.c_char_p(f.mod_desc), build.i64(f.L64),
            ctypes.c_void_p(stream()))
        assert rc == 0, rc
        return out

    def turns(fns):
        """Both versions in order and back (old, new, new, old), --turns
        rounds."""
        order = list(fns)
        events = {v: [0.0] * args.turns for v in fns}
        device = {v: [0.0] * args.turns for v in fns}
        for t in range(args.turns):
            for v in order + order[::-1]:
                events[v][t] += chip_smoke.time_ms(torch, fns[v], reps) / 2
                d = chip_smoke.device_only_ms(torch, fns[v], reps)
                device[v][t] += (d or float("nan")) / 2
        return events, device

    def spread(xs):
        return f"{sum(xs) / len(xs):.4f} [{min(xs):.4f}-{max(xs):.4f}]"

    rows = []
    for f in (Fp128Vec, Fp252Vec):
        x = f.pack(chip_smoke.big_values(f, n, f.L64), dev)
        y = f.pack(chip_smoke.big_values(f, n, f.L64 + 1), dev)
        for offset in (1, f.generator):
            dom = BigDomain(f, n, offset)
            for inverse in (False, True):
                tw, first, last = dom._tables(inverse, str(dev))
                table = dom._kernel_table(inverse, str(dev))
                args_ = (x, tw, first, last, f)
                fns = {"old": lambda a=args_: old_ntt(*a),
                       "new": lambda a=args_, t=table: kbig.big_ntt(
                           a[0], a[1], a[4], a[2], a[3], t)}
                rows.append((f"big_ntt {f.name} "
                             f"{'ifft' if inverse else 'fft'} "
                             f"{'coset' if offset != 1 else 'plain'}", fns))
        # each version reads the copies in turn, from the first (compared)
        sets = [(x, y)] + [(x.clone(), y.clone()) for _ in range(
            chip_smoke.l2_copies(torch, 3 * x.nbytes) - 1)]
        fns = {}
        for v, mul in (("old", old_mul), ("new", kbig.big_mul)):
            it = itertools.cycle(sets)
            fns[v] = lambda it=it, mul=mul, f=f: mul(*next(it), f)
        rows.append((f"big_mul {f.name}", fns))
        for name, fns in rows[-5:]:
            want = fns["old"]()
            for v, fn in fns.items():
                if not torch.equal(fn(), want):
                    raise SystemExit(f"ab_kernels: {name}: {v} and old "
                                     f"differ")
            events, device = turns(fns)
            res = results.setdefault("big", {})[name] = {}
            for v in fns:
                res[f"{v}_ms"] = events[v]
                res[f"{v}_device_only_ms"] = device[v]
                print(f"{name}: {v} {spread(events[v])} ms, device only "
                      f"{spread(device[v])} ms", flush=True)
        del x, y, sets
        torch.cuda.empty_cache()
    big = results["big"]
    for kernel in ("big_ntt", "big_mul"):
        rows_k = [r for name, r in big.items() if name.startswith(kernel)]
        for key in rows_k[0]:
            if all(key in r for r in rows_k):
                total = [sum(r[key][t] for r in rows_k)
                         for t in range(args.turns)]
                print(f"{kernel} summed, {key}: {spread(total)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old_dir")
    ap.add_argument("--reps", type=int, default=0,
                    help="launches per timing (default 20 below 2^20 points "
                         "a launch, else 5)")
    ap.add_argument("--paths", default="F,B,W,L,R,H,S,D")
    ap.add_argument("--turns", type=int, default=1,
                    help="rounds of turns (old, new, new, old; variants in "
                         "order and back)")
    ap.add_argument("--inv-variants", action="store_true")
    ap.add_argument("--rpo-sweep", action="store_true")
    ap.add_argument("--ood-variants", action="store_true")
    ap.add_argument("--ood-staged", action="store_true")
    ap.add_argument("--ood", action="store_true",
                    help="kernel F's OOD sums against scripts/ood_grouped.cu")
    ap.add_argument("--coin", action="store_true",
                    help="the coin steps against scripts/coin_single.cu")
    ap.add_argument("--big", action="store_true",
                    help="the BIG path's big_ntt and big_mul against an old "
                         "bigfield.cu (with its bigfield.cuh) in DIR")
    ap.add_argument("--old-tree", default=None,
                    help="a whole older tree (git archive): kernel E's old "
                         "generated sources come from its ops/eval.py")
    args = ap.parse_args()
    paths = args.paths.split(",")
    import torch

    if not torch.cuda.is_available():
        print("ab_kernels: needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ministark_tpu_torch.fields import device as fd
    from ministark_tpu_torch.fields.scalar import P
    from ministark_tpu_torch.ntt import Domain, _split_n, _stage_table
    from ministark_tpu_torch.ops import build
    from ministark_tpu_torch.ops import inv as kinv
    from ministark_tpu_torch.ops import ntt as kntt
    from ministark_tpu_torch.ops import transpose as ktr

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    old_dir = os.path.abspath(args.old_dir)
    old = build_old(old_dir)
    from ministark_tpu_torch.ops import sha256 as ksha

    if not args.big or set(old) - {"bigfield"}:
        for k in (kntt.KERNEL, ktr.KERNEL, kinv.KERNEL, ksha.KERNEL):
            k.build()
    if args.inv_variants:
        variants, report = build_inv_variants(old_dir)
        print("\n".join(report), flush=True)
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev)
    g.manual_seed(7)

    def stream():
        return ctypes.c_void_p(build.current_stream())


    def rand(*shape):
        return fd.canonicalize(torch.randint(
            -(1 << 63), (1 << 63) - 1, shape, generator=g, device=dev,
            dtype=torch.int64))

    def old_ntt(x, tw, pre, tmat):
        B, n1, C = x.shape
        y = torch.empty_like(x)
        tw = tw if tw.numel() else torch.ones(1, dtype=torch.int64,
                                              device=dev)
        null = build.ptr_or_null
        rc = old["ntt"].ms_col_ntt(
            build.ptr(x), build.ptr(y), build.ptr(tw), null(pre), null(tmat),
            build.i64(B), build.i64(n1), build.i64(C),
            build.i64(n1.bit_length() - 1), stream())
        assert rc == 0, rc
        return y

    def old_stage(x, tw, pre, tmat):
        """The old multi-pass NTT: one launch a stage."""
        B, n1, C = x.shape
        y = torch.empty_like(x)
        null = build.ptr_or_null
        log_n1 = n1.bit_length() - 1
        for stage in range(log_n1 + 1):
            rc = old["ntt"].ms_col_ntt_stage(
                build.ptr(x), build.ptr(y), build.ptr(tw), null(pre),
                null(tmat), build.i64(B), build.i64(n1), build.i64(C),
                build.i64(log_n1), build.i64(stage), stream())
            assert rc == 0, rc
        return y

    def old_tr(x):
        B, R, C = x.shape
        y = torch.empty((B, C, R), dtype=x.dtype, device=dev)
        rc = old["transpose"].ms_transpose(build.ptr(x), build.ptr(y),
                                           build.i64(B), build.i64(R),
                                           build.i64(C), stream())
        assert rc == 0, rc
        return y

    def old_inv_fp(a):
        out = torch.empty_like(a)
        rc = old["inv"].ms_inv_fp(build.ptr(a), build.ptr(out),
                                  build.i64(a.numel()), stream())
        assert rc == 0, rc
        return out

    def old_inv_ext3(a):
        out = torch.empty_like(a)
        rc = old["inv"].ms_inv_ext3(build.ptr(a), build.ptr(out),
                                    build.i64(a.shape[0]),
                                    build.i64(a.shape[-1]), stream())
        assert rc == 0, rc
        return out

    def variant_fn(field, v, a):
        def run():
            out = torch.empty_like(a)
            fn = getattr(variants, variant_name(field, v))
            if field == "fp":
                rc = fn(build.ptr(a), build.ptr(out), build.i64(a.numel()),
                        stream())
            else:
                rc = fn(build.ptr(a), build.ptr(out), build.i64(a.shape[0]),
                        build.i64(a.shape[-1]), stream())
            assert rc == 0, rc
            return out
        return run

    def events_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    results = {}

    def spread(xs):
        return f"{sum(xs) / len(xs):.4f} [{min(xs):.4f}-{max(xs):.4f}]"

    def record(name, path, parts):
        """parts: ({"old": fn, "new": fn}, points) for each of the path's
        launches; each version's times add up over them.  Below 2^20
        points, where a launch costs the host more than the card, also the
        device time alone (torch.profiler), in the same turns.  Each of
        --turns rounds takes old, new, new, old; the mean of every visit is
        printed with the range of the rounds' means."""
        import chip_smoke

        turns = {"old": [0.0] * args.turns, "new": [0.0] * args.turns}
        dturns = {"old": [0.0] * args.turns, "new": [0.0] * args.turns}
        small = False
        for fns, points in parts:
            if not torch.equal(fns["old"](), fns["new"]()):
                raise SystemExit(f"ab_kernels: {name} on {path}: old and "
                                 f"new differ")
            reps = args.reps or (20 if points < (1 << 20) else 5)
            small = small or points < 1 << 20
            for t in range(args.turns):
                for v in ("old", "new", "new", "old"):
                    turns[v][t] += events_ms(fns[v], reps) / 2
                    if points < 1 << 20:
                        d = chip_smoke.device_only_ms(torch, fns[v], reps)
                        dturns[v][t] += (d or float("nan")) / 2
        totals = {v: sum(x) / args.turns for v, x in turns.items()}
        totals.update({f"{v}_turns": x for v, x in turns.items()})
        if small:
            totals.update({f"{v}_device_only": sum(x) / args.turns
                           for v, x in dturns.items()})
            totals.update({f"{v}_device_only_turns": x
                           for v, x in dturns.items()})
        results.setdefault(name, {})[path] = totals
        dev_only = ""
        if small:
            dev_only = (f"; device only: old {spread(dturns['old'])} ms, "
                        f"new {spread(dturns['new'])} ms")
        print(f"{name} ({path}): old {spread(turns['old'])} ms, new "
              f"{spread(turns['new'])} ms, "
              f"{totals['old'] / totals['new']:.2f}x{dev_only}", flush=True)

    def record_variants(name, path, fns, want, points):
        """Every variant of `fns` ({name: fn}) equal to `want`, then timed
        in turns: all in order, then all in reverse, --turns rounds."""
        for v, fn in fns.items():
            if not torch.equal(fn(), want):
                raise SystemExit(f"ab_kernels: {v} on {path} differs")
        import chip_smoke

        reps = args.reps or (20 if points < (1 << 20) else 5)
        order = list(fns)
        times = {v: [0.0] * args.turns for v in order}
        dev_ms = {v: [0.0] * args.turns for v in order}
        for t in range(args.turns):
            for v in order + order[::-1]:
                times[v][t] += events_ms(fns[v], reps) / 2
                if points < 1 << 20:
                    d = chip_smoke.device_only_ms(torch, fns[v], reps)
                    dev_ms[v][t] += (d or float("nan")) / 2
        results.setdefault(name, {})[path] = times
        for v in sorted(order, key=lambda v: sum(times[v])):
            extra = (f" (device only {spread(dev_ms[v])} ms)"
                     if points < 1 << 20 else "")
            print(f"{name} ({path}): {v} {spread(times[v])} ms{extra}",
                  flush=True)

    def inv_inputs(path):
        """Kernel A's inputs on `path`, zeros included: the Fp vector (F:
        the OOD inverses over the 2^23-point LDE domain; B, W: the three
        Fp constraint denominators over the CE domain) and the Fq3 DEEP
        rows (B, W: three OOD points, (3, 3, n))."""
        n = {"F": 1 << 23, "B": 1 << 24, "W": 1 << 15}[path]
        a = rand(n if path == "F" else 3 * n)
        a[::4096] = 0
        a3 = None
        if path != "F":
            a3 = rand(3, 3, n)
            a3[..., ::4096] = 0
        return a, a3

    def lde_passes(n, planes, offset=7):
        """Both passes of a (planes, n) coset LDE: (x, tw, pre, tmat) each,
        and the transpose's input."""
        n1, n2 = _split_n(n)
        d = Domain(n, offset)
        tw1 = _stage_table(pow(d.group_gen, n2, P), n1, dev)
        tw2 = _stage_table(pow(d.group_gen, n1, P), n2, dev)
        return ((rand(planes, n1, n2), tw1, rand(n1, n2), rand(n1, n2)),
                (rand(planes, n2, n1), tw2, None, None))

    def ntt_parts(passes):
        return [({"old": lambda p=p: old_ntt(*p),
                  "new": lambda p=p: kntt.col_ntt(*p)}, p[0].numel())
                for p in passes]

    def tr_parts(xs):
        return [({"old": lambda x=x: old_tr(x),
                  "new": lambda x=x: ktr.transpose(x)}, x.numel())
                for x in xs]

    for path, n, widths in (("F", 1 << 23, (8,)),
                            ("B", 1 << 24, (17, 27, 48)),
                            ("W", 1 << 15, (17, 27, 48))):
        if path not in paths:
            continue
        if "ntt" in old or "transpose" in old:
            passes = [p for w in widths for p in lde_passes(n, w)]
            if "ntt" in old:
                record("ntt", path, ntt_parts(passes))
            if "transpose" in old:
                record("transpose", path,
                       tr_parts([p[0] for p in passes[::2]]))
            del passes
            torch.cuda.empty_cache()
        if "inv" in old or args.inv_variants:
            a, a3 = inv_inputs(path)
            if "inv" in old:
                record("inv", path, [({"old": lambda: old_inv_fp(a),
                                       "new": lambda: kinv.inv_fp(a)},
                                      a.numel())])
                if a3 is not None:
                    record("inv_ext3", path,
                           [({"old": lambda: old_inv_ext3(a3),
                              "new": lambda: kinv.inv_ext3(a3)},
                             a3.numel())])
            if args.inv_variants and path != "W":
                record_variants(
                    "inv variants", path,
                    {variant_name("fp", v): variant_fn("fp", v, a)
                     for v in INV_FP_VARIANTS}, kinv.inv_fp(a), a.numel())
                if a3 is not None:
                    record_variants(
                        "inv_ext3 variants", path,
                        {variant_name("ext3", v): variant_fn("ext3", v, a3)
                         for v in INV_EXT3_VARIANTS}, kinv.inv_ext3(a3),
                        a3.numel())
            del a, a3
            torch.cuda.empty_cache()

    t1, t2 = _split_n(1 << 27)
    n1, n2 = _split_n(1 << 29)
    if "L" in paths and "ntt" in old:
        # L: the 2^27-point inverse transform's two passes (tmat) and the
        # 2^29-point coset transform's first (pre and tmat), one column a
        # block
        passes = [(rand(1, rows, cols),
                   _stage_table(pow(Domain(rows * cols).group_gen, cols, P),
                                rows, dev),
                   rand(rows, cols) if pre else None, rand(rows, cols))
                  for rows, cols, pre in ((t1, t2, False), (t2, t1, False),
                                          (n1, n2, True))]
        record("ntt", "L", ntt_parts(passes))
        del passes
        torch.cuda.empty_cache()
    if "L" in paths and "transpose" in old:
        record("transpose", "L", tr_parts([rand(1, t1, t2), rand(1, n1, n2)]))
        torch.cuda.empty_cache()
    if "L" in paths and hasattr(old.get("ntt"), "ms_col_ntt_stage"):
        # the multi-pass NTT: the 2^29-point LDE's second pass (2^14
        # columns of 2^15 rows), and n1 = 2^12 (the check against kernel B)
        # and 2^16 on narrow columns, with pre and tmat
        def stage_part(B, rows, cols, tables):
            x = rand(B, rows, cols)
            tw = _stage_table(pow(Domain(rows * cols).group_gen, cols, P),
                              rows, dev)
            pre = rand(rows, cols) if tables else None
            tmat = rand(rows, cols) if tables else None
            return ({"old": lambda: old_stage(x, tw, pre, tmat),
                     "new": lambda: kntt.col_ntt_staged(x, tw, pre, tmat)},
                    x.numel())

        record("ntt_stage", "L", [stage_part(1, n2, n1, False)])
        torch.cuda.empty_cache()
        record("ntt_stage", "n1=2^12", [stage_part(2, 1 << 12, 64, True)])
        record("ntt_stage", "n1=2^16", [stage_part(1, 1 << 16, 16, True)])

    if "rpo256" in old:
        rpo_ab(args, paths, old["rpo256"], rand, stream, record,
               record_variants, dev, results)
    if "sha256" in old:
        sha_ab(paths, old["sha256"], rand, stream, record, record_variants,
               dev)
    if "deep" in old or args.old_tree:
        ef_ab(paths, old, args.old_tree, rand, stream, record,
              record_variants, dev)
    if args.ood:
        ood_ab(paths, old_dir, rand, record, dev)
    if args.coin:
        coin_ab(paths, old_dir, record, dev)
    if args.ood_variants:
        ood_variants(paths, old_dir, rand, record_variants, dev)
    if args.ood_staged:
        ood_staged(paths, old_dir, rand, record_variants, dev)
    if args.big:
        big_ab(args, old_dir, old, dev, results)

    print(json.dumps({"card": card, "ab": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
