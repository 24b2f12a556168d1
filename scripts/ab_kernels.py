#!/usr/bin/env python3
"""Kernels A (batch inverse), B (column NTT) and C (transpose) against an
earlier version of their sources, on one card, at the shapes of
chip_smoke.py's paths.

    git show <commit>:ministark_tpu_torch/csrc/ntt.cu > DIR/ntt.cu
    git show <commit>:ministark_tpu_torch/csrc/transpose.cu > DIR/transpose.cu
    git show <commit>:ministark_tpu_torch/csrc/inv.cu > DIR/inv.cu
    git show <commit>:ministark_tpu_torch/csrc/goldilocks.cuh > DIR/goldilocks.cuh
    python3 scripts/ab_kernels.py DIR [--reps N] [--paths F,B,W,L]
                                      [--inv-variants]

Builds each of the three sources found in DIR with the port's nvcc flags
into DIR, its includes looked up in DIR before csrc/ (so an old inv.cu
takes its own goldilocks.cuh), and loads it beside the current kernels
(the old entry points: ``ms_col_ntt`` with its tile width argument,
``ms_transpose``, ``ms_inv_fp`` and ``ms_inv_ext3``).  For every shape it
checks that old and new give the same values, then times them in turns
(old, new, new, old; CUDA events over ``reps`` launches each, after a
warm-up) and prints the mean of each version's two turns; one JSON line
at the end.  Paths as in chip_smoke.py: F (fib 2^24 values: the
2^23-point 8-column LDE, one 2^23-value inverse), B (brainfuck 2^20 rows:
2^24-point LDEs of 17, 27 and 48 planes, the three Fp denominators and
the three Fq3 DEEP rows of 2^24 values to invert), W (hello_world: the
same at 2^15 points), L (the 2^29-point LDE's three kernel-B passes and
two transposes; no inverse).

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
import math
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


PROTOS = {"ntt": ("ms_col_ntt",), "transpose": ("ms_transpose",),
          "inv": ("ms_inv_fp", "ms_inv_ext3")}


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
            getattr(libs[name], fn).restype = ctypes.c_int
    return libs


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
    p = _nvcc(src, out, build.CSRC, "-Xptxas", "-v")
    _, err = p.communicate(timeout=900)
    if p.returncode:
        raise RuntimeError(f"building the kernel A variants failed:\n{err}")
    report, kernel = [], None
    for line in err.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        elif kernel and ("registers" in line or "spill" in line):
            report.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
    lib = ctypes.CDLL(out)
    for field, vs in (("fp", INV_FP_VARIANTS), ("ext3", INV_EXT3_VARIANTS)):
        for v in vs:
            getattr(lib, variant_name(field, v)).restype = ctypes.c_int
    return lib, report


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old_dir")
    ap.add_argument("--reps", type=int, default=0,
                    help="launches per timing (default 20 below 2^20 points "
                         "a launch, else 5)")
    ap.add_argument("--paths", default="F,B,W,L")
    ap.add_argument("--inv-variants", action="store_true")
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
    for k in (kntt.KERNEL, ktr.KERNEL, kinv.KERNEL):
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
            build.i64(n1.bit_length() - 1),
            build.i64(math.gcd(C, 16384 // n1)), stream())
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

    def record(name, path, parts):
        """parts: ({"old": fn, "new": fn}, points) for each of the path's
        launches; each version's times add up over them."""
        totals = {}
        for fns, points in parts:
            if not torch.equal(fns["old"](), fns["new"]()):
                raise SystemExit(f"ab_kernels: {name} on {path}: old and "
                                 f"new differ")
            reps = args.reps or (20 if points < (1 << 20) else 5)
            for v in ("old", "new", "new", "old"):
                totals[v] = totals.get(v, 0.0) + events_ms(fns[v], reps) / 2
        results.setdefault(name, {})[path] = totals
        print(f"{name} ({path}): old {totals['old']:.3f} ms, new "
              f"{totals['new']:.3f} ms, {totals['old'] / totals['new']:.2f}x",
              flush=True)

    def record_variants(name, path, fns, want, points):
        """Every variant of `fns` ({name: fn}) equal to `want`, then timed
        in turns: all in order, then all in reverse."""
        for v, fn in fns.items():
            if not torch.equal(fn(), want):
                raise SystemExit(f"ab_kernels: {v} on {path} differs")
        reps = args.reps or (20 if points < (1 << 20) else 5)
        order = list(fns)
        times = dict.fromkeys(order, 0.0)
        for v in order + order[::-1]:
            times[v] += events_ms(fns[v], reps) / 2
        results.setdefault(name, {})[path] = times
        for v in sorted(order, key=times.get):
            print(f"{name} ({path}): {v} {times[v]:.3f} ms", flush=True)

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

    if "L" in paths and "ntt" in old and "transpose" in old:
        # L: the 2^27-point inverse transform's two passes (tmat) and the
        # 2^29-point coset transform's first (pre and tmat), one column a
        # block
        t1, t2 = _split_n(1 << 27)
        n1, n2 = _split_n(1 << 29)
        passes = [(rand(1, rows, cols),
                   _stage_table(pow(Domain(rows * cols).group_gen, cols, P),
                                rows, dev),
                   rand(rows, cols) if pre else None, rand(rows, cols))
                  for rows, cols, pre in ((t1, t2, False), (t2, t1, False),
                                          (n1, n2, True))]
        record("ntt", "L", ntt_parts(passes))
        del passes
        torch.cuda.empty_cache()
        record("transpose", "L", tr_parts([rand(1, t1, t2), rand(1, n1, n2)]))

    print(json.dumps({"card": card, "ab": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
