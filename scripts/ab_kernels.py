#!/usr/bin/env python3
"""Kernels B (column NTT) and C (transpose) against an earlier version of
their sources, on one card, at the shapes of chip_smoke.py's paths.

    git show <commit>:ministark_tpu_torch/csrc/ntt.cu > DIR/ntt.cu
    git show <commit>:ministark_tpu_torch/csrc/transpose.cu > DIR/transpose.cu
    python3 scripts/ab_kernels.py DIR [--reps N] [--paths F,B,W,L]

Builds the two old sources with the port's nvcc flags into DIR and loads
them beside the current kernels (the old entry points: ``ms_col_ntt`` with
its tile width argument, ``ms_transpose``).  For every shape it checks
that old and new give the same values, then times them in turns (old,
new, new, old; CUDA events over ``reps`` launches each, after a warm-up)
and prints the mean of each version's two turns; one JSON line at the
end.  Paths as in chip_smoke.py: F (fib 2^24 values: the 2^23-point
8-column LDE), B (brainfuck 2^20 rows: 2^24-point LDEs of 17, 27 and 48
planes), W (hello_world: the same at 2^15 points), L (the 2^29-point
LDE's three kernel-B passes and two transposes).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_old(old_dir):
    """{"ntt": CDLL, "transpose": CDLL} of the old sources, built at once
    with the port's nvcc flags."""
    from ministark_tpu_torch.ops import build

    jobs = {}
    for name in ("ntt", "transpose"):
        out = os.path.join(old_dir, f"{name}_old.so")
        jobs[name] = out, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o",
             out, os.path.join(old_dir, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, (out, p) in jobs.items():
        _, err = p.communicate(timeout=600)
        if p.returncode:
            raise RuntimeError(f"building the old {name}.cu failed:\n{err}")
        libs[name] = ctypes.CDLL(out)
    libs["ntt"].ms_col_ntt.restype = ctypes.c_int
    libs["transpose"].ms_transpose.restype = ctypes.c_int
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old_dir")
    ap.add_argument("--reps", type=int, default=0,
                    help="launches per timing (default 20 below 2^20 points "
                         "a launch, else 5)")
    ap.add_argument("--paths", default="F,B,W,L")
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
    from ministark_tpu_torch.ops import ntt as kntt
    from ministark_tpu_torch.ops import transpose as ktr

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    old = build_old(os.path.abspath(args.old_dir))
    kntt.KERNEL.build()
    ktr.KERNEL.build()
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
        passes = [p for w in widths for p in lde_passes(n, w)]
        record("ntt", path, ntt_parts(passes))
        record("transpose", path, tr_parts([p[0] for p in passes[::2]]))
        del passes
        torch.cuda.empty_cache()

    if "L" in paths:
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
