#!/usr/bin/env python3
"""Registers, shared memory and spills of every hand-written CUDA kernel.

    python3 scripts/ptxas_report.py [--sass FILE.cu,...] [--sass-dir DIR]

Compiles each ``ministark_tpu_torch/csrc/*.cu`` file and the constraint
evaluators generated for the fib AIR (2^21 rows), the brainfuck AIR
(2^20 rows) and the Rescue AIR (2^18 rows) with the port's nvcc flags plus ``-Xptxas -v``, all in
parallel, and prints ptxas's line for each kernel and the seconds each
source took to build.
Needs nvcc (the CUDA toolkit); no card.  Writes into a temporary directory
and leaves nothing behind.

``--sass`` also disassembles the named sources' libraries (``cuobjdump
-sass``) and prints, for each kernel, its instruction count, its most
frequent opcodes, its constant-memory loads (LDC: a constant read through
a computed address; a constant operand c[bank][offset] inside an
instruction costs no load) and its loops (backward branches: the body's
length and opcode mix), which say whether independent dependency chains
share a loop body (interleaved) or each run a loop of their own.  With
``--sass-dir`` the whole listing of each is written there too.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")


def sass_summary(listing: str) -> list[str]:
    """Per kernel of a cuobjdump -sass listing: instructions, top opcodes,
    constant loads and loops."""
    out, funcs = [], re.split(r"\n\s*Function : ", listing)[1:]
    for f in funcs:
        name = f.split("\n", 1)[0].strip()
        insns = [(int(m.group(1), 16), m.group(3), m.group(4))
                 for m in _INSN.finditer(f)]
        if not insns:
            continue
        ops = collections.Counter(op.split(".")[0] for _a, op, _r in insns)
        const_operands = sum(1 for _a, op, rest in insns
                             if "c[0x3]" in rest and not op.startswith("LDC"))
        addr = {a: i for i, (a, _op, _r) in enumerate(insns)}
        loops = []
        for i, (a, op, rest) in enumerate(insns):
            if op.startswith("BRA"):
                t = re.search(r"0x([0-9a-f]+)", rest)
                if t and int(t.group(1), 16) <= a and int(t.group(1), 16) in addr:
                    j = addr[int(t.group(1), 16)]
                    body = collections.Counter(
                        o.split(".")[0] for _a, o, _r in insns[j:i + 1])
                    loops.append((i + 1 - j, body))
        out.append(f"{name}: {len(insns)} instructions; "
                   + ", ".join(f"{o} {c}" for o, c in ops.most_common(10))
                   + f"; LDC {ops.get('LDC', 0)}, constant-bank operands "
                   f"{const_operands}; {len(loops)} loops")
        for size, body in sorted(loops, key=lambda x: -x[0])[:8]:
            out.append(f"    loop of {size} instructions: "
                       + ", ".join(f"{o} {c}" for o, c in
                                   body.most_common(6)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass", default="",
                    help="comma-separated csrc sources to disassemble")
    ap.add_argument("--sass-dir", default=None)
    args = ap.parse_args()
    sass = {f for f in args.sass.split(",") if f}
    sys.path.insert(0, ROOT)
    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.air import Air, ProofOptions
    from ministark_tpu_torch.fields.scalar import Fp
    from ministark_tpu_torch.models.brainfuck import (BrainfuckAirConfig,
                                                      BrainfuckClaim)
    from ministark_tpu_torch.models.fib import FibAirConfig
    from ministark_tpu_torch.models.rescue import RescueAirConfig
    from ministark_tpu_torch.ops import build

    jobs = {f: build._read(os.path.join(build.CSRC, f))
            for f in sorted(os.listdir(build.CSRC)) if f.endswith(".cu")}
    fib = Air(FibAirConfig, 1 << 21, Fp(0), ProofOptions(32, 4, 8, 8, 64))
    jobs["eval_fib"] = teval._plan_for(fib)[1]
    bf = Air(BrainfuckAirConfig, 1 << 20, BrainfuckClaim("", b"", b""),
             ProofOptions(19, 16, 20, 16, 16))
    jobs["eval_bf"] = teval._plan_for(bf)[1]
    rescue = Air(RescueAirConfig, 1 << 18, (0, 0, 0, 0),
                 ProofOptions(32, 8, 8, 8, 64))
    jobs["eval_rescue"] = teval._plan_for(rescue)[1]

    with tempfile.TemporaryDirectory() as tmp:
        def compile_one(item):
            name, text = item
            src = os.path.join(tmp, f"{name.replace('.cu', '')}.cu")
            with open(src, "w") as f:
                f.write(text)
            cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                   "-I", build.CSRC, "-o", src + ".so", src]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=900)
            print(f"{name}: built in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            listing = None
            if name in sass and proc.returncode == 0:
                cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()),
                                         "cuobjdump")
                listing = subprocess.run(
                    [cuobjdump, "-sass", src + ".so"], capture_output=True,
                    text=True, timeout=600).stdout
            return name, proc, listing

        with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
            results = list(ex.map(compile_one, jobs.items()))
    failed = False
    for name, proc, listing in results:
        if listing is not None:
            print("\n".join(f"{name} SASS {line}"
                            for line in sass_summary(listing)), flush=True)
            if args.sass_dir:
                os.makedirs(args.sass_dir, exist_ok=True)
                with open(os.path.join(args.sass_dir, name + ".sass"),
                          "w") as f:
                    f.write(listing)
        if proc.returncode != 0:
            failed = True
            print(f"{name}: nvcc failed\n{proc.stderr}", flush=True)
            continue
        kernel = None
        for line in proc.stderr.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
            elif "registers" in line or "spill" in line:
                print(f"{name} {kernel}: {line.split(':', 1)[-1].strip()}",
                      flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
