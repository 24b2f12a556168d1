#!/usr/bin/env python3
"""Registers, shared memory and spills of every hand-written CUDA kernel.

    python3 scripts/ptxas_report.py

Compiles each ``ministark_tpu_torch/csrc/*.cu`` file and the constraint
evaluators generated for the fib AIR (2^21 rows) and the brainfuck AIR
(2^20 rows, one source per term group) with the port's nvcc flags plus
``-Xptxas -v``, all in parallel, and prints ptxas's line for each kernel.
Needs nvcc (the CUDA toolkit); no card.  Writes into a temporary directory
and leaves nothing behind.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.air import Air, ProofOptions
    from ministark_tpu_torch.fields.scalar import Fp
    from ministark_tpu_torch.models.brainfuck import (BrainfuckAirConfig,
                                                      BrainfuckClaim)
    from ministark_tpu_torch.models.fib import FibAirConfig
    from ministark_tpu_torch.ops import build

    jobs = {f: build._read(os.path.join(build.CSRC, f))
            for f in sorted(os.listdir(build.CSRC)) if f.endswith(".cu")}
    fib = Air(FibAirConfig, 1 << 21, Fp(0), ProofOptions(32, 4, 8, 8, 64))
    jobs["eval_fib"] = teval._plan_for(fib)[1][0]
    bf = Air(BrainfuckAirConfig, 1 << 20, BrainfuckClaim("", b"", b""),
             ProofOptions(19, 16, 20, 16, 16))
    for g, src in enumerate(teval._plan_for(bf)[1]):
        jobs[f"eval_bf_group{g}"] = src

    with tempfile.TemporaryDirectory() as tmp:
        def compile_one(item):
            name, text = item
            src = os.path.join(tmp, f"{name.replace('.cu', '')}.cu")
            with open(src, "w") as f:
                f.write(text)
            cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                   "-I", build.CSRC, "-o", src + ".so", src]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=900)
            return name, proc

        with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
            results = list(ex.map(compile_one, jobs.items()))
    failed = False
    for name, proc in results:
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
