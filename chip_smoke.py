#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ministark_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, any failure exits non-zero:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every hand-written kernel from ``ministark_tpu_torch/csrc`` (and
     the constraint evaluator generated for the fib AIR) with nvcc;
  3. run each kernel against its plain PyTorch version on the card at the
     shapes of the 2^24-value prove: integer field math, so the tolerance
     is exact equality; print both times;
  4. prove fib at 2^10 values with the golden-fixture options: the bytes
     must equal ``tests/golden/fib_2e10.proof`` and all six kernels must
     have launched;
  5. prove fib at 2^24 values (2^21 rows x 8 columns) with bench.py's
     options, cold then warm, with per-phase CUDA-event times and peak
     device memory; the counts of launches are reset just before the warm
     prove and read just after; the port's verifier must accept the proof
     and reject it with one byte flipped;
  6. print the kernel table as one JSON line, then the result line.

It imports nothing of JAX and nothing of ``ministark_tpu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "fib_2e10.proof")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(torch, a, b) -> float:
    """0 when equal; else the largest |a - b| over (some) differing entries,
    as unsigned 64-bit integers."""
    if a.shape != b.shape:
        fail(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if torch.equal(a, b):
        return 0.0
    idx = (a != b).reshape(-1).nonzero()[:1024, 0]
    av = a.reshape(-1)[idx].tolist()
    bv = b.reshape(-1)[idx].tolist()
    m = 1 << 64
    return float(max(abs(x % m - y % m) for x, y in zip(av, bv)))


def compare_kernels(torch, dev, fib_air_big):
    """Phase 3: each kernel against its plain version at the prove's shapes."""
    from ministark_tpu_torch.fields import device as fd
    from ministark_tpu_torch.fields.scalar import P
    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.ntt import (_split_n, _stage_table,
                                         _twiddle_matrix, powers)
    from ministark_tpu_torch.ntt import Domain
    from ministark_tpu_torch.ops import deep as kdeep
    from ministark_tpu_torch.ops import eval as keval
    from ministark_tpu_torch.ops import inv as kinv
    from ministark_tpu_torch.ops import ntt as kntt
    from ministark_tpu_torch.ops import sha256 as ksha
    from ministark_tpu_torch.ops import transpose as ktr

    g = torch.Generator(device=dev)
    g.manual_seed(2024)

    def rand(*shape):
        v = torch.randint(-(1 << 63), (1 << 63) - 1, shape, generator=g,
                          device=dev, dtype=torch.int64)
        return fd.canonicalize(v)

    cols = 8
    lde_n = fib_air_big.lde_domain().size
    ce_n = fib_air_big.ce_domain().size
    n1, n2 = _split_n(lde_n)
    lde = Domain(lde_n, 7)
    results = {}

    def check(name, kernel, plain, reps=3):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        ms = time_ms(torch, kernel, reps)
        plain_ms = time_ms(torch, plain, reps)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        print(f"kernel {name}: max_abs_err={err} (tolerance 0) kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
        if err != 0:
            fail(f"kernel {name} disagrees with its plain version")

    # A: the OOD barycentric inverses, one LDE-sized vector (zeros included)
    a = rand(lde_n)
    a[::4096] = 0
    check("inv", lambda: kinv.inv_fp(a), lambda: kinv.inv_fp_plain(a))

    # B: both column passes of the 8-column coset LDE
    x1 = rand(cols, n1, n2)
    tw1 = _stage_table(pow(lde.group_gen, n2, P), n1, dev)
    pre = powers(7, lde_n, dev).reshape(n1, n2)
    tmat = _twiddle_matrix(lde_n, lde.group_gen, dev)
    x2 = rand(cols, n2, n1)
    tw2 = _stage_table(pow(lde.group_gen, n1, P), n2, dev)
    post = rand(n2, n1)

    def ntt_kernel():
        return torch.cat([kntt.col_ntt(x1, tw1, pre=pre, tmat=tmat).reshape(-1),
                          kntt.col_ntt(x2, tw2, tmat=post).reshape(-1)])

    def ntt_plain():
        return torch.cat([
            kntt.col_ntt_plain(x1, tw1, pre=pre, tmat=tmat).reshape(-1),
            kntt.col_ntt_plain(x2, tw2, tmat=post).reshape(-1)])

    check("ntt", ntt_kernel, ntt_plain, reps=2)

    # C: the six-step transpose of the same LDE
    check("transpose", lambda: ktr.transpose(x1),
          lambda: ktr.transpose_plain(x1))

    # D: LDE row digests (column-major view) and one tree level of merges
    m = rand(cols, lde_n)
    left = torch.randint(0, 256, (lde_n // 2, 32), generator=g, device=dev,
                         dtype=torch.int64).to(torch.uint8)
    right = torch.randint(0, 256, (lde_n // 2, 32), generator=g, device=dev,
                          dtype=torch.int64).to(torch.uint8)

    def sha_kernel():
        return torch.cat([ksha.hash_rows(m.T), ksha.merge(left, right)])

    def sha_plain():
        return torch.cat([ksha.hash_rows_plain(m.T),
                          ksha.merge_plain(left, right)])

    check("sha256", sha_kernel, sha_plain, reps=2)

    # E: the fib AIR's generated evaluator over the CE domain
    plan, source, _denoms = teval._plan_for(fib_air_big)
    cb = fib_air_big.ce_blowup_factor
    trace = rand(cols, ce_n)
    xs = fib_air_big.ce_domain().elements(dev)
    inv = rand(len(plan.inv_keys), ce_n)
    per = torch.zeros((0, ce_n), dtype=torch.int64, device=dev)
    s = rand(max(len(plan.scalars), 1))
    check("eval",
          lambda: keval.eval_terms(plan, source, cb, trace, xs, per, inv, s),
          lambda: keval.eval_terms_plain(plan, cb, trace, xs, per, inv, s))

    # F: the DEEP sum over the LDE: one term per trace argument (two
    # distinct OOD points) and per composition column (a third)
    T = len(fib_air_big.trace_arguments()) + cb
    dcols = [rand(lde_n) for _ in range(T)]
    dinvs = [rand(lde_n) for _ in range(3)]
    rows = [dinvs[t % 2 if t < T - cb else 2] for t in range(T)]
    ds = rand(2 * T + 2)
    xl = lde.elements(dev)
    check("deep", lambda: kdeep.deep(dcols, rows, ds, xl),
          lambda: kdeep.deep_plain(dcols, rows, ds, xl))
    return results


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, ROOT)
    try:
        from ministark_tpu_torch.air import Air, ProofOptions
        from ministark_tpu_torch.fields.scalar import Fp
        from ministark_tpu_torch.models.fib import (FibAirConfig, FibClaim,
                                                    gen_trace)
        from ministark_tpu_torch.ops import (build, deep, eval, inv, ntt,  # noqa: F401
                                            sha256, transpose)
        from ministark_tpu_torch.proof import Proof
        from ministark_tpu_torch.verifier import VerificationError
        from ministark_tpu_torch import eval as teval
    except ImportError as e:
        fail(f"the port is not importable beside this script: {e}")
    if not os.path.exists(GOLDEN):
        fail(f"missing golden proof {GOLDEN}")
    for mod in ("jax", "ministark_tpu"):
        if mod in sys.modules:
            fail(f"{mod} was imported")

    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # -- phase 2: build ------------------------------------------------------
    golden_opts = ProofOptions(num_queries=8, lde_blowup_factor=4,
                               grinding_factor=2, fri_folding_factor=4,
                               fri_max_remainder_coeffs=16)
    big_opts = ProofOptions(num_queries=32, lde_blowup_factor=4,
                            grinding_factor=8, fri_folding_factor=8,
                            fri_max_remainder_coeffs=64)
    t0 = time.perf_counter()
    sources = [teval._plan_for(Air(FibAirConfig, rows, Fp(0), o))[1]
               for rows, o in ((1 << 7, golden_opts), (1 << 21, big_opts))]
    jobs = [(k, None) for k in build.KERNELS.values() if k.source] + [
        (build.KERNELS["eval"], s) for s in sources]
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        list(ex.map(lambda j: j[0].build(j[1]), jobs))
    print(f"build: {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- phase 3: kernels against their plain versions -------------------------
    big_air = Air(FibAirConfig, 1 << 21, Fp(0), big_opts)
    results = compare_kernels(torch, dev, big_air)

    # -- phase 4: the golden 2^10-value proof --------------------------------
    for k in build.KERNELS.values():
        k.launches = 0
    trace = gen_trace(1 << 10, dev)
    claim = FibClaim(trace.last_value())
    data = claim.prove(golden_opts, trace).to_bytes(Fp)
    with open(GOLDEN, "rb") as f:
        if data != f.read():
            fail("the 2^10-value proof differs from tests/golden/fib_2e10.proof")
    small = {name: k.launches for name, k in build.KERNELS.items()}
    print(f"golden 2^10 proof: byte-identical ({len(data)} bytes); "
          f"launches {small}", flush=True)
    if min(small.values()) == 0:
        fail(f"a kernel did not launch in the 2^10 prove: {small}")

    # -- phase 5: the 2^24-value prove ---------------------------------------
    t0 = time.perf_counter()
    trace = gen_trace(1 << 24, dev)
    claim = FibClaim(trace.last_value())
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    claim.prove(big_opts, trace)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0

    for k in build.KERNELS.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    phases: list = []
    t0 = time.perf_counter()
    proof = claim.prove(big_opts, trace, phases)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in build.KERNELS.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if min(launches.values()) == 0:
        fail(f"a kernel did not launch in the 2^24 prove: {launches}")

    data = proof.to_bytes(Fp)
    t0 = time.perf_counter()
    claim.verify(Proof.from_bytes(data, Fp, Fp), 30)
    verify_s = time.perf_counter() - t0
    tampered = bytearray(data)
    tampered[21] ^= 1  # first byte of the base trace commitment
    try:
        claim.verify(Proof.from_bytes(bytes(tampered), Fp, Fp), 30)
    except VerificationError as e:
        print(f"tampered 2^24 proof rejected: {e}", flush=True)
    else:
        fail("the verifier accepted a tampered proof")

    print(json.dumps({"fib_2e24": {
        "card": card, "trace_gen_s": trace_s, "cold_prove_s": cold_s,
        "warm_prove_s": warm_s, "verify_s": verify_s,
        "proof_bytes": len(data), "peak_device_gib": peak_gib,
        "phases": phases, "launches": launches}}), flush=True)

    kernels = []
    for name, k in build.KERNELS.items():
        src = (f"ministark_tpu_torch/csrc/{k.source}" if k.source
               else "ministark_tpu_torch/ops/eval.py")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": k.replaces, "launches": launches[name],
                        **results[name]})
    print(f"{card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
