#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ministark_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Nine main paths, each driven through the user's entry points: the fib
prove (Fp, SHA-256), the brainfuck proves of fibonacci.bf and hello_world
(Fq3 extension field, SHA-256), the fully algebraic fib prove (RPO-256
trees and coin), hello_world with RPO-256 trees and coin (Fq3, the device
RPO grind), a 2^29-point coset LDE (the multi-pass column NTT), the
Rescue-Prime hash chain (Fp, SHA-256; eleven periodic columns, powers of
trace sums), the 128- and 252-bit field vectors with their NTT at
2^18 points (BIG), and the multi-process prover (D: ``parallel``'s
``prove_sharded`` over ``torch.distributed``, over SHA-256 trees, D-F,
and over RPO-256 trees and coin, D-R).  Every prove's FRI commit phase runs the device coin
between its layers (``coin_sha``, or ``coin_rpo`` for the RPO coin).
Phases, any failure exits non-zero:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every hand-written kernel from ``ministark_tpu_torch/csrc`` and
     the constraint evaluators generated for the fib, brainfuck and Rescue
     AIRs (one source each) with nvcc, one process per source, all started
     together;
  3. run each kernel against its plain PyTorch version on the card, once
     for each path that launches it, at that path's shapes: the nine fib
     kernels at the 2^24-value fib prove's (kernel F's OOD sums,
     ``ood_sums``, at the prove's pairs), the eleven of the brainfuck
     path (the five Fq3 kernels, ``ood_sums_ext3`` among them, and the
     ntt, transpose, sha256, inv, SHA-256 grind and SHA-256 tree tops it
     shares with fib) at the
     2^20-row brainfuck prove's and again at hello_world's (each SHA-256
     path's grind on a seed made from its name, the nonce against the
     native host grind's and a batch's counts of leading zeros against the
     plain version; a whole SHA-256 tree of its LDE's leaves, merges and
     the tops launch, compared on 2^18 leaves), the RPO fib prove's nine (its six shared ones at the
     fib prove's shapes; the RPO permutation's row hashes, merges and FRI
     rows; the RPO grind on one batch; a whole Merkle tree of its 2^23
     leaves, the merges and the tops launch, compared on a 2^18-leaf
     tree), hello_world RPO's ten (its seven shared ones, the RPO
     permutation, the grind, a whole tree of its 2^15 leaves) at
     hello_world's shapes, and the LDE's kernel B and transposes on both
     passes of its 2^27- and the first of its 2^29-point transform, and
     the multi-pass NTT on the second (and at n1 = 2^12 against kernel B
     and its plain version, and at 2^16 on one and on 16 columns), and
     the nine kernels of the Rescue path at its 2^18-row prove's shapes
     (2^21-point LDE and CE domains: the 8-column composition LDE, the
     4-column trace, the Rescue evaluator with its periodic inputs); each
     prove path's coin step on seeds made from the path's name (k = 1, 3,
     5 draws for SHA-256, 1-8 for RPO-256, the root read in place from a
     level of digests; an RPO draw digest at a counter past 2^32 against
     the host's; timed a launch at the prove's k and N, 50 launches, with
     the device time alone and the host time a call); and BIG's big_ntt
     (Fp128 and Fp252, forward and inverse, plain and coset) and big_mul
     at 2^18 points, 20 launches a part with the device time alone and
     the host time a call, big_ntt also compared (untimed) at 2, 32, 2^11
     and 2^15 points and big_mul over two other odd moduli (the generic
     product);
     integer field math, so the tolerance is exact equality;
     print the kernel's time, the plain version's, the bound (the least time the
     card could take) and, where one PyTorch call computes the same
     function, its time.  At hello_world's shapes the ntt, transpose,
     sha256, sha256_ext3, eval_ext3, deep_ext3 and ood_sums_ext3 kernels
     (and the strided copy the transpose is held against) are timed over
     50 back-to-back launches, with their device time alone
     (torch.profiler) and the host time of one call beside it.  The plain
     RPO permutation is some 16,000 elementwise launches, so at the fib
     path's shapes it is compared on a 2^18-state sample of the same
     inputs (the line says so) while the kernel is timed at the full
     shape;
  4. prove fib at 2^10 values, brainfuck "++>+++[<+>-]<." and the Rescue
     chain of 4 links with the golden-fixture options, and the fully
     algebraic fib at 2^7 values and the brainfuck program with RPO-256
     trees and coin:
     the bytes must equal ``tests/golden/`` and every kernel of each path
     must have launched; prove and verify fib at 2^7 values with RPO-256
     trees and the SHA-256 coin;
  5. prove fib at 2^24 values (2^21 rows x 8 columns) with bench.py's
     options, cold then warm;
  6. prove ``programs/fibonacci.bf`` with its count cut from eleven to ten
     numbers (2^20 rows) with the 96-bit options (19 queries, blowup 16,
     grind 20, fold 16, remainder 16), cold then warm, after timing the VM
     on the host;
  7. prove ``programs/hello_world.bf`` with the same options, cold then
     warm (bench.py's latency line);
  8. prove the fully algebraic fib at 2^24 values with bench.py's options,
     cold then warm;
  9. prove hello_world with RPO-256 trees and coin, 96-bit options, cold
     then warm (its 20-bit grind runs on the card);
 10. prove the Rescue chain of 2^14 links (2^18 rows x 4 columns; the
     chain on the host, timed) with RESCUE_OPTS (blowup 8, the least the
     AIR takes), cold then warm, and time its periodic columns over the
     CE domain on their own;
 11. a 2^29-point coset LDE of one 2^27-row column through
     ``Matrix.interpolate``/``evaluate``, checked exactly (the inverse
     transform gives the coefficients back; a column of 64 coefficients
     agrees with Horner's rule on the host at a few points);
 12. BIG: Fp128 and Fp252 ``BigDomain`` at 2^18 points, plain and over
     the coset of the field's generator, fft and ifft timed and checked
     the same way (ifft(fft(x)) == x; Horner at a few points), and
     ``BigField.mul`` of 2^18 pairs against bigint products of a sample;
 13. D: kernel B on both slabs a rank of two gives the sharded six-step
     of the 2^23-point FRI fold, kernel C on its local transpose, kernel
     D on a rank's 2^22 LDE rows and its subtree, kernel E's block entry
     on a rank's block of the CE domain with its halo, kernel A on the
     block's denominators and the rank's OOD weights, kernel F's DEEP sum
     and OOD sums on the rank's 2^22 LDE rows, and (D-R) kernel G's row
     hashes of a rank's 2^22 base and composition rows, a level of its
     merges and its FRI layer 0 rows, its whole 2^22-leaf subtree and the
     tip's tops launch over two roots, each against its plain version;
     then fib at 2^24 values by ``prove_sharded`` at NCCL world size 1 in
     this process, and fib and hello_world (D-F), then the fully
     algebraic fib and hello_world RPO (D-R, RPO-256 trees and coin), in
     two gloo ranks sharing the card (spawned; they load the libraries
     phase 2 built): every rank's bytes must equal phase 5's, 7's, 8's or
     9's one-process proof and verify, every prove must make collectives,
     the same on every rank; cold and warm seconds, rank 0's per-phase
     device ms and launches, collectives, bytes and the largest
     collective a prove, every rank's peak memory beside the one-process
     prove's (a D-R fib rank's at most 70% of it);
 14. print the card, the kernel table as one JSON line (one entry per
     kernel and path, with that path's launches), then the result.

In phases 5-13 the counts of launches are reset just before the warm run
and read just after, with per-phase CUDA-event times (the warm prove's
Proof of work and FRI phases printed on lines of their own) and peak device memory; the port's verifier must accept each proof (30 bits for fib, 96
for brainfuck; on the host, in pure Python for RPO) and reject it with one
byte flipped.  It imports nothing of JAX and nothing of ``ministark_tpu``.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_FIB = os.path.join(ROOT, "tests", "golden", "fib_2e10.proof")
GOLDEN_BF = os.path.join(ROOT, "tests", "golden", "brainfuck_2plus3.proof")
GOLDEN_RPO = os.path.join(ROOT, "tests", "golden", "fib_2e7_rpo_full.proof")
GOLDEN_BF_RPO = os.path.join(ROOT, "tests", "golden",
                             "brainfuck_2plus3_rpo.proof")
GOLDEN_RESCUE = os.path.join(ROOT, "tests", "golden", "rescue_4links.proof")
PROGRAMS = os.path.join(ROOT, "programs")
GOLDEN_BF_PROGRAM = "++>+++[<+>-]<."

FIB, BF = "fib_2e24", "bf_fibonacci_2e20"  # the SHA-256 paths' proves
HELLO = "bf_hello_world"  # bench.py's latency line
FIB_RPO, BF_RPO = "fib_rpo_2e24", "bf_hello_world_rpo"  # the RPO paths'
LDE = "lde_2e29"
RESCUE = "rescue_2e18"  # the Rescue hash chain, 2^14 links
BIG = "big_2e18"  # the 128- and 252-bit field vectors and their NTT
FIB_PATH = ("inv", "ntt", "transpose", "sha256", "eval", "deep", "ood_sums",
            "sha256_grind", "sha256_tree", "coin_sha")
BF_PATH = ("inv", "ntt", "transpose", "sha256", "inv_ext3", "sha256_ext3",
           "eval_ext3", "deep_ext3", "ood_sums_ext3", "sha256_grind",
           "sha256_tree", "coin_sha")
FIB_RPO_PATH = ("inv", "ntt", "transpose", "eval", "deep", "ood_sums",
                "rpo256", "rpo256_grind", "rpo256_tree", "coin_rpo")
BF_RPO_PATH = ("inv", "ntt", "transpose", "inv_ext3", "eval_ext3",
               "deep_ext3", "ood_sums_ext3", "rpo256", "rpo256_grind",
               "rpo256_tree", "coin_rpo")
LDE_PATH = ("ntt", "transpose", "ntt_stage")
RESCUE_PATH = ("inv", "ntt", "transpose", "sha256", "eval", "deep",
               "ood_sums", "sha256_grind", "sha256_tree", "coin_sha")
BIG_PATH = ("big_mul", "big_ntt")
# D: the multi-process prover (parallel/), fib at F's size in SHARDED_RANKS
# gloo ranks sharing the card (and at NCCL world size 1), hello_world in
# SHARDED_RANKS gloo ranks; its kernel rows are at the shapes a rank gives
# them (the sharded six-step's slabs, a rank's rows and subtree, a rank's
# block of the CE domain)
SHARDED = "sharded_fib_2e24"
SHARDED_PATH = ("inv", "ntt", "transpose", "sha256", "sha256_tree", "eval",
                "deep", "ood_sums")
# D-R: the fully algebraic fib (R) and hello_world RPO (H) by prove_sharded
# in the same gloo ranks: every kernel of R's path launches on a rank; its
# kernel rows are the RPO-256 ones at rank 0's shapes (the others' shapes
# are D-F's)
SHARDED_RPO = "sharded_fib_rpo_2e24"
SHARDED_RPO_ROWS = ("rpo256", "rpo256_tree")
SHARDED_RANKS = 2
BIG_LOG_N = 18  # the largest size of the reference's FFT bench
RPO_SAMPLE = 1 << 18  # states the plain RPO permutation is compared on
SHA_SAMPLE = 1 << 18  # leaves and nonces the plain SHA-256 is compared on

# The bound (bound_ms) is the larger of bytes over the memory rate and
# 32-bit integer operations over the INT32 instruction rate, the peaks of
# an H100 SXM: 3.35 TB/s; 64 INT32 lanes per SM (Hopper architecture white
# paper) x 132 SMs x 1.98 GHz, the card's maximum SM clock as nvidia-smi
# reports.
MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# The operation model: 32-bit integer operations per field operation.  A
# Goldilocks add or sub is a 64-bit add with carry and a conditional
# correction (6); a product is four 32x32->64 products (8 instruction
# slots) and about a dozen adds, compares and selects to reduce it (20).
OPS_ADD = 6
OPS_MUL = 20
OPS_MUL3 = 6 * OPS_MUL + 17 * OPS_ADD       # Karatsuba with u^3 = 2
# A 64x64 -> 128-bit product added, unreduced, into a 160-bit accumulator:
# four 32x32 -> 64 multiply-adds in a carry chain (8 instruction slots) and
# five carry adds into the words above
OPS_MAC = 13
# A batch of inverses needs no more work than Montgomery's trick: three
# products per element and one Fermat chain a^(p-2) for the whole batch
# (an addition chain of about 75 products), whatever a kernel does.
OPS_INV = 3 * OPS_MUL
OPS_INV_CHAIN = 75 * OPS_MUL
# An Fq3 inverse by the norm map: the adjugate (6 products), the norm (3),
# one batched Fp inverse, and the three products by it.
OPS_INV3 = 12 * OPS_MUL + 8 * OPS_ADD + OPS_INV
# SHA-256: its shifts and logic run on the INT32 (ALU) pipe alone, while
# its adds may issue as IMAD on the FMA pipe beside them (ptxas puts about
# 40% of a merge's adds there), so the least time counts the shifts and
# the three-input logic (LOP3): 10 a round (six funnel shifts, four
# LOP3), 8 a scheduled word (six shifts, two LOP3).  A block of padding
# alone has a constant schedule (64 rounds); a grind nonce's rounds 0-7
# read only the seed (56 rounds and the 48 scheduled words).
OPS_SHA_ROUND, OPS_SHA_WORD = 10, 8
OPS_SHA_BLOCK = 64 * OPS_SHA_ROUND + 48 * OPS_SHA_WORD
OPS_SHA_PAD_BLOCK = 64 * OPS_SHA_ROUND
OPS_SHA_GRIND = 56 * OPS_SHA_ROUND + 48 * OPS_SHA_WORD
# RPO-256: 7 rounds of 12 x (4 + 72) products (x^7 and the x^(1/7) chain),
# two MDS layers (each output 24 32x32->64 multiply-adds and its
# reduction) and 24 round-constant adds
OPS_MDS = 12 * (24 * 2 + 10)
OPS_RPO = 7 * (12 * 76 * OPS_MUL + 2 * OPS_MDS + 24 * OPS_ADD)
# A big-field Montgomery product over W 32-bit words (W = 4 for Fp128, 8
# for Fp252; the kernel's u64 limbs are pairs of them): CIOS takes 2 W^2 +
# W word products (a b, then q p, and q), each a 32x32->64 multiply-add
# into a carry chain (two instructions, mad.lo.cc and madc.hi.cc), and a
# conditional subtraction of W borrows and W selects; a sum or difference
# W adds with carry and the conditional correction (W subtractions with
# borrow, W selects).
def ops_big_mul(w: int) -> int:
    return 2 * (2 * w * w + w) + 2 * w


# The same product at its least work where p = 1 + (top words) is 1 mod
# 2^(32 (w - top)) with those words in its upper half (Fp128: one top word,
# Fp252: two; csrc/bigfield.cuh big_redc_sparse): a b's w^2 word products,
# one row of w products a top word for m p, m = -t_lo (w subtractions with
# borrow), t_hi + V (w adds with carry) and the conditional subtraction.
BIG_TOP_WORDS = {"Fp128": 1, "Fp252": 2}


def ops_big_mul_sparse(w: int, top: int) -> int:
    return 2 * w * w + 2 * w * top + w + w + 2 * w


def ops_big_add(w: int) -> int:
    return 3 * w


# The coin steps: the SHA-256 reseed is a 64-byte merge (a data block and
# a block of padding alone), a draw digest a 40-byte message whose rounds
# 0-7 read only the seed (OPS_SHA_GRIND), an accepted draw one product by
# R^-1; the RPO-256 reseed is one permutation, a digest of four draws
# another; N powers of alpha take N - 2 products (Fp or Fq3: alpha^0 and
# alpha^1 are given).
OPS_COIN_SHA_RESEED = OPS_SHA_BLOCK + OPS_SHA_PAD_BLOCK


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least time in ms, what bounds it) for this many bytes and ops."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sha_ops(message_bytes: int) -> int:
    """The least work of one SHA-256 of a message of this many bytes (a
    multiple of 4): its blocks that hold data, then a block of padding
    alone where the length does not fit the last of them."""
    data = (message_bytes + 63) // 64
    total = (message_bytes + 9 + 63) // 64
    return data * OPS_SHA_BLOCK + (total - data) * OPS_SHA_PAD_BLOCK


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


def device_only_ms(torch, fn, reps: int):
    """Mean device time of fn()'s kernels alone over `reps` back-to-back
    runs, from torch.profiler's CUDA events (each kernel's start to end, no
    launch gaps); None where the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type.name == "CUDA"]
    if not dev:
        return None
    return sum(e.time_range.end - e.time_range.start
               for e in dev) / 1e3 / reps


def host_us(torch, fn, reps: int) -> float:
    """Median host time of one fn() call, in microseconds: what the call
    costs the CPU to enqueue (it returns before the card finishes), the
    queue drained before each call."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return sorted(times)[reps // 2] * 1e6


def timed_once(torch, fn):
    """(fn(), its device time in ms) for a single run."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


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


def chain_products(e: int) -> int:
    """Products of the shortest addition chain for x^e: exact (a search)
    up to e = 256, above it ceil(log2 e), a lower bound."""
    if e > 256:
        return (e - 1).bit_length()
    best = [e.bit_length() + bin(e).count("1") - 2]  # the binary method

    def search(chain):
        if len(chain) - 1 >= best[0]:
            return
        top = chain[-1]
        if top == e:
            best[0] = len(chain) - 1
            return
        # even the doublings alone cannot reach e in the products left
        if top << (best[0] - len(chain)) < e:
            return
        for s in sorted({a + b for a in chain for b in chain
                         if top < a + b <= e}, reverse=True):
            search(chain + [s])

    search([1])
    return best[0]


def eval_ops_per_point(keval, plan) -> int:
    """32-bit integer operations per CE point of the generated evaluator:
    its DAG walked group by group with the same structural sharing, each
    operation costed by its operands' kinds (Fp or Fq3).  A power of X
    from the shared prologue costs nothing where a term reads it; the
    prologue's products count once a point (log2 N squarings of the chain,
    each with the running product where one is kept, then the short
    chains), where a count of the plain square-and-multiply would take
    bit_length + popcount products for every Pow in each group.  Any other
    power (the Rescue AIR's x^7 of trace sums) counts its shortest
    addition chain (x^7: 4 products)."""
    count = [0]

    def leaf_fn(leaf):
        if isinstance(leaf, keval._InvInput):
            return plan.inv_kind[leaf.key]
        if isinstance(leaf, keval.X):
            return "x"
        return keval.leaf_kind(leaf, plan.num_base, plan.fq_is_ext)

    def op_fn(op, a, b, exp):
        if op == "pow" and a == "x" and exp in plan.power_of:
            return "fp"
        a, b = ("fp" if k == "x" else k for k in (a, b))
        fq = "fq" in (a, b)
        if op == "neg":
            count[0] += OPS_ADD * (3 if a == "fq" else 1)
            return a
        if op == "pow":
            m = OPS_MUL3 if a == "fq" else OPS_MUL
            count[0] += m * chain_products(exp)
            return a
        if op == "add":
            count[0] += OPS_ADD * (3 if a == b == "fq" else 1)
        elif a == b:
            count[0] += OPS_MUL3 if fq else OPS_MUL
        else:
            count[0] += 3 * OPS_MUL
        return "fq" if fq else "fp"

    for start, stop in plan.groups:
        outs = keval._walk(plan.terms[start:stop], leaf_fn, op_fn)
        acc = "fq" if plan.fq_is_ext else "fp"
        for o in outs:
            op_fn("add", acc, o, None)
    per_step, after = keval.power_products(plan)
    steps = (plan.trace_len.bit_length() - 1) if per_step else 0
    return count[0] + OPS_MUL * (per_step * steps + after)


def deep_ops_per_point(kinds, points, ext) -> int:
    """32-bit integer operations per LDE point of the DEEP sum at its least
    work: alpha_t T_t[i] and a sum a term (kinds: 0 for an Fp column, 1 for
    an Fq3 one), (C_g - that sum) inv_g[i] and a sum a distinct inverse
    row (`points` of them), then times (A + B x), where the sum as written
    takes two products a term (by the inverse and by alpha)."""
    if not ext:
        return (len(kinds) * (OPS_MUL + OPS_ADD)
                + points * (OPS_MUL + 2 * OPS_ADD) + 2 * OPS_MUL + OPS_ADD)
    terms = sum(OPS_MUL3 + 3 * OPS_ADD if k else 3 * OPS_MUL + 3 * OPS_ADD
                for k in kinds)
    return (terms + points * (OPS_MUL3 + 6 * OPS_ADD) + 3 * OPS_MUL
            + 3 * OPS_ADD + OPS_MUL3)


def ood_ops_per_point(kinds, points, ext, wide_points=0) -> int:
    """32-bit integer operations per LDE point of the OOD sums at their
    least work: g^i by one product from g^(i - stride), the weights
    inv_j[i] g^i once a point j (Fq3: three products), then a product a
    pair added unreduced into its accumulator (OPS_MAC; an Fp column: one
    in Fp, three by an Fq3 weight; an Fq3 column: Karatsuba's six, with
    its three sums of column planes a pair and of weight planes once for
    each of the `wide_points` points an Fq3 column pairs with; kinds: 0
    for an Fp column, 1 for an Fq3 one).  The reductions are once a
    thread, not a point."""
    if not ext:
        return OPS_MUL + points * OPS_MUL + len(kinds) * OPS_MAC
    return (OPS_MUL + points * 3 * OPS_MUL + wide_points * 3 * OPS_ADD
            + sum(6 * OPS_MAC + 3 * OPS_ADD if k else 3 * OPS_MAC
                  for k in kinds))


class Checker:
    """Each kernel against its plain version; collects the kernel table."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev
        self.results = {}
        self.g = torch.Generator(device=dev)
        self.g.manual_seed(2024)

    def rand(self, *shape):
        from ministark_tpu_torch.fields import device as fd

        v = self.torch.randint(-(1 << 63), (1 << 63) - 1, shape,
                               generator=self.g, device=self.dev,
                               dtype=self.torch.int64)
        return fd.canonicalize(v)

    def scalar_table(self, plan):
        """Random field values, with the plan's Pow exponents in their
        slots."""
        s = self.rand(max(plan.num_slots, 1))
        for what, e, _kind in plan.scalars:
            if what == "exp":
                s[plan.slot[("exp", e)]] = e
        return s

    def check(self, name, path, parts, nbytes, ops, reps=3, plain_reps=3,
              plain_on=None, launch_cost=False, timed=None):
        """Kernel `name` against its plain version at `path`'s shapes.  Each
        part makes its own inputs and returns (kernel, plain, library or
        None[, full]), functions of no arguments; the parts' times add up,
        and one part's inputs are freed before the next part's are made.
        plain_reps=1 times the one comparison run of the plain version (for
        plain versions that take seconds).  A part that returns `full`
        compares kernel() with plain() on a sample of its inputs (named by
        `plain_on`) and times full(), the kernel at the path's shape.
        launch_cost=True times the kernel and the library call in turns
        (kernel, library, library, kernel) and also takes, for each, the
        device time alone (torch.profiler, `reps` launches) and the host
        time of one call (the median of `reps`).  `timed`: the indices of
        the parts whose times count (by default all); the others are only
        compared."""
        torch = self.torch
        err = ms = plain_ms = 0.0
        library_ms = None
        cost = {"device_only_ms": 0.0, "host_us": 0.0,
                "library_device_only_ms": 0.0, "library_host_us": 0.0}
        for index, make in enumerate(parts):
            kernel, plain, library, *full = make()
            got = kernel()
            if plain_reps == 1:
                want, t_plain = timed_once(torch, plain)
            else:
                want = plain()
            torch.cuda.synchronize()
            err = max(err, max_abs_err(torch, got, want))
            del got, want
            if timed is not None and index not in timed:
                del kernel, plain, library, full
                continue
            if launch_cost and library is not None:
                # launch-bound: kernel and library in turns (k, l, l, k)
                t = [time_ms(torch, f, reps)
                     for f in (kernel, library, library, kernel)]
                ms += (t[0] + t[3]) / 2
                library_ms = (library_ms or 0.0) + (t[1] + t[2]) / 2
            else:
                ms += time_ms(torch, full[0] if full else kernel, reps)
            plain_ms += (t_plain if plain_reps == 1
                         else time_ms(torch, plain, plain_reps))
            if library is not None and not launch_cost:
                library_ms = (library_ms or 0.0) + time_ms(torch, library,
                                                           reps)
            if launch_cost:
                for key, fn in (("", kernel), ("library_", library)):
                    if fn is None:
                        continue
                    d = device_only_ms(torch, fn, reps)
                    k = key + "device_only_ms"
                    cost[k] = None if None in (d, cost[k]) else cost[k] + d
                    cost[key + "host_us"] += host_us(torch, fn, reps)
            del kernel, plain, library, full
            torch.cuda.empty_cache()
        bound_ms, bound_by = bound(nbytes, ops)
        self.results[(name, path)] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}
        lib = "" if library_ms is None else f", library {library_ms:.3f} ms"
        if launch_cost:
            self.results[(name, path)].update(cost)
            lib += ("; device only (torch.profiler): kernel "
                    f"{cost['device_only_ms']} ms, library "
                    f"{cost['library_device_only_ms']} ms; host per call: "
                    f"kernel {cost['host_us']:.1f} us, library "
                    f"{cost['library_host_us']:.1f} us")
        on = ""
        if plain_on:
            self.results[(name, path)]["plain_on"] = plain_on
            on = f" (compared and plain timed on {plain_on})"
        print(f"kernel {name} ({path}): max_abs_err={err} (tolerance 0) "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms{on}, bound "
              f"{bound_ms:.3f} ms ({bound_by}){lib}", flush=True)
        if err != 0:
            fail(f"kernel {name} disagrees with its plain version on {path}")


def part(kernel, plain, library=None):
    """A one-part check over inputs that already exist."""
    return [lambda: (kernel, plain, library)]


def chunked(fn, x, step):
    """fn over slices of `step` along axis 0, concatenated: the plain
    versions are run so where a whole matrix's temporaries would not fit."""
    import torch

    return torch.cat([fn(x[i:i + step]) for i in range(0, x.shape[0], step)])


def compare_fib_kernels(ck: Checker, fib_air_big, path, names):
    """The Fp kernels `names` at the shapes of the prove of `fib_air_big`,
    for `path`: the 2^24-value fib prove (SHA-256, or RPO, whose LDE,
    constraint evaluation and DEEP shapes are the same), or the Rescue
    prove (4 trace columns, 11 periodic inputs).  The NTT, transpose and
    row hashes take the wider of its two LDEs (fib's 8-column trace,
    Rescue's 8-column composition)."""
    torch, dev = ck.torch, ck.dev
    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.fields.scalar import P
    from ministark_tpu_torch.ntt import (Domain, _split_n, _stage_table,
                                         _twiddle_matrix, powers)
    from ministark_tpu_torch.ops import deep as kdeep
    from ministark_tpu_torch.ops import eval as keval
    from ministark_tpu_torch.ops import inv as kinv
    from ministark_tpu_torch.ops import ntt as kntt
    from ministark_tpu_torch.ops import sha256 as ksha
    from ministark_tpu_torch.ops import transpose as ktr

    rand = ck.rand
    cols = fib_air_big.config.NUM_BASE_COLUMNS
    lde_cols = max(cols, fib_air_big.ce_blowup_factor)
    lde_n = fib_air_big.lde_domain().size
    ce_n = fib_air_big.ce_domain().size
    n1, n2 = _split_n(lde_n)
    lde = Domain(lde_n, 7)

    # A: the OOD barycentric inverses, one LDE-sized vector (zeros included)
    a = rand(lde_n)
    a[::4096] = 0
    ck.check("inv", path, part(lambda: kinv.inv_fp(a),
                               lambda: kinv.inv_fp_plain(a)),
             16 * lde_n, lde_n * OPS_INV + OPS_INV_CHAIN)
    del a

    # B: both column passes of the 8-column coset LDE
    x1 = rand(lde_cols, n1, n2)
    tw1 = _stage_table(pow(lde.group_gen, n2, P), n1, dev)
    pre = powers(7, lde_n, dev).reshape(n1, n2)
    tmat = _twiddle_matrix(lde_n, lde.group_gen, dev)
    x2 = rand(lde_cols, n2, n1)
    tw2 = _stage_table(pow(lde.group_gen, n1, P), n2, dev)
    post = rand(n2, n1)

    # one part per pass, so the time is the two launches' alone
    passes = [
        lambda: (lambda: kntt.col_ntt(x1, tw1, pre=pre, tmat=tmat),
                 lambda: kntt.col_ntt_plain(x1, tw1, pre=pre, tmat=tmat),
                 None),
        lambda: (lambda: kntt.col_ntt(x2, tw2, tmat=post),
                 lambda: kntt.col_ntt_plain(x2, tw2, tmat=post), None)]
    butterflies = lde_cols * lde_n * (lde_n.bit_length() - 1) // 2
    ck.check("ntt", path, passes,
             8 * (4 * lde_cols * lde_n + 3 * lde_n + n1 // 2 + n2 // 2),
             butterflies * (OPS_MUL + 2 * OPS_ADD)
             + 3 * lde_cols * lde_n * OPS_MUL,
             reps=2, plain_reps=2)

    # C: the six-step transpose of the same LDE; one torch call (a strided
    # copy) computes the same function
    ck.check("transpose", path,
             part(lambda: ktr.transpose(x1), lambda: ktr.transpose_plain(x1),
                  lambda: x1.transpose(-1, -2).contiguous()),
             16 * lde_cols * lde_n, 0)
    del x1, x2, pre, tmat, post

    # D: LDE row digests (column-major view) and one tree level of merges
    if "sha256" in names:
        m = rand(lde_cols, lde_n)
        left, right = (torch.randint(0, 256, (lde_n // 2, 32), generator=ck.g,
                                     device=dev, dtype=torch.int64)
                       .to(torch.uint8) for _ in range(2))

        def sha_kernel():
            return torch.cat([ksha.hash_rows(m.T), ksha.merge(left, right)])

        def sha_plain():
            return torch.cat([ksha.hash_rows_plain(m.T),
                              ksha.merge_plain(left, right)])

        ck.check("sha256", path, part(sha_kernel, sha_plain),
                 8 * lde_cols * lde_n + 32 * lde_n + 64 * (lde_n // 2)
                 + 32 * (lde_n // 2),
                 lde_n * sha_ops(8 * lde_cols) + lde_n // 2 * sha_ops(64),
                 reps=2, plain_reps=2)
        del m, left, right

    # E: the AIR's generated evaluator over the CE domain (fib: no
    # periodic inputs; Rescue: eleven)
    plan, source, _denoms = teval._plan_for(fib_air_big)
    cb = fib_air_big.ce_blowup_factor
    nper = len(plan.periodic)
    args = [rand(cols, ce_n), torch.zeros((0, 3, ce_n), dtype=torch.int64,
                                          device=dev),
            fib_air_big.ce_domain().elements(dev), rand(nper, ce_n),
            rand(len(plan.inv_keys), ce_n),
            torch.zeros((0, 3, ce_n), dtype=torch.int64, device=dev),
            ck.scalar_table(plan)]
    ck.check("eval", path,
             part(lambda: keval.eval_terms(plan, source, cb, *args),
                  lambda: keval.eval_terms_plain(plan, cb, *args)),
             8 * ce_n * (cols + 1 + nper + len(plan.inv_keys) + 1),
             ce_n * eval_ops_per_point(keval, plan))
    del args

    # F: the DEEP sum over the LDE: one term per trace argument (two
    # distinct OOD points) and per composition column (a third)
    T = len(fib_air_big.trace_arguments()) + cb
    dcols = [rand(lde_n) for _ in range(T)]
    dinvs = rand(3, lde_n)
    inv_rows = list(dinvs)
    rows = [inv_rows[t % 2 if t < T - cb else 2] for t in range(T)]
    ds = rand(2 * T + 2)
    xl = lde.elements(dev)
    ck.check("deep", path, part(lambda: kdeep.deep(dcols, rows, ds, xl),
                                lambda: kdeep.deep_plain(dcols, rows, ds, xl)),
             8 * lde_n * (T + 3 + 2),
             lde_n * deep_ops_per_point([0] * T, 3, False))
    del dcols

    # F (OOD sums): the prove's pairs, each base column at the two trace
    # points, the composition column at z^m
    ocols = [rand(lde_n) for _ in range(cols + cb)]
    pairs = [(j, c) for c in range(cols) for j in (0, 1)]
    pairs += [(2, cols + k) for k in range(cb)]
    gpow = powers(lde.group_gen, lde_n, dev)
    ck.check("ood_sums", path,
             part(lambda: kdeep.ood_sums(ocols, dinvs, pairs, gpow),
                  lambda: kdeep.ood_sums_plain(ocols, dinvs, pairs, gpow)),
             8 * lde_n * (cols + cb + 3),
             lde_n * ood_ops_per_point([0] * len(pairs), 3, False))
    del ocols, dinvs


def compare_bf_kernels(ck: Checker, bf_air_big, path, names):
    """The brainfuck kernels `names` at the shapes of `path`'s prove,
    whose AIR is `bf_air_big`: the four Fq3 kernels, and the ntt,
    transpose, inv and (on the SHA-256 paths) sha256 kernels it shares
    with the fib path.  fibonacci.bf's 2^20 rows give LDE and CE domains
    of 2^24 points, hello_world's 2^11 rows domains of 2^15."""
    torch, dev = ck.torch, ck.dev
    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.fields.scalar import P
    from ministark_tpu_torch.ntt import (_split_n, _stage_table,
                                         _twiddle_matrix, powers)
    from ministark_tpu_torch.ops import deep as kdeep
    from ministark_tpu_torch.ops import eval as keval
    from ministark_tpu_torch.ops import inv as kinv
    from ministark_tpu_torch.ops import ntt as kntt
    from ministark_tpu_torch.ops import sha256 as ksha
    from ministark_tpu_torch.ops import transpose as ktr

    rand = ck.rand
    lde = bf_air_big.lde_domain()
    n = lde.size
    ce_n = bf_air_big.ce_domain().size
    nb = bf_air_big.config.NUM_BASE_COLUMNS
    ne = bf_air_big.config.NUM_EXTENSION_COLUMNS
    ncomp = bf_air_big.ce_blowup_factor
    args = bf_air_big.trace_arguments()
    offsets = sorted({off for _c, off in args})
    npts = len(offsets) + 1  # distinct OOD points: one per offset, and z^m
    chunk = 1 << 20
    plan, source, _denoms = teval._plan_for(bf_air_big)
    n_fp = sum(1 for k in plan.inv_keys if plan.inv_kind[k] == "fp")

    # A: the constraint evaluation's Fp denominators over the CE domain
    d = rand(n_fp, ce_n)
    d[..., ::4096] = 0
    ck.check("inv", path, part(lambda: kinv.inv_fp(d),
                               lambda: kinv.inv_fp_plain(d)),
             16 * n_fp * ce_n, n_fp * ce_n * OPS_INV + OPS_INV_CHAIN,
             plain_reps=1)
    del d

    # B: both column passes of the three coset LDEs: the base
    # trace (17 planes), the extension trace (9 Fq3 columns, 27 planes) and
    # the composition trace (16 Fq3 columns, 48 planes); one part per
    # matrix and pass, the plain version four planes at a time
    widths = (nb, 3 * ne, 3 * ncomp)
    n1, n2 = _split_n(n)
    tw1 = _stage_table(pow(lde.group_gen, n2, P), n1, dev)
    tw2 = _stage_table(pow(lde.group_gen, n1, P), n2, dev)
    pre = powers(lde.offset, n, dev).reshape(n1, n2)
    tmat = _twiddle_matrix(n, lde.group_gen, dev)

    def ntt_part(planes, first):
        def make():
            if first:
                x = rand(planes, n1, n2)
                return (lambda: kntt.col_ntt(x, tw1, pre=pre, tmat=tmat),
                        lambda: chunked(lambda c: kntt.col_ntt_plain(
                            c, tw1, pre=pre, tmat=tmat), x, 4), None)
            x = rand(planes, n2, n1)
            return (lambda: kntt.col_ntt(x, tw2),
                    lambda: chunked(lambda c: kntt.col_ntt_plain(c, tw2),
                                    x, 4), None)
        return make

    # at hello_world's 2^15 points a launch takes microseconds: time 50
    # back to back, and the device time alone and the host time of a call
    small = n < 1 << 20
    ck.check("ntt", path, [ntt_part(w, f) for w in widths for f in (1, 0)],
             sum(8 * (4 * w * n + 2 * n + n1 // 2 + n2 // 2) for w in widths),
             sum(w * n * (n.bit_length() - 1) // 2 * (OPS_MUL + 2 * OPS_ADD)
                 + 2 * w * n * OPS_MUL for w in widths),
             reps=50 if small else 2, plain_reps=1, launch_cost=small)
    del pre, tmat

    # C: the six-step transposes of the same three LDEs
    def tr_part(planes):
        def make():
            x = rand(planes, n1, n2)
            return (lambda: ktr.transpose(x), lambda: ktr.transpose_plain(x),
                    lambda: x.transpose(-1, -2).contiguous())
        return make

    ck.check("transpose", path, [tr_part(w) for w in widths],
             sum(16 * w * n for w in widths), 0, reps=50 if small else 2,
             plain_reps=50 if small else 2, launch_cost=small)

    if "sha256" in names:
        # D: the base LDE's row digests (17 columns, column-major view)
        # and one tree level of merges
        def sha_rows():
            m = rand(nb, n)
            return (lambda: ksha.hash_rows(m.T),
                    lambda: chunked(ksha.hash_rows_plain, m.T, chunk), None)

        def sha_merges():
            left, right = (torch.randint(0, 256, (n // 2, 32), generator=ck.g,
                                         device=dev, dtype=torch.int64)
                           .to(torch.uint8) for _ in range(2))
            return (lambda: ksha.merge(left, right),
                    lambda: torch.cat([
                        ksha.merge_plain(left[i:i + chunk], right[i:i + chunk])
                        for i in range(0, n // 2, chunk)]), None)

        ck.check("sha256", path, [sha_rows, sha_merges],
                 8 * nb * n + 32 * n + 64 * (n // 2) + 32 * (n // 2),
                 n * sha_ops(8 * nb) + n // 2 * sha_ops(64),
                 reps=50 if small else 2, plain_reps=1, launch_cost=small)

    # A (Fq3): the DEEP phase's barycentric inverses 1/(y - x), zeros
    # included
    a = rand(npts, 3, n)
    a[..., ::4096] = 0
    ck.check("inv_ext3", path, part(lambda: kinv.inv_ext3(a),
                                    lambda: kinv.inv_ext3_plain(a)),
             2 * 24 * npts * n, npts * n * OPS_INV3 + OPS_INV_CHAIN,
             plain_reps=1)
    del a

    if "sha256_ext3" in names:
        # D (Fq3): the extension trace, the composition trace and FRI layer 0
        # (rows of 16 Fq3 values)
        fold = bf_air_big.options.fri_folding_factor
        mats = [rand(ne, 3, n), rand(ncomp, 3, n), rand(fold, 3, n // fold)]

        def sha_kernel():
            return torch.cat([ksha.hash_rows_ext3(m) for m in mats])

        def sha_plain():
            out = []
            for m in mats:
                rows = ksha.ext3_rows(m)
                out += [ksha.hash_rows_plain(rows[i:i + chunk])
                        for i in range(0, rows.shape[0], chunk)]
            return torch.cat(out)

        ck.check("sha256_ext3", path, part(sha_kernel, sha_plain),
                 sum(8 * m.numel() + 32 * m.shape[2] for m in mats),
                 sum(m.shape[2] * sha_ops(24 * m.shape[0]) for m in mats),
                 reps=50 if small else 2, plain_reps=1, launch_cost=small)
        del mats

    # E (Fq3): the brainfuck AIR's generated evaluator, one kernel per term
    # group, over the CE domain
    eargs = [rand(nb, ce_n), rand(ne, 3, ce_n),
             bf_air_big.ce_domain().elements(dev),
             torch.zeros((len(plan.periodic), ce_n), dtype=torch.int64,
                         device=dev),
             rand(n_fp, ce_n), rand(len(plan.inv_keys) - n_fp, 3, ce_n),
             ck.scalar_table(plan)]
    cb = bf_air_big.ce_blowup_factor
    planes = nb + 3 * ne + 1 + len(plan.periodic) + n_fp + 3 * (
        len(plan.inv_keys) - n_fp)
    ck.check("eval_ext3", path,
             part(lambda: keval.eval_terms(plan, source, cb, *eargs),
                  lambda: torch.cat([
                      keval.eval_terms_plain(
                          plan, cb, *eargs,
                          points=(i, min(i + chunk // 2, ce_n)))
                      for i in range(0, ce_n, chunk // 2)], dim=-1)),
             8 * ce_n * (planes + 3), ce_n * eval_ops_per_point(keval, plan),
             reps=50 if small else 3, plain_reps=1, launch_cost=small)
    del eargs

    # F (Fq3): the DEEP sum, one term per trace argument (base and
    # extension columns) and per composition column, times (A + B x)
    base, ext, comp = rand(nb, n), rand(ne, 3, n), rand(ncomp, 3, n)
    invs = rand(npts, 3, n)
    # one view a column and a point, as composer.py gives them
    views = [base[c] for c in range(nb)] + [ext[e] for e in range(ne)]
    inv_rows = list(invs)
    cols, rows = [], []
    for col, off in args:
        cols.append(views[col])
        rows.append(inv_rows[offsets.index(off)])
    cols += [comp[k] for k in range(ncomp)]
    rows += [inv_rows[-1]] * ncomp
    T = len(cols)
    ds = rand(6 * T + 6)
    xl = bf_air_big.lde_domain().elements(dev)
    kinds = [int(c.ndim == 2) for c in cols]
    ck.check("deep_ext3", path,
             part(lambda: kdeep.deep_ext3(cols, rows, ds, xl),
                  lambda: kdeep.deep_ext3_plain(cols, rows, ds, xl)),
             8 * n * (nb + 3 * ne + 3 * ncomp + 3 * npts + 1 + 3),
             n * deep_ops_per_point(kinds, npts, True),
             reps=50 if small else 3, plain_reps=1, launch_cost=small)

    # F (OOD sums, Fq3): the prove's pairs, every trace argument's column
    # at its point and the composition columns at z^m, on the same columns
    # and inverse rows
    ocols = views + [comp[k] for k in range(ncomp)]
    pairs = sorted({(offsets.index(off), col) for col, off in args},
                   key=lambda jc: (jc[1], jc[0]))
    pairs += [(npts - 1, nb + ne + k) for k in range(ncomp)]
    gpow = powers(lde.group_gen, n, dev)
    ck.check("ood_sums_ext3", path,
             part(lambda: kdeep.ood_sums_ext3(ocols, invs, pairs, gpow),
                  lambda: kdeep.ood_sums_ext3_plain(ocols, invs, pairs,
                                                    gpow)),
             8 * n * (nb + 3 * ne + 3 * ncomp + 3 * npts),
             n * ood_ops_per_point(
                 [int(ocols[c].ndim == 2) for _j, c in pairs], npts, True,
                 len({j for j, c in pairs if ocols[c].ndim == 2})),
             reps=50 if small else 3, plain_reps=1, launch_cost=small)


def rpo_part(ck, make_input, hash_fn, plain_fn, sample=True):
    """One rpo256 part: make_input() gives the full-shape input (rows
    first); the kernel is timed on it, and kernel and plain version are
    compared on its first RPO_SAMPLE rows when `sample`, else on all."""
    def make():
        x = make_input()
        xs = x[:RPO_SAMPLE] if sample else x
        full = (lambda: hash_fn(x)) if sample else None
        return (lambda: hash_fn(xs), lambda: plain_fn(xs), None,
                *([full] if full else []))
    return make


def digests(ck, n):
    """n random RPO digests: four canonical elements each, (n, 32) uint8."""
    return ck.rand(n, 4).view(ck.torch.uint8)


def merge_halves(merge):
    """One tree level as the tree builds it: the two halves of a level."""
    return lambda d: merge(d[:d.shape[0] // 2], d[d.shape[0] // 2:])


def compare_rpo_rows(ck: Checker, path, fib_air_big, n):
    """The RPO permutation at the fully algebraic fib prove's shapes over n
    LDE rows (all of them in one process, a rank's share in D-R): the n
    eight-column base rows and the n composition rows, each laid out as
    (ncols, n) and read as its transpose, one tree level of n / 2 merges
    and FRI layer 0's n / fold rows of fold; compared on the first
    RPO_SAMPLE rows of each part, timed whole."""
    from ministark_tpu_torch.ops import rpo256 as krpo

    cb = fib_air_big.ce_blowup_factor
    fold = fib_air_big.options.fri_folding_factor

    parts = [
        rpo_part(ck, lambda: ck.rand(8, n).T, krpo.hash_rows,
                 krpo.hash_rows_plain),
        rpo_part(ck, lambda: ck.rand(cb, n).T, krpo.hash_rows,
                 krpo.hash_rows_plain),
        rpo_part(ck, lambda: digests(ck, n), merge_halves(krpo.merge),
                 merge_halves(krpo.merge_plain)),
        rpo_part(ck, lambda: ck.rand(n // fold, fold), krpo.hash_rows,
                 krpo.hash_rows_plain)]
    perms = (n + n * ((cb + 7) // 8) + n // 2
             + (n // fold) * ((fold + 7) // 8))
    ck.check("rpo256", path, parts,
             8 * (8 + cb + 1) * n + 64 * n + 96 * (n // 2) + 32 * (n // fold),
             perms * OPS_RPO, reps=2, plain_reps=1,
             plain_on=f"the first {RPO_SAMPLE} rows of each part")


def compare_bf_rpo_kernels(ck: Checker, hello_air):
    """The RPO permutation at hello_world's shapes (LDE 2^15 points): the
    17-column base rows, the 9- and 16-column Fq3 rows, one tree level of
    merges and FRI layer 0 (2^11 rows of 16 Fq3 values), all compared in
    full."""
    from ministark_tpu_torch.ops import rpo256 as krpo

    n = hello_air.lde_domain().size
    nb = hello_air.config.NUM_BASE_COLUMNS
    ne = hello_air.config.NUM_EXTENSION_COLUMNS
    ncomp = hello_air.ce_blowup_factor
    fold = hello_air.options.fri_folding_factor

    def whole(make_input, fn, plain):
        return rpo_part(ck, make_input, fn, plain, sample=False)

    parts = [
        whole(lambda: ck.rand(nb, n).T, krpo.hash_rows, krpo.hash_rows_plain),
        whole(lambda: ck.rand(ne, 3, n), krpo.hash_rows_ext3,
              krpo.hash_rows_ext3_plain),
        whole(lambda: ck.rand(ncomp, 3, n), krpo.hash_rows_ext3,
              krpo.hash_rows_ext3_plain),
        whole(lambda: digests(ck, n), merge_halves(krpo.merge),
              merge_halves(krpo.merge_plain)),
        whole(lambda: ck.rand(fold, 3, n // fold), krpo.hash_rows_ext3,
              krpo.hash_rows_ext3_plain)]
    absorbs = [(w + 7) // 8 for w in (nb, 3 * ne, 3 * ncomp)]
    perms = n * sum(absorbs) + n // 2 + (n // fold) * ((3 * fold + 7) // 8)
    elems = (nb + 3 * ne + 3 * ncomp) * n + 3 * n
    ck.check("rpo256", BF_RPO, parts, 8 * elems + 32 * 3 * n + 96 * (n // 2)
             + 32 * (n // fold), perms * OPS_RPO, reps=2, plain_reps=1)


def tree_plain(kmod, leaves):
    """Every level of the tree over `leaves` by `kmod`'s merge_plain, the
    two halves of each level merged, as one tensor."""
    import torch

    levels, cur = [leaves], leaves
    while cur.shape[0] > 1:
        h = cur.shape[0] // 2
        cur = kmod.merge_plain(cur[:h], cur[h:])
        levels.append(cur)
    return torch.cat(levels)


def compare_tree(ck: Checker, path, n, sample, sha=False, tip=0):
    """A whole Merkle tree (RPO-256, or SHA-256 where `sha`) over n leaf
    digests through ``merkle.tree_levels`` (the path's largest tree: its
    merge launches and the tops launch), timed at n; compared level by
    level with merge_plain on a tree of `sample` leaves (all n where
    sample == n).  With `tip`, a second part: the tree over `tip` digests
    (a sharded tree's tip over the ranks' subtree roots), whole."""
    import torch

    from ministark_tpu_torch import hash as H
    from ministark_tpu_torch import hash_rpo, merkle
    from ministark_tpu_torch.ops import rpo256 as krpo
    from ministark_tpu_torch.ops import sha256 as ksha

    hashfn, kmod = (H, ksha) if sha else (hash_rpo, krpo)

    def make():
        leaves = digests(ck, n)
        small = leaves[:sample]

        def full():
            return merkle.tree_levels(leaves, hashfn)

        return (lambda: torch.cat(merkle.tree_levels(small, hashfn)),
                lambda: tree_plain(kmod, small), None,
                *([full] if sample < n else []))

    def make_tip():
        roots = digests(ck, tip)
        return (lambda: torch.cat(merkle.tree_levels(roots, hashfn)),
                lambda: tree_plain(kmod, roots), None)

    on = f"a tree of {sample} of the {n} leaves" if sample < n else None
    if tip:
        on = f"{on or 'the whole tree'}; the tip of {tip} roots whole"
    ck.check("sha256_tree" if sha else "rpo256_tree", path,
             [make, make_tip] if tip else [make],
             32 * (2 * n - 1) + (32 * (2 * tip - 1) if tip else 0),
             (n - 1 + max(tip - 1, 0)) * (sha_ops(64) if sha else OPS_RPO),
             reps=2 if n > 1 << 20 else 20, plain_reps=1, plain_on=on)


def compare_sha_grind(ck: Checker, path, bits):
    """The SHA-256 grind of `path` (`bits` bits) on a seed made from the
    path's name: its nonce against the native host grind's, and every
    nonce's count of leading zeros in its first batch (4 * 2^bits nonces,
    at most 2^22; a 2^18-nonce sample where larger) against the plain
    version; timed as the prover runs it (``ops.sha256.grind``: the
    launches, and one read back each).  The bound counts the nonces up to
    the one found."""
    import hashlib

    torch = ck.torch
    from ministark_tpu_torch import native
    from ministark_tpu_torch.ops import sha256 as ksha

    seed = hashlib.sha256(path.encode()).digest()
    nonce = ksha.grind(seed, bits, ck.dev)
    want = native.pow_grind(seed, bits)
    print(f"kernel sha256_grind ({path}): {bits}-bit nonce {nonce}, the "
          f"native host grind's {want}", flush=True)
    if nonce != want:
        fail(f"the SHA-256 grind on {path} found {nonce}, the host {want}")
    batch = min(ksha.BATCH_CUDA, 4 << bits)
    sample = min(batch, SHA_SAMPLE)

    def make():
        lz = torch.empty(sample, dtype=torch.int32, device=ck.dev)

        def kernel():
            ksha.grind_batch(seed, 1, sample, bits, ck.dev, lz=lz)
            return lz

        return (kernel,
                lambda: ksha.leading_zeros_plain(seed, 1, sample, ck.dev),
                None, lambda: ksha.grind(seed, bits, ck.dev))

    ck.check("sha256_grind", path, [make], 32 + 4, nonce * OPS_SHA_GRIND,
             reps=20, plain_reps=1,
             plain_on=f"the counts of the first {sample} nonces")


def compare_grind(ck: Checker, path, bits):
    """The RPO grind kernel on one batch of nonces, as large as the path's
    grind launches it (4 * 2^bits, at most 2^20): every nonce's count of
    leading zeros against the plain version, on a 2^18-nonce sample where
    the batch is larger."""
    torch = ck.torch
    from ministark_tpu_torch.ops import pow as kpow

    seed = kpow.seed_elements(bytes(range(7, 39)), ck.dev)
    batch = min(kpow.BATCH_CUDA, 1 << (bits + 2))
    sample = min(batch, RPO_SAMPLE)

    def make():
        lz = torch.empty(sample, dtype=torch.int32, device=ck.dev)

        def kernel():
            kpow.grind_batch(seed, 1, sample, bits, lz=lz)
            return lz

        full = [lambda: kpow.grind_batch(seed, 1, batch, bits)]
        return (kernel, lambda: kpow.leading_zeros_plain(seed, 1, sample),
                None, *(full if batch > sample else []))

    ck.check("rpo256_grind", path, [make], 32 + 4, batch * OPS_RPO,
             plain_reps=1, plain_on=(f"the first {sample} of {batch} nonces"
                                     if batch > sample else None))


def compare_coin(ck: Checker, path, fold, k_prove, rpo=False):
    """The path's coin step (``coin_sha``, or ``coin_rpo`` for the RPO
    coin) against its plain version on seeds and roots made from the
    path's name: k = 1, 3, 5 draws for SHA-256, 1-8 for RPO-256 (Fp draws
    one at a time, an Fq3 alpha three), with the `fold` powers of alpha
    the path's folds take for k = 1 and 3; the root read in place from a
    level of digests.  The row's times and bound are one launch's at the
    prove's (k_prove, fold), the launch the prove makes once a FRI layer
    (50 launches, device time alone and host time a call too).  For the
    RPO coin also one draw digest at a counter past 2^32 against the
    host's ``hash_rpo.merge_with_int``."""
    import hashlib

    torch = ck.torch
    from ministark_tpu_torch import hash_rpo
    from ministark_tpu_torch.ops import coin as kcoin

    name = "coin_rpo" if rpo else "coin_sha"
    fn = kcoin.coin_rpo if rpo else kcoin.coin_sha
    plain = kcoin.coin_rpo_plain if rpo else kcoin.coin_sha_plain
    ks = list(range(1, 9) if rpo else (1, 3, 5))
    tag = path.encode()
    if rpo:  # RPO roots and seeds: four canonical elements
        seed = hash_rpo.hash_elements(list(hashlib.sha256(tag).digest()[:8]))
        root = hash_rpo.hash_elements(list(tag))
    else:
        seed = hashlib.sha256(tag).digest()
        root = hashlib.sha256(tag + b" root").digest()
    level = torch.stack([kcoin.seed_tensor(d, ck.dev) for d in (seed, root)])
    s = level[0].clone()

    def flat(out):
        return torch.cat([out[0].view(torch.int64), out[1],
                          out[2].reshape(-1)])

    def powers(k):
        return fold if k in (1, 3) else 0

    def make(k):
        return lambda: (lambda: flat(fn(s, level[1], k, powers(k))),
                        lambda: flat(plain(s, level[1], k, powers(k))), None)

    k = k_prove
    ck.check(name, path, [make(kk) for kk in ks],
             32 * 3 + 8 * k * (1 + fold),
             (OPS_RPO if rpo else OPS_COIN_SHA_RESEED)
             + (k + 3) // 4 * (OPS_RPO if rpo else OPS_SHA_GRIND)
             + k * OPS_MUL
             + max(fold - 2, 0) * (OPS_MUL if k == 1 else OPS_MUL3),
             reps=50, plain_reps=1, launch_cost=True, timed={ks.index(k)})
    r = ck.results[(name, path)]
    print(f"kernel {name} ({path}): {r['ms'] * 1e3:.1f} us a launch at the "
          f"prove's k = {k}, N = {fold} ({r['device_only_ms']} ms device "
          f"time alone, {r['host_us']:.1f} us host time a call); the prove "
          f"launches it once a FRI layer", flush=True)
    if rpo:
        counter = (1 << 32) + 5
        d = kcoin.rpo_draw_digests(s.view(torch.int64),
                                   torch.tensor([counter], device=ck.dev))
        want = hash_rpo.merge_with_int(seed, counter)
        got = d[:, 0].cpu().numpy().tobytes()
        print(f"kernel coin_rpo ({path}): draw digest at counter 2^32 + 5 "
              f"equal to hash_rpo.merge_with_int's: {got == want}",
              flush=True)
        if got != want:
            fail("the RPO draw digest at a counter past 2^32 differs")


def big_values(field, n, seed):
    """n field values made from a numpy seed, uniform below p."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nb = (field.p.bit_length() + 7) // 8 + 8
    raw = rng.bytes(nb * n)
    return [int.from_bytes(raw[i:i + nb], "little") % field.p
            for i in range(0, nb * n, nb)]


# the sizes big_ntt is also compared at, untimed: one pass of 2 and 32
# points, two passes of 2^11 and 2^15
BIG_EXTRA_LOG_N = (1, 5, 11, 15)


def big_ntt_ops(n: int, mul_ops: int, w: int, scaled: bool) -> int:
    """(n/2) log2 n butterflies, each a sum and a difference, and a product
    in all but the n - 1 whose twiddle is w^0 = 1; a product a point where
    a scale table is folded in."""
    log_n = n.bit_length() - 1
    bflies = n // 2 * log_n
    return (bflies * 2 * ops_big_add(w) + (bflies - (n - 1)) * mul_ops
            + (n * mul_ops if scaled else 0))


def l2_copies(torch, nbytes: int) -> int:
    """How many copies of a working set of `nbytes` take four times the
    card's L2 cache: a timing that reads them in turn reads device memory,
    not the cache that back-to-back calls on the same inputs would hit
    (twice the L2 still left part of them there)."""
    props = torch.cuda.get_device_properties(0)
    l2 = getattr(props, "L2_cache_size", 50 << 20)
    return max(2, -(-4 * l2 // nbytes))


def compare_big_kernels(ck: Checker):
    """The BIG path's kernels at 2^18 points (2^18 pairs), Fp128 and
    Fp252: big_ntt forward and inverse, plain and coset (offset the
    field's generator), and big_mul, against their plain versions, timed
    with their device time alone and host time a call (launch_cost); also
    compared, untimed: big_ntt at 2, 32, 2^11 and 2^15 points the same
    eight ways, and big_mul over two other odd moduli (the generic
    product, M127 = 2^127 - 1 and 2^255 - 19).  big_mul is timed over
    copies of its inputs read in turn (l2_copies), so that its inputs come
    from device memory as its bytes bound assumes; big_ntt's inputs (8 MB
    at most, a small share of its time) stay in L2.  The bound counts the
    sparse product (ops_big_mul_sparse); the CIOS model's bound is printed
    beside it."""
    from ministark_tpu_torch.fields.bigvec import (BigDomain, BigField,
                                                   Fp128Vec, Fp252Vec)
    from ministark_tpu_torch.ops import bigfield as kbig

    n = 1 << BIG_LOG_N
    ntt_parts, mul_parts, extra_ntt = [], [], []
    ntt_bytes = mul_bytes = 0
    ntt_ops = mul_ops = ntt_ops_cios = mul_ops_cios = 0

    def ntt_part(f, m, offset, inverse, x=None):
        def make():
            xs = x if x is not None else f.pack(big_values(f, m, m), ck.dev)
            dom = BigDomain(f, m, offset)
            tw, first, last = dom._tables(inverse, str(ck.dev))
            table = dom._kernel_table(inverse, str(ck.dev))
            return (lambda: kbig.big_ntt(xs, tw, f, first, last, table),
                    lambda: kbig.big_ntt_plain(xs, tw, f, first, last), None)
        return make

    def mul_part(g, a=None, b=None, rotate=False):
        def make():
            xa = a if a is not None else g.pack(big_values(g, n, 3), ck.dev)
            xb = b if b is not None else g.pack(big_values(g, n, 4), ck.dev)
            sets = [(xa, xb)]  # the first call (compared) takes these
            if rotate:
                sets += [(xa.clone(), xb.clone()) for _ in range(
                    l2_copies(ck.torch, 3 * xa.nbytes) - 1)]
            it = itertools.cycle(sets)
            return (lambda: kbig.big_mul(*next(it), g),
                    lambda: kbig.big_mul_plain(xa, xb, g), None)
        return make

    for f in (Fp128Vec, Fp252Vec):
        w, top = 2 * f.L64, BIG_TOP_WORDS[f.name]
        x = f.pack(big_values(f, n, f.L64), ck.dev)
        y = f.pack(big_values(f, n, f.L64 + 1), ck.dev)
        for offset in (1, f.generator):
            for inverse in (False, True):
                ntt_parts.append(ntt_part(f, n, offset, inverse, x))
                scaled = offset != 1 or inverse
                ntt_bytes += 2 * 8 * f.L64 * n
                ntt_ops += big_ntt_ops(n, ops_big_mul_sparse(w, top), w,
                                       scaled)
                ntt_ops_cios += big_ntt_ops(n, ops_big_mul(w), w, scaled)
                extra_ntt += [ntt_part(f, 1 << k, offset, inverse)
                              for k in BIG_EXTRA_LOG_N]
        mul_parts.append(mul_part(f, x, y, rotate=True))
        mul_bytes += 3 * 8 * f.L64 * n
        mul_ops += n * ops_big_mul_sparse(w, top)
        mul_ops_cios += n * ops_big_mul(w)
    extra_mul = [mul_part(BigField("M127", 2**127 - 1, 3, 1)),
                 mul_part(BigField("P255m19", 2**255 - 19, 2, 2))]
    for name, ops, ops_cios, nbytes in (
            ("big_ntt", ntt_ops, ntt_ops_cios, ntt_bytes),
            ("big_mul", mul_ops, mul_ops_cios, mul_bytes)):
        print(f"kernel {name} ({BIG}) bound: {bound(nbytes, ops)[0]:.4f} ms "
              f"({bound(nbytes, ops)[1]}; the sparse product), "
              f"{bound(nbytes, ops_cios)[0]:.4f} ms ({bound(nbytes, ops_cios)[1]}"
              "; the CIOS model before it)", flush=True)
    ck.check("big_ntt", BIG, ntt_parts + extra_ntt, ntt_bytes, ntt_ops,
             reps=20, plain_reps=1, launch_cost=True,
             timed=set(range(len(ntt_parts))))
    ck.check("big_mul", BIG, mul_parts + extra_mul, mul_bytes, mul_ops,
             reps=20, plain_reps=1, launch_cost=True,
             timed=set(range(len(mul_parts))))


def big_path(torch, build, ck):
    """The BIG path through the user's entry points: for Fp128 and Fp252 a
    2^18-point ``BigDomain`` plain and over the coset of the field's
    generator, ``fft`` and ``ifft`` timed (CUDA events, the mean of three
    after one) and checked (ifft(fft(x)) == x; 64 coefficients against
    Horner's rule on the host at a few points), and ``BigField.mul`` of
    2^18 pairs against the bigint products of a sample.  The launch counts
    are reset just before and read just after."""
    from ministark_tpu_torch.fields.bigvec import BigDomain, Fp128Vec, Fp252Vec

    n = 1 << BIG_LOG_N
    fields, ok = {}, True
    doms = {(f.name, off): BigDomain(f, n, off)
            for f in (Fp128Vec, Fp252Vec) for off in (1, f.generator)}
    for (name, off), dom in doms.items():  # tables built before the run
        for inverse in (False, True):
            dom._tables(inverse, str(ck.dev))
            dom._kernel_table(inverse, str(ck.dev))
    inputs = {f.name: (f.pack(big_values(f, n, 7), ck.dev),
                       f.pack(big_values(f, 64, 8), ck.dev),
                       f.pack(big_values(f, n, 9), ck.dev))
              for f in (Fp128Vec, Fp252Vec)}
    torch.cuda.synchronize()
    reset_counts(build)
    for f in (Fp128Vec, Fp252Vec):
        x, c64, y = inputs[f.name]
        out = {}
        for off in (1, f.generator):
            dom = doms[(f.name, off)]
            ev = dom.fft(x)
            fft_ms = time_ms(torch, lambda: dom.fft(x), 3)
            ifft_ms = time_ms(torch, lambda: dom.ifft(ev), 3)
            back = torch.equal(dom.ifft(ev), x)
            coeffs = f.unpack(c64)
            pad = torch.zeros((f.L64, n), dtype=torch.int64, device=ck.dev)
            pad[:, :64] = c64
            evals = dom.fft(pad)
            idx = (0, 1, n // 3 + 5, n - 1)
            got = f.unpack(evals[:, list(idx)])
            horner = all(g == _horner(f.p, coeffs, dom.element(i))
                         for g, i in zip(got, idx))
            out[f"offset_{off}"] = {"fft_ms": fft_ms, "ifft_ms": ifft_ms,
                                    "ifft_fft_is_x": back,
                                    "horner_4_points": horner}
            ok &= back and horner
        prod = f.mul(x, y)
        mul_ms = time_ms(torch, lambda: f.mul(x, y), 3)
        sample = range(0, n, n // 16)
        xs, ys = f.unpack(x[:, list(sample)]), f.unpack(y[:, list(sample)])
        exact = f.unpack(prod[:, list(sample)]) == [
            a * b % f.p for a, b in zip(xs, ys)]
        out["mul_ms"], out["mul_sample_exact"] = mul_ms, exact
        ok &= exact
        fields[f.name] = out
    launches = read_counts(build, BIG_PATH, "the BIG path")
    print(json.dumps({BIG: {"points": n, **fields, "launches": launches}}),
          flush=True)
    if not ok:
        fail("the BIG path's transforms or products are not exact")
    return {"launches": launches}


def _horner(p, coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def plain_by_columns(kntt, x, tw, pre=None, tmat=None, parts=16):
    """col_ntt_plain over `parts` slices of the columns, concatenated: the
    plain version of a 2^27- or 2^29-point pass, whose temporaries would
    not fit whole."""
    import torch

    step = x.shape[-1] // parts

    def cut(t, i):
        return None if t is None else t[..., i:i + step].contiguous()

    return torch.cat([kntt.col_ntt_plain(cut(x, i), tw, cut(pre, i),
                                         cut(tmat, i))
                      for i in range(0, x.shape[-1], step)], dim=-1)


def compare_lde_kernels(ck: Checker):
    """The LDE path's kernels at its shapes: kernel B and the transpose on
    both passes of the 2^27-point inverse transform (columns of 2^13, then
    2^14 points, one column per block) and on the first pass of the
    2^29-point coset transform (columns of 2^14 points, with its pre and
    twiddle tables); the multi-pass kernel on that transform's second
    pass (2^14 columns of 2^15 points), and at n1 = 2^12 against kernel B
    on one input.  Each buffer of 2^29 values is 4 GiB; the plain version
    runs a sixteenth of the columns at a time."""
    torch = ck.torch
    from ministark_tpu_torch.fields.scalar import P
    from ministark_tpu_torch.ntt import Domain, _split_n, _stage_table, powers
    from ministark_tpu_torch.ops import ntt as kntt
    from ministark_tpu_torch.ops import transpose as ktr

    n_trace, n = 1 << 27, 1 << 29
    t1, t2 = _split_n(n_trace)
    n1, n2 = _split_n(n)
    g_trace_inv = pow(Domain(n_trace).group_gen, P - 2, P)
    lde = Domain(n, 7)

    def pass_part(rows, cols, root, tables):
        # a pass of an (rows * cols)-point transform with primitive root
        # `root`: its columns' root is root^cols
        def make():
            x = ck.rand(1, rows, cols)
            tw = _stage_table(pow(root, cols, P), rows, ck.dev)
            pre = ck.rand(rows, cols) if "pre" in tables else None
            tmat = ck.rand(rows, cols)
            return (lambda: kntt.col_ntt(x, tw, pre, tmat),
                    lambda: plain_by_columns(kntt, x, tw, pre, tmat), None)
        return make

    passes = ((t1, t2, g_trace_inv, ("tmat",)),
              (t2, t1, g_trace_inv, ("tmat",)),
              (n1, n2, lde.group_gen, ("pre", "tmat")))
    ck.check("ntt", LDE, [pass_part(*p) for p in passes],
             sum(8 * (2 + len(t)) * r * c + 4 * r for r, c, _, t in passes),
             sum(r * c * (r.bit_length() - 1) // 2 * (OPS_MUL + 2 * OPS_ADD)
                 + len(t) * r * c * OPS_MUL for r, c, _, t in passes),
             reps=2, plain_reps=1)
    torch.cuda.empty_cache()

    def tr_part(rows, cols):
        def make():
            x = ck.rand(1, rows, cols)
            return (lambda: ktr.transpose(x), lambda: ktr.transpose_plain(x),
                    lambda: x.transpose(-1, -2).contiguous())
        return make

    ck.check("transpose", LDE, [tr_part(t1, t2), tr_part(n1, n2)],
             16 * (n_trace + n), 0, reps=2, plain_reps=2)
    torch.cuda.empty_cache()

    tw2 = _stage_table(pow(lde.group_gen, n1, P), n2, ck.dev)
    x = ck.rand(1, n2, n1)
    butterflies = n // 2 * (n2.bit_length() - 1)
    ck.check("ntt_stage", LDE,
             part(lambda: kntt.col_ntt(x, tw2),
                  lambda: plain_by_columns(kntt, x, tw2)),
             16 * n, butterflies * (OPS_MUL + 2 * OPS_ADD), reps=2,
             plain_reps=1)
    del x
    torch.cuda.empty_cache()

    m = 1 << 12
    tw = powers(pow(lde.group_gen, n // m, P), m // 2, ck.dev)
    y, pre, tmat = ck.rand(2, m, 64), ck.rand(m, 64), ck.rand(m, 64)
    staged = kntt.col_ntt_staged(y, tw, pre, tmat)
    err = max_abs_err(torch, staged, kntt.col_ntt(y, tw, pre, tmat))
    err_plain = max_abs_err(torch, staged,
                            kntt.col_ntt_plain(y, tw, pre, tmat))
    print(f"kernel ntt_stage at n1 = 2^12 against kernel B on the same "
          f"input: max_abs_err={err}, against the plain version "
          f"{err_plain} (tolerance 0)", flush=True)
    if err != 0 or err_plain != 0:
        fail("the multi-pass NTT disagrees with kernel B or its plain "
             "version at n1 = 2^12")
    # the longest column it takes in two passes, on narrow columns
    m = 1 << 16
    tw = powers(pow(lde.group_gen, n // m, P), m // 2, ck.dev)
    for cols in (1, 16):
        y, pre, tmat = ck.rand(1, m, cols), ck.rand(m, cols), ck.rand(m, cols)
        err = max_abs_err(torch, kntt.col_ntt_staged(y, tw, pre, tmat),
                          kntt.col_ntt_plain(y, tw, pre, tmat))
        print(f"kernel ntt_stage at n1 = 2^16, {cols} column(s), against "
              f"its plain version: max_abs_err={err} (tolerance 0)",
              flush=True)
        if err != 0:
            fail("the multi-pass NTT disagrees with its plain version at "
                 "n1 = 2^16")


# ProofOptions(num_queries, lde_blowup_factor, grinding_factor,
# fri_folding_factor, fri_max_remainder_coeffs)
FIB_OPTS = (32, 4, 8, 8, 64)    # bench.py's fib options
BF_OPTS = (19, 16, 20, 16, 16)  # brainfuck's 96-bit options
# fib's options with the blowup raised to 8, the least the Rescue AIR takes
# (its constraints have degree 8 N): 2^21-point LDE and CE domains
RESCUE_OPTS = (32, 8, 8, 8, 64)
RESCUE_LINKS = 1 << 14  # 2^18 rows


def rescue_seed() -> tuple[int, int]:
    """The Rescue chain's seed (s0, s1), made from a fixed integer: two
    field elements (63-bit values, below the Goldilocks prime)."""
    import random

    rng = random.Random(20260418)
    return rng.getrandbits(63), rng.getrandbits(63)


def rpo_claims():
    """The RPO configurations: ``Stark`` subclasses that set the hash knobs
    (the reference's MerkleTree and PublicCoin associated types), as the
    JAX package's tests define them: (FibClaimRpoFull, FibClaimRpo,
    BrainfuckClaimRpo)."""
    from ministark_tpu_torch import hash_rpo
    from ministark_tpu_torch.models.brainfuck import BrainfuckClaim
    from ministark_tpu_torch.models.fib import FibClaim

    class FibClaimRpoFull(FibClaim):  # RPO trees and RPO coin
        merkle_hash = hash_rpo
        coin_hash = hash_rpo

    class FibClaimRpo(FibClaim):  # RPO trees, SHA-256 coin
        merkle_hash = hash_rpo

    class BrainfuckClaimRpo(BrainfuckClaim):
        merkle_hash = hash_rpo
        coin_hash = hash_rpo

    return FibClaimRpoFull, FibClaimRpo, BrainfuckClaimRpo


def workload(name: str):
    """One of the proves this script drives (and
    ``scripts/profile_prove.py`` profiles), made through the user's entry
    points on the card:
      "fib"        fib at 2^24 values (2^21 rows x 8 columns), FIB_OPTS;
      "fib_big"    fib at 2^29 values (2^26 rows x 8 columns), FIB_OPTS:
                   more than one card holds in one process, for
                   ``scripts/prove_sharded.py`` on several cards;
      "fib_big_rpo" "fib_big" with RPO-256 trees and coin;
      "bf"         ``programs/fibonacci.bf`` with its count line cut from
                   eleven '+' to ten (2^20 rows), BF_OPTS;
      "hello"      ``programs/hello_world.bf``, BF_OPTS;
      "fib_rpo"    "fib" with RPO-256 trees and coin;
      "hello_rpo"  "hello" with RPO-256 trees and coin;
      "rescue"     the Rescue chain of 2^14 links from ``rescue_seed()``
                   (2^18 rows x 4 columns), RESCUE_OPTS.
    Returns (claim, trace, options, info); info holds the host seconds that
    made the trace and, for brainfuck, the rows and the program's output."""
    import torch

    from ministark_tpu_torch.air import ProofOptions
    from ministark_tpu_torch.models.brainfuck import (BrainfuckClaim,
                                                      BrainfuckTrace, simulate)
    from ministark_tpu_torch.models.fib import FibClaim, gen_trace

    fib_rpo, _, bf_rpo = rpo_claims()
    if name == "rescue":
        from ministark_tpu_torch.models.rescue import RescueClaim
        from ministark_tpu_torch.models.rescue import gen_trace as rescue_trace

        seed = rescue_seed()
        t0 = time.perf_counter()
        trace, (d0, d1) = rescue_trace(seed, RESCUE_LINKS)
        torch.cuda.synchronize()
        return RescueClaim(*seed, d0.v, d1.v), trace, ProofOptions(
            *RESCUE_OPTS), {"trace_gen_s": time.perf_counter() - t0}
    if name in ("fib", "fib_rpo", "fib_big", "fib_big_rpo"):
        t0 = time.perf_counter()
        trace = gen_trace(1 << (29 if name.startswith("fib_big") else 24))
        claim = (fib_rpo if name.endswith("_rpo") else FibClaim)(
            trace.last_value())
        torch.cuda.synchronize()
        return claim, trace, ProofOptions(*FIB_OPTS), {
            "trace_gen_s": time.perf_counter() - t0}
    program = "fibonacci.bf" if name == "bf" else "hello_world.bf"
    with open(os.path.join(PROGRAMS, program)) as f:
        source = f.read()
    if name == "bf":
        lines = source.split("\n")
        count = next(i for i, line in enumerate(lines) if line)
        if lines[count] != "+" * 11:
            fail(f"unexpected count line in programs/fibonacci.bf: "
                 f"{lines[count]!r}")
        lines[count] = "+" * 10
        source = "\n".join(lines)
    t0 = time.perf_counter()
    tables, output = simulate(source)
    vm_s = time.perf_counter() - t0
    rows = tables["processor"].shape[0]
    if name == "bf" and rows != 1 << 20:
        fail(f"expected 2^20 rows, got {rows}")
    t0 = time.perf_counter()
    trace = BrainfuckTrace(tables)
    torch.cuda.synchronize()
    cls = bf_rpo if name == "hello_rpo" else BrainfuckClaim
    return cls(source, b"", output), trace, ProofOptions(*BF_OPTS), {
        "vm_s": vm_s, "trace_upload_s": time.perf_counter() - t0,
        "rows": rows, "output": output}


def reset_counts(build):
    for k in build.KERNELS.values():
        k.launches = 0


def read_counts(build, path, what):
    return read_counts_of({name: k.launches
                           for name, k in build.KERNELS.items()}, path, what)


def read_counts_of(counts: dict, path, what):
    missing = [k for k in path if counts[k] == 0]
    if missing:
        fail(f"kernels {missing} did not launch in {what}: {counts}")
    return counts


def prove_timed(torch, build, claim, opts, trace, path, what):
    """Cold prove, then the warm prove with its counts of launches reset
    just before and read just after, per-phase times and peak memory."""
    t0 = time.perf_counter()
    claim.prove(opts, trace)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    reset_counts(build)
    torch.cuda.reset_peak_memory_stats()
    phases: list = []
    t0 = time.perf_counter()
    proof = claim.prove(opts, trace, phases)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = read_counts(build, path, what)
    pow_ = next(p for p in phases if p["phase"] == "Proof of work")
    print(f"{what}: warm Proof of work {pow_['host_ms']:.3f} ms host, "
          f"{pow_['device_ms']:.3f} ms device (nonce {proof.pow_nonce}, "
          f"grind {opts.grinding_factor} bits)", flush=True)
    fri = next(p for p in phases if p["phase"] == "FRI")
    print(f"{what}: warm FRI {fri['host_ms']:.3f} ms host, "
          f"{fri['device_ms']:.3f} ms device (CUDA events), "
          f"{len(proof.fri_proof.layers)} layers", flush=True)
    return proof, {"cold_prove_s": cold_s, "warm_prove_s": warm_s,
                   "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "phases": phases, "launches": launches}


def verify_and_tamper(claim, data, fp, fq, bits, what):
    from ministark_tpu_torch.proof import Proof
    from ministark_tpu_torch.verifier import VerificationError

    t0 = time.perf_counter()
    claim.verify(Proof.from_bytes(data, fp, fq), bits)
    verify_s = time.perf_counter() - t0
    tampered = bytearray(data)
    tampered[21] ^= 1  # first byte of the base trace commitment
    try:
        claim.verify(Proof.from_bytes(bytes(tampered), fp, fq), bits)
    except VerificationError as e:
        print(f"tampered {what} proof rejected: {e}", flush=True)
    else:
        fail(f"the verifier accepted a tampered {what} proof")
    return verify_s


def periodic_ms(torch, claim, opts, trace) -> float:
    """Device ms of the constraint evaluation's periodic columns alone: each
    of the AIR's Periodic leaves over the CE domain, as
    ``eval.eval_composition`` computes them (plain torch), the mean of
    three runs after one."""
    from ministark_tpu_torch import eval as teval

    air = claim.build_air(trace.base_columns().num_rows, opts)
    plan = teval._plan_for(air)[0]
    x = air.ce_domain().elements(trace.base_columns().device)
    return time_ms(torch, lambda: [teval.periodic_values(p, x, air.trace_len)
                                   for p in plan.periodic], 3)


def lde_2e29(torch, build, ck):
    """A one-column 2^29-point coset LDE (blowup 4 over a 2^27-row trace
    domain) through Matrix.interpolate/evaluate; its second column pass
    (2^15 rows) runs the multi-pass kernel.  Checked exactly: the inverse
    transform of the LDE gives the coefficients back (zero above 2^27), and
    a column of 64 nonzero coefficients agrees with Horner's rule on the
    host at a few LDE points."""
    from ministark_tpu_torch.fields import device as fd
    from ministark_tpu_torch.fields.scalar import P
    from ministark_tpu_torch.matrix import Matrix
    from ministark_tpu_torch import ntt as tntt

    n, blowup = 1 << 27, 4
    trace_dom, lde_dom = tntt.Domain(n), tntt.Domain(n * blowup, 7)
    # each 2^29-point buffer is 4 GiB: the LDE, the padded input, the first
    # pass's output and its transpose, plus the cached pre and twiddle
    # tables of each transform (powers and matrix, 4 GiB apiece)
    print(f"{LDE}: 2^27-row column, LDE 2^29 points, 4 GiB per 2^29-point "
          f"buffer; about 40 GiB at peak with the tables", flush=True)
    col = Matrix(ck.rand(1, n))
    coeffs = col.interpolate(trace_dom)   # warm-up: tables and kernels
    coeffs.evaluate(lde_dom)
    torch.cuda.synchronize()
    reset_counts(build)
    torch.cuda.reset_peak_memory_stats()
    lde, ms = timed_once(torch, lambda: col.interpolate(trace_dom)
                         .evaluate(lde_dom))
    launches = read_counts(build, LDE_PATH, "the 2^29-point LDE")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del col
    tntt._TABLE_CACHE.clear()
    torch.cuda.empty_cache()
    back = lde_dom.ifft(lde.values)
    exact = (torch.equal(back[:, :n], coeffs.values)
             and not back[:, n:].any().item())
    del back, lde
    tntt._TABLE_CACHE.clear()
    torch.cuda.empty_cache()
    c64 = torch.zeros((1, n), dtype=torch.int64, device=ck.dev)
    c64[0, :64] = ck.rand(64)
    evals = Matrix(c64).evaluate(lde_dom).values[0]
    host = fd.to_ints(c64[0, :64])
    horner = True
    for i in (0, 1, 12345, 2 * n + 7, 4 * n - 1):
        x, acc = lde_dom.element(i).v, 0
        for c in reversed(host):
            acc = (acc * x + c) % P
        horner &= fd.to_ints(evals[i:i + 1])[0] == acc
    del c64, evals, coeffs
    tntt._TABLE_CACHE.clear()
    torch.cuda.empty_cache()
    print(f"{LDE}: interpolate + evaluate {ms:.3f} ms (device), peak "
          f"{peak:.2f} GiB; ifft(fft(x)) == x: {exact}; Horner at 5 "
          f"points: {horner}; launches {launches}", flush=True)
    if not (exact and horner):
        fail("the 2^29-point LDE is not exact")
    return {"device_ms": ms, "peak_device_gib": peak, "launches": launches}


def compare_sharded_kernels(ck: Checker, fib_air_big, d: int):
    """D's kernels at the shapes a rank of d gives them in the fib prove:
    kernel B on both slabs of the sharded six-step of the first FRI fold's
    inverse transform (2^23 points: (n1, n2/d) with the twiddle slab, then
    (n2, n1/d) with 1/n), kernel C on its local transpose ((d, n1/d,
    n2/d) blocks), kernel D on a rank's rows of the LDE (rows j = rank
    mod d of the 8 columns, and a level of merges) and on a rank's whole
    subtree, kernel E's block entry on rank 0's block of the CE domain
    (its halo the next block's first points), kernel A on that block's
    denominators and on the rank's OOD weights' denominators, and kernel
    F's DEEP sum and OOD sums on the rank's LDE rows."""
    from types import SimpleNamespace

    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.fields.scalar import P
    from ministark_tpu_torch.ntt import Domain, _split_n, _stage_table
    from ministark_tpu_torch.ops import deep as kdeep
    from ministark_tpu_torch.ops import eval as keval
    from ministark_tpu_torch.ops import inv as kinv
    from ministark_tpu_torch.ops import ntt as kntt
    from ministark_tpu_torch.ops import sha256 as ksha
    from ministark_tpu_torch.ops import transpose as ktr
    from ministark_tpu_torch.parallel.executor import domain_points
    from ministark_tpu_torch.parallel.ntt import ShardedDomain

    torch, dev, rand = ck.torch, ck.dev, ck.rand
    n = fib_air_big.lde_domain().size
    cols = fib_air_big.config.NUM_BASE_COLUMNS
    n1, n2 = _split_n(n)
    m = n // d
    sdom = ShardedDomain(SimpleNamespace(d=d, rank=0, device=dev), n)
    root = Domain(n).group_gen_inv
    tw1 = _stage_table(pow(root, n2, P), n1, dev)
    tw2 = _stage_table(pow(root, n1, P), n2, dev)

    def passes():
        x1, x2 = rand(1, n1, n2 // d), rand(1, n2, n1 // d)
        tmat, post = sdom._tmat(root), sdom._post()
        return [lambda: (lambda: kntt.col_ntt(x1, tw1, tmat=tmat),
                         lambda: kntt.col_ntt_plain(x1, tw1, tmat=tmat),
                         None),
                lambda: (lambda: kntt.col_ntt(x2, tw2, tmat=post),
                         lambda: kntt.col_ntt_plain(x2, tw2, tmat=post),
                         None)]
    ck.check("ntt", SHARDED, passes(),
             8 * (6 * m + n1 // 2 + n2 // 2),
             m * (n.bit_length() - 1) // 2 * (OPS_MUL + 2 * OPS_ADD)
             + 2 * m * OPS_MUL, reps=5, plain_reps=2)

    x = rand(d, n1 // d, n2 // d)
    ck.check("transpose", SHARDED,
             part(lambda: ktr.transpose(x), lambda: ktr.transpose_plain(x),
                  lambda: x.transpose(-1, -2).contiguous()),
             16 * m, 0, reps=5)
    del x

    rows = rand(cols, m)  # a rank's rows of the LDE after the all_to_all
    left, right = (torch.randint(0, 256, (m // 2, 32), generator=ck.g,
                                 device=dev, dtype=torch.int64)
                   .to(torch.uint8) for _ in range(2))
    ck.check("sha256", SHARDED,
             part(lambda: torch.cat([ksha.hash_rows(rows.T),
                                     ksha.merge(left, right)]),
                  lambda: torch.cat([ksha.hash_rows_plain(rows.T),
                                     ksha.merge_plain(left, right)])),
             8 * cols * m + 32 * m + 64 * (m // 2) + 32 * (m // 2),
             m * sha_ops(8 * cols) + m // 2 * sha_ops(64),
             reps=2, plain_reps=2)
    del rows, left, right
    compare_tree(ck, SHARDED, m, min(m, SHA_SAMPLE), sha=True)

    # A: rank 0's CE block's denominators (one vector a denominator) and
    # its OOD weights' denominators (y - x_i) at the three OOD points
    plan, source, _denoms = teval._plan_for(fib_air_big)
    ce_dom = fib_air_big.ce_domain()
    mc, halo = ce_dom.size // d, teval.trace_halo(fib_air_big)
    ninv = len(plan.inv_keys)
    dens, ws = rand(ninv * mc), rand(3 * m)
    dens[::4096] = 0
    ck.check("inv", SHARDED,
             [lambda: (lambda: kinv.inv_fp(dens),
                       lambda: kinv.inv_fp_plain(dens), None),
              lambda: (lambda: kinv.inv_fp(ws),
                       lambda: kinv.inv_fp_plain(ws), None)],
             16 * (ninv * mc + 3 * m),
             (ninv * mc + 3 * m) * OPS_INV + 2 * OPS_INV_CHAIN)
    del dens, ws

    # E: the block entry at rank 0's block, trace columns of mc + halo
    cb = fib_air_big.ce_blowup_factor
    nper = len(plan.periodic)
    args = [rand(cols, mc + halo),
            torch.zeros((0, 3, mc + halo), dtype=torch.int64, device=dev),
            domain_points(ce_dom, 0, 1, mc, dev)[0], rand(nper, mc),
            rand(ninv, mc),
            torch.zeros((0, 3, mc), dtype=torch.int64, device=dev),
            ck.scalar_table(plan)]
    ck.check("eval", SHARDED,
             part(lambda: keval.eval_terms_block(plan, source, cb, *args),
                  lambda: keval.eval_terms_plain(plan, cb, *args,
                                                 block=True)),
             8 * (cols * (mc + halo) + mc * (1 + nper + ninv + 1)),
             mc * eval_ops_per_point(keval, plan))
    del args

    # F: the DEEP sum and the OOD sums on rank 0's rows j = i d of the LDE
    # (x and g^j its own), the fib prove's terms and pairs
    T = len(fib_air_big.trace_arguments()) + cb
    xl, gpow = domain_points(fib_air_big.lde_domain(), 0, d, m, dev)
    dcols = [rand(m) for _ in range(T)]
    dinvs = rand(3, m)
    inv_rows = list(dinvs)
    drows = [inv_rows[t % 2 if t < T - cb else 2] for t in range(T)]
    ds = rand(2 * T + 2)
    ck.check("deep", SHARDED,
             part(lambda: kdeep.deep(dcols, drows, ds, xl),
                  lambda: kdeep.deep_plain(dcols, drows, ds, xl)),
             8 * m * (T + 3 + 2), m * deep_ops_per_point([0] * T, 3, False))
    del dcols
    ocols = [rand(m) for _ in range(cols + cb)]
    pairs = [(j, c) for c in range(cols) for j in (0, 1)]
    pairs += [(2, cols + k) for k in range(cb)]
    ck.check("ood_sums", SHARDED,
             part(lambda: kdeep.ood_sums(ocols, dinvs, pairs, gpow),
                  lambda: kdeep.ood_sums_plain(ocols, dinvs, pairs, gpow)),
             8 * m * (cols + cb + 3),
             m * ood_ops_per_point([0] * len(pairs), 3, False))
    del ocols, dinvs, xl, gpow


def compare_sharded_rpo_kernels(ck: Checker, fib_air_big, d: int):
    """D-R's RPO-256 rows at the shapes rank 0 of d gives them in the fully
    algebraic fib prove (R): the row hashes of the rank's LDE rows j = 0
    mod d of the 8 base columns and of the composition's cb columns, laid
    out as the executor lays them after its exchange ((ncols, n / d)
    contiguous, read as its transpose), one level of merges of the rank's
    leaves and FRI layer 0's rows of the rank (n / fold / d rows of fold);
    the rank's whole subtree through ``merkle.tree_levels`` (its merges
    and the tops launch) and the tip over the d gathered subtree roots,
    the tops launch at m = d.  The large parts are compared on their first
    RPO_SAMPLE rows (a tree of RPO_SAMPLE leaves) and timed whole."""
    m = fib_air_big.lde_domain().size // d
    compare_rpo_rows(ck, SHARDED_RPO, fib_air_big, m)
    compare_tree(ck, SHARDED_RPO, m, RPO_SAMPLE, tip=d)


def sharded_prove(mesh, name: str, verify_bits: int | None = None):
    """Run on every rank: `name`'s workload (made on the rank's device)
    proved by prove_sharded, cold then warm; the warm run's bytes, host
    seconds, per-phase ms, launches (counts reset just before it and read
    just after), collectives and peak device memory.  With `verify_bits`
    rank 0 also verifies its proof and rejects it with a byte flipped
    (``verify_and_tamper``)."""
    import torch
    import torch.distributed as dist

    from ministark_tpu_torch.ops import build
    from ministark_tpu_torch.parallel.prover import prove_sharded

    claim, trace, opts, info = workload(name)
    t0 = time.perf_counter()
    prove_sharded(claim, opts, trace, mesh)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    dist.barrier()
    reset_counts(build)
    mesh.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    phases: list = []
    t0 = time.perf_counter()
    proof = prove_sharded(claim, opts, trace, mesh, phase_log=phases)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    out = {}
    if verify_bits is not None and mesh.rank == 0:
        from ministark_tpu_torch.fields.scalar import Fp

        out["verify_s"] = verify_and_tamper(claim, proof.to_bytes(claim.fq),
                                            Fp, claim.fq, verify_bits, name)
    return {**out, "proof": proof.to_bytes(claim.fq),
            "cold_prove_s": cold_s, "warm_prove_s": warm_s,
            "phases": phases,
            "launches": {k: v.launches for k, v in build.KERNELS.items()},
            "collectives": mesh.collectives,
            "collective_bytes": mesh.collective_bytes,
            "max_collective_bytes": mesh.max_collective_bytes,
            "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
            "loaded": sorted(m for m, v in sys.modules.items()
                             if v is not None and m.split(".")[0] in (
                                 "jax", "jaxlib", "ministark_tpu"))}


def sharded_path(torch, build, expect: dict, claims: dict, card: str,
                 one_peak: dict):
    """D: fib at F's size by prove_sharded at NCCL world size 1 in this
    process, then fib and hello_world (D-F) and, over RPO-256 trees and
    coin, the fully algebraic fib and hello_world (D-R) in SHARDED_RANKS
    gloo ranks sharing the card (spawned processes that load the libraries
    built in phase 2); every rank's bytes must equal the one-process proof
    of phase 5 (F), 7 (W), 8 (R) or 9 (H), and verify; every prove must
    make collectives, the same count and bytes on every rank; every rank's
    peak memory is printed beside the one-process prove's (`one_peak`),
    and a D-R fib rank's may be at most 70% of it.  Returns rank 0's
    launches of the gloo fib run and of the gloo RPO fib run."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from ministark_tpu_torch.fields.scalar import Fp, Fq3
    from ministark_tpu_torch.parallel.sharded import make_mesh
    from ministark_tpu_torch.parallel.spawn import RankPool
    from ministark_tpu_torch.proof import Proof

    def report(what, name, runs):
        fq = Fq3 if name.startswith("hello") else Fp
        for rank, r in enumerate(runs):
            if r["proof"] != expect[name]:
                fail(f"{what}: rank {rank}'s proof differs from the "
                     f"one-process proof")
            if r["loaded"]:
                fail(f"{what}: rank {rank} imported {r['loaded']}")
        if runs[0]["collectives"] == 0:
            fail(f"{what}: the prove made no collective")
        if len({(r["collectives"], r["collective_bytes"])
                for r in runs}) != 1:
            fail(f"{what}: the ranks' collectives differ")
        claims[name].verify(Proof.from_bytes(runs[0]["proof"], Fp, fq),
                            96 if fq is Fq3 else 30)
        r0 = runs[0]
        phases = {p["phase"]: round(p["device_ms"], 3) for p in r0["phases"]}
        print(f"{what}: byte-identical to the one-process proof on "
              f"{len(runs)} rank(s), verified; warm {r0['warm_prove_s']:.3f}"
              f" s on rank 0 (ranks {[round(r['warm_prove_s'], 3) for r in runs]}"
              f"), cold {r0['cold_prove_s']:.3f} s; collectives "
              f"{r0['collectives']} a prove, {r0['collective_bytes']} bytes "
              f"sent a rank, the largest {r0['max_collective_bytes']}; peak "
              f"{[round(r['peak_device_gib'], 3) for r in runs]} GiB a rank "
              f"(the one-process prove: {one_peak[name]:.3f} GiB); rank 0's "
              f"phases, device ms: {phases}",
              flush=True)
        print(json.dumps({what: {"card": card, **{k: v for k, v in r0.items()
                                                   if k != "proof"},
                                 "ranks": len(runs),
                                 "warm_prove_s_ranks": [r["warm_prove_s"]
                                                        for r in runs],
                                 "peak_device_gib_ranks": [
                                     r["peak_device_gib"] for r in runs]}}),
              flush=True)

    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        mesh = make_mesh("nccl", init_method=f"file://{store}/nccl",
                         rank=0, world_size=1)
        try:
            run = sharded_prove(mesh, "fib")
        finally:
            dist.destroy_process_group()
        if run["collectives"] == 0:
            fail("the NCCL world-size-1 prove made no collective")
        report(f"{SHARDED} (NCCL, world size 1)", "fib", [run])
        del run
        torch.cuda.empty_cache()
        shared = (f"{SHARDED_RANKS} gloo ranks sharing one card: a "
                  f"shared-card gloo run through host memory, not a "
                  f"multi-card figure")
        with RankPool(SHARDED_RANKS, "gloo", "cuda", f"{store}/gloo",
                      timeout=900) as pool:
            fib_runs = pool.run(sharded_prove, "fib")
            report(f"{SHARDED} ({shared})", "fib", fib_runs)
            hello_runs = pool.run(sharded_prove, "hello")
            report(f"sharded_bf_hello_world ({shared})", "hello", hello_runs)
            rpo_runs = pool.run(sharded_prove, "fib_rpo")
            report(f"{SHARDED_RPO} ({shared})", "fib_rpo", rpo_runs)
            peak = max(r["peak_device_gib"] for r in rpo_runs)
            if peak > 0.7 * one_peak["fib_rpo"]:
                fail(f"{SHARDED_RPO}: a rank's peak {peak:.3f} GiB is more "
                     f"than 70% of the one-process prove's "
                     f"{one_peak['fib_rpo']:.3f} GiB")
            hello_rpo_runs = pool.run(sharded_prove, "hello_rpo")
            report(f"sharded_bf_hello_world_rpo ({shared})", "hello_rpo",
                   hello_rpo_runs)
            read_counts_of(hello_rpo_runs[0]["launches"], BF_RPO_PATH,
                           "the sharded RPO hello_world prove (rank 0)")
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return (read_counts_of(fib_runs[0]["launches"], SHARDED_PATH,
                           "the sharded fib prove (rank 0)"),
            read_counts_of(rpo_runs[0]["launches"], FIB_RPO_PATH,
                           "the sharded RPO fib prove (rank 0)"))


def build_kernels():
    """Build every kernel library: one nvcc a source file, and one a
    generated evaluator (fib, brainfuck, Rescue), all started together.
    The generated sources do not depend on the trace length (the trace
    length and any other Pow exponent sit in the scalar table), so one AIR
    of each kind suffices; returns those AIRs (fib, brainfuck, Rescue) at
    the proves' sizes."""
    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.air import Air, ProofOptions
    from ministark_tpu_torch.fields.scalar import Fp
    from ministark_tpu_torch.models.brainfuck import (BrainfuckAirConfig,
                                                      BrainfuckClaim)
    from ministark_tpu_torch.models.fib import FibAirConfig
    from ministark_tpu_torch.models.rescue import RescueAirConfig
    from ministark_tpu_torch.ops import (bigfield, build, coin,  # noqa: F401
                                         deep, eval, inv, ntt, rpo256,
                                         sha256, transpose)

    t0 = time.perf_counter()
    fib_air_big = Air(FibAirConfig, 1 << 21, Fp(0), ProofOptions(*FIB_OPTS))
    bf_air_big = Air(BrainfuckAirConfig, 1 << 20,
                     BrainfuckClaim("", b"", b""), ProofOptions(*BF_OPTS))
    rescue_air_big = Air(RescueAirConfig, RESCUE_LINKS * 16, (0, 0, 0, 0),
                         ProofOptions(*RESCUE_OPTS))
    by_file = {}  # kernels that share a source file share its library
    for k in build.KERNELS.values():
        if k.source:
            by_file.setdefault(k.source, k)
    jobs = [(k, None) for k in by_file.values()]
    jobs += [(build.KERNELS["eval"], teval._plan_for(fib_air_big)[1]),
             (build.KERNELS["eval_ext3"], teval._plan_for(bf_air_big)[1]),
             (build.KERNELS["eval"], teval._plan_for(rescue_air_big)[1])]
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        list(ex.map(lambda j: j[0].build(j[1]), jobs))
    print(f"build: {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return fib_air_big, bf_air_big, rescue_air_big


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, ROOT)
    try:
        from ministark_tpu_torch.air import Air, ProofOptions
        from ministark_tpu_torch.fields.scalar import Fp, Fq3
        from ministark_tpu_torch.models.brainfuck import (
            BrainfuckAirConfig, BrainfuckClaim, BrainfuckTrace, simulate)
        from ministark_tpu_torch.models.fib import FibClaim, gen_trace
        from ministark_tpu_torch.models.rescue import RescueClaim
        from ministark_tpu_torch.models.rescue import (
            gen_trace as rescue_trace)
        from ministark_tpu_torch.ops import (bigfield, build, coin,  # noqa: F401
                                            deep, eval, inv, ntt, rpo256,
                                            sha256, transpose)
        import ministark_tpu_torch.ops.pow  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable beside this script: {e}")
    for path in (GOLDEN_FIB, GOLDEN_BF, GOLDEN_RPO, GOLDEN_BF_RPO,
                 GOLDEN_RESCUE, PROGRAMS):
        if not os.path.exists(path):
            fail(f"missing {path}")
    for mod in ("jax", "ministark_tpu"):
        if mod in sys.modules:
            fail(f"{mod} was imported")

    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    fib_golden_opts = ProofOptions(num_queries=8, lde_blowup_factor=4,
                                   grinding_factor=2, fri_folding_factor=4,
                                   fri_max_remainder_coeffs=16)
    bf_golden_opts = ProofOptions(num_queries=9, lde_blowup_factor=16,
                                  grinding_factor=0, fri_folding_factor=4,
                                  fri_max_remainder_coeffs=16)
    rescue_golden_opts = ProofOptions(num_queries=8, lde_blowup_factor=8,
                                      grinding_factor=4, fri_folding_factor=4,
                                      fri_max_remainder_coeffs=16)

    # -- phase 2: build ------------------------------------------------------
    fib_air_big, bf_air_big, rescue_air_big = build_kernels()

    # -- phase 3: kernels against their plain versions -------------------------
    ck = Checker(torch, dev)
    with open(os.path.join(PROGRAMS, "hello_world.bf")) as f:
        hello_rows = simulate(f.read())[0]["processor"].shape[0]
    hello_air = Air(BrainfuckAirConfig, hello_rows,
                    BrainfuckClaim("", b"", b""), ProofOptions(*BF_OPTS))
    compare_fib_kernels(ck, fib_air_big, FIB, FIB_PATH)
    compare_bf_kernels(ck, bf_air_big, BF, BF_PATH)
    compare_bf_kernels(ck, hello_air, HELLO, BF_PATH)
    torch.cuda.empty_cache()
    hello_n = hello_air.lde_domain().size
    for path, bits, n in ((FIB, FIB_OPTS[2], fib_air_big.lde_domain().size),
                          (BF, BF_OPTS[2], bf_air_big.lde_domain().size),
                          (HELLO, BF_OPTS[2], hello_n)):
        compare_sha_grind(ck, path, bits)
        compare_tree(ck, path, n, min(n, SHA_SAMPLE), sha=True)
        compare_coin(ck, path, (FIB_OPTS if path == FIB else BF_OPTS)[3],
                     1 if path == FIB else 3)
    torch.cuda.empty_cache()
    compare_fib_kernels(ck, fib_air_big, FIB_RPO, FIB_RPO_PATH)
    compare_rpo_rows(ck, FIB_RPO, fib_air_big, fib_air_big.lde_domain().size)
    compare_bf_kernels(ck, hello_air, BF_RPO, BF_RPO_PATH)
    compare_bf_rpo_kernels(ck, hello_air)
    compare_grind(ck, FIB_RPO, FIB_OPTS[2])
    compare_grind(ck, BF_RPO, BF_OPTS[2])
    compare_tree(ck, FIB_RPO, fib_air_big.lde_domain().size, RPO_SAMPLE)
    compare_tree(ck, BF_RPO, hello_n, hello_n)
    compare_coin(ck, FIB_RPO, FIB_OPTS[3], 1, rpo=True)
    compare_coin(ck, BF_RPO, BF_OPTS[3], 3, rpo=True)
    torch.cuda.empty_cache()
    compare_lde_kernels(ck)
    torch.cuda.empty_cache()
    compare_fib_kernels(ck, rescue_air_big, RESCUE, RESCUE_PATH)
    rescue_n = rescue_air_big.lde_domain().size
    compare_sha_grind(ck, RESCUE, RESCUE_OPTS[2])
    compare_tree(ck, RESCUE, rescue_n, min(rescue_n, SHA_SAMPLE), sha=True)
    compare_coin(ck, RESCUE, RESCUE_OPTS[3], 1)
    torch.cuda.empty_cache()
    compare_big_kernels(ck)
    torch.cuda.empty_cache()

    # -- phase 4: the golden proofs ------------------------------------------
    reset_counts(build)
    trace = gen_trace(1 << 10)
    claim = FibClaim(trace.last_value())
    data = claim.prove(fib_golden_opts, trace).to_bytes(Fp)
    with open(GOLDEN_FIB, "rb") as f:
        if data != f.read():
            fail("the 2^10-value proof differs from tests/golden/fib_2e10.proof")
    counts = read_counts(build, FIB_PATH, "the golden fib prove")
    print(f"golden fib 2^10 proof: byte-identical ({len(data)} bytes); "
          f"launches {counts}", flush=True)

    reset_counts(build)
    tables, output = simulate(GOLDEN_BF_PROGRAM)
    claim = BrainfuckClaim(GOLDEN_BF_PROGRAM, b"", output)
    data = claim.prove(bf_golden_opts, BrainfuckTrace(tables)).to_bytes(Fq3)
    with open(GOLDEN_BF, "rb") as f:
        if data != f.read():
            fail("the brainfuck proof differs from "
                 "tests/golden/brainfuck_2plus3.proof")
    # grind 0: the golden brainfuck prove never grinds
    counts = read_counts(build, [k for k in BF_PATH if k != "sha256_grind"],
                         "the golden brainfuck prove")
    print(f"golden brainfuck proof: byte-identical ({len(data)} bytes); "
          f"launches {counts}", flush=True)

    reset_counts(build)
    fib_rpo, fib_rpo_trees, _ = rpo_claims()
    trace = gen_trace(1 << 7)
    rpo_opts = ProofOptions(8, 4, 3, 4, 4)
    data = fib_rpo(trace.last_value()).prove(rpo_opts, trace).to_bytes(Fp)
    with open(GOLDEN_RPO, "rb") as f:
        if data != f.read():
            fail("the fully algebraic fib proof differs from "
                 "tests/golden/fib_2e7_rpo_full.proof")
    counts = read_counts(build, FIB_RPO_PATH, "the golden RPO fib prove")
    print(f"golden fully algebraic fib 2^7 proof: byte-identical "
          f"({len(data)} bytes); launches {counts}", flush=True)
    claim = fib_rpo_trees(trace.last_value())
    verify_and_tamper(claim, claim.prove(rpo_opts, trace).to_bytes(Fp), Fp,
                      Fp, 8, "RPO-tree SHA-coin fib 2^7")

    reset_counts(build)
    bf_rpo = rpo_claims()[2](GOLDEN_BF_PROGRAM, b"", output)
    data = bf_rpo.prove(bf_golden_opts, BrainfuckTrace(tables)).to_bytes(Fq3)
    with open(GOLDEN_BF_RPO, "rb") as f:
        if data != f.read():
            fail("the RPO brainfuck proof differs from "
                 "tests/golden/brainfuck_2plus3_rpo.proof")
    # grind 0: the golden brainfuck prove never grinds
    counts = read_counts(build, [k for k in BF_RPO_PATH
                                 if k != "rpo256_grind"],
                         "the golden RPO brainfuck prove")
    print(f"golden RPO brainfuck proof: byte-identical ({len(data)} bytes); "
          f"launches {counts}", flush=True)

    reset_counts(build)
    trace, (d0, d1) = rescue_trace((7, 8), 4)
    claim = RescueClaim(7, 8, d0.v, d1.v)
    data = claim.prove(rescue_golden_opts, trace).to_bytes(Fp)
    with open(GOLDEN_RESCUE, "rb") as f:
        if data != f.read():
            fail("the Rescue proof differs from "
                 "tests/golden/rescue_4links.proof")
    counts = read_counts(build, RESCUE_PATH, "the golden Rescue prove")
    print(f"golden Rescue 4-link proof: byte-identical ({len(data)} bytes); "
          f"launches {counts}", flush=True)

    # -- phase 5: the 2^24-value fib prove -------------------------------------
    claim, trace, opts, info = workload("fib")
    proof, fib = prove_timed(torch, build, claim, opts, trace, FIB_PATH,
                             "the 2^24-value fib prove")
    data = proof.to_bytes(Fp)
    one_process, one_claims = {"fib": data}, {"fib": claim}
    fib["verify_s"] = verify_and_tamper(claim, data, Fp, Fp, 30, "fib 2^24")
    print(json.dumps({FIB: {"card": card, **info, "proof_bytes": len(data),
                            **fib}}), flush=True)
    del trace, claim, proof
    torch.cuda.empty_cache()

    # -- phase 6: fibonacci.bf, ten numbers, 2^20 rows -------------------------
    claim, trace, opts, info = workload("bf")
    output = info.pop("output")
    print(f"fibonacci.bf (10 numbers): VM {info['vm_s']:.3f} s on the host, "
          f"{info['rows']} rows, output {output!r}", flush=True)
    proof, bf = prove_timed(torch, build, claim, opts, trace, BF_PATH,
                            "the 2^20-row brainfuck prove")
    data = proof.to_bytes(Fq3)
    bf["verify_s"] = verify_and_tamper(claim, data, Fp, Fq3, 96,
                                       "brainfuck 2^20")
    print(json.dumps({BF: {"card": card, **info, "proof_bytes": len(data),
                           **bf}}), flush=True)
    del trace, claim, proof
    torch.cuda.empty_cache()

    # -- phase 7: hello_world.bf ------------------------------------------------
    claim, trace, opts, info = workload("hello")
    del info["output"]
    proof, hello = prove_timed(torch, build, claim, opts, trace, BF_PATH,
                               "the hello_world prove")
    one_process["hello"], one_claims["hello"] = proof.to_bytes(Fq3), claim
    hello["verify_s"] = verify_and_tamper(claim, one_process["hello"], Fp,
                                          Fq3, 96, "hello_world")
    print(json.dumps({HELLO: {"card": card, **info, **hello}}), flush=True)
    del trace, claim, proof
    torch.cuda.empty_cache()

    # -- phase 8: the fully algebraic fib prove, 2^24 values --------------------
    claim, trace, opts, info = workload("fib_rpo")
    proof, fib_rpo_run = prove_timed(torch, build, claim, opts, trace,
                                     FIB_RPO_PATH, "the RPO fib prove")
    data = proof.to_bytes(Fp)
    one_process["fib_rpo"], one_claims["fib_rpo"] = data, claim
    fib_rpo_run["verify_s"] = verify_and_tamper(claim, data, Fp, Fp, 30,
                                                "RPO fib 2^24")
    print(json.dumps({FIB_RPO: {"card": card, **info,
                                "proof_bytes": len(data), **fib_rpo_run}}),
          flush=True)
    del trace, claim, proof
    torch.cuda.empty_cache()

    # -- phase 9: hello_world with RPO trees and coin ---------------------------
    claim, trace, opts, info = workload("hello_rpo")
    del info["output"]
    proof, hello_rpo = prove_timed(torch, build, claim, opts, trace,
                                   BF_RPO_PATH, "the RPO hello_world prove")
    one_process["hello_rpo"], one_claims["hello_rpo"] = (
        proof.to_bytes(Fq3), claim)
    hello_rpo["verify_s"] = verify_and_tamper(
        claim, one_process["hello_rpo"], Fp, Fq3, 96, "RPO hello_world")
    print(json.dumps({BF_RPO: {"card": card, **info, **hello_rpo}}),
          flush=True)
    del trace, claim, proof
    torch.cuda.empty_cache()

    # -- phase 10: the Rescue chain, 2^14 links, 2^18 rows ---------------------
    claim, trace, opts, info = workload("rescue")
    print(f"{RESCUE}: the chain of {RESCUE_LINKS} links on the host "
          f"{info['trace_gen_s']:.3f} s", flush=True)
    proof, rescue = prove_timed(torch, build, claim, opts, trace,
                                RESCUE_PATH, "the Rescue prove")
    data = proof.to_bytes(Fp)
    rescue["verify_s"] = verify_and_tamper(claim, data, Fp, Fp, 30,
                                           "Rescue 2^18")
    rescue["periodic_ms"] = periodic_ms(torch, claim, opts, trace)
    print(json.dumps({RESCUE: {"card": card, **info,
                               "proof_bytes": len(data), **rescue}}),
          flush=True)
    del trace, claim, proof
    torch.cuda.empty_cache()

    # -- phase 11: the 2^29-point LDE -------------------------------------------
    lde = lde_2e29(torch, build, ck)

    # -- phase 12: the 128- and 252-bit field vectors at 2^18 points -----------
    big = big_path(torch, build, ck)

    # -- phase 13: D, the multi-process prover ------------------------------------
    torch.cuda.empty_cache()
    compare_sharded_kernels(ck, fib_air_big, SHARDED_RANKS)
    torch.cuda.empty_cache()
    compare_sharded_rpo_kernels(ck, fib_air_big, SHARDED_RANKS)
    torch.cuda.empty_cache()
    sharded, sharded_rpo = sharded_path(
        torch, build, one_process, one_claims, card,
        {"fib": fib["peak_device_gib"], "hello": hello["peak_device_gib"],
         "fib_rpo": fib_rpo_run["peak_device_gib"],
         "hello_rpo": hello_rpo["peak_device_gib"]})

    # one entry per kernel and path: checked at that path's shapes, with
    # the launches of that path's warm run
    kernels = []
    for path, names, counts in (
            (FIB, FIB_PATH, fib["launches"]), (BF, BF_PATH, bf["launches"]),
            (HELLO, BF_PATH, hello["launches"]),
            (FIB_RPO, FIB_RPO_PATH, fib_rpo_run["launches"]),
            (BF_RPO, BF_RPO_PATH, hello_rpo["launches"]),
            (LDE, LDE_PATH, lde["launches"]),
            (RESCUE, RESCUE_PATH, rescue["launches"]),
            (BIG, BIG_PATH, big["launches"]),
            (SHARDED, SHARDED_PATH, sharded),
            (SHARDED_RPO, SHARDED_RPO_ROWS, sharded_rpo)):
        for name in names:
            k = build.KERNELS[name]
            src = (f"ministark_tpu_torch/csrc/{k.source}" if k.source
                   else "ministark_tpu_torch/ops/eval.py")
            kernels.append({"name": name, "route": "cuda", "source": src,
                            "replaces": k.replaces, "path": path,
                            "launches": counts[name],
                            **ck.results[(name, path)]})
    if {k["name"] for k in kernels} != set(build.KERNELS):
        fail("a registered kernel is on no path")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"{card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
