"""Affine prefix scans over the extension field (mirrors
``ministark_tpu.scan``).

Running permutation products and evaluation sums (BrainSTARK extension
columns, examples/brainfuck/trace.rs:108-289) are affine recurrences
s' = a*s + b.  As tensor code they become log-depth Hillis-Steele doubling
passes: with (A_i, B_i) the composition of f_{i-2^k+1..i}, one pass gives
compositions of twice the span,

    (A, B)_i <- (A_i * A_{i-2^k},  A_i * B_{i-2^k} + B_i).

The JAX package runs this as XLA code with no Pallas kernel.  Here CUDA
tensors launch a hand-written kernel (``ops/scan.py``, csrc/scan.cu: one
pass that reads a and b once); CPU tensors take the doubling in plain
PyTorch, every column of a batch scanned in the same passes.
``affine_scan_ext3_sequential`` is the test oracle.
"""

from __future__ import annotations

import torch

from .fields import device as fd
from .ops import scan as kscan


def _shift_right(x: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """x shifted k places along its last axis, Fq3 `fill` (fill, 0, 0)
    coming in."""
    pad = torch.zeros_like(x[..., :k])
    pad[..., 0, :] = fill
    return torch.cat([pad, x[..., :-k]], dim=-1)


def affine_scan_ext3(a: torch.Tensor, b: torch.Tensor, init: torch.Tensor,
                     inclusive) -> torch.Tensor:
    """Per-step maps f_i(s) = a_i*s + b_i from an initial state:

    inclusive:  out[i] = f_i(f_{i-1}(...f_0(init)))   (state AFTER step i)
    exclusive:  out[0] = init, out[i] = state BEFORE step i

    a, b: (B, 3, n) Fq3 batches; init: (B, 3); inclusive: a bool, or B
    bools, one per batch entry.  Returns (B, 3, n).  CUDA tensors launch
    the kernel; CPU tensors take the plain version."""
    if a.is_cuda:
        return kscan.affine_scan_ext3(a, b, init, inclusive)
    return affine_scan_ext3_plain(a, b, init, inclusive)


def affine_scan_ext3_plain(a: torch.Tensor, b: torch.Tensor,
                           init: torch.Tensor, inclusive) -> torch.Tensor:
    """``affine_scan_ext3`` as log2(n) Hillis-Steele doubling passes."""
    n = a.shape[-1]
    A, Bv = a, b
    k = 1
    while k < n:
        Bv = fd.add(fd.ext3_mul(A, _shift_right(Bv, k, 0)), Bv)
        A = fd.ext3_mul(A, _shift_right(A, k, 1))
        k *= 2
    init = init.unsqueeze(-1)
    after = fd.add(fd.ext3_mul(A, init), Bv)
    before = torch.cat([init, after[..., :-1]], dim=-1)
    inc = torch.as_tensor(inclusive, device=a.device).reshape(-1, 1, 1)
    return torch.where(inc, after, before)


def affine_scan_ext3_sequential(a, b, init, inclusive) -> torch.Tensor:
    """The same recurrence one step at a time (the test oracle)."""
    n = a.shape[-1]
    state = init.unsqueeze(-1)
    after = []
    for i in range(n):
        state = fd.add(fd.ext3_mul(a[..., i:i + 1], state), b[..., i:i + 1])
        after.append(state)
    after = torch.cat(after, dim=-1)
    before = torch.cat([init.unsqueeze(-1), after[..., :-1]], dim=-1)
    inc = torch.as_tensor(inclusive, device=a.device).reshape(-1, 1, 1)
    return torch.where(inc, after, before)
