"""Batched column NTT: wrapper for kernel B (csrc/ntt.cu) beside its plain
PyTorch version.

Contract (both versions): x is (B, n1, C) int64; every column (b, :, c) is
transformed along n1 with

    load rows bit-reversed (times pre[row, c] when given),
    all log2(n1) radix-2 DIT stages with tw[k] = w^k, k < n1/2,
    output canonical (times tmat[row, c] when given),

where `pre` and `tmat` are (n1, C) tables shared by every batch.  Columns
of up to ``MAX_N1`` rows run kernel B, one launch with every stage in
registers and shared memory (csrc/ntt_sched.cuh has its schedule); longer
ones (transforms of more than 2^28 points) run the multi-pass kernel, one
launch per pass of up to ``PASS_MAX_LOG`` stages over device memory
(csrc/ntt_pass.cuh has its schedule): two passes up to 2^16 rows.
"""

from __future__ import annotations

import functools

import torch

from ..fields import device as fd
from . import build

KERNEL = build.register(
    "ntt", "ntt.cu",
    replaces="ministark_tpu/ops/ntt_pallas.py:137 _col_ntt_kernel_unrolled",
    prototypes={"ms_col_ntt": (build.PTR,) * 5 + (build.I64,) * 4})
KERNEL_STAGE = build.register(
    "ntt_stage", "ntt.cu",
    replaces="ministark_tpu/ops/ntt_pallas.py:94 _col_ntt_kernel",
    prototypes={"ms_col_ntt_pass": (build.PTR,) * 5 + (build.I64,) * 5})

# Longest column kernel B takes (NTT_MAX_LOG in csrc/ntt_sched.cuh).
MAX_N1 = 1 << 14
# Stages a pass of the multi-pass kernel at most (NTT_PASS_MAX_LOG in
# csrc/ntt_pass.cuh).
PASS_MAX_LOG = 8


def num_passes(log_n1: int) -> int:
    """Launches of the multi-pass kernel for a column of 2^log_n1 rows."""
    return max(1, -(-log_n1 // PASS_MAX_LOG))


@functools.lru_cache(maxsize=32)
def _bitrev_index(n: int, device: str) -> torch.Tensor:
    log_n = n.bit_length() - 1
    idx = torch.arange(n, dtype=torch.int64, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def bitrev_index(n: int, device) -> torch.Tensor:
    """i -> bitrev(i) over log2(n) bits, built and cached on `device`."""
    return _bitrev_index(n, str(torch.device(device)))


def col_ntt_plain(x, tw, pre=None, tmat=None):
    B, n1, C = x.shape
    if pre is not None:
        x = fd.mul(x, pre)
    x = x[:, bitrev_index(n1, x.device)]
    log_n1 = n1.bit_length() - 1
    for s in range(1, log_n1 + 1):
        m = 1 << s
        half = m >> 1
        w = tw[::n1 // m][:half].reshape(1, 1, half, 1)
        v = x.reshape(B, n1 // m, 2, half, C)
        u, t = v[:, :, 0], fd.mul(v[:, :, 1], w)
        x = torch.stack([fd.add(u, t), fd.sub(u, t)], dim=2).reshape(B, n1, C)
    if tmat is not None:
        x = fd.mul(x, tmat)
    return x


def _check(x, tw, pre, tmat):
    """Validate a CUDA launch's arguments; returns (x, tw) ready for it."""
    B, n1, C = x.shape
    if n1 & (n1 - 1):
        raise ValueError(f"column length {n1} is not a power of two")
    x = x.contiguous()
    build.check_cuda(x, name="x")
    tw = tw.contiguous() if tw.numel() else torch.ones(1, dtype=torch.int64,
                                                      device=x.device)
    for name, t in (("tw", tw), ("pre", pre), ("tmat", tmat)):
        if t is not None:
            build.check_cuda(t, name=name)
    for name, t in (("pre", pre), ("tmat", tmat)):
        if t is not None and tuple(t.shape) != (n1, C):
            raise ValueError(f"{name} must be ({n1}, {C}), got {tuple(t.shape)}")
    return x, tw


def col_ntt(x, tw, pre=None, tmat=None):
    """See the module docstring.  CUDA tensors launch a kernel; CPU
    tensors take the plain version."""
    if not x.is_cuda:
        return col_ntt_plain(x, tw, pre, tmat)
    B, n1, C = x.shape
    if n1 > MAX_N1:
        return col_ntt_staged(x, tw, pre, tmat)
    x, tw = _check(x, tw, pre, tmat)
    y = torch.empty_like(x)
    KERNEL.launch("ms_col_ntt", x.data_ptr(), y.data_ptr(), tw.data_ptr(),
                  None if pre is None else pre.data_ptr(),
                  None if tmat is None else tmat.data_ptr(), B, n1, C,
                  n1.bit_length() - 1)
    return y


def col_ntt_staged(x, tw, pre=None, tmat=None):
    """The same function on a CUDA tensor by the multi-pass kernel: the
    first pass gathers the rows bit-reversed (times `pre`) into a new
    tensor and runs the first stages, each later pass runs the next ones
    in place on it, the last folds `tmat`.  ``col_ntt`` takes it for
    columns longer than ``MAX_N1``."""
    x, tw = _check(x, tw, pre, tmat)
    B, n1, C = x.shape
    log_n1 = n1.bit_length() - 1
    y = torch.empty_like(x)
    for p in range(num_passes(log_n1)):
        KERNEL_STAGE.launch("ms_col_ntt_pass", x.data_ptr(), y.data_ptr(),
                            tw.data_ptr(),
                            None if pre is None else pre.data_ptr(),
                            None if tmat is None else tmat.data_ptr(), B,
                            n1, C, log_n1, p)
    return y
