"""Batched transpose (B, R, C) -> (B, C, R): wrapper for kernel C
(csrc/transpose.cu) beside its plain PyTorch version."""

from __future__ import annotations

import torch

from . import build

KERNEL = build.register(
    "transpose", "transpose.cu",
    replaces="ministark_tpu/ops/transpose_pallas.py:25 _tr2_kernel",
    prototypes={"ms_transpose": (build.PTR, build.PTR, build.I64, build.I64,
                                 build.I64)})


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2).contiguous()


def transpose(x: torch.Tensor) -> torch.Tensor:
    """(B, R, C) int64 -> (B, C, R).  CUDA tensors launch the kernel; CPU
    tensors take the plain version.  The six-step runs it on transforms of
    2^15 points too, where the launch costs more than the move, so this
    path does no more than its checks need."""
    if not x.is_cuda:
        return transpose_plain(x)
    if x.dtype != torch.int64:
        raise TypeError(f"input must be torch.int64, got {x.dtype}")
    x = x.contiguous()
    B, R, C = x.shape
    y = x.new_empty((B, C, R))
    KERNEL.launch("ms_transpose", x.data_ptr(), y.data_ptr(), B, R, C)
    return y
