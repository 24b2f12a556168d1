"""Batched transpose (B, R, C) -> (B, C, R): wrapper for kernel C
(csrc/transpose.cu) beside its plain PyTorch version."""

from __future__ import annotations

import torch

from . import build

KERNEL = build.register(
    "transpose", "transpose.cu",
    replaces="ministark_tpu/ops/transpose_pallas.py:25 _tr2_kernel")


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2).contiguous()


def transpose(x: torch.Tensor) -> torch.Tensor:
    """(B, R, C) int64 -> (B, C, R).  CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if not x.is_cuda:
        return transpose_plain(x)
    x = x.contiguous()
    build.check_cuda(x)
    B, R, C = x.shape
    if B > 65535 or (R + 31) // 32 > 65535:
        raise ValueError(f"transpose grid too large for shape {tuple(x.shape)}")
    y = torch.empty((B, C, R), dtype=x.dtype, device=x.device)
    KERNEL.launch("ms_transpose", build.ptr(x), build.ptr(y), build.i64(B),
                  build.i64(R), build.i64(C))
    return y
