"""Batched Goldilocks inverse: wrapper for kernel A (csrc/inv.cu) beside
its plain PyTorch version (``fields.device.inv``)."""

from __future__ import annotations

import torch

from ..fields import device as fd
from . import build

KERNEL = build.register(
    "inv", "inv.cu",
    replaces="ministark_tpu/ops/inv_pallas.py:44 _inv_fp_hybrid_kernel")


def inv_fp_plain(a: torch.Tensor) -> torch.Tensor:
    return fd.inv(a)


def inv_fp(a: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse, 0 -> 0.  CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if not a.is_cuda:
        return inv_fp_plain(a)
    a = a.contiguous()
    build.check_cuda(a)
    out = torch.empty_like(a)
    KERNEL.launch("ms_inv_fp", build.ptr(a), build.ptr(out),
                  build.i64(a.numel()))
    return out
