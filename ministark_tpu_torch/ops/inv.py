"""Batched Goldilocks inverses: wrappers for kernel A (csrc/inv.cu), in Fp
and in Fq3, each beside its plain PyTorch version (``fields.device.inv``
and ``fields.device.ext3_inv``)."""

from __future__ import annotations

import torch

from ..fields import device as fd
from . import build

KERNEL = build.register(
    "inv", "inv.cu",
    replaces="ministark_tpu/ops/inv_pallas.py:44 _inv_fp_hybrid_kernel")
KERNEL_EXT3 = build.register(
    "inv_ext3", "inv.cu",
    replaces="ministark_tpu/ops/inv_pallas.py:72 _inv_ext3_kernel")


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


def inv_ext3_plain(a: torch.Tensor) -> torch.Tensor:
    return fd.ext3_inv(a)


def inv_ext3(a: torch.Tensor) -> torch.Tensor:
    """Elementwise Fq3 inverse of a (..., 3, n) tensor, 0 -> 0.  CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    if not a.is_cuda:
        return inv_ext3_plain(a)
    if a.ndim < 2 or a.shape[-2] != 3:
        raise ValueError(f"inv_ext3 needs a (..., 3, n) tensor, got "
                         f"{tuple(a.shape)}")
    a = a.contiguous()
    build.check_cuda(a)
    out = torch.empty_like(a)
    n = a.shape[-1]
    KERNEL_EXT3.launch("ms_inv_ext3", build.ptr(a), build.ptr(out),
                       build.i64(a.numel() // (3 * n) if n else 0),
                       build.i64(n))
    return out
