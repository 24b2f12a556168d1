"""The affine scan of the extension columns over Fq3: the wrapper of
csrc/scan.cu (math in csrc/scan.cuh).  Its plain PyTorch version is
``scan.affine_scan_ext3_plain``, which ``scan.affine_scan_ext3`` takes for
CPU tensors."""

from __future__ import annotations

import ctypes

import torch

from . import build

KERNEL = build.register(
    "affine_scan_ext3", "scan.cu",
    replaces="none: ministark_tpu/scan.py:32 affine_scan_ext3 is XLA code "
             "(Hillis-Steele doubling), with no Pallas kernel",
    prototypes={"ms_affine_scan_ext3": (
        build.PTR, build.PTR, build.PTR, ctypes.c_uint64, build.PTR,
        build.I64, build.I64, build.PTR)})

# the kernel's inclusive flags are the bits of one 64-bit argument
MAX_COLUMNS = 64


def inclusive_mask(inclusive, B: int) -> int:
    """The columns' inclusive flags (one bool for all, or B bools) as the
    kernel's bit mask: bit c for column c."""
    flags = [bool(inclusive)] * B if isinstance(inclusive, bool) else [
        bool(f) for f in inclusive]
    if len(flags) != B:
        raise ValueError(f"affine_scan_ext3: {len(flags)} inclusive flags "
                         f"for {B} columns")
    return sum(1 << c for c, f in enumerate(flags) if f)


def affine_scan_ext3(a: torch.Tensor, b: torch.Tensor, init: torch.Tensor,
                     inclusive) -> torch.Tensor:
    """``scan.affine_scan_ext3`` on the card (csrc/scan.cu: three kernels
    a call): a, b (B, 3, n), init (B, 3), all int64 on one CUDA device;
    returns (B, 3, n)."""
    if (a.ndim != 3 or a.shape[1] != 3 or b.shape != a.shape
            or init.shape != (a.shape[0], 3)):
        raise ValueError(f"affine_scan_ext3: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, init {tuple(init.shape)}; "
                         f"needs (B, 3, n), (B, 3, n), (B, 3)")
    B, _, n = a.shape
    if B > MAX_COLUMNS:
        raise ValueError(f"affine_scan_ext3: {B} columns, more than "
                         f"{MAX_COLUMNS}")
    mask = inclusive_mask(inclusive, B)
    a, b, init = a.contiguous(), b.contiguous(), init.contiguous()
    for t, name in ((a, "a"), (b, "b"), (init, "init")):
        build.check_cuda(t, name=name)
    if b.device != a.device or init.device != a.device:
        raise ValueError("affine_scan_ext3: a, b and init on different "
                         "devices")
    out = torch.empty_like(a)
    if B * n == 0:
        return out
    scratch = torch.empty(KERNEL.query("ms_affine_scan_ext3_scratch", B, n),
                          dtype=torch.int64, device=a.device)
    KERNEL.launch("ms_affine_scan_ext3", a.data_ptr(), b.data_ptr(),
                  init.data_ptr(), mask, out.data_ptr(), B, n,
                  scratch.data_ptr())
    return out
