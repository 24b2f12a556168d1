"""Fused DEEP composition: wrapper for kernel F (csrc/deep.cu) beside its
plain PyTorch version."""

from __future__ import annotations

import torch

from ..fields import device as fd
from . import build

KERNEL = build.register(
    "deep", "deep.cu",
    replaces="ministark_tpu/ops/deep_pallas.py:103 _group_kernel_base")


def deep_plain(cols, invs, s, x):
    T = len(cols)
    sv = s.tolist()
    acc = torch.zeros_like(x)
    for t in range(T):
        d = fd.sub(torch.full_like(x, sv[2 * t]), cols[t])
        acc = fd.add(acc, fd.mul(fd.mul(d, invs[t]), s[2 * t + 1]))
    return fd.mul(acc, fd.add(fd.mul(x, s[2 * T + 1]), s[2 * T]))


def deep(cols: list, invs: list, s: torch.Tensor, x: torch.Tensor):
    """sum_t alpha_t * (ood_t - cols[t]) * invs[t], times (A + B * x).
    cols/invs: T (n,) int64 vectors; s: [ood_0, alpha_0, ..., A, B].
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if not x.is_cuda:
        return deep_plain(cols, invs, s, x)
    T, n = len(cols), x.shape[0]
    if len(invs) != T or s.shape != (2 * T + 2,):
        raise ValueError("deep: need one inverse row and two scalars per term")
    for name, t in [("x", x), ("s", s)] + [("col", c) for c in cols] + [
            ("inv", v) for v in invs]:
        build.check_cuda(t, name=name)
        if name in ("col", "inv") and t.shape != (n,):
            raise ValueError(f"deep: {name} of shape {tuple(t.shape)} != ({n},)")
    ptrs = torch.tensor([c.data_ptr() for c in cols] +
                        [v.data_ptr() for v in invs],
                        dtype=torch.int64).to(x.device)
    out = torch.empty_like(x)
    KERNEL.launch("ms_deep", build.ptr(ptrs), build.ptr(ptrs[T:]),
                  build.ptr(s), build.ptr(x), build.ptr(out), build.i64(n),
                  build.i64(T))
    return out
