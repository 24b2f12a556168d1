"""Fused DEEP composition: wrappers for kernel F (csrc/deep.cu), in Fp and
in Fq3, each beside its plain PyTorch version."""

from __future__ import annotations

import torch

from ..fields import device as fd
from . import build

KERNEL = build.register(
    "deep", "deep.cu",
    replaces="ministark_tpu/ops/deep_pallas.py:103 _group_kernel_base")
KERNEL_EXT3 = build.register(
    "deep_ext3", "deep.cu",
    replaces="ministark_tpu/ops/deep_pallas.py:64 _group_kernel_ext")


def deep_plain(cols, invs, s, x):
    T = len(cols)
    sv = s.tolist()
    acc = torch.zeros_like(x)
    for t in range(T):
        d = fd.sub(torch.full_like(x, sv[2 * t]), cols[t])
        acc = fd.add(acc, fd.mul(fd.mul(d, invs[t]), s[2 * t + 1]))
    return fd.mul(acc, fd.add(fd.mul(x, s[2 * T + 1]), s[2 * T]))


def _check_terms(cols, invs, x, ext: bool):
    n = x.shape[0]
    build.check_cuda(x, name="x")
    col_ok = ((n,), (3, n)) if ext else ((n,),)
    inv_ok = ((3, n),) if ext else ((n,),)
    for name, ts, ok in (("col", cols, col_ok), ("inv", invs, inv_ok)):
        for t in ts:
            build.check_cuda(t, name=name)
            if tuple(t.shape) not in ok:
                raise ValueError(f"deep: {name} of shape {tuple(t.shape)} "
                                 f"is not one of {ok}")


def _pointer_table(tensors, device):
    return torch.tensor([t.data_ptr() for t in tensors],
                        dtype=torch.int64).to(device)


def deep(cols: list, invs: list, s: torch.Tensor, x: torch.Tensor):
    """sum_t alpha_t * (ood_t - cols[t]) * invs[t], times (A + B * x).
    cols/invs: T (n,) int64 vectors; s: [ood_0, alpha_0, ..., A, B].
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if not x.is_cuda:
        return deep_plain(cols, invs, s, x)
    T, n = len(cols), x.shape[0]
    if len(invs) != T or s.shape != (2 * T + 2,):
        raise ValueError("deep: need one inverse row and two scalars per term")
    build.check_cuda(s, name="s")
    _check_terms(cols, invs, x, False)
    ptrs = _pointer_table(list(cols) + list(invs), x.device)
    out = torch.empty_like(x)
    KERNEL.launch("ms_deep", build.ptr(ptrs), build.ptr(ptrs[T:]),
                  build.ptr(s), build.ptr(x), build.ptr(out), build.i64(n),
                  build.i64(T))
    return out


def deep_ext3_plain(cols, invs, s, x):
    T = len(cols)
    sc = s.reshape(-1, 3, 1)  # one (3, 1) Fq3 scalar per slot triple
    acc = torch.zeros((3, x.shape[0]), dtype=torch.int64, device=x.device)
    for t in range(T):
        ood, alpha = sc[2 * t], sc[2 * t + 1]
        c = cols[t] if cols[t].ndim == 2 else fd.ext3_from_base(cols[t])
        q = fd.ext3_mul(fd.sub(ood, c), invs[t])
        acc = fd.add(acc, fd.ext3_mul(q, alpha))
    adj = fd.add(sc[2 * T], fd.ext3_mul_base(sc[2 * T + 1], x))
    return fd.ext3_mul(acc, adj)


def deep_ext3(cols: list, invs: list, s: torch.Tensor, x: torch.Tensor):
    """The DEEP sum over an Fq3 transcript, times (A + B * x), as a (3, n)
    tensor.  cols: T columns, each (n,) in Fp or (3, n) in Fq3; invs: T
    (3, n) inverse rows; s: 3 slots per Fq3 scalar, [ood_0, alpha_0, ...,
    A, B]; x: (n,).  CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    if not x.is_cuda:
        return deep_ext3_plain(cols, invs, s, x)
    T, n = len(cols), x.shape[0]
    if len(invs) != T or s.shape != (6 * T + 6,):
        raise ValueError("deep_ext3: need one inverse row and two Fq3 "
                         "scalars per term")
    build.check_cuda(s, name="s")
    _check_terms(cols, invs, x, True)
    ptrs = _pointer_table(list(cols) + list(invs), x.device)
    kinds = torch.tensor([int(c.ndim == 2) for c in cols],
                         dtype=torch.int64).to(x.device)
    out = torch.empty((3, n), dtype=torch.int64, device=x.device)
    KERNEL_EXT3.launch("ms_deep_ext3", build.ptr(ptrs), build.ptr(kinds),
                       build.ptr(ptrs[T:]), build.ptr(s), build.ptr(x),
                       build.ptr(out), build.i64(n), build.i64(T))
    return out
