"""Batched column NTT in plain PyTorch.

x is (B, n1, C) int64; every column (b, :, c) is transformed along n1 with

    load rows bit-reversed (times pre[row, c] when given),
    all log2(n1) radix-2 DIT stages with tw[k] = w^k, k < n1/2,
    output canonical (times tmat[row, c] when given).
"""

from __future__ import annotations

import functools

import torch

from ..fields import device as fd


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


def col_ntt(x, tw, pre=None, tmat=None):
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
