"""Goldilocks field arithmetic on torch tensors (Fp only).

Representation: one element per ``torch.int64`` entry, holding the
canonical value's u64 bit pattern (values >= 2^63 read as negative).  The
CUDA kernels reinterpret the same storage as ``uint64_t``.

Torch has no unsigned 64-bit add, shift or compare on the CPU, so the
arithmetic here is written with wrapping int64 ops, which are right bit for
bit, plus two rules: mask after every right shift (``>>`` is arithmetic),
and compare as unsigned by flipping the sign bit first (``_ult``).

These are the plain versions the CPU path runs; on CUDA tensors the same
functions run as torch ops on the card wherever the JAX package used plain
XLA.  The batch inverse goes through the hand-written kernel
(``ops/inv.py``) on CUDA tensors.
"""

from __future__ import annotations

import torch

from .scalar import P

I64 = torch.int64
_MASK32 = 0xFFFFFFFF
_EPS = 0xFFFFFFFF  # 2^64 mod p
_SIGN = -(1 << 63)
P_I64 = P - (1 << 64)  # p's bit pattern as a signed int64


def to_i64(v: int) -> int:
    """A canonical u64 value as the int64 with the same bit pattern."""
    v %= P
    return v - (1 << 64) if v >= (1 << 63) else v


def _ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _srl32(a: torch.Tensor) -> torch.Tensor:
    """Logical right shift by 32."""
    return (a >> 32) & _MASK32


def canonicalize(a: torch.Tensor) -> torch.Tensor:
    """Reduce a u64 bit pattern into [0, p)."""
    return torch.where(_ult(a, P_I64), a, a - P_I64)


def add(a: torch.Tensor, b) -> torch.Tensor:
    s = a + b
    wrapped = _ult(s, a)
    s = s + wrapped.to(I64) * _EPS
    return canonicalize(s)


def sub(a: torch.Tensor, b) -> torch.Tensor:
    d = a - b
    borrow = _ult(a, b)
    d = d - borrow.to(I64) * _EPS
    return canonicalize(d)


def neg(a: torch.Tensor) -> torch.Tensor:
    return torch.where(a == 0, a, P_I64 - a)


def _mul_wide(a: torch.Tensor, b):
    """Full 128-bit product of u64 patterns -> (hi, lo)."""
    a_lo = a & _MASK32
    a_hi = _srl32(a)
    b_lo = b & _MASK32
    b_hi = _srl32(b)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = _srl32(ll) + (lh & _MASK32) + (hl & _MASK32)
    lo = (ll & _MASK32) | (mid << 32)
    hi = hh + _srl32(lh) + _srl32(hl) + (mid >> 32)
    return hi, lo


def mul(a: torch.Tensor, b) -> torch.Tensor:
    """Goldilocks product: 2^64 = 2^32 - 1 and 2^96 = -1 (mod p)."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(to_i64(b), dtype=I64, device=a.device)
    hi, lo = _mul_wide(a, b)
    hi_hi = _srl32(hi)
    hi_lo = hi & _MASK32
    t = lo - hi_hi
    t = t - _ult(lo, hi_hi).to(I64) * _EPS
    s = t + hi_lo * _EPS
    s = s + _ult(s, t).to(I64) * _EPS
    return canonicalize(s)


def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    assert e >= 0
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return torch.ones_like(a) if result is None else result


def inv(a: torch.Tensor) -> torch.Tensor:
    """Elementwise Fermat inverse a^(p-2); 0 maps to 0."""
    return pow_const(a, P - 2)


def batch_inv(a: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse through the hand-written kernel on CUDA tensors
    (its plain version, ``inv``, on CPU tensors)."""
    from ..ops.inv import inv_fp

    return inv_fp(a)


def full(shape, value: int, device) -> torch.Tensor:
    return torch.full(shape, to_i64(value), dtype=I64, device=device)


def powers(base: int, n: int, device) -> torch.Tensor:
    """[1, base, ..., base^(n-1)] by log-doubling: each step multiplies the
    table so far by base^k (log2(n) vector multiplies)."""
    out = torch.ones(1, dtype=I64, device=device)
    base %= P
    step = base
    while out.numel() < n:
        take = min(out.numel(), n - out.numel())
        out = torch.cat([out, mul(out[:take], step)])
        step = step * step % P
    return out[:n]


def sum_mod(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Field sum along `dim` by pairwise halving (log-depth, exact mod p)."""
    a = a.movedim(dim, -1)
    while a.shape[-1] > 1:
        n = a.shape[-1]
        half = n // 2
        s = add(a[..., :half], a[..., half:2 * half])
        a = torch.cat([s, a[..., 2 * half:]], dim=-1) if n % 2 else s
    return a[..., 0]


def to_ints(a: torch.Tensor) -> list[int]:
    """Flat list of canonical Python ints."""
    return [v & 0xFFFFFFFFFFFFFFFF for v in a.reshape(-1).tolist()]
