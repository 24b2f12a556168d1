"""Goldilocks field arithmetic on torch tensors: Fp and its cubic
extension Fq3 = Fp[u]/(u^3 - 2).

Representation: one element per ``torch.int64`` entry, holding the
canonical value's u64 bit pattern (values >= 2^63 read as negative).  An Fq3 tensor
carries its three components on the second-to-last axis: shape
``(..., 3, n)``, so a matrix of C extension columns is ``(C, 3, n)`` and
each component plane is contiguous.  Sums and differences of Fq3 tensors
are the Fp ones, component by component.

Torch has no unsigned 64-bit add, shift or compare on the CPU, so the
arithmetic here is written with wrapping int64 ops, which are right bit for
bit, plus two rules: mask after every right shift (``>>`` is arithmetic),
and compare as unsigned by flipping the sign bit first (``_ult``).

Every function here is plain PyTorch, on whatever device its tensors
lie.
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
    return canonicalize(mul_lazy(a, b))


def mul_lazy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b as some u64 representative mod p, not reduced into [0, p):
    for chains of products (any u64 pattern is a valid input)."""
    return _reduce128_lazy(*_mul_wide(a, b))


def _reduce128_lazy(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """hi * 2^64 + lo (u64 patterns) as a u64 representative mod p."""
    hi_hi = _srl32(hi)
    t = lo - hi_hi
    t = torch.where(_ult(lo, hi_hi), t - _EPS, t)  # borrow: -2^64 = -EPS
    s = t + (hi & _MASK32) * _EPS
    return torch.where(_ult(s, t), s + _EPS, s)    # carry: 2^64 = EPS


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
    """Elementwise inverse (``inv``)."""
    return inv(a)


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


# -- cubic extension Fq3 = Fp[u]/(u^3 - 2), components on axis -2 ----------


def _dbl(a: torch.Tensor) -> torch.Tensor:
    return add(a, a)


def ext3(c0, c1, c2) -> torch.Tensor:
    return torch.stack([c0, c1, c2], dim=-2)


def ext3_from_base(a: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(a)
    return ext3(a, z, z)


def ext3_table(values, device) -> torch.Tensor:
    """Host Fq3 (or Fp) scalars as one flat tensor [c0, c1, c2, c0, ...],
    in one copy to `device`."""
    from .scalar import Fq3

    flat = []
    for v in values:
        q = Fq3.from_base(v)
        flat += [to_i64(q.c0.v), to_i64(q.c1.v), to_i64(q.c2.v)]
    return torch.tensor(flat, dtype=I64, device=device)


def ext3_scalar(v, device) -> torch.Tensor:
    """An Fq3 (or Fp) host scalar as a (3, 1) tensor that broadcasts
    against (..., 3, n)."""
    return ext3_table([v], device).reshape(3, 1)


def ext3_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Karatsuba: 6 base products (fields/npfield.py's schoolbook gives the
    same value)."""
    a0, a1, a2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    v0, v1, v2 = mul(a0, b0), mul(a1, b1), mul(a2, b2)
    t0 = sub(sub(mul(add(a1, a2), add(b1, b2)), v1), v2)
    t1 = sub(sub(mul(add(a0, a1), add(b0, b1)), v0), v1)
    t2 = sub(sub(mul(add(a0, a2), add(b0, b2)), v0), v2)
    return ext3(add(v0, _dbl(t0)), add(t1, _dbl(v2)), add(t2, v1))


def ext3_mul_base(a: torch.Tensor, b) -> torch.Tensor:
    """Fq3 times Fp: b (..., n) or a Python int scales every component."""
    return mul(a, b.unsqueeze(-2) if isinstance(b, torch.Tensor) else b)


def ext3_pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    assert e >= 0
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else ext3_mul(result, base)
        e >>= 1
        if e:
            base = ext3_mul(base, base)
    if result is None:
        one = torch.zeros_like(a)
        one[..., 0, :] = 1
        return one
    return result


def ext3_inv(a: torch.Tensor) -> torch.Tensor:
    """Norm-map inverse: with v the product of a's two conjugates,
    a^-1 = v / N(a) and N(a) = a * v lies in Fp; 0 maps to 0."""
    c0, c1, c2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    v0 = sub(mul(c0, c0), _dbl(mul(c1, c2)))
    v1 = sub(_dbl(mul(c2, c2)), mul(c0, c1))
    v2 = sub(mul(c1, c1), mul(c0, c2))
    norm = add(mul(c0, v0), _dbl(add(mul(c2, v1), mul(c1, v2))))
    return ext3_mul_base(ext3(v0, v1, v2), inv(norm))


def ext3_batch_inv(a: torch.Tensor) -> torch.Tensor:
    """Elementwise Fq3 inverse (``ext3_inv``)."""
    return ext3_inv(a)


def ext3_to_scalars(a: torch.Tensor) -> list:
    """A (3, n) tensor -> n host Fq3 scalars."""
    from .scalar import Fq3

    c = a.reshape(3, -1).cpu().tolist()
    m = 0xFFFFFFFFFFFFFFFF
    return [Fq3(x & m, y & m, z & m) for x, y, z in zip(*c)]
