"""Host-side (scalar, exact) field arithmetic over the Goldilocks field and its
cubic extension.

These classes are plain-Python-int backed and bit-exact at the *value* level with
the arkworks fields used by the reference (reference: gpu/src/fields.rs:33-97,
gpu/src/metal/felt_u64.h.metal). They are used for everything off-device:
Fiat-Shamir transcript draws, the verifier, FRI per-coset checks, and test
oracles. Device (vectorized) arithmetic lives in `fields.device`.

Montgomery forms never appear here: serialization and hashing in the reference
use canonical little-endian bytes (src/hash.rs:92-100), so value-level math is
all that matters for proof bytes.
"""

from __future__ import annotations

# Goldilocks prime p = 2^64 - 2^32 + 1
P = 0xFFFFFFFF00000001
# Multiplicative generator of Fp* (arkworks GENERATOR for this field).
GENERATOR = 7
TWO_ADICITY = 32
# 2^32-th root of unity: GENERATOR^((p-1) / 2^32)
TWO_ADIC_ROOT_OF_UNITY = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)

# Montgomery R = 2^64 mod p. arkworks' `F::rand` samples the Montgomery-form
# limbs uniformly below p (ark-ff fp Distribution impl); the canonical value of
# a draw is therefore `u * R^{-1} mod p`.
R_MONT = (1 << 64) % P
R_MONT_INV = pow(R_MONT, P - 2, P)

# Fq3 = Fp[u] / (u^3 - NONRESIDUE), NONRESIDUE = 2 (gpu/src/fields.rs:78-95).
FQ3_NONRESIDUE = 2


class Fp:
    """Goldilocks field element (canonical value in [0, p))."""

    __slots__ = ("v",)
    EXTENSION_DEGREE = 1
    NUM_BYTES = 8

    def __init__(self, v: int):
        self.v = v % P

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Fq3):
            return o + self
        return Fp(self.v + _val(o))

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Fq3):
            return Fq3.from_base(self) - o
        return Fp(self.v - _val(o))

    def __rsub__(self, o):
        if isinstance(o, Fq3):
            return o - Fq3.from_base(self)
        return Fp(_val(o) - self.v)

    def __mul__(self, o):
        if isinstance(o, Fq3):
            return o * self
        return Fp(self.v * _val(o))

    __rmul__ = __mul__

    def __neg__(self):
        return Fp(-self.v)

    def __truediv__(self, o):
        if isinstance(o, Fq3):
            return Fq3.from_base(self) / o
        return self * Fp(_val(o)).inverse()

    def __rtruediv__(self, o):
        return Fp(_val(o)) * self.inverse()

    def __pow__(self, e: int):
        return Fp(pow(self.v, e, P))

    def pow(self, e: int):
        return self.__pow__(e)

    def inverse(self):
        if self.v == 0:
            raise ZeroDivisionError("inverse of zero")
        return Fp(pow(self.v, P - 2, P))

    # -- comparisons --------------------------------------------------------
    def __eq__(self, o):
        if isinstance(o, Fp):
            return self.v == o.v
        if isinstance(o, int):
            return self.v == o % P
        if isinstance(o, Fq3):
            return Fq3.from_base(self) == o
        return NotImplemented

    def __hash__(self):
        return hash(("Fp", self.v))

    def __repr__(self):
        return f"Fp({self.v})"

    def is_zero(self):
        return self.v == 0

    # -- serialization (ark CanonicalSerialize compatible) ------------------
    def to_bytes(self) -> bytes:
        return self.v.to_bytes(8, "little")

    @staticmethod
    def from_bytes(b: bytes) -> "Fp":
        assert len(b) == 8
        return Fp(int.from_bytes(b, "little"))

    @staticmethod
    def zero() -> "Fp":
        return Fp(0)

    @staticmethod
    def one() -> "Fp":
        return Fp(1)


class Fq3:
    """Cubic extension Fp[u]/(u^3 - 2), coefficients (c0, c1, c2).

    Mirrors the reference's `Fq3` built with ark `Fp3Config` with NONRESIDUE=2
    (gpu/src/fields.rs:78-95); serialization order is c0, c1, c2 each 8 bytes
    little-endian.
    """

    __slots__ = ("c0", "c1", "c2")
    EXTENSION_DEGREE = 3
    NUM_BYTES = 24

    def __init__(self, c0, c1=0, c2=0):
        self.c0 = c0 if isinstance(c0, Fp) else Fp(c0)
        self.c1 = c1 if isinstance(c1, Fp) else Fp(c1)
        self.c2 = c2 if isinstance(c2, Fp) else Fp(c2)

    @staticmethod
    def from_base(v) -> "Fq3":
        if isinstance(v, Fq3):
            return v
        return Fq3(v if isinstance(v, Fp) else Fp(v))

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        o = Fq3.from_base(o)
        return Fq3(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    __radd__ = __add__

    def __sub__(self, o):
        o = Fq3.from_base(o)
        return Fq3(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __rsub__(self, o):
        return Fq3.from_base(o) - self

    def __mul__(self, o):
        if isinstance(o, (Fp, int)):
            f = o if isinstance(o, Fp) else Fp(o)
            return Fq3(self.c0 * f, self.c1 * f, self.c2 * f)
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        m = FQ3_NONRESIDUE
        return Fq3(
            a0 * b0 + m * (a1 * b2 + a2 * b1),
            a0 * b1 + a1 * b0 + m * (a2 * b2),
            a0 * b2 + a1 * b1 + a2 * b0,
        )

    __rmul__ = __mul__

    def __neg__(self):
        return Fq3(-self.c0, -self.c1, -self.c2)

    def __truediv__(self, o):
        if isinstance(o, (Fp, int)):
            o = Fq3.from_base(o)
        return self * o.inverse()

    def __rtruediv__(self, o):
        return Fq3.from_base(o) * self.inverse()

    def __pow__(self, e: int):
        result = Fq3.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def pow(self, e: int):
        return self.__pow__(e)

    def inverse(self):
        # Standard cubic-extension inverse for u^3 = m.
        a, b, c = self.c0, self.c1, self.c2
        m = FQ3_NONRESIDUE
        v0 = a * a - m * (b * c)
        v1 = m * (c * c) - a * b
        v2 = b * b - a * c
        norm = a * v0 + m * (c * v1) + m * (b * v2)
        ninv = norm.inverse()
        return Fq3(v0 * ninv, v1 * ninv, v2 * ninv)

    # -- comparisons --------------------------------------------------------
    def __eq__(self, o):
        if isinstance(o, (Fp, int)):
            o = Fq3.from_base(o)
        if isinstance(o, Fq3):
            return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2
        return NotImplemented

    def __hash__(self):
        return hash(("Fq3", self.c0.v, self.c1.v, self.c2.v))

    def __repr__(self):
        return f"Fq3({self.c0.v}, {self.c1.v}, {self.c2.v})"

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    # -- serialization ------------------------------------------------------
    def to_bytes(self) -> bytes:
        return self.c0.to_bytes() + self.c1.to_bytes() + self.c2.to_bytes()

    @staticmethod
    def from_bytes(b: bytes) -> "Fq3":
        assert len(b) == 24
        return Fq3(Fp.from_bytes(b[0:8]), Fp.from_bytes(b[8:16]), Fp.from_bytes(b[16:24]))

    @staticmethod
    def zero() -> "Fq3":
        return Fq3(0)

    @staticmethod
    def one() -> "Fq3":
        return Fq3(1)


def _val(o) -> int:
    if isinstance(o, Fp):
        return o.v
    if isinstance(o, int):
        return o
    raise TypeError(f"cannot coerce {type(o)} to Fp")


def get_root_of_unity(n: int) -> Fp:
    """n-th root of unity following ark `FftField::get_root_of_unity`
    (used by Radix2EvaluationDomain::new): TWO_ADIC_ROOT^(2^(TWO_ADICITY-log2 n))."""
    assert n & (n - 1) == 0 and n > 0
    log_n = n.bit_length() - 1
    assert log_n <= TWO_ADICITY
    return Fp(pow(TWO_ADIC_ROOT_OF_UNITY, 1 << (TWO_ADICITY - log_n), P))
