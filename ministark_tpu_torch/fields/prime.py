"""Generic host-scalar prime fields.

The reference ships a generic Montgomery field template instantiated per
prime (gpu/src/metal/felt_u128.h.metal:105-192, felt_u256.h.metal); here a
class factory plays that role.  Values are canonical integers — proofs never
expose Montgomery form, so matching the reference at the value level needs no
Montgomery representation on the host.
"""

from __future__ import annotations


def make_prime_field(name: str, modulus: int, generator: int,
                     num_bytes: int):
    """Build a host scalar field class for ``modulus`` with the same surface
    as fields.scalar.Fp (add/sub/mul/div/pow/inverse/serde helpers)."""

    P = modulus

    class PrimeField:
        __slots__ = ("v",)
        EXTENSION_DEGREE = 1
        NUM_BYTES = num_bytes
        MODULUS = P
        GENERATOR = generator

        def __init__(self, v: int):
            self.v = v % P

        def __add__(self, o):
            return PrimeField(self.v + _val(o))

        __radd__ = __add__

        def __sub__(self, o):
            return PrimeField(self.v - _val(o))

        def __rsub__(self, o):
            return PrimeField(_val(o) - self.v)

        def __mul__(self, o):
            return PrimeField(self.v * _val(o))

        __rmul__ = __mul__

        def __neg__(self):
            return PrimeField(-self.v)

        def __truediv__(self, o):
            return self * PrimeField(_val(o)).inverse()

        def __pow__(self, e: int):
            return PrimeField(pow(self.v, e, P))

        def pow(self, e: int):
            return self.__pow__(e)

        def inverse(self):
            if self.v == 0:
                raise ZeroDivisionError
            return PrimeField(pow(self.v, P - 2, P))

        def __eq__(self, o):
            if isinstance(o, PrimeField):
                return self.v == o.v
            if isinstance(o, int):
                return self.v == o % P
            return NotImplemented

        def __hash__(self):
            return hash((name, self.v))

        def __repr__(self):
            return f"{name}({self.v})"

        def is_zero(self):
            return self.v == 0

        def to_bytes(self) -> bytes:
            return self.v.to_bytes(num_bytes, "little")

        @staticmethod
        def from_bytes(b: bytes) -> "PrimeField":
            return PrimeField(int.from_bytes(b, "little"))

        @staticmethod
        def zero():
            return PrimeField(0)

        @staticmethod
        def one():
            return PrimeField(1)

    def _val(o) -> int:
        if isinstance(o, PrimeField):
            return o.v
        if isinstance(o, int):
            return o
        raise TypeError(type(o))

    PrimeField.__name__ = PrimeField.__qualname__ = name
    return PrimeField
