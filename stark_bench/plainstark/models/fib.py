"""Fibonacci-chain AIR over Goldilocks (reference: examples/fib/main.rs).

8 columns; each row holds 8 successive products of the chain
v_{k} = v_{k-2} * v_{k-1} starting 1, 2.  Constraint classes exercised:
boundary (divide by (x - x_0)), transition (multiply by
(x - x_last)/(x^n - 1)), terminal (divide by (x - x_last)).
"""

from __future__ import annotations

import torch

from .. import serde
from ..air import Hints
from ..constraints import Constraint, constant, curr, hint, next, x
from ..fields import device as fd
from ..fields.scalar import Fp, P
from ..matrix import Matrix
from ..ntt import Domain
from ..stark import Stark, Trace

NUM_COLS = 8
CLAIMED_NTH_FIB_NUM = 0  # hint index


class FibTrace(Trace):
    def __init__(self, matrix: Matrix):
        self.matrix = matrix

    def base_columns(self) -> Matrix:
        return self.matrix

    def last_value(self) -> Fp:
        return Fp(int(self.matrix.values[7, -1]) % (1 << 64))


class FibAirConfig:
    NUM_BASE_COLUMNS = NUM_COLS
    NUM_EXTENSION_COLUMNS = 0
    fp_type = Fp
    fq_type = Fp

    @staticmethod
    def gen_hints(trace_len, claimed_nth_fib_number: Fp, challenges) -> Hints:
        return Hints.new([(CLAIMED_NTH_FIB_NUM, claimed_nth_fib_number)])

    @staticmethod
    def constraints(trace_len: int) -> list[Constraint]:
        dom = Domain(trace_len)
        first_x = constant(dom.element(0))       # == 1
        last_x = constant(dom.element(trace_len - 1))  # == g^{-1}
        one = constant(Fp(1))

        # first-row values: v0=1, v1=2, v_k = v_{k-2} * v_{k-1}
        v = [Fp(1), Fp(2)]
        for k in range(2, NUM_COLS):
            v.append(v[k - 2] * v[k - 1])

        boundary = [
            (curr(i) - constant(v[i])) / (x() - first_x) for i in range(NUM_COLS)
        ]

        transition_core = [
            next(0) - curr(6) * curr(7),
            next(1) - curr(7) * next(0),
            next(2) - next(0) * next(1),
            next(3) - next(1) * next(2),
            next(4) - next(2) * next(3),
            next(5) - next(3) * next(4),
            next(6) - next(4) * next(5),
            next(7) - next(5) * next(6),
        ]
        transition = [
            c * ((x() - last_x) / (x().pow(trace_len) - one)) for c in transition_core
        ]

        terminal = [(curr(7) - hint(CLAIMED_NTH_FIB_NUM)) / (x() - last_x)]

        return [Constraint(c) for c in boundary + terminal + transition]


def chain_exponents() -> tuple[int, list[int]]:
    """The chain v_k = v_{k-2} * v_{k-1} from 1, 2 is v_k = 2^F_k with F
    the Fibonacci numbers from F_0 = 0, F_1 = 1.  2 has order 192 mod p
    (2^96 = -1), so v_k = 2^(F_k mod 192), and F_k mod 192 repeats with
    its Pisano period.  Returns (the period, F_k mod 192 over one)."""
    assert pow(2, 96, P) == P - 1
    f = [0, 1]
    while f[-2:] != [0, 1] or len(f) == 2:
        f.append((f[-2] + f[-1]) % 192)
    return len(f) - 2, f[:-2]


def gen_trace(n: int, device) -> FibTrace:
    """n total values (n/8 rows) of the chain, worked out value by value
    from the closed form on `device`."""
    assert n & (n - 1) == 0 and n > 8
    period, f = chain_exponents()
    pow2 = torch.tensor([fd.to_i64(pow(2, e, P)) for e in range(192)],
                        dtype=torch.int64, device=device)
    fk = torch.tensor(f, dtype=torch.int64, device=device)
    k = torch.arange(n, dtype=torch.int64, device=device)
    v = pow2[fk[k % period]]
    return FibTrace(Matrix(v.reshape(n // NUM_COLS, NUM_COLS).T.contiguous()))


class FibClaim(Stark):
    air_config = FibAirConfig
    fp = Fp
    fq = Fp

    def __init__(self, claimed_nth_fib_number: Fp):
        self.claim = claimed_nth_fib_number

    def get_public_inputs(self) -> Fp:
        return self.claim

    def generate_trace(self, witness: FibTrace) -> FibTrace:
        return witness

    def serialize_public_inputs(self, w: serde.Writer):
        w.field(self.claim)
