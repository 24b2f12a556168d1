"""Rescue-Prime hash-chain AIR over Goldilocks (mirrors
``ministark_tpu.models.rescue.air``).

The reference promises a Rescue example but leaves the AIR as `todo!()`
(examples/rescue/main.rs:46); this completes it.  Statement:

    given seed (s0, s1), digest (d0, d1) and chain length K:
    h_0 = (s0, s1);  h_{k+1} = Rescue2to1(h_k);  h_K = (d0, d1)

One Rescue-XLIX round per row (m=4, capacity 2, alpha=7, N=14 rounds),
R=16 rows per chain link; the middle-state trick keeps constraints at
degree alpha on both sides:

    MDS(s^a) + C0  ==  (MDS^-1(s_next - C1))^a        (active rows)

Rows 14: state copy; row 15 -> 16: rate continuity + capacity reset.  Round
constants, their MDS^-1-transformed twins, and the three row-class selector
masks are Periodic columns (interval 16) — this is the model that exercises
the DSL's periodic-column feature.

The chain runs on the host in plain Python integers, a link after another,
and the trace goes to the device once."""

from __future__ import annotations

import numpy as np

from ... import serde
from ...air import Hints
from ...constraints import Constraint, constant, curr, hint, next, periodic, x
from ...fields.scalar import Fp, GENERATOR, P
from ...matrix import Matrix
from ...ntt import Domain
from ...stark import Stark, Trace
from .primitive import RescueParams

M = 4          # state width
CAPACITY = 2
RATE = 2
ROUNDS = 14
ROWS_PER_LINK = 16
ALPHA = 7

HINT_OUT0 = 0
HINT_OUT1 = 1
HINT_SEED0 = 2
HINT_SEED1 = 3


def goldilocks_params() -> RescueParams:
    return _params_cached()


_PARAMS = None


def _params_cached():
    global _PARAMS
    if _PARAMS is None:
        _PARAMS = RescueParams(Fp, P, GENERATOR, M, CAPACITY, ROUNDS,
                               security_level=128, digest_size=2)
        assert _PARAMS.alpha == ALPHA
    return _PARAMS


def _interval_coeffs(values):
    """Interpolate 16 per-row values into periodic-column coefficients:
    the column evaluates to values[r mod 16] on the trace domain."""
    dom = Domain(ROWS_PER_LINK)
    # host-side size-16 iNTT (exact scalar math)
    n = ROWS_PER_LINK
    w_inv = pow(dom.group_gen, P - 2, P)
    n_inv = pow(n, P - 2, P)
    coeffs = []
    for k in range(n):
        acc = 0
        for i, v in enumerate(values):
            acc = (acc + v.v * pow(w_inv, i * k, P)) % P
        coeffs.append(Fp(acc * n_inv % P))
    return tuple(coeffs)


class RescueTrace(Trace):
    def __init__(self, matrix: Matrix):
        self.matrix = matrix

    def base_columns(self) -> Matrix:
        return self.matrix


def _chain(seed: tuple, num_links: int):
    """The chain's rows (a list of num_links * 16 states of 4 ints) and
    its digest h_K (two ints)."""
    params = goldilocks_params()
    mds = [tuple(c.v for c in row) for row in params.mds]
    rc = [c.v for c in params.round_constants]
    alpha, alpha_inv = params.alpha, params.alpha_inv
    rows = []
    h0, h1 = seed[0] % P, seed[1] % P
    for _ in range(num_links):
        s = [h0, h1, 0, 0]
        rows.append(s)
        for r in range(ROUNDS):
            c = 2 * M * r
            t = [pow(v, alpha, P) for v in s]
            t = [(m0 * t[0] + m1 * t[1] + m2 * t[2] + m3 * t[3] + rc[c + j])
                 % P for j, (m0, m1, m2, m3) in enumerate(mds)]
            t = [pow(v, alpha_inv, P) for v in t]
            s = [(m0 * t[0] + m1 * t[1] + m2 * t[2] + m3 * t[3]
                  + rc[c + M + j]) % P for j, (m0, m1, m2, m3) in enumerate(mds)]
            rows.append(s)
        # copy row (14 -> 15); row 15 equals the final state too
        rows.append(s)
        h0, h1 = s[0], s[1]
    return rows, (h0, h1)


def gen_trace(seed: tuple, num_links: int, device=None):
    """Simulate the chain; trace rows = num_links * 16, columns = state, on
    `device` (the card unless the caller names another).  Returns
    (RescueTrace, digest), the digest two Fp."""
    assert num_links & (num_links - 1) == 0
    rows, (h0, h1) = _chain(seed, num_links)
    arr = np.asarray(rows, dtype=np.uint64)
    assert arr.shape == (num_links * ROWS_PER_LINK, M)
    return RescueTrace(Matrix.from_columns_np(arr.T, device)), (Fp(h0), Fp(h1))


def chain_digest(seed: tuple, num_links: int):
    _, (h0, h1) = _chain(seed, num_links)
    return Fp(h0), Fp(h1)


class RescueAirConfig:
    NUM_BASE_COLUMNS = M
    NUM_EXTENSION_COLUMNS = 0
    fp_type = Fp
    fq_type = Fp

    @staticmethod
    def gen_hints(trace_len, public_inputs, challenges) -> Hints:
        seed0, seed1, out0, out1 = public_inputs
        return Hints.new([
            (HINT_OUT0, Fp(out0)), (HINT_OUT1, Fp(out1)),
            (HINT_SEED0, Fp(seed0)), (HINT_SEED1, Fp(seed1)),
        ])

    @staticmethod
    def constraints(trace_len: int) -> list[Constraint]:
        params = goldilocks_params()
        dom = Domain(trace_len)
        first_x = constant(dom.element(0))
        last_x = constant(dom.element(trace_len - 1))
        one = constant(Fp(1))
        m = M

        # periodic selector masks over the 16-row link
        active_vals = [Fp(1 if t < ROUNDS else 0) for t in range(ROWS_PER_LINK)]
        copy_vals = [Fp(1 if t == ROUNDS else 0) for t in range(ROWS_PER_LINK)]
        bound_vals = [Fp(1 if t == ROWS_PER_LINK - 1 else 0) for t in range(ROWS_PER_LINK)]
        ACTIVE = periodic(_interval_coeffs(active_vals), ROWS_PER_LINK)
        COPY = periodic(_interval_coeffs(copy_vals), ROWS_PER_LINK)
        BOUND = periodic(_interval_coeffs(bound_vals), ROWS_PER_LINK)

        # periodic round-constant columns: C0_j(t) = rc[t*2m + j] (0 beyond
        # round rows); D_j(t) = (MDS^-1 row j) . rc[t*2m + m + .]
        def c0_col(j):
            vals = [params.round_constants[t * 2 * m + j] if t < ROUNDS else Fp(0)
                    for t in range(ROWS_PER_LINK)]
            return periodic(_interval_coeffs(vals), ROWS_PER_LINK)

        def d_col(j):
            vals = []
            for t in range(ROWS_PER_LINK):
                if t < ROUNDS:
                    c1 = [params.round_constants[t * 2 * m + m + k] for k in range(m)]
                    vals.append(sum((params.mds_inv[j][k] * c1[k] for k in range(m)),
                                    start=Fp(0)))
                else:
                    vals.append(Fp(0))
            return periodic(_interval_coeffs(vals), ROWS_PER_LINK)

        C0 = [c0_col(j) for j in range(m)]
        D = [d_col(j) for j in range(m)]

        def pow_a(e):
            return e.pow(ALPHA)

        transition = []
        for j in range(m):
            fwd = None
            for k in range(m):
                term = constant(params.mds[j][k]) * pow_a(curr(k))
                fwd = term if fwd is None else fwd + term
            fwd = fwd + C0[j]
            bwd_inner = None
            for k in range(m):
                term = constant(params.mds_inv[j][k]) * next(k)
                bwd_inner = term if bwd_inner is None else bwd_inner + term
            bwd = pow_a(bwd_inner - D[j])
            active_part = ACTIVE * (fwd - bwd)

            copy_part = COPY * (next(j) - curr(j))
            if j < RATE:
                bound_part = BOUND * (next(j) - curr(j))
            else:
                bound_part = BOUND * next(j)
            c = (active_part + copy_part + bound_part) * (
                (x() - last_x) / (x().pow(trace_len) - one))
            transition.append(c)

        # boundary: seed binds through hints (hints derive from public
        # inputs, the same mechanism as fib's claimed value); capacity
        # lanes start at zero
        boundary = [
            (curr(0) - hint(HINT_SEED0)) / (x() - first_x),
            (curr(1) - hint(HINT_SEED1)) / (x() - first_x),
            curr(2) / (x() - first_x),
            curr(3) / (x() - first_x),
        ]

        terminal = [
            (curr(0) - hint(HINT_OUT0)) / (x() - last_x),
            (curr(1) - hint(HINT_OUT1)) / (x() - last_x),
        ]

        return [Constraint(c) for c in transition + boundary + terminal]


class RescueClaim(Stark):
    """Public inputs: (seed0, seed1, out0, out1); trace length fixes K."""

    air_config = RescueAirConfig
    fp = Fp
    fq = Fp

    def __init__(self, seed0: int, seed1: int, out0: int, out1: int):
        self.pi = (seed0 % P, seed1 % P, out0 % P, out1 % P)

    def get_public_inputs(self):
        return self.pi

    def generate_trace(self, witness: RescueTrace) -> RescueTrace:
        return witness

    def serialize_public_inputs(self, w: serde.Writer):
        for v in self.pi:
            w.field(Fp(v))
