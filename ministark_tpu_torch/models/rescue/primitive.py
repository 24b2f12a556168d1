"""Rescue-Prime (Rescue-XLIX) hash primitive, field-generic
(reference: examples/rescue/rescue.rs — parameter generation per
eprint 2020/1143; the reference example stops at `todo!()`).

Round constants come from SHAKE-256 over the seed string
`Rescue-XLIX(modulus,state_width,capacity,security_level)` read as
little-endian integers of (modulus_bits rounded up to bytes) + 1 bytes —
byte-for-byte the reference's derivation (rescue.rs:132-163).

The MDS matrix is the transpose of the right half of the reduced row echelon
form of the Vandermonde generator matrix g^(i*j) (Algorithm 4).

`get_alphas` deviates deliberately: the reference reduces the inverse
exponent mod p (rescue.rs:204) which is incorrect for exponent arithmetic;
we reduce mod p-1 so x^alpha ∘ x^alpha_inv is actually the identity."""

from __future__ import annotations

import hashlib
import math


class RescueParams:
    def __init__(self, field_cls, modulus: int, generator: int,
                 state_width: int, capacity: int, rounds: int,
                 security_level: int, digest_size: int):
        self.field = field_cls
        self.modulus = modulus
        self.generator = generator
        self.state_width = state_width
        self.capacity = capacity
        self.rate = state_width - capacity
        self.rounds = rounds
        self.security_level = security_level
        self.digest_size = digest_size
        self.round_constants = self._round_constants()
        self.mds = self._mds_matrix()
        self.mds_inv = _matrix_inverse(self.mds, field_cls)
        self.alpha, self.alpha_inv = self._get_alphas()

    # -- parameter generation -------------------------------------------------

    def _round_constants(self):
        seed = (f"Rescue-XLIX({self.modulus},{self.state_width},"
                f"{self.capacity},{self.security_level})")
        shake = hashlib.shake_256(seed.encode())
        bits = self.modulus.bit_length()
        bytes_per_int = -(-bits // 8) + 1
        total = 2 * self.state_width * self.rounds
        stream = shake.digest(bytes_per_int * total)
        F = self.field
        out = []
        for i in range(total):
            chunk = stream[i * bytes_per_int:(i + 1) * bytes_per_int]
            out.append(F(int.from_bytes(chunk, "little")))
        return out

    def _mds_matrix(self):
        F = self.field
        m = self.state_width
        rows, cols = m, 2 * m
        g = F(self.generator)
        mat = [[g ** (i * j) for j in range(cols)] for i in range(rows)]
        ech = _echelon_form(mat, F)
        right = [r[cols - rows:] for r in ech]
        return [[right[j][i] for j in range(rows)] for i in range(rows)]  # transpose

    def _get_alphas(self):
        p = self.modulus
        alpha = 3
        while alpha <= p - 2:
            g = math.gcd(alpha, p - 1)
            if g == 1:
                return alpha, pow(alpha, -1, p - 1)
            alpha += 1
        raise ValueError("no valid alpha")

    # -- sponge ---------------------------------------------------------------

    def permute(self, state: list) -> list:
        F = self.field
        m = self.state_width
        for r in range(self.rounds):
            state = [s ** self.alpha for s in state]
            state = _matvec(self.mds, state)
            state = [s + self.round_constants[r * 2 * m + j]
                     for j, s in enumerate(state)]
            state = [s ** self.alpha_inv for s in state]
            state = _matvec(self.mds, state)
            state = [s + self.round_constants[r * 2 * m + m + j]
                     for j, s in enumerate(state)]
        return state

    def hash(self, inputs: list) -> list:
        """Sponge with 1-then-zeros padding (rescue.rs:54-97)."""
        F = self.field
        rate = self.rate
        data = list(inputs) + [F.one()]
        while len(data) % rate != 0:
            data.append(F.zero())
        state = [F.zero()] * self.state_width
        for i in range(0, len(data), rate):
            for j in range(rate):
                state[j] = state[j] + data[i + j]
            state = self.permute(state)
        out = []
        while len(out) < self.digest_size:
            out.extend(state[:rate])
            if len(out) < self.digest_size:
                state = self.permute(state)
        return out[: self.digest_size]


def _matvec(m, v):
    return [sum((m[i][j] * v[j] for j in range(len(v))),
                start=type(v[0]).zero()) for i in range(len(m))]


def _echelon_form(mat, F):
    """Reduced row echelon form by Gauss-Jordan elimination."""
    m = [row[:] for row in mat]
    nrows, ncols = len(m), len(m[0])
    pivot_row = 0
    for col in range(ncols):
        if pivot_row >= nrows:
            break
        sel = None
        for r in range(pivot_row, nrows):
            if not m[r][col].is_zero():
                sel = r
                break
        if sel is None:
            continue
        m[pivot_row], m[sel] = m[sel], m[pivot_row]
        inv = m[pivot_row][col].inverse()
        m[pivot_row] = [x * inv for x in m[pivot_row]]
        for r in range(nrows):
            if r != pivot_row and not m[r][col].is_zero():
                f = m[r][col]
                m[r] = [a - f * b for a, b in zip(m[r], m[pivot_row])]
        pivot_row += 1
    return m


def _matrix_inverse(mat, F):
    n = len(mat)
    aug = [row[:] + [F.one() if i == j else F.zero() for j in range(n)]
           for i, row in enumerate(mat)]
    ech = _echelon_form(aug, F)
    return [row[n:] for row in ech]
