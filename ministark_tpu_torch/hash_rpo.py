"""Host-side RPO-256 (scalar, exact) — the verifier-side counterpart of
ops/rpo256.py, sharing its canonical parameters.

Digests are 32 bytes: the 4 digest elements in canonical LE (8 bytes each),
matching the reference's `Rpo256Digest` memory layout of 4 field elements.
"""

from __future__ import annotations

from .fields.scalar import Fp, P
from .ops.rpo256 import (
    CAPACITY,
    DIGEST_SIZE,
    INV_ALPHA,
    MDS,
    NUM_ROUNDS,
    RATE,
    ROUND_CONSTANTS_0,
    ROUND_CONSTANTS_1,
    STATE_WIDTH,
)

COLLISION_RESISTANCE = 128

# digest words are (lo, hi) u32 pairs of canonical-LE u64 elements
DIGEST_WORDS_BE = False
ZERO_DIGEST = b"\x00" * 32


def _permute(state: list[int]) -> list[int]:
    for r in range(NUM_ROUNDS):
        state = [
            (sum(int(MDS[m, n]) * state[n] for n in range(STATE_WIDTH))
             + int(ROUND_CONSTANTS_0[r][m])) % P
            for m in range(STATE_WIDTH)
        ]
        state = [pow(v, 7, P) for v in state]
        state = [
            (sum(int(MDS[m, n]) * state[n] for n in range(STATE_WIDTH))
             + int(ROUND_CONSTANTS_1[r][m])) % P
            for m in range(STATE_WIDTH)
        ]
        state = [pow(v, INV_ALPHA, P) for v in state]
    return state


def hash_elements(elements) -> bytes:
    """RPO hash of a sequence of field elements (column-major absorb rule:
    1-then-zeros padding + capacity flag when len % 8 != 0).  Extension-field
    elements absorb as their base coefficients in order."""
    vals = []
    for e in elements:
        if isinstance(e, Fp):
            vals.append(e.v)
        elif hasattr(e, "c0"):  # Fq3
            vals.extend([e.c0.v, e.c1.v, e.c2.v])
        else:
            vals.append(int(e) % P)
    padded = len(vals) % RATE != 0
    if padded:
        vals = vals + [1] + [0] * ((RATE - (len(vals) + 1) % RATE) % RATE)
    state = [0] * STATE_WIDTH
    if padded:
        state[0] = 1
    for i in range(0, len(vals), RATE):
        state[CAPACITY:CAPACITY + RATE] = vals[i:i + RATE]
        state = _permute(state)
    return _digest_bytes(state)


def merge(d0: bytes, d1: bytes) -> bytes:
    state = [0] * STATE_WIDTH
    state[CAPACITY:CAPACITY + RATE] = _digest_vals(d0) + _digest_vals(d1)
    return _digest_bytes(_permute(state))


def merge_with_int(seed: bytes, value: int) -> bytes:
    """hash(seed || value) with the int as two field elements (lo32, hi32) —
    keeps the sponge element-aligned; used only by RPO-coin configurations."""
    vals = _digest_vals(seed) + [value & 0xFFFFFFFF, value >> 32]
    state = [0] * STATE_WIDTH
    state[0] = 1  # 6 elements -> padding rule applies
    state[CAPACITY:CAPACITY + RATE] = vals + [1, 0]
    return _digest_bytes(_permute(state))


def _digest_vals(d: bytes) -> list[int]:
    return [int.from_bytes(d[8 * i:8 * i + 8], "little") for i in range(DIGEST_SIZE)]


def _digest_bytes(state: list[int]) -> bytes:
    return b"".join(
        int(state[CAPACITY + i]).to_bytes(8, "little") for i in range(DIGEST_SIZE))
