"""Replica of ``ark_std::test_rng()`` and ark-ff's ``F::rand`` over it.

The reference's brainfuck example seeds its permutation-argument initials
from ``ark_std::test_rng()`` (examples/brainfuck/trace.rs:82-84) — a fixed,
deterministic stream.  Reproducing it byte-for-byte is required for
bit-identical brainfuck proofs.  The chain of definitions (all pinned by the
reference's Cargo.lock: ark-std 0.4.0, rand 0.8.5, rand_chacha 0.3.1):

* ``ark_std::test_rng()`` = ``rand::rngs::StdRng::from_seed(SEED)`` with the
  fixed 32-byte array below (ark-std 0.4.0 src/rand_helper.rs).
* ``StdRng`` (rand 0.8.5) = ``ChaCha12Rng`` (rand_chacha 0.3.1): the djb
  ChaCha variant — 64-bit block counter in state words 12-13, 64-bit stream
  id (zero) in words 14-15 — with a 64-u32 results buffer (four ChaCha
  blocks per refill) behind rand_core's ``BlockRng``.
* ``BlockRng::next_u64`` (rand_core 0.6) joins two consecutive buffer words
  little-endian-first, with the documented straddle rule at a buffer edge.
* ``Fp::rand`` (ark-ff 0.4) rejection-samples one u64 limb until `< p` and
  uses it as the MONTGOMERY representation: canonical value = u * R^{-1}
  mod p with R = 2^64 (same rule as random.py's public-coin draws).
* ``Fq3::rand`` draws c0, c1, c2 in order (ark-ff CubicExtField::rand).

Pure Python (host-side setup code only).
"""

from __future__ import annotations

from .fields.scalar import Fp, Fq3, P

# ark-std 0.4.0 src/rand_helper.rs "arbitrary seed"
ARK_TEST_RNG_SEED = bytes([
    1, 0, 0, 0, 23, 0, 0, 0, 200, 1, 0, 0, 210, 30, 0, 0,
    0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
])

_MASK32 = 0xFFFFFFFF


def _rotl32(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _MASK32


def _chacha_block(key_words, counter: int, rounds: int):
    """One ChaCha block (djb variant): 16 output u32 words."""
    state = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
             *key_words,
             counter & _MASK32, (counter >> 32) & _MASK32, 0, 0]
    x = list(state)

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & _MASK32; x[d] = _rotl32(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & _MASK32; x[b] = _rotl32(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & _MASK32; x[d] = _rotl32(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & _MASK32; x[b] = _rotl32(x[b] ^ x[c], 7)

    for _ in range(rounds // 2):
        qr(0, 4, 8, 12); qr(1, 5, 9, 13); qr(2, 6, 10, 14); qr(3, 7, 11, 15)
        qr(0, 5, 10, 15); qr(1, 6, 11, 12); qr(2, 7, 8, 13); qr(3, 4, 9, 14)

    return [(x[i] + state[i]) & _MASK32 for i in range(16)]


class ChaCha12Rng:
    """rand_chacha 0.3.1 ``ChaCha12Rng`` + rand_core 0.6 ``BlockRng``
    word-consumption semantics (buffer = 4 blocks = 64 u32 words)."""

    BUF_WORDS = 64

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self._key = [int.from_bytes(seed[4 * i:4 * i + 4], "little")
                     for i in range(8)]
        self._counter = 0          # 64-bit block counter
        self._buf: list[int] = []
        self._index = self.BUF_WORDS  # forces a refill on first use

    def _generate(self):
        self._buf = []
        for _ in range(4):
            self._buf.extend(_chacha_block(self._key, self._counter, 12))
            self._counter += 1


    def next_u64(self) -> int:
        # rand_core 0.6 BlockRng::next_u64
        i = self._index
        if i < self.BUF_WORDS - 1:
            self._index += 2
            return self._buf[i] | (self._buf[i + 1] << 32)
        if i >= self.BUF_WORDS:
            self._generate()
            self._index = 2
            return self._buf[0] | (self._buf[1] << 32)
        lo = self._buf[self.BUF_WORDS - 1]
        self._generate()
        self._index = 1
        return lo | (self._buf[0] << 32)


def test_rng() -> ChaCha12Rng:
    """``ark_std::test_rng()``."""
    return ChaCha12Rng(ARK_TEST_RNG_SEED)


_R_INV = pow(1 << 64, P - 2, P)  # R^{-1} mod p, R = 2^64


def rand_fp(rng: ChaCha12Rng) -> Fp:
    """ark-ff ``Fp64::rand``: rejection-sample a u64 limb < p, interpret as
    Montgomery form (canonical value = limb * R^{-1} mod p)."""
    while True:
        u = rng.next_u64()
        if u < P:
            return Fp(u * _R_INV % P)


def rand_fq3(rng: ChaCha12Rng) -> Fq3:
    c0 = rand_fp(rng)
    c1 = rand_fp(rng)
    c2 = rand_fp(rng)
    return Fq3(c0.v, c1.v, c2.v)
