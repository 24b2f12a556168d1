"""Byte-exact Fiat-Shamir public coin (reference: src/random.rs).

Semantics replicated precisely:

* state = (seed digest, counter, byte buffer);
* ``gen_next`` -> counter += 1; buffer = sha256(seed || counter_be)  and the
  byte stream **pops from the END of each digest** (src/random.rs:147-156);
* integers are assembled **big-endian** from that stream (src/random.rs:158-179);
* ``draw`` follows ark `Fp::rand`: sample a u64, reject while >= p; the
  accepted u64 is the field element's internal (Montgomery, R=2^64) limb, so
  the canonical drawn value is ``u * R^{-1} mod p``  [ASSUMPTION documented in
  fields/scalar.py -- the Metal kernels share buffers with ark elements in
  Montgomery form, gpu/src/metal/felt_u64.h.metal:118];
* ``draw_queries`` uses rand-0.8 ``gen_range(0..n)`` (Lemire widening
  multiply with zone rejection) collected into a sorted set
  (src/random.rs:138-140);
* PoW: ``leading_zeros(sha256(seed || nonce_be)) >= bits`` (src/random.rs:129-132).
"""

from __future__ import annotations

from . import hash as H
from .fields.scalar import Fp, Fq3, P, R_MONT_INV


class PublicCoin:
    """PublicCoinImpl<F, Sha256HashFn> equivalent. `field` is Fp or Fq3."""

    def __init__(self, seed: bytes, field=Fp, hashfn=H):
        assert len(seed) == 32
        self.seed = seed
        self.counter = 0
        self.bytes_buf = b""
        self.field = field
        # the reference's hash type parameter D (PublicCoinImpl<F, D>,
        # src/random.rs:62-86): SHA-256 default, hash_rpo for algebraic coins
        self.hashfn = hashfn

    # -- reseeding -----------------------------------------------------------

    def _reset(self):
        self.counter = 0
        self.bytes_buf = b""

    def reseed_with_digest(self, digest: bytes):
        self.seed = self.hashfn.merge(self.seed, digest)
        self._reset()

    def reseed_with_field_elements(self, vals):
        for v in vals:
            self.seed = self.hashfn.merge(self.seed, self.hashfn.hash_elements([v]))
            self._reset()

    def reseed_with_field_element_vector(self, vals):
        # reference default forwards to per-element reseed (src/random.rs:37-39)
        self.reseed_with_field_elements(vals)

    def reseed_with_int(self, val: int):
        self.seed = self.hashfn.merge_with_int(self.seed, val)
        self._reset()

    # -- byte stream ---------------------------------------------------------

    def _gen_next(self) -> bytes:
        self.counter += 1
        self.bytes_buf = b""
        return self.hashfn.merge_with_int(self.seed, self.counter)

    def next_byte(self) -> int:
        if not self.bytes_buf:
            self.bytes_buf = self._gen_next()
        b = self.bytes_buf[-1]
        self.bytes_buf = self.bytes_buf[:-1]
        return b

    def fill_bytes(self, n: int) -> bytes:
        return bytes(self.next_byte() for _ in range(n))


    def next_u64(self) -> int:
        return int.from_bytes(self.fill_bytes(8), "big")

    # -- draws ---------------------------------------------------------------

    def _draw_fp(self) -> Fp:
        # ark BigInt::rand + is_geq_modulus rejection; accepted limb is the
        # Montgomery representation.
        while True:
            u = self.next_u64()
            if u < P:
                return Fp(u * R_MONT_INV % P)

    def draw(self):
        if self.field is Fp:
            return self._draw_fp()
        c0 = self._draw_fp()
        c1 = self._draw_fp()
        c2 = self._draw_fp()
        return Fq3(c0, c1, c2)

    def draw_multiple(self, n: int) -> list:
        return [self.draw() for _ in range(n)]

    def gen_range(self, n: int) -> int:
        """rand 0.8 UniformInt::<u64>::sample_single for range [0, n)."""
        assert n > 0
        range_ = n
        lz = 64 - range_.bit_length()
        zone = ((range_ << lz) - 1) & 0xFFFFFFFFFFFFFFFF
        while True:
            v = self.next_u64()
            prod = v * range_
            hi, lo = prod >> 64, prod & 0xFFFFFFFFFFFFFFFF
            if lo <= zone:
                return hi

    def draw_queries(self, max_n: int, domain_size: int) -> list[int]:
        """May return fewer than max_n (BTreeSet dedupe, src/random.rs:138-140)."""
        s = set()
        for _ in range(max_n):
            s.add(self.gen_range(domain_size))
        return sorted(s)

    # -- proof of work -------------------------------------------------------

    def verify_proof_of_work(self, bits: int, nonce: int) -> bool:
        digest = self.hashfn.merge_with_int(self.seed, nonce)
        return H.leading_zeros(digest) >= bits  # bit count is hash-agnostic

