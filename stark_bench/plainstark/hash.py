"""Hash functions: host-side SHA-256 wrapper matching the reference's
`Sha256HashFn` (src/hash.rs:58-100).

* ``hash_elements`` = SHA-256 over the concatenated canonical LE bytes of the
  elements (ark `serialize_uncompressed`, src/hash.rs:92-100).
* ``merge`` = SHA-256(d0 || d1)  (src/hash.rs:77-82)
* ``merge_with_int`` = SHA-256(seed || value.to_be_bytes())  (src/hash.rs:84-89)

Digests are plain 32-byte ``bytes``.  The batched tensor version used for
row hashes and Merkle levels is ``ops.sha256``.
"""

from __future__ import annotations

import hashlib


Digest = bytes
ZERO_DIGEST: Digest = b"\x00" * 32


def sha256(data: bytes) -> Digest:
    return hashlib.sha256(data).digest()


def merge(d0: Digest, d1: Digest) -> Digest:
    return sha256(d0 + d1)


def merge_with_int(seed: Digest, value: int) -> Digest:
    return sha256(seed + (value & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "big"))


def hash_elements(elements) -> Digest:
    h = hashlib.sha256()
    for e in elements:
        h.update(e.to_bytes())
    return h.digest()


def leading_zeros(digest: Digest) -> int:
    """Number of leading zero bits (src/random.rs:181-192)."""
    zeros = 0
    for byte in digest:
        if byte == 0:
            zeros += 8
        else:
            zeros += 8 - byte.bit_length()
            break
    return zeros
