"""Proof-of-work grind of RPO-coin configurations (reference:
src/random.rs:48-55; mirrors ``ministark_tpu.ops.pow.grind_rpo``): the
SMALLEST nonce >= 1 whose digest ``hash_rpo.merge_with_int(seed, nonce)``
has at least `bits` leading zero bits, searched a batch of nonces at a
time.  On a CUDA device each batch is one launch of kernel G's grind entry
point (csrc/rpo256.cu), one nonce a group of lanes; on the CPU each batch
runs through the plain permutation.  SHA-256 coins grind through kernel
D (``ops.sha256.grind``).
"""

from __future__ import annotations

import torch

from . import build
from . import rpo256 as krpo

_P, _I = build.PTR, build.I64
KERNEL = build.register(
    "rpo256_grind", "rpo256.cu",
    replaces="ministark_tpu/ops/rpo256_pallas.py:136 _rpo_kernel "
             "(ministark_tpu/ops/pow.py:97 _grind_rpo_batch)",
    prototypes={"ms_rpo_grind": (_P, _I, _I, _I, _P, _P, _I)})

# nonces per batch: a b-bit grind expects 2^b tries, so on the card a batch
# of 4 * 2^b (at most 2^20) nonces usually ends it in one launch; the CPU's
# plain batches stay small
BATCH_CUDA = 1 << 20
BATCH_CPU = 1 << 8


def seed_elements(seed: bytes, device) -> torch.Tensor:
    """A 32-byte digest's four little-endian u64 elements, (4,) int64."""
    return torch.frombuffer(bytearray(seed), dtype=torch.int64).to(device)


def leading_zeros_plain(seed: torch.Tensor, start: int,
                        n: int) -> torch.Tensor:
    """Leading zero bits of the digests of nonces start .. start + n - 1,
    (n,) int32: the states [1, 0, 0, 0 | seed | lo32, hi32, 1, 0] through
    the plain permutation."""
    dev = seed.device
    nonce = start + torch.arange(n, dtype=torch.int64, device=dev)
    state = torch.zeros((krpo.STATE_WIDTH, n), dtype=torch.int64, device=dev)
    state[0] = 1
    state[4:8] = seed[:, None]
    state[8] = nonce & 0xFFFFFFFF
    state[9] = nonce >> 32
    state[10] = 1
    digest = krpo.permute_plain(state)[4:8]               # (4, n)
    shifts = torch.arange(0, 64, 8, device=dev)[None, :, None]
    stream = ((digest[:, None, :] >> shifts) & 0xFF).reshape(32, n)
    nonzero = stream != 0
    first = nonzero.int().argmax(0)                       # first nonzero byte
    byte = stream.gather(0, first[None])[0]
    bit_length = sum((byte >= (1 << k)).int() for k in range(8))
    return torch.where(nonzero.any(0), 8 * first + 8 - bit_length,
                       8 * 32).int()


def grind_batch_plain(seed: torch.Tensor, start: int, n: int,
                      bits: int) -> int:
    ok = (leading_zeros_plain(seed, start, n) >= bits).nonzero()
    return int(ok[0, 0]) if ok.numel() else -1


def grind_batch(seed: torch.Tensor, start: int, n: int, bits: int,
                lz: torch.Tensor | None = None) -> int:
    """Index (from `start`) of the first valid nonce of the batch, or -1.
    On CUDA, `lz` (an (n,) int32 tensor), when given, receives every
    nonce's count of leading zeros."""
    if not seed.is_cuda:
        if lz is not None:
            lz.copy_(leading_zeros_plain(seed, start, n))
        return grind_batch_plain(seed, start, n, bits)
    build.check_cuda(seed, name="seed")
    if not 0 < n < 2 ** 31 or not 0 <= start < 2 ** 63:
        raise ValueError(f"batch of {n} nonces from {start} out of range")
    if lz is not None:
        build.check_cuda(lz, dtype=torch.int32, name="lz")
    best = torch.full((1,), n, dtype=torch.int32, device=seed.device)
    KERNEL.launch("ms_rpo_grind", seed.data_ptr(), start, n, bits,
                  best.data_ptr(), None if lz is None else lz.data_ptr(),
                  krpo.lane_elems(n))
    idx = int(best.item())
    return idx if idx < n else -1


def grind_rpo(seed: bytes, bits: int, device) -> int:
    """Smallest nonce >= 1 with leading_zeros(hash_rpo.merge_with_int(seed,
    nonce)) >= bits, searched on `device`."""
    s = seed_elements(seed, device)
    batch = min(BATCH_CUDA, 1 << (bits + 2)) if s.is_cuda else BATCH_CPU
    start = 1
    while True:
        idx = grind_batch(s, start, batch, bits)
        if idx >= 0:
            return start + idx
        start += batch
