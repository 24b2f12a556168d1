"""Batched SHA-256 for Merkle trees and the proof-of-work grind of
SHA-256 coins: wrappers for kernel D (csrc/sha256.cu) beside their plain
PyTorch versions.

Digests are (n, 32) uint8 tensors holding the standard digest bytes.  The
plain versions hold 32-bit words in int64 tensors and mask after every
add and shift.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

KERNEL = build.register(
    "sha256", "sha256.cu",
    replaces="ministark_tpu/ops/sha256_pallas.py:51 _sha_kernel")
KERNEL_EXT3 = build.register(
    "sha256_ext3", "sha256.cu",
    replaces="ministark_tpu/ops/sha256_pallas.py:171 hash_rows_ext3_lanes")

KERNEL_TREE = build.register(
    "sha256_tree", "sha256.cu",
    replaces="ministark_tpu/ops/sha256_pallas.py:190 build_tree_levels_lanes",
    prototypes={"ms_sha_tree_tops": (build.PTR, build.PTR, build.I64)})
KERNEL_GRIND = build.register(
    "sha256_grind", "sha256.cu",
    replaces="ministark_tpu/ops/pow.py:19 _grind_batch (over "
             "ministark_tpu/ops/sha256.py:152 merge_with_int_words)",
    prototypes={"ms_sha_grind": (ctypes.c_char_p, build.I64, build.I64,
                                 build.I64, build.PTR, build.PTR)})

# on the card, the levels of a tree from one of at most this many nodes up
# to the root are one launch (a sweep of 16 .. 1024 on a 2^15-leaf tree
# found no clear winner: PERF.md)
TOPS_LEAVES = 64
# nonces per grind batch: a b-bit grind expects 2^b tries, so on the card a
# batch of 4 * 2^b (at most 2^22) nonces usually ends it in one launch;
# the CPU's plain batches stay small
BATCH_CUDA = 1 << 22
BATCH_CPU = 1 << 12

_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)
_H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
       0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
_M = 0xFFFFFFFF


def _rot3(x, a, b, c):
    """rotr(x, a) ^ rotr(x, b) ^ rotr(x, c) for 32-bit words in int64: with
    the word doubled into 64 bits, each rotation is one shift (bits n..n+31
    lie below the sign extension for n < 32)."""
    y = x | (x << 32)
    return ((y >> a) ^ (y >> b) ^ (y >> c)) & _M


def _sig(x, a, b, s):
    """rotr(x, a) ^ rotr(x, b) ^ (x >> s): the message-schedule sigmas."""
    y = x | (x << 32)
    return (((y >> a) ^ (y >> b)) & _M) ^ (x >> s)


def _const_schedule(words):
    """Message schedule of a block of constant words, as Python ints."""
    w = list(words)
    rot = lambda x, n: ((x >> n) | (x << (32 - n))) & _M  # noqa: E731
    for t in range(16, 64):
        s0 = rot(w[t - 15], 7) ^ rot(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = rot(w[t - 2], 17) ^ rot(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M)
    return w


def _bswap32(x):
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF))


def sha256_words_plain(words: torch.Tensor) -> torch.Tensor:
    """SHA-256 of (n, W) big-endian 32-bit words (int64) -> (n, 8) words."""
    n, W = words.shape
    total = ((W + 3 + 15) // 16) * 16
    pad = [0] * (total - W)
    pad[0] = 0x80000000
    pad[-2] = (W * 32) >> 32
    pad[-1] = (W * 32) & _M
    data_total = 16 * ((W + 15) // 16)
    msg = torch.cat([words, torch.tensor(pad[:data_total - W],
                                         dtype=torch.int64,
                                         device=words.device).expand(n, -1)],
                    dim=1)
    st = [torch.full((n,), h, dtype=torch.int64, device=words.device)
          for h in _H0]
    for blk in range(0, total, 16):
        if blk < data_total:
            w = [msg[:, blk + t] for t in range(16)]
            for t in range(16, 64):
                w.append((w[t - 16] + _sig(w[t - 15], 7, 18, 3) + w[t - 7]
                          + _sig(w[t - 2], 17, 19, 10)) & _M)
            kw = [w[t] + _K[t] for t in range(64)]
        else:  # a block of pure padding: its schedule is a constant
            ws = _const_schedule(pad[blk - W:blk - W + 16])
            kw = [(ws[t] + _K[t]) & _M for t in range(64)]
        a, b, c, d, e, f, g, h = st
        for t in range(64):
            ch = g ^ (e & (f ^ g))
            t1 = (h + _rot3(e, 6, 11, 25) + ch + kw[t]) & _M
            maj = (a & b) | ((a | b) & c)
            h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & _M, c, b, a,
                                      (t1 + _rot3(a, 2, 13, 22) + maj) & _M)
        st = [(s + v) & _M for s, v in zip(st, (a, b, c, d, e, f, g, h))]
    return torch.stack(st, dim=1)


def words_to_digests(words: torch.Tensor) -> torch.Tensor:
    """(n, 8) digest words -> (n, 32) uint8 digest bytes."""
    b = torch.stack([(words >> s) & 0xFF for s in (24, 16, 8, 0)], dim=2)
    return b.reshape(words.shape[0], 32).to(torch.uint8)


def digests_to_words(d: torch.Tensor) -> torch.Tensor:
    b = d.reshape(-1, 8, 4).to(torch.int64)
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]


def hash_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """Row digests of an (n, ncols) field matrix (any strides)."""
    lo = _bswap32(rows & _M)
    hi = _bswap32((rows >> 32) & _M)
    words = torch.stack([lo, hi], dim=2).reshape(rows.shape[0], -1)
    return words_to_digests(sha256_words_plain(words))


def merge_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    words = torch.cat([digests_to_words(left), digests_to_words(right)], 1)
    return words_to_digests(sha256_words_plain(words))


def hash_rows(rows: torch.Tensor) -> torch.Tensor:
    """SHA-256 of each row of an (n, ncols) int64 field matrix, elements in
    ark little-endian bytes (``hash.hash_elements``) -> (n, 32) uint8.
    `rows` may be a strided view (a transposed column-major matrix).  CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    if not rows.is_cuda:
        return hash_rows_plain(rows)
    if rows.dtype != torch.int64:
        raise TypeError(f"rows must be int64, got {rows.dtype}")
    n, ncols = rows.shape
    out = torch.empty((n, 32), dtype=torch.uint8, device=rows.device)
    rs, cs = rows.stride()
    KERNEL.launch("ms_hash_rows", build.ptr(rows), build.ptr(out),
                  build.i64(n), build.i64(ncols), build.i64(rs),
                  build.i64(cs))
    return out


def ext3_rows(m: torch.Tensor) -> torch.Tensor:
    """A (C, 3, n) Fq3 matrix as the (n, 3C) view of its rows: element
    (row i, word 3c + k) is component k of column c at i, so a row
    serializes column by column as c0 || c1 || c2, and every element lies
    n apart from the next (a uniform stride, hence no copy)."""
    if m.ndim != 3 or m.shape[1] != 3 or not m.is_contiguous():
        raise ValueError(f"need a contiguous (C, 3, n) Fq3 matrix, got "
                         f"{tuple(m.shape)}")
    return m.reshape(3 * m.shape[0], m.shape[2]).T


def hash_rows_ext3_plain(m: torch.Tensor) -> torch.Tensor:
    return hash_rows_plain(ext3_rows(m))


def hash_rows_ext3(m: torch.Tensor) -> torch.Tensor:
    """Row digests of a (C, 3, n) Fq3 matrix, each element serialized as
    c0 || c1 || c2 (8 little-endian bytes each) -> (n, 32) uint8.  Replaces
    ``hash_rows_ext3_lanes``: on CUDA tensors kernel D's strided row hash
    runs over the matrix in place; CPU tensors take the plain version."""
    rows = ext3_rows(m)
    if not m.is_cuda:
        return hash_rows_plain(rows)
    build.check_cuda(m, name="m")
    n, width = rows.shape
    out = torch.empty((n, 32), dtype=torch.uint8, device=m.device)
    KERNEL_EXT3.launch("ms_hash_rows", build.ptr(m), build.ptr(out),
                       build.i64(n), build.i64(width), build.i64(1),
                       build.i64(n))
    return out


def merge(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Merkle merges sha256(left[i] || right[i]) of (n, 32) uint8 digests.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if not left.is_cuda:
        return merge_plain(left, right)
    left, right = left.contiguous(), right.contiguous()
    for name, t in (("left", left), ("right", right)):
        build.check_cuda(t, dtype=torch.uint8, name=name)
    if left.shape != right.shape or left.shape[1:] != (32,):
        raise ValueError(f"merge needs two (n, 32) digest arrays, got "
                         f"{tuple(left.shape)} and {tuple(right.shape)}")
    out = torch.empty_like(left)
    KERNEL.launch("ms_merge", build.ptr(left), build.ptr(right),
                  build.ptr(out), build.i64(left.shape[0]))
    return out


def tree_tops(level: torch.Tensor) -> list[torch.Tensor]:
    """Every tree level above `level`, (m, 32) uint8 digests in tree-bitrev
    storage (m a power of two, 2 <= m <= TOPS_LEAVES): level h holds the
    merges of the two halves of the level below, the root's level last.
    One launch builds them all into one buffer and the levels are views of
    it.  Card only: its plain version is ``merge_plain`` a level at a time,
    which ``merkle.tree_levels`` runs for CPU tensors."""
    m = level.shape[0]
    if m < 2 or m & (m - 1) or m > TOPS_LEAVES:
        raise ValueError(f"tree tops need 2 <= m <= {TOPS_LEAVES} digests, "
                         f"m a power of two; got {m}")
    level = level.contiguous()
    build.check_cuda(level, dtype=torch.uint8, name="level")
    if level.shape[1:] != (32,):
        raise ValueError(f"need (m, 32) digests, got {tuple(level.shape)}")
    out = torch.empty((m - 1, 32), dtype=torch.uint8, device=level.device)
    KERNEL_TREE.launch("ms_sha_tree_tops", level.data_ptr(), out.data_ptr(),
                       m)
    levels, start, h = [], 0, m // 2
    while h:
        levels.append(out[start:start + h])
        start, h = start + h, h // 2
    return levels


# -- proof of work (reference: src/random.rs:48-55) ---------------------------

def _seed_words(seed: bytes) -> list[int]:
    if len(seed) != 32:
        raise ValueError(f"need a 32-byte seed, got {len(seed)} bytes")
    return [int.from_bytes(seed[4 * k:4 * k + 4], "big") for k in range(8)]


def leading_zeros_plain(seed: bytes, start: int, n: int,
                        device="cpu") -> torch.Tensor:
    """Leading zero bits of sha256(seed || nonce as 8 big-endian bytes) for
    the nonces start .. start + n - 1, (n,) int32 on `device`."""
    nonce = start + torch.arange(n, dtype=torch.int64, device=device)
    seed_w = torch.tensor(_seed_words(seed), dtype=torch.int64,
                          device=device).expand(n, 8)
    words = torch.cat([seed_w, ((nonce >> 32) & _M)[:, None],
                       (nonce & _M)[:, None]], dim=1)
    d = sha256_words_plain(words)                          # (n, 8)
    # a word's leading zeros: 32 - its bit length
    bitlen = sum((d >= (1 << k)).int() for k in range(32))
    nonzero = d != 0
    first = nonzero.int().argmax(1)                        # first nonzero word
    z = 32 * first + 32 - bitlen.gather(1, first[:, None])[:, 0]
    return torch.where(nonzero.any(1), z, 256).int()


def grind_batch_plain(seed: bytes, start: int, n: int, bits: int) -> int:
    ok = (leading_zeros_plain(seed, start, n) >= bits).nonzero()
    return int(ok[0, 0]) if ok.numel() else -1


def grind_batch(seed: bytes, start: int, n: int, bits: int, device,
                lz: torch.Tensor | None = None) -> int:
    """Index (from `start`) of the first nonce of the batch whose digest
    has at least `bits` leading zero bits, or -1.  On a CUDA device one
    launch of the kernel and one read back; `lz` (an (n,) int32 tensor
    there), when given, receives every nonce's count of leading zeros.  On
    the CPU the plain version."""
    if torch.device(device).type != "cuda":
        if lz is not None:
            lz.copy_(leading_zeros_plain(seed, start, n))
        return grind_batch_plain(seed, start, n, bits)
    if len(seed) != 32:  # the kernel's launch reads 32 bytes from it
        raise ValueError(f"need a 32-byte seed, got {len(seed)} bytes")
    if not 0 < n < 2 ** 31 or not 0 <= start < 2 ** 63 - n:
        raise ValueError(f"batch of {n} nonces from {start} out of range")
    if lz is not None:
        build.check_cuda(lz, dtype=torch.int32, name="lz")
        if lz.numel() != n:
            raise ValueError(f"lz holds {lz.numel()} counts, need {n}")
    best = torch.full((1,), n, dtype=torch.int32, device=device)
    KERNEL_GRIND.launch("ms_sha_grind", seed, start, n, bits,
                        best.data_ptr(),
                        None if lz is None else lz.data_ptr())
    idx = int(best.item())
    return idx if idx < n else -1


def grind(seed: bytes, bits: int, device) -> int:
    """Smallest nonce >= 1 with at least `bits` leading zero bits in
    sha256(seed || nonce as 8 big-endian bytes) (``native.pow_grind``'s
    answer), searched in batches in nonce order on `device`: the first
    batch with a hit holds the smallest."""
    cuda = torch.device(device).type == "cuda"
    batch = min(BATCH_CUDA if cuda else BATCH_CPU, 4 << bits)
    start = 1
    while True:
        idx = grind_batch(seed, start, batch, bits, device)
        if idx >= 0:
            return start + idx
        start += batch
