"""Batched SHA-256 for Merkle trees, in plain PyTorch.

Digests are (n, 32) uint8 tensors holding the standard digest bytes.  The
32-bit words are held in int64 tensors and masked after every add and
shift.  Rows go through in chunks of ``CHUNK`` to bound the temporaries
(the 64 words of a block's schedule, each a tensor of the chunk's rows).
"""

from __future__ import annotations

import torch

CHUNK = 1 << 20

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


def _hash_rows(rows: torch.Tensor) -> torch.Tensor:
    """Row digests of an (n, ncols) field matrix (any strides)."""
    lo = _bswap32(rows & _M)
    hi = _bswap32((rows >> 32) & _M)
    words = torch.stack([lo, hi], dim=2).reshape(rows.shape[0], -1)
    return words_to_digests(sha256_words_plain(words))


def _merge(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    words = torch.cat([digests_to_words(left), digests_to_words(right)], 1)
    return words_to_digests(sha256_words_plain(words))


def _chunked(fn, *xs):
    n = xs[0].shape[0]
    if n <= CHUNK:
        return fn(*xs)
    return torch.cat([fn(*(x[a:a + CHUNK] for x in xs))
                      for a in range(0, n, CHUNK)])


def hash_rows(rows: torch.Tensor) -> torch.Tensor:
    """SHA-256 of each row of an (n, ncols) int64 field matrix, elements in
    little-endian bytes (``hash.hash_elements``) -> (n, 32) uint8."""
    return _chunked(_hash_rows, rows)


def ext3_rows(m: torch.Tensor) -> torch.Tensor:
    """A (C, 3, n) Fq3 matrix as the (n, 3C) view of its rows: a row
    serializes column by column as c0 || c1 || c2."""
    if m.ndim != 3 or m.shape[1] != 3 or not m.is_contiguous():
        raise ValueError(f"need a contiguous (C, 3, n) Fq3 matrix, got "
                         f"{tuple(m.shape)}")
    return m.reshape(3 * m.shape[0], m.shape[2]).T


def hash_rows_ext3(m: torch.Tensor) -> torch.Tensor:
    """Row digests of a (C, 3, n) Fq3 matrix -> (n, 32) uint8."""
    return hash_rows(ext3_rows(m))


def merge(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Merkle merges sha256(left[i] || right[i]) of (n, 32) uint8 digests."""
    return _chunked(_merge, left, right)
