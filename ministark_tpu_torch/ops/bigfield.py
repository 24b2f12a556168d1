"""Big prime field vectors (``fields.bigvec``): wrappers for
csrc/bigfield.cu beside their plain PyTorch versions.

An array of n field elements is an (L, n) int64 tensor of u64 Montgomery
limbs (L = 2 for Fp128, 4 for Fp252; limb k holds bits 64k .. 64k + 63 of
v R mod p, R = 2^(64 L)).  The plain versions split each limb into two
32-bit words held in int64 and run the JAX package's CIOS over those
words (``ministark_tpu.fields.bigvec.BigField.mul`` runs it over 16-bit
words in uint32): a product of two words plus two word addends is below
2^64, so its bit pattern in wrapping int64 arithmetic is exact; right
shifts are masked (``>>`` is arithmetic).  R is the same 2^(32 * 2L).
CUDA tensors launch the kernel; CPU tensors take the plain version.

The kernel's transform reads its twiddles from one table in the order its
threads read them (``twiddle_table``): the entries w^e whose exponents
``ms_big_ntt_table`` lists, taken from tw (w^(e + n/2) = -w^e).
``fields.bigvec.BigDomain`` builds it once per domain and device beside
tw and passes it to ``big_ntt``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .ntt import bitrev_index

_P, _I = build.PTR, build.I64
KERNEL_MUL = build.register(
    "big_mul", "bigfield.cu",
    replaces="ministark_tpu/fields/bigvec.py:155 BigField.mul (XLA)",
    prototypes={"ms_big_mul": (_P, _P, _P, _I, _I, ctypes.c_char_p, _I)})
KERNEL_NTT = build.register(
    "big_ntt", "bigfield.cu",
    replaces="ministark_tpu/fields/bigvec.py:283 BigDomain._transform (XLA)",
    prototypes={"ms_big_ntt": (_P, _P, _P, _P, _I, _P, _P, _I,
                               ctypes.c_char_p, _I)})

_M = 0xFFFFFFFF


def words(a: torch.Tensor) -> list[torch.Tensor]:
    """(L, ...) u64 limbs -> 2L 32-bit words, least significant first."""
    out = []
    for k in range(a.shape[0]):
        out += [a[k] & _M, (a[k] >> 32) & _M]
    return out


def join(w: list[torch.Tensor]) -> torch.Tensor:
    """2L 32-bit words -> (L, ...) u64 limbs."""
    return torch.stack([w[2 * k] | (w[2 * k + 1] << 32)
                        for k in range(len(w) // 2)])


def cond_sub_p(t: list, overflow, p_words: list[int]) -> list:
    """t (words) + overflow 2^(32 len(t)), below 2p -> reduced mod p."""
    d, brw = [], 0
    for j, pj in enumerate(p_words):
        s = t[j] - pj - brw
        d.append(s & _M)
        brw = (s < 0).to(torch.int64)
    use_d = (overflow != 0) | (brw == 0)
    return [torch.where(use_d, d[j], t[j]) for j in range(len(t))]


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor, p_words: list[int],
                   n0inv32: int) -> torch.Tensor:
    """a b R^-1 mod p over (L, ...) limb tensors that broadcast: CIOS over
    32-bit words (n0inv32 = -p^-1 mod 2^32)."""
    aw, bw = words(a), words(b)
    W = len(p_words)
    zero = torch.zeros_like(aw[0] + bw[0])
    t = [zero] * (W + 2)
    for i in range(W):
        bi = bw[i]
        c = zero
        for j in range(W):
            s = t[j] + aw[j] * bi + c   # below 2^64: exact as a bit pattern
            t[j] = s & _M
            c = (s >> 32) & _M
        s = t[W] + c
        t[W] = s & _M
        t[W + 1] = t[W + 1] + ((s >> 32) & _M)
        q = (t[0] * n0inv32) & _M
        s = t[0] + q * p_words[0]
        c = (s >> 32) & _M
        for j in range(1, W):
            s = t[j] + q * p_words[j] + c
            t[j - 1] = s & _M
            c = (s >> 32) & _M
        s = t[W] + c
        t[W - 1] = s & _M
        t[W] = t[W + 1] + ((s >> 32) & _M)
        t[W + 1] = zero
    return join(cond_sub_p(t[:W], t[W], p_words))


def big_mul_plain(a: torch.Tensor, b: torch.Tensor, field) -> torch.Tensor:
    """(L, n) times (L, n) or (L, 1), elementwise, Montgomery."""
    return mont_mul_plain(a, b, field.p_words32, field.n0inv32)


def big_mul(a: torch.Tensor, b: torch.Tensor, field) -> torch.Tensor:
    """Elementwise Montgomery product of (L, n) limb arrays a and b, b
    (L, n) or (L, 1).  One launch on the card; the plain version for CPU
    tensors."""
    if not a.is_cuda:
        return big_mul_plain(a, b, field)
    L = field.L64
    a, b = a.contiguous(), b.contiguous()
    build.check_cuda(a, name="a")
    build.check_cuda(b, name="b")
    if a.ndim != 2 or a.shape[0] != L or b.ndim != 2 or b.shape[0] != L \
            or b.shape[1] not in (1, a.shape[1]):
        raise ValueError(f"big_mul needs ({L}, n) and ({L}, n) or ({L}, 1) "
                         f"limbs, got {tuple(a.shape)}, {tuple(b.shape)}")
    n = a.shape[1]
    out = torch.empty_like(a)
    KERNEL_MUL.launch("ms_big_mul", a.data_ptr(), b.data_ptr(),
                      out.data_ptr(), n, int(b.shape[1] == n and n != 1),
                      field.mod_desc, L)
    return out


def add_plain(a: torch.Tensor, b: torch.Tensor, field) -> torch.Tensor:
    aw, bw = words(a), words(b)
    t, c = [], 0
    for x, y in zip(aw, bw):
        s = x + y + c
        t.append(s & _M)
        c = s >> 32
    return join(cond_sub_p(t, c, field.p_words32))


def sub_plain(a: torch.Tensor, b: torch.Tensor, field) -> torch.Tensor:
    aw, bw = words(a), words(b)
    t, brw = [], 0
    for x, y in zip(aw, bw):
        s = x - y - brw
        t.append(s & _M)
        brw = (s < 0).to(torch.int64)
    out, c = [], 0
    for j, pj in enumerate(field.p_words32):  # add p back where it borrowed
        s = t[j] + pj * brw + c
        out.append(s & _M)
        c = s >> 32
    return join(out)


def big_ntt_plain(x: torch.Tensor, tw: torch.Tensor, field,
                  scale_first: torch.Tensor | None = None,
                  scale_last: torch.Tensor | None = None) -> torch.Tensor:
    """The radix-2 transform of ``BigDomain._transform``: x (L, n) natural
    order, times scale_first where given, bit-reversed, the stages of span
    2 .. n (twiddles tw[:, j n/m]), times scale_last where given."""
    L, n = x.shape
    if scale_first is not None:
        x = big_mul_plain(x, scale_first, field)
    x = x[:, bitrev_index(n, x.device)]
    m = 2
    while m <= n:
        xr = x.reshape(L, n // m, m)
        u = xr[:, :, :m // 2]
        w = tw[:, ::n // m][:, None, :m // 2]
        t = big_mul_plain(xr[:, :, m // 2:], w, field)
        x = torch.cat([add_plain(u, t, field), sub_plain(u, t, field)],
                      dim=2).reshape(L, n)
        m *= 2
    if scale_last is not None:
        x = big_mul_plain(x, scale_last, field)
    return x


def twiddle_values(tw: torch.Tensor, field, n: int,
                   exps: torch.Tensor) -> torch.Tensor:
    """(L, len(exps)) limbs of w^e for each exponent e < n, from tw (L,
    n/2) = w^j: w^e = -w^(e - n/2) for e >= n/2."""
    half = max(n // 2, 1)
    e = exps.to(tw.device)
    vals = tw[:, e % half]
    neg = sub_plain(torch.zeros_like(vals), vals, field)
    return torch.where(e >= half, neg, vals).contiguous()


def twiddle_table(tw: torch.Tensor, field, n: int):
    """The kernel's twiddle table for an n-point transform with twiddles
    tw, on tw's device, and the transform's number of passes."""
    log_n = n.bit_length() - 1
    count = KERNEL_NTT.query("ms_big_ntt_table", log_n, 0)
    exps = np.zeros(max(count, 1), dtype=np.int64)
    KERNEL_NTT.query("ms_big_ntt_table", log_n, exps.ctypes.data)
    return (twiddle_values(tw, field, n, torch.from_numpy(exps[:count])),
            KERNEL_NTT.query("ms_big_ntt_passes", log_n))


def big_ntt(x: torch.Tensor, tw: torch.Tensor, field,
            scale_first: torch.Tensor | None = None,
            scale_last: torch.Tensor | None = None,
            table=None) -> torch.Tensor:
    """The transform of an (L, n) limb array, y[k] = sum_i x[i] w^(i k) (n
    a power of two, natural order in and out; ``big_ntt_plain``'s radix-2
    stages), twiddles tw (L, n/2) = w^j, the coset's
    powers folded into the first pass (scale_first) and the inverse's
    offset^-i n^-1 into the last (scale_last).  On the card one launch a
    pass of up to 2^9 points (2^18 points: two), its twiddles from
    `table` (``twiddle_table(tw, field, n)``, built here where not
    given); the plain version for CPU tensors."""
    if not x.is_cuda:
        return big_ntt_plain(x, tw, field, scale_first, scale_last)
    L, n = x.shape
    if L != field.L64 or n & (n - 1) or n < 1:
        raise ValueError(f"big_ntt needs ({field.L64}, 2^k) limbs, got "
                         f"{tuple(x.shape)}")
    x, tw = x.contiguous(), tw.contiguous()
    for name, t, shape in (("x", x, (L, n)), ("tw", tw, (L, n // 2)),
                           ("scale_first", scale_first, (L, n)),
                           ("scale_last", scale_last, (L, n))):
        if t is None:
            continue
        build.check_cuda(t, name=name)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    tab, passes = table if table is not None else twiddle_table(tw, field,
                                                                 n)
    y = torch.empty_like(x)
    tmp = torch.empty_like(x) if passes > 1 else None
    KERNEL_NTT.launch("ms_big_ntt", x.data_ptr(), y.data_ptr(),
                      build.ptr_or_null(tmp).value, tab.data_ptr(),
                      tab.shape[1], build.ptr_or_null(scale_first).value,
                      build.ptr_or_null(scale_last).value, n,
                      field.mod_desc, L)
    return y
