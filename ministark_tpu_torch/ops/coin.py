"""The device Fiat-Shamir coin step between two FRI layers (mirrors
``ministark_tpu.ops.coin``): reseed the coin with a layer's Merkle root and
make the k draws the next fold needs, and the fold's powers of the drawn
alpha, without the root leaving the device.  Wrappers for csrc/coin.cu
beside their plain PyTorch versions.

* ``coin_sha``: seed' = sha256(seed || root); the draws pop u64s from the
  END of sha256(seed' || counter as 8 big-endian bytes), counter 1, 2, ..,
  reject a u64 >= p and take an accepted one as a Montgomery limb, so a
  draw is u * R^-1 mod p.  A real rejection loop, as the host coin
  (``random.PublicCoin``) runs it.
* ``coin_rpo``: seed' = ``hash_rpo.merge(seed, root)``; the draws are the
  digest elements e3, e2, e1, e0 of ``hash_rpo.merge_with_int(seed',
  counter)``, counter 1, 2, .., each times R^-1.

Seeds and roots are (32,) uint8 tensors (the digest bytes, for SHA-256 and
RPO-256 alike, so a tree root ``levels[-1][0]`` is read in place); draws
are (k,) int64 canonical Fp values; the powers alpha^0 .. alpha^(N-1) of
an Fp (k = 1) or Fq3 (k = 3) alpha a (k, N) int64 tensor, component
planes first.  CUDA tensors launch the kernel; CPU tensors take the plain
version.  The host coin stays the source of truth:
the FRI prover replays it from the roots and compares every draw.
"""

from __future__ import annotations

import torch

from ..fields import device as fd
from ..fields.scalar import R_MONT_INV
from . import build
from . import rpo256 as krpo
from . import sha256 as ksha

_P, _I = build.PTR, build.I64
KERNEL_SHA = build.register(
    "coin_sha", "coin.cu",
    replaces="ministark_tpu/ops/coin.py:35 reseed + :40 draw_fps (XLA in "
             "ministark_tpu/fri.py:419 _fri_pipeline_program)",
    prototypes={"ms_coin_sha": (_P, _P, _I, _I, _P, _P, _P)})
KERNEL_RPO = build.register(
    "coin_rpo", "coin.cu",
    replaces="ministark_tpu/ops/coin.py:102 rpo_reseed + :112 rpo_draw_fps "
             "(XLA in ministark_tpu/fri.py:419 _fri_pipeline_program)",
    prototypes={"ms_coin_rpo": (_P, _P, _I, _I, _P, _P, _P)})

_M = 0xFFFFFFFF


def seed_tensor(seed: bytes, device) -> torch.Tensor:
    """A coin's 32-byte seed as a (32,) uint8 tensor on `device`; to the
    card from pinned memory without waiting for the work queued there."""
    if len(seed) != 32:
        raise ValueError(f"need a 32-byte seed, got {len(seed)} bytes")
    t = torch.frombuffer(bytearray(seed), dtype=torch.uint8)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def sha_candidates(d: torch.Tensor) -> torch.Tensor:
    """(m, 8) digest words -> (4m,) int64: each digest's four u64s in the
    order the coin pops them (u64 i is the little-endian value of bytes
    24 - 8i .. 31 - 8i)."""
    bswap = ksha._bswap32
    c = [(bswap(d[:, 7 - 2 * i]) << 32) | bswap(d[:, 6 - 2 * i])
         for i in range(4)]
    return torch.stack(c, dim=1).reshape(-1)


def accepted(u: torch.Tensor) -> torch.Tensor:
    """The rejection predicate of a popped u64 (int64 bit patterns): u < p."""
    return fd._ult(u, fd.P_I64)


def alpha_powers_plain(draws: torch.Tensor, N: int) -> torch.Tensor:
    """(k, N): alpha^j for j < N, alpha the Fp draws[0] (k = 1) or the Fq3
    (draws[0], draws[1], draws[2]) (k = 3)."""
    k = draws.shape[0]
    if k not in (1, 3):
        raise ValueError(f"alpha is one Fp or three Fq3 draws, got {k}")
    alpha = draws.reshape(k, 1)
    p = torch.zeros_like(alpha)
    p[0] = 1
    out = []
    for _ in range(N):
        out.append(p)
        p = fd.mul(p, alpha) if k == 1 else fd.ext3_mul(p, alpha)
    return (torch.cat(out, dim=1) if out
            else torch.zeros((k, 0), dtype=torch.int64, device=draws.device))


def coin_sha_plain(seed: torch.Tensor, root: torch.Tensor, k: int,
                   N: int = 0):
    """(seed', draws, alpha's powers) of the SHA-256 coin step, on seed's
    device."""
    words = torch.cat([ksha.digests_to_words(seed.reshape(1, 32)),
                       ksha.digests_to_words(root.reshape(1, 32))], dim=1)
    sw = ksha.sha256_words_plain(words)                        # (1, 8)
    found, got, counter = [], 0, 1
    while got < k:
        m = (k - got + 3) // 4  # digests that give k draws if none rejects
        c = counter + torch.arange(m, dtype=torch.int64, device=seed.device)
        msg = torch.cat([sw.expand(m, 8), ((c >> 32) & _M)[:, None],
                         (c & _M)[:, None]], dim=1)
        u = sha_candidates(ksha.sha256_words_plain(msg))
        u = u[accepted(u)]
        found.append(u)
        got += u.numel()
        counter += m
    draws = fd.mul(torch.cat(found)[:k], R_MONT_INV)
    return (ksha.words_to_digests(sw)[0], draws,
            _powers(draws, N))


def _powers(draws, N):
    if N == 0:
        return torch.zeros((draws.shape[0], 0), dtype=torch.int64,
                           device=draws.device)
    return alpha_powers_plain(draws, N)


def coin_rpo_plain(seed: torch.Tensor, root: torch.Tensor, k: int,
                   N: int = 0):
    """(seed', draws, alpha's powers) of the RPO-256 coin step, on seed's
    device."""
    dev = seed.device
    state = torch.zeros((krpo.STATE_WIDTH, 1), dtype=torch.int64, device=dev)
    state[4:8, 0] = seed.contiguous().view(torch.int64)
    state[8:12, 0] = root.contiguous().view(torch.int64)
    sd = krpo.permute_plain(state)[4:8, 0]                     # (4,)
    c = 1 + torch.arange((k + 3) // 4, dtype=torch.int64, device=dev)
    d = rpo_draw_digests(sd, c)                                # (4, m)
    u = d.flip(0).T.reshape(-1)[:k]  # e3, e2, e1, e0 of each digest
    draws = fd.mul(u, R_MONT_INV)
    return sd.view(torch.uint8), draws, _powers(draws, N)


def rpo_draw_digests(seed: torch.Tensor, counters: torch.Tensor):
    """(4, m) digest elements of ``hash_rpo.merge_with_int(seed, c)`` for
    the m counters c (int64, below 2^63): the states [1, 0, 0, 0 | seed |
    c mod 2^32, c >> 32, 1, 0] through the plain permutation."""
    m = counters.shape[0]
    state = torch.zeros((krpo.STATE_WIDTH, m), dtype=torch.int64,
                        device=seed.device)
    state[0] = 1
    state[4:8] = seed[:, None]
    state[8] = counters & _M
    state[9] = counters >> 32
    state[10] = 1
    return krpo.permute_plain(state)[4:8]


def _check(seed, root, k, N):
    for name, t in (("seed", seed), ("root", root)):
        build.check_cuda(t, dtype=torch.uint8, name=name)
        if t.shape != (32,):
            raise ValueError(f"{name} must be (32,) digest bytes, got "
                             f"{tuple(t.shape)}")
    if k < 1 or N < 0 or (N and k not in (1, 3)):
        raise ValueError(f"need k >= 1 draws, and k = 1 or 3 for powers; "
                         f"got k = {k}, N = {N}")


def _launch(kernel, fn, seed, root, k, N):
    root = root.contiguous()
    _check(seed, root, k, N)
    out = torch.empty(32, dtype=torch.uint8, device=seed.device)
    draws = torch.empty(k, dtype=torch.int64, device=seed.device)
    pw = torch.empty((k, N), dtype=torch.int64, device=seed.device)
    kernel.launch(fn, seed.data_ptr(), root.data_ptr(), k, N, out.data_ptr(),
                  draws.data_ptr(), pw.data_ptr())
    return out, draws, pw


def coin_sha(seed: torch.Tensor, root: torch.Tensor, k: int, N: int = 0):
    """The SHA-256 coin step: (seed', the first k draws after it, the
    first N powers of alpha).  One launch on the card; the plain version
    for CPU tensors."""
    if not seed.is_cuda:
        return coin_sha_plain(seed, root, k, N)
    return _launch(KERNEL_SHA, "ms_coin_sha", seed, root, k, N)


def coin_rpo(seed: torch.Tensor, root: torch.Tensor, k: int, N: int = 0):
    """The RPO-256 coin step: (seed', the first k draws after it, the
    first N powers of alpha).  One launch on the card; the plain version
    for CPU tensors."""
    if not seed.is_cuda:
        return coin_rpo_plain(seed, root, k, N)
    return _launch(KERNEL_RPO, "ms_coin_rpo", seed, root, k, N)
