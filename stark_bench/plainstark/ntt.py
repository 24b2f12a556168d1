"""NTT / evaluation domains over the Goldilocks field on torch tensors.

``Domain`` has ark ``Radix2EvaluationDomain`` semantics: ``element(i) =
offset * g^i`` with ``g = get_root_of_unity(n)``.  ``fft`` maps
natural-order coefficients to natural-order evaluations over the (coset)
domain and ``ifft`` is its exact inverse, on (B, n) batches.  Every
transform of n >= 2 points is the six-step decomposition n = n1 * n2:
column NTTs of length n1 (coset scale in, twiddle matrix out), a
transpose, column NTTs of length n2, all in plain PyTorch.
"""

from __future__ import annotations

import torch

from .fields import device as fd
from .fields.scalar import Fp, P, get_root_of_unity
from .ops import ntt as kntt


def bit_reverse_index(n: int, i: int) -> int:
    log_n = n.bit_length() - 1
    return int(f"{i:0{log_n}b}"[::-1], 2) if log_n > 0 else 0


def permute_bitrev(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Bit-reverse permutation of `t` along `dim` (one gather)."""
    n = t.shape[dim]
    return t.index_select(dim, kntt.bitrev_index(n, t.device))


def _split_n(n: int):
    log_n = n.bit_length() - 1
    l1 = log_n // 2
    return 1 << l1, 1 << (log_n - l1)


_TABLE_CACHE: dict = {}
_TABLE_CACHE_MAX = 64


def _cached(key, build):
    hit = _TABLE_CACHE.get(key)
    if hit is None:
        if len(_TABLE_CACHE) >= _TABLE_CACHE_MAX:
            _TABLE_CACHE.pop(next(iter(_TABLE_CACHE)))
        hit = _TABLE_CACHE[key] = build()
    return hit


def powers(base: int, n: int, device) -> torch.Tensor:
    """Cached table base^i, i < n, on `device`."""
    base %= P
    return _cached(("powers", base, n, str(device)),
                   lambda: fd.powers(base, n, device))


def _twiddle_matrix(n: int, root: int, device) -> torch.Tensor:
    """T[k1, j2] = root^(k1 * j2), shape (n1, n2)."""
    def build():
        n1, n2 = _split_n(n)
        w = powers(root, n, device)
        k1 = torch.arange(n1, device=device)[:, None]
        j2 = torch.arange(n2, device=device)[None, :]
        return w[(k1 * j2) % n]
    return _cached(("tmat", n, root, str(device)), build)


def _stage_table(root: int, m: int, device) -> torch.Tensor:
    """w^k, k < m/2, for the length-m column transforms (w = root)."""
    return powers(root, max(m // 2, 1), device)[: m // 2]


# elements a transform takes at once (its temporaries are some ten times
# as many)
BATCH_ELEMS = 1 << 25


def ntt_sixstep(x: torch.Tensor, n: int, root: int, pre=None, post=None):
    """Natural-order in/out NTT of a (B, n) batch with primitive n-th root
    `root`: out[b, k] = sum_j x[b, j] * pre[j] * root^(jk) * post[k], a
    few rows of the batch at a time."""
    rows = max(1, BATCH_ELEMS // n)
    if x.shape[0] > rows:
        return torch.cat([ntt_sixstep(x[i:i + rows], n, root, pre, post)
                          for i in range(0, x.shape[0], rows)])
    B = x.shape[0]
    n1, n2 = _split_n(n)
    dev = x.device
    tw1 = _stage_table(pow(root, n2, P), n1, dev)
    tw2 = _stage_table(pow(root, n1, P), n2, dev)
    y = kntt.col_ntt(x.reshape(B, n1, n2), tw1,
                     pre=None if pre is None else pre.reshape(n1, n2),
                     tmat=_twiddle_matrix(n, root, dev))
    y = y.transpose(1, 2).contiguous()  # (B, n2, n1): rows j2, columns k1
    y = kntt.col_ntt(y, tw2, tmat=None if post is None else post.reshape(n2, n1))
    return y.reshape(B, n)


class Domain:
    """Radix-2 (coset) evaluation domain {offset * g^i}, ark-compatible."""

    def __init__(self, size: int, offset: int = 1):
        assert size & (size - 1) == 0 and size > 0
        self.size = size
        self.offset = offset % P
        self.group_gen = get_root_of_unity(size).v if size > 1 else 1
        self.group_gen_inv = pow(self.group_gen, P - 2, P)
        self.offset_inv = pow(self.offset, P - 2, P)
        self.size_inv = pow(size, P - 2, P)

    def element(self, i: int) -> Fp:
        return Fp(self.offset * pow(self.group_gen, i, P))

    def elements(self, device) -> torch.Tensor:
        """offset * g^i for all i, natural order (cached per device)."""
        def build():
            g = powers(self.group_gen, self.size, device)
            return g if self.offset == 1 else fd.mul(g, self.offset)
        return _cached(("elements", self.size, self.offset, str(device)),
                       build)

    def offset_pow_size(self) -> int:
        return pow(self.offset, self.size, P)

    def fft(self, coeffs: torch.Tensor) -> torch.Tensor:
        """(..., m <= n) coefficients, natural order -> (..., n) evaluations
        over the coset, natural order (shorter inputs are zero-padded)."""
        n = self.size
        lead = coeffs.shape[:-1]
        x = coeffs.reshape(-1, coeffs.shape[-1])
        if x.shape[-1] < n:
            x = torch.nn.functional.pad(x, (0, n - x.shape[-1]))
        assert x.shape[-1] == n, f"coefficient count exceeds domain size {n}"
        pre = (None if self.offset == 1
               else powers(self.offset, n, x.device))
        if n == 1:
            return x.reshape(*lead, n).clone()
        return ntt_sixstep(x, n, self.group_gen, pre=pre).reshape(*lead, n)

    def ifft(self, evals: torch.Tensor) -> torch.Tensor:
        n = self.size
        lead = evals.shape[:-1]
        x = evals.reshape(-1, n)
        if n == 1:
            return x.reshape(*lead, n).clone()
        post = _cached(
            ("ipost", n, self.offset, str(x.device)),
            lambda: fd.mul(powers(self.offset_inv, n, x.device),
                           self.size_inv))
        return ntt_sixstep(x, n, self.group_gen_inv,
                           post=post).reshape(*lead, n)
