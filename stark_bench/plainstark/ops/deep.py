"""The DEEP sum over the LDE domain (``deep``, ``deep_ext3``) and the OOD
barycentric sums (``ood_sums``, ``ood_sums_ext3``), in plain PyTorch."""

from __future__ import annotations

import torch

from ..fields import device as fd

# columns the OOD sums multiply by the weights at once, as (columns, 3, n)
# elements: bounds the temporaries
PLAIN_OOD_ELEMS = 1 << 26


def deep(cols, invs, s, x):
    T = len(cols)
    sv = s.tolist()
    acc = torch.zeros_like(x)
    for t in range(T):
        d = fd.sub(torch.full_like(x, sv[2 * t]), cols[t])
        acc = fd.add(acc, fd.mul(fd.mul(d, invs[t]), s[2 * t + 1]))
    return fd.mul(acc, fd.add(fd.mul(x, s[2 * T + 1]), s[2 * T]))


def deep_ext3(cols, invs, s, x):
    T = len(cols)
    sc = s.reshape(-1, 3, 1)  # one (3, 1) Fq3 scalar per slot triple
    acc = torch.zeros((3, x.shape[0]), dtype=torch.int64, device=x.device)
    for t in range(T):
        ood, alpha = sc[2 * t], sc[2 * t + 1]
        c = cols[t] if cols[t].ndim == 2 else fd.ext3_from_base(cols[t])
        q = fd.ext3_mul(fd.sub(ood, c), invs[t])
        acc = fd.add(acc, fd.ext3_mul(q, alpha))
    adj = fd.add(sc[2 * T], fd.ext3_mul_base(sc[2 * T + 1], x))
    return fd.ext3_mul(acc, adj)


def _plain_sums(cols, invs, pairs, gpow, ext: bool):
    """sum_i cols[c][i] * invs[j][i] * gpow[i] for each pair (j, c), a few
    columns at a time: point by point, its columns' products with the
    weights w = invs[j] * gpow, summed by ``fd.sum_mod``."""
    n = gpow.shape[-1]
    step = max(1, PLAIN_OOD_ELEMS // (3 * n))
    out: dict = {}
    if not pairs:
        return torch.zeros((3, 0) if ext else (0,), dtype=torch.int64,
                           device=gpow.device)
    for j in sorted({j for j, _c in pairs}):
        w = (fd.ext3_mul_base(invs[j], gpow) if ext
             else fd.mul(invs[j], gpow))
        ks = [k for k, (jj, _c) in enumerate(pairs) if jj == j]
        base = [k for k in ks if cols[pairs[k][1]].ndim == 1]
        wide = [k for k in ks if cols[pairs[k][1]].ndim == 2]
        for group, times_w in ((base, (lambda t: fd.ext3_mul_base(w, t))
                                if ext else (lambda t: fd.mul(t, w))),
                               (wide, lambda t: fd.ext3_mul(t, w))):
            for a in range(0, len(group), step):
                part = group[a:a + step]
                t = torch.stack([cols[pairs[k][1]] for k in part])
                out.update(zip(part, fd.sum_mod(times_w(t), dim=-1)))
    return torch.stack([out[k] for k in range(len(pairs))], dim=-1)


def ood_sums(cols, invs, pairs, gpow):
    return _plain_sums(cols, invs, pairs, gpow, False)


def ood_sums_ext3(cols, invs, pairs, gpow):
    return _plain_sums(cols, invs, pairs, gpow, True)
