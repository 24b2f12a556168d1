"""The distributed six-step NTT over the ranks of a mesh (mirrors
``ministark_tpu.parallel.ntt``).

A vector of n points is held as contiguous (n / d) blocks in natural
order, rank r holding [r n / d, (r + 1) n / d).  View it as the (n1, n2)
matrix M[j1, j2] = x[j1 n2 + j2] (``ntt._split_n``), so rank r holds the
rows j1 of its block of n1 / d.  Then, as the one-process
``ntt.ntt_sixstep`` does on one device:

  1. all_to_all: the row block -> the (n1, n2 / d) slab of columns j2 of
     rank r's block of n2 / d;
  2. column NTTs of length n1 on the slab (kernel B, ``ops.ntt.col_ntt``;
     its plain version for CPU tensors), the coset scale folded in before
     and the six-step twiddles T[k1, j2] = w^(k1 j2) after;
  3. all_to_all: rows k1 of rank r's block of n1 / d, and the local
     transpose (kernel C) to the (n2, n1 / d) slab;
  4. column NTTs of length n2 (kernel B), 1/n and the coset unscale
     folded in after for the inverse;
  5. all_to_all: D[k2, k1] back to contiguous natural-order blocks,
     out[k2 n1 + k1].

Three all_to_alls of n / d elements a rank.  The slabs of the twiddles and
of the coset scales are built once per (n, root or offset, rank, device),
each from two short power tables, never from an n-point one but the
twiddles' (shared with the one-process NTT's cache).  Inputs are (..., n / d):
an Fp block (n / d,), an Fq3 block (3, n / d), or any batch of them.
"""

from __future__ import annotations

import torch

from ..fields import device as fd
from ..fields.scalar import P
from ..ntt import Domain, _cached, _split_n, _stage_table, powers
from ..ops import ntt as kntt
from ..ops import transpose as ktr


def _outer_powers(a: int, rows: int, b: int, cols: int, scale: int,
                  device) -> torch.Tensor:
    """T[i, j] = scale * a^i * b^j, shape (rows, cols)."""
    left = fd.powers(a % P, rows, device)
    right = fd.mul(fd.powers(b % P, cols, device), scale % P)
    return fd.mul(left[:, None], right[None, :])


class ShardedDomain:
    """The (coset) domain {offset g^i} of ``ntt.Domain`` with transforms
    that run over the ranks of `mesh` on contiguous natural-order blocks."""

    def __init__(self, mesh, size: int, offset: int = 1):
        self.mesh = mesh
        self.d = mesh.d
        self.dom = Domain(size, offset)
        self.n = size
        self.n1, self.n2 = _split_n(size)
        assert self.n1 % self.d == 0 and self.n2 % self.d == 0, (
            "the world size must divide both six-step factors")

    # -- the per-rank slabs of the tables -----------------------------------

    def _key(self, what, value):
        return ("sharded", what, self.n, value, self.d, self.mesh.rank,
                str(self.mesh.device))

    def _tmat(self, root: int) -> torch.Tensor:
        """T[k1, j2] = root^(k1 j2) on this rank's columns j2: (n1, n2/d)."""
        n, n1, w = self.n, self.n1, self.n2 // self.d
        dev = self.mesh.device

        def build():
            k1 = torch.arange(n1, device=dev)[:, None]
            j2 = torch.arange(w, device=dev)[None, :] + self.mesh.rank * w
            return powers(root, n, dev)[(k1 * j2) % n]
        return _cached(self._key("tmat", root), build)

    def _pre(self) -> torch.Tensor | None:
        """offset^j, j = j1 n2 + j2, on this rank's columns: (n1, n2/d)."""
        off = self.dom.offset
        if off == 1:
            return None
        n1, n2, w = self.n1, self.n2, self.n2 // self.d
        return _cached(self._key("pre", off), lambda: _outer_powers(
            pow(off, n2, P), n1, off, w, pow(off, self.mesh.rank * w, P),
            self.mesh.device))

    def _post(self) -> torch.Tensor:
        """(1/n) offset^-k, k = k2 n1 + k1, on this rank's rows k1:
        (n2, n1/d)."""
        inv, n1, n2 = self.dom.offset_inv, self.n1, self.n2
        w = n1 // self.d
        scale = self.dom.size_inv * pow(inv, self.mesh.rank * w, P)
        return _cached(self._key("post", inv), lambda: _outer_powers(
            pow(inv, n1, P), n2, inv, w, scale, self.mesh.device))

    # -- the transforms ------------------------------------------------------

    def _pipeline(self, x: torch.Tensor, root: int, pre=None, post=None):
        n, n1, n2, d = self.n, self.n1, self.n2, self.d
        assert x.shape[-1] == n // d, (tuple(x.shape), n, d)
        lead = x.shape[:-1]
        B = x.numel() // (n // d)
        dev = x.device
        mesh = self.mesh
        # 1) rows j1 of my block -> columns j2 of my block
        t = x.reshape(B, n1 // d, d, n2 // d).permute(2, 0, 1, 3)
        t = mesh.all_to_all(t)  # [src (j1 block), b, j1_loc, j2_loc]
        t = t.transpose(0, 1).reshape(B, n1, n2 // d)
        # 2) column NTTs along j1, coset scale in, six-step twiddles out
        t = kntt.col_ntt(t, _stage_table(pow(root, n2, P), n1, dev),
                         pre=pre, tmat=self._tmat(root))
        # 3) rows k1 of my block, then the local transpose
        t = mesh.all_to_all(t.reshape(B, d, n1 // d, n2 // d).transpose(0, 1))
        t = ktr.transpose(t.transpose(0, 1).reshape(B * d, n1 // d, n2 // d))
        t = t.reshape(B, n2, n1 // d)  # [b, j2, k1_loc]
        # 4) column NTTs along j2 (the inverse's 1/n and unscale out)
        t = kntt.col_ntt(t, _stage_table(pow(root, n1, P), n2, dev),
                         tmat=post)
        # 5) D[k2, k1] -> contiguous natural order, out[k2 n1 + k1]
        t = mesh.all_to_all(t.reshape(B, d, n2 // d, n1 // d).transpose(0, 1))
        return t.permute(1, 2, 0, 3).reshape(*lead, n // d)

    def fft(self, coeffs: torch.Tensor) -> torch.Tensor:
        """This rank's block of natural-order coefficients -> its block of
        the evaluations over the coset (``Domain.fft``)."""
        return self._pipeline(coeffs, self.dom.group_gen, pre=self._pre())

    def ifft(self, evals: torch.Tensor) -> torch.Tensor:
        """The inverse (``Domain.ifft``), block for block."""
        return self._pipeline(evals, self.dom.group_gen_inv,
                              post=self._post())
