"""Big prime field vectors on the device: Montgomery limb arrays over the
128-bit STARK-Anatomy prime and the 252-bit StarkWare prime, with their
radix-2 coset NTT (mirrors ``ministark_tpu.fields.bigvec``; the
counterpart of the reference's generic Montgomery GPU field,
gpu/src/metal/felt_u128.h.metal and felt_u256.h.metal, and its FFT,
gpu/src/plan.rs).

An array of n elements is an (L, n) int64 tensor of u64 limbs holding the
Montgomery form v R mod p, R = 2^(64 L): L = 2 for Fp128, 4 for Fp252
(the JAX package holds 16-bit limbs in uint32 with the same R =
2^(16 L16), so the Montgomery values are identical and only the limb
width differs; ``fields.convert`` regroups them).  More leading axes
than the limb axis are batch axes: (L, *batch).  The products and the
transforms go through the hand-written kernels on CUDA tensors
(``ops.bigfield``); sums, differences and negation are plain torch, as in
the JAX package.  ``pack`` and ``unpack`` convert at the host boundary
with exact bigint math and put the limbs on the card unless given a
``device``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import bigfield as kbig
from .device import resolve_device
from .fp128 import GENERATOR128, P128, TWO_ADICITY128
from .fp252 import GENERATOR252, P252, TWO_ADICITY252


class BigField:
    """A prime field instance: modulus, limbs, Montgomery constants, and
    the vectorized operations over (L64, *batch) limb tensors."""

    def __init__(self, name: str, modulus: int, generator: int,
                 two_adicity: int):
        assert modulus % 2 == 1
        self.name = name
        self.p = modulus
        self.generator = generator
        self.two_adicity = two_adicity
        self.L64 = -(-modulus.bit_length() // 64)
        self.R = 1 << (64 * self.L64)
        assert self.R > modulus
        self.R_inv = pow(self.R, -1, modulus)
        self.p_words32 = [(modulus >> (32 * j)) & 0xFFFFFFFF
                          for j in range(2 * self.L64)]
        self.n0inv32 = (-pow(modulus, -1, 1 << 32)) % (1 << 32)
        n0inv64 = (-pow(modulus, -1, 1 << 64)) % (1 << 64)
        # the kernels' description of the modulus: its limbs, then n0inv
        self.mod_desc = (modulus.to_bytes(8 * self.L64, "little")
                         + n0inv64.to_bytes(8, "little"))
        self.two_adic_root = pow(generator, (modulus - 1) >> two_adicity,
                                 modulus)

    # -- host <-> device -----------------------------------------------------

    def _limbs(self, mont: list[int], device) -> torch.Tensor:
        nb = 8 * self.L64
        raw = b"".join(v.to_bytes(nb, "little") for v in mont)
        a = np.frombuffer(raw, dtype=np.int64).reshape(len(mont), self.L64)
        return torch.from_numpy(a.T.copy()).to(device)

    def pack(self, values, device=None) -> torch.Tensor:
        """Canonical ints -> (L64, n) Montgomery limbs on `device` (the
        card unless given)."""
        dev = resolve_device(device)
        return self._limbs([(int(v) % self.p) * self.R % self.p
                            for v in values], dev)

    def pack_scalar(self, value: int, device=None) -> torch.Tensor:
        """One canonical value -> (L64,) Montgomery limbs."""
        return self.pack([value], device)[:, 0]

    def unpack(self, limbs: torch.Tensor) -> list[int]:
        """(L64, *batch) Montgomery limbs -> canonical ints (batch order)."""
        a = limbs.detach().reshape(self.L64, -1).T.contiguous().cpu()
        raw = a.numpy().tobytes()
        nb = 8 * self.L64
        return [int.from_bytes(raw[i:i + nb], "little") * self.R_inv % self.p
                for i in range(0, len(raw), nb)]

    # -- device operations ----------------------------------------------------

    def zeros(self, shape, device=None) -> torch.Tensor:
        return torch.zeros((self.L64, *shape), dtype=torch.int64,
                           device=resolve_device(device))

    def ones(self, shape, device=None) -> torch.Tensor:
        """Montgomery ONE = R mod p, broadcast to shape."""
        one = self.pack_scalar(1, device)
        return one.reshape(self.L64, *([1] * len(shape))).expand(
            self.L64, *shape).contiguous()

    def add(self, a, b):
        return kbig.add_plain(a, b, self)

    def sub(self, a, b):
        return kbig.sub_plain(a, b, self)

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def is_zero(self, a):
        return (a == 0).all(0)

    def mul(self, a, b):
        """Montgomery product (a b R^-1: canonical values map to canonical
        products) of limb tensors that broadcast."""
        shape = torch.broadcast_shapes(a.shape, b.shape)
        if a.shape[1:].numel() == 1 and shape[1:].numel() > 1:
            a, b = b, a  # the scalar operand second
        flat = a.expand(shape).reshape(self.L64, -1)
        scalar = b.shape[1:].numel() == 1 and flat.shape[1] > 1
        other = (b.reshape(self.L64, 1) if scalar
                 else b.expand(shape).reshape(self.L64, -1))
        return kbig.big_mul(flat, other, self).reshape(shape)

    def square(self, a):
        return self.mul(a, a)

    def pow(self, a, e: int):
        """a^e for a Python-int exponent (square-and-multiply)."""
        result = None
        base = a
        while e:
            if e & 1:
                result = base if result is None else self.mul(result, base)
            e >>= 1
            if e:
                base = self.square(base)
        if result is None:
            return self.ones(a.shape[1:], a.device)
        return result

    def inverse(self, a):
        """Elementwise inverse by Fermat (undefined at 0)."""
        return self.pow(a, self.p - 2)

    def batch_inverse(self, a):
        """Montgomery-trick batch inverse along the last axis (one Fermat
        inversion in all).  Zeros are NOT tolerated."""
        n = a.shape[-1]
        if n == 1:
            return self.inverse(a)
        prefix = [a[..., 0]]
        for k in range(1, n):
            prefix.append(self.mul(prefix[-1], a[..., k]))
        inv_all = self.inverse(prefix[-1])
        out = [None] * n
        for k in range(n - 1, 0, -1):
            out[k] = self.mul(inv_all, prefix[k - 1])
            inv_all = self.mul(inv_all, a[..., k])
        out[0] = inv_all
        return torch.stack(out, dim=-1)


class BigDomain:
    """Radix-2 (coset) evaluation domain over a BigField: the counterpart
    of the reference's generic-field GPU FFT.  Values in and out are
    (L64, n) Montgomery limb tensors in natural order; the transform runs
    through ``ops.bigfield.big_ntt`` (a launch a pass of up to 2^9 points,
    or its plain version on the CPU).  Tables are built on the host with
    exact bigint math and cached per device, the kernel's twiddle table
    beside them on the card."""

    def __init__(self, field: BigField, size: int, offset: int = 1):
        assert size & (size - 1) == 0, "size must be a power of two"
        k = size.bit_length() - 1
        assert k <= field.two_adicity
        self.field = field
        self.size = size
        self.offset = offset % field.p
        self.group_gen = pow(field.two_adic_root,
                             1 << (field.two_adicity - k), field.p)
        self.group_gen_inv = pow(self.group_gen, -1, field.p)
        self.size_inv = pow(size, -1, field.p)

    def element(self, i: int) -> int:
        return self.offset * pow(self.group_gen, i, self.field.p) % self.field.p

    def _powers(self, base: int, n: int, scale: int = 1) -> list[int]:
        p, out, w = self.field.p, [], scale % self.field.p
        for _ in range(n):
            out.append(w)
            w = w * base % p
        return out

    @functools.lru_cache(maxsize=None)
    def _tables(self, inverse: bool, device: str):
        """(twiddles w^j for j < n/2, scale_first, scale_last) packed on
        `device`: the coset's powers before a forward transform, offset^-i
        n^-1 after an inverse one, None where not needed."""
        f, n = self.field, self.size
        root = self.group_gen_inv if inverse else self.group_gen
        tw = f.pack(self._powers(root, n // 2), device)
        if inverse:
            last = f.pack(self._powers(pow(self.offset, -1, f.p), n,
                                       self.size_inv), device)
            return tw, None, last
        first = (None if self.offset == 1
                 else f.pack(self._powers(self.offset, n), device))
        return tw, first, None

    @functools.lru_cache(maxsize=None)
    def _kernel_table(self, inverse: bool, device: str):
        """The kernel's twiddle table and pass count on `device` (a card),
        from the twiddles of ``_tables``."""
        tw = self._tables(inverse, device)[0]
        return kbig.twiddle_table(tw, self.field, self.size)

    def _transform(self, x, inverse: bool):
        f, n = self.field, self.size
        assert tuple(x.shape) == (f.L64, n)
        dev = str(x.device)
        tw, first, last = self._tables(inverse, dev)
        table = self._kernel_table(inverse, dev) if x.is_cuda else None
        return kbig.big_ntt(x, tw, f, first, last, table)

    def fft(self, coeffs):
        return self._transform(coeffs, inverse=False)

    def ifft(self, evals):
        return self._transform(evals, inverse=True)

    def __hash__(self):
        return hash((self.field.name, self.size, self.offset))

    def __eq__(self, o):
        return (self.field is o.field and self.size == o.size
                and self.offset == o.offset)


# -- concrete instances (the reference's two big-field families) -------------

Fp128Vec = BigField("Fp128", P128, GENERATOR128, TWO_ADICITY128)
Fp252Vec = BigField("Fp252", P252, GENERATOR252, TWO_ADICITY252)
