"""Scalar polynomial helpers (reference: src/utils.rs:53-204)."""

from __future__ import annotations


def horner_evaluate(coeffs, x):
    """sum coeffs[i] x^i (src/utils.rs:121-131)."""
    acc = type(x).zero()
    for c in reversed(list(coeffs)):
        acc = acc * x + c
    return acc


def divide_out_point(coeffs, z, c):
    """c * (P(X) - P(z)) / (X - z) by synthetic division
    (src/utils.rs:151-161). Returns new coefficient list."""
    out = [None] * len(coeffs)
    remainder = type(z).zero()
    for i in range(len(coeffs) - 1, -1, -1):
        out[i] = remainder * c
        remainder = remainder * z + coeffs[i]
    return out


def evaluate_vanishing_polynomial(domain, tau):
    """tau^n - offset^n (src/utils.rs:86-91)."""
    from ..fields.scalar import Fp

    return tau ** domain.size - Fp(domain.offset_pow_size())


def interleave(source, radix: int):
    """[a0..an] -> [[a0, a_{n/r}, ...], ...] (src/utils.rs:53-66)."""
    n = len(source) // radix
    return [[source[i + j * n] for j in range(radix)] for i in range(n)]


def reduce_lde_blowup_factor(lde: list, blowup_from: int, blowup_to: int) -> list:
    """Decimate an LDE to a smaller blowup (src/utils.rs:184-204)."""
    assert blowup_from % blowup_to == 0
    r = blowup_from // blowup_to
    return lde[::r]
