"""Test fixtures (reference: src/utils.rs:598-655).

Each returns a port ``Matrix`` on `device`, the card unless the caller
names another."""

from __future__ import annotations

import numpy as np

from ..fields.scalar import P
from ..matrix import Matrix


def gen_fib_matrix(n: int, device=None) -> Matrix:
    """Two-column fibonacci-style matrix (src/utils.rs:617-631)."""
    c0 = np.zeros(n, dtype=np.uint64)
    c1 = np.zeros(n, dtype=np.uint64)
    c0[0], c1[0] = 1, 1
    for i in range(1, n):
        c0[i] = (int(c0[i - 1]) + int(c1[i - 1])) % P
        c1[i] = (int(c0[i]) + int(c1[i - 1])) % P
    return Matrix.from_columns_np([c0, c1], device)


def gen_binary_valued_matrix(n: int, v1: int, v2: int, seed: int = 0,
                             device=None) -> Matrix:
    """Single column of random picks from {v1, v2} (src/utils.rs:649-655)."""
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, 2, n)
    col = np.where(picks == 1, np.uint64(v1 % P), np.uint64(v2 % P))
    return Matrix.from_columns_np([col], device)
