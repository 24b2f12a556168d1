"""Conversion between the port's u64 field tensors and the JAX package's
``(lo, hi)`` u32 limb planes.  Used at the test boundary only, so both
packages can be handed the same witness and compared value for value."""

from __future__ import annotations

import numpy as np
import torch


def from_jax_matrix(lo, hi) -> torch.Tensor:
    """(lo, hi) u32 limb arrays (numpy or JAX) -> int64 tensor of u64 bit
    patterns, same shape."""
    v = (np.asarray(lo, dtype=np.uint64)
         | (np.asarray(hi, dtype=np.uint64) << np.uint64(32)))
    return torch.from_numpy(v.view(np.int64).copy())


def to_jax_limbs(t: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """int64 tensor of u64 bit patterns -> (lo, hi) u32 numpy planes."""
    v = t.detach().cpu().numpy().view(np.uint64)
    return ((v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (v >> np.uint64(32)).astype(np.uint32))


def to_u64_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 values (the npfield representation)."""
    return t.detach().cpu().numpy().view(np.uint64).copy()


def from_u64_numpy(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64)
                            .view(np.int64).copy())
