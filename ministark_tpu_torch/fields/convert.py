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


def from_jax_big_limbs(limbs16) -> torch.Tensor:
    """The JAX package's big-field limbs ((L16, n) uint32, 16 bits each,
    ``ministark_tpu.fields.bigvec``) -> the port's (L16 / 4, n) int64 u64
    limbs (``fields.bigvec``): four 16-bit limbs a u64, the same
    Montgomery values."""
    a = np.asarray(limbs16, dtype=np.uint64)
    L16 = a.shape[0]
    if L16 % 4:
        raise ValueError(f"need a multiple of four 16-bit limbs, got {L16}")
    q = a.reshape(L16 // 4, 4, *a.shape[1:])
    v = (q[:, 0] | (q[:, 1] << np.uint64(16)) | (q[:, 2] << np.uint64(32))
         | (q[:, 3] << np.uint64(48)))
    return torch.from_numpy(v.view(np.int64).copy())


def to_jax_big_limbs(t: torch.Tensor) -> np.ndarray:
    """The port's (L64, n) int64 u64 limbs -> (4 L64, n) uint32 16-bit
    limbs, the JAX package's layout."""
    v = t.detach().cpu().numpy().view(np.uint64)
    parts = [(v >> np.uint64(16 * j)) & np.uint64(0xFFFF) for j in range(4)]
    return np.stack(parts, axis=1).reshape(4 * v.shape[0],
                                           *v.shape[1:]).astype(np.uint32)
