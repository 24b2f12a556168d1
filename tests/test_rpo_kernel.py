"""Pallas RPO-256 kernel (ops/rpo256_pallas.py) vs the host scalar
implementation, in interpret mode on CPU — the same pinning strategy the
SHA lanes / NTT kernels use (tests/test_ntt_kernels.py)."""

import numpy as np
import jax.numpy as jnp
import pytest

from ministark_tpu import hash_rpo
from ministark_tpu.fields import Fp, P
from ministark_tpu.fields import device as fd
from ministark_tpu.ops import rpo256_pallas as rpl

RNG = np.random.default_rng(2024)


def _state_lanes(vals):
    """(n, 12) u64 -> lane-major (12, n) limb pairs."""
    lo = jnp.asarray((vals.T & 0xFFFFFFFF).astype(np.uint32))
    hi = jnp.asarray((vals.T >> 32).astype(np.uint32))
    return lo, hi


def test_permute_lanes_matches_host():
    n = 256  # 2D kernel path
    vals = RNG.integers(0, P, size=(n, 12), dtype=np.uint64)
    lo, hi = _state_lanes(vals)
    olo, ohi = rpl.permute_lanes(lo, hi, interpret=True)
    got = (np.asarray(olo, np.uint64)
           | (np.asarray(ohi, np.uint64) << np.uint64(32)))
    for b in [0, 1, 17, 255]:
        want = hash_rpo._permute([int(v) for v in vals[b]])
        assert got[:, b].tolist() == want, f"lane {b}"


def test_permute_lanes_packed_matches_host():
    n = 1024  # sublane-packed (12, 8, n/8) path
    vals = RNG.integers(0, P, size=(n, 12), dtype=np.uint64)
    lo, hi = _state_lanes(vals)
    olo, ohi = rpl.permute_lanes(lo, hi, interpret=True)
    got = (np.asarray(olo, np.uint64)
           | (np.asarray(ohi, np.uint64) << np.uint64(32)))
    for b in [0, 5, 513, 1023]:
        want = hash_rpo._permute([int(v) for v in vals[b]])
        assert got[:, b].tolist() == want, f"lane {b}"


def test_permute_lanes_boundary_values():
    """Worst-case operands for the lazy-reduction chains: 0, 1, p-1, p-2,
    2^32-1, 2^32, p-2^32 in every state slot."""
    specials = np.array([0, 1, P - 1, P - 2, (1 << 32) - 1, 1 << 32,
                         P - (1 << 32), 12345], dtype=np.uint64)
    n = 128
    vals = np.zeros((n, 12), dtype=np.uint64)
    for i in range(n):
        vals[i] = specials[(np.arange(12) + i) % len(specials)]
    lo, hi = _state_lanes(vals)
    olo, ohi = rpl.permute_lanes(lo, hi, interpret=True)
    got = (np.asarray(olo, np.uint64)
           | (np.asarray(ohi, np.uint64) << np.uint64(32)))
    for b in [0, 1, 7, 127]:
        want = hash_rpo._permute([int(v) for v in vals[b]])
        assert got[:, b].tolist() == want, f"lane {b}"


def test_hash_columns_lanes_matches_host():
    for ncols in [3, 8, 11]:
        n = 128
        vals = RNG.integers(0, P, size=(ncols, n), dtype=np.uint64)
        cols = [tuple(map(jnp.asarray, fd.pack_np(vals[c])))
                for c in range(ncols)]
        words = np.asarray(rpl.hash_columns_lanes(cols, interpret=True))
        for r in [0, 63, 127]:
            want = hash_rpo.hash_elements(
                [Fp(int(vals[c, r])) for c in range(ncols)])
            got = b"".join(
                (int(words[2 * k, r]) | (int(words[2 * k + 1, r]) << 32))
                .to_bytes(8, "little") for k in range(4))
            assert got == want, f"ncols={ncols} row={r}"


# 394 s: XLA:CPU compiling the JAX package's interpret-mode kernel (8 CPUs).
@pytest.mark.slow
def test_commit_matrix_rpo_kernel_dispatch(monkeypatch):
    """merkle.commit_matrix_fp with the RPO hash produces the same tree
    through the Pallas kernel path (MINISTARK_TPU_RPO=interpret) as through
    the XLA path — root and proof bytes identical."""
    from ministark_tpu import hash_rpo, merkle

    n, ncols = 512, 3
    vals = RNG.integers(0, P, size=(ncols, n), dtype=np.uint64)
    lo, hi = map(jnp.asarray, fd.pack_np(vals))

    merkle._COMMIT_PROGRAMS.pop(("rpo-fp", (ncols, n), False), None)
    tree_xla = merkle.commit_matrix_fp(lo, hi, hashfn=hash_rpo)
    root_xla = tree_xla.root()
    proof_xla = tree_xla.prove([3, 100, 511])

    monkeypatch.setenv("MINISTARK_TPU_RPO", "interpret")
    merkle._COMMIT_PROGRAMS.pop(("rpo-fp", (ncols, n), False), None)
    tree_k = merkle.commit_matrix_fp(lo, hi, hashfn=hash_rpo)
    assert tree_k.root() == root_xla
    pk = tree_k.prove([3, 100, 511])
    assert (pk.nodes, pk.initial_leaves, pk.sibling_leaves, pk.height) == (
        proof_xla.nodes, proof_xla.initial_leaves, proof_xla.sibling_leaves,
        proof_xla.height)
    merkle._COMMIT_PROGRAMS.pop(("rpo-fp", (ncols, n), False), None)


def test_merge_and_tree_match_xla_path():
    """The lane-major Pallas tree equals the XLA tree level-by-level."""
    from ministark_tpu.ops import rpo256

    n = 512
    leaves = RNG.integers(0, P, size=(n, 4), dtype=np.uint64)
    lo, hi = map(jnp.asarray, fd.pack_np(leaves))
    words = jnp.stack([lo, hi], axis=2).reshape(n, 8)

    # XLA reference levels (natural sibling order)
    cur = words
    xla_levels = [cur]
    while cur.shape[0] > 1:
        left = (cur[0::2, 0::2], cur[0::2, 1::2])
        right = (cur[1::2, 0::2], cur[1::2, 1::2])
        dg = rpo256.merge_digests(left, right)
        cur = jnp.stack([dg[0], dg[1]], axis=2).reshape(cur.shape[0] // 2, 8)
        xla_levels.append(cur)

    # Pallas lane-major merge with the same sibling order
    lanes = jnp.transpose(words)
    cur_l = lanes
    for lvl in range(1, 3):
        cur_l = rpl.merge_lanes(cur_l[:, 0::2], cur_l[:, 1::2],
                                interpret=True)
        assert np.array_equal(np.asarray(cur_l),
                              np.asarray(jnp.transpose(xla_levels[lvl]))), lvl
