"""The port's SHA-256 and Merkle layer (plain versions of kernel D) against
the JAX package's host hash (``ministark_tpu.hash``) and its host Merkle
verifier, on numpy inputs from a fixed seed.

torch and the port are imported inside the tests, so collecting this file
stays cheap in every pytest-xdist worker.
"""

import numpy as np
import pytest

from ministark_tpu import hash as H
from ministark_tpu import merkle as jax_merkle
from ministark_tpu.fields.scalar import Fp, P
from ministark_tpu.ntt import bit_reverse_index


def _matrix(seed, ncols, n):
    return np.random.default_rng(seed).integers(0, P, size=(ncols, n),
                                                dtype=np.uint64)


@pytest.mark.parametrize("ncols", [1, 4, 8, 9])
def test_row_hashes_match_hash_elements(ncols):
    """Column-major matrix rows (a strided view), as the trace commit
    hashes them; 9 columns span three SHA blocks."""
    from ministark_tpu_torch.fields.convert import from_u64_numpy
    from ministark_tpu_torch.ops import sha256 as ksha

    m = _matrix(ncols, ncols, 33)
    got = ksha.hash_rows(from_u64_numpy(m).T).numpy()
    for i in range(m.shape[1]):
        want = H.hash_elements([Fp(int(v)) for v in m[:, i]])
        assert got[i].tobytes() == want, i


def test_row_major_rows_and_merges_match_host_sha():
    """FRI layer rows (row-major, N per row) and 64-byte Merkle merges."""
    from ministark_tpu_torch.fields.convert import from_u64_numpy
    from ministark_tpu_torch.ops import sha256 as ksha

    rows = _matrix(21, 16, 4).T.copy()  # (16 rows, 4 elements)
    got = ksha.hash_rows(from_u64_numpy(rows)).numpy()
    for i, row in enumerate(rows):
        assert got[i].tobytes() == H.hash_elements([Fp(int(v)) for v in row])
    import torch

    rng = np.random.default_rng(22)
    left = rng.integers(0, 256, size=(40, 32), dtype=np.uint8)
    right = rng.integers(0, 256, size=(40, 32), dtype=np.uint8)
    merged = ksha.merge(torch.from_numpy(left), torch.from_numpy(right)).numpy()
    for i in range(40):
        assert merged[i].tobytes() == H.merge(left[i].tobytes(),
                                              right[i].tobytes())


def _host_tree(m):
    """Reference tree over the protocol's bit-reversed leaf order, from the
    JAX package's host hash: heap layout, nodes[1] = root."""
    n = m.shape[1]
    leaves = [H.hash_elements([Fp(int(v)) for v in m[:, bit_reverse_index(n, j)]])
              for j in range(n)]
    nodes = [b""] * n + leaves
    for i in range(n - 1, 0, -1):
        nodes[i] = H.merge(nodes[2 * i], nodes[2 * i + 1])
    return nodes


@pytest.mark.parametrize("n", [2, 64, 1024])
def test_commit_root_and_multiproofs(n):
    """Roots match a host tree; multi-proofs pass the JAX package's
    verify_view and the port's; a tampered node is rejected."""
    from ministark_tpu_torch import merkle
    from ministark_tpu_torch.fields.convert import from_u64_numpy

    m = _matrix(n, 3, n)
    tree = merkle.commit_matrix(from_u64_numpy(m))
    nodes = _host_tree(m)
    assert tree.root() == nodes[1]
    rng = np.random.default_rng(n + 1)
    idx = sorted(set(int(i) for i in rng.integers(0, n, size=min(n, 12))))
    view = tree.prove(idx)
    assert view.initial_leaves == [nodes[n + i] for i in idx]
    jax_view = jax_merkle.MerkleView(view.nodes, view.initial_leaves,
                                     view.sibling_leaves, view.height)
    jax_merkle.verify_view(tree.root(), jax_view, idx)
    merkle.verify_view(tree.root(), view, idx)

    from ministark_tpu_torch import serde
    w = serde.Writer()
    view.serialize(w)
    again = merkle.MerkleView.deserialize(serde.Reader(w.bytes()))
    assert again == view

    leaf0 = bytes([view.initial_leaves[0][0] ^ 1]) + view.initial_leaves[0][1:]
    bad = merkle.MerkleView(view.nodes, [leaf0] + view.initial_leaves[1:],
                            view.sibling_leaves, view.height)
    with pytest.raises(merkle.InvalidProof):
        merkle.verify_view(tree.root(), bad, idx)


def test_leaf_order_tree_matches_host_tree():
    """FRI layers commit leaves already in leaf order."""
    import torch

    from ministark_tpu_torch import merkle

    rng = np.random.default_rng(31)
    leaves = rng.integers(0, 256, size=(32, 32), dtype=np.uint8)
    tree = merkle.CommittedMerkleTree.from_leaf_digests(torch.from_numpy(leaves))
    nodes = [b""] * 32 + [row.tobytes() for row in leaves]
    for i in range(31, 0, -1):
        nodes[i] = H.merge(nodes[2 * i], nodes[2 * i + 1])
    assert tree.root() == nodes[1]
    view = tree.prove([3, 4, 17])
    assert view.initial_leaves == [nodes[32 + i] for i in (3, 4, 17)]
    merkle.verify_view(tree.root(), view, [3, 4, 17])
