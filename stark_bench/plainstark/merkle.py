"""SHA-256 Merkle commitments: the tree built level by level on torch
tensors, plus host multi-proofs (reference: src/merkle.rs).

Levels are stored in TREE-BITREV order: storage row p of a level holds
node bitrev(p), so the two children of every node sit in the two
contiguous halves of the level below and each level is one merge of two
halves.  For the protocol's bit-reversed leaf order the natural row
digests ARE that storage.  Digests are (m, 32) uint8 tensors; only roots
and queried nodes reach the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import hash as H
from .ntt import bit_reverse_index, permute_bitrev
from .ops import sha256 as ksha


@dataclass
class MerkleView:
    """Multi-path proof (src/merkle.rs:68-81)."""
    nodes: list[bytes]
    initial_leaves: list[bytes]
    sibling_leaves: list[bytes]
    height: int

    def serialize(self, w):
        w.digest_vec(self.nodes)
        w.digest_vec(self.initial_leaves)
        w.digest_vec(self.sibling_leaves)
        w.u32(self.height)

    @staticmethod
    def deserialize(r) -> "MerkleView":
        return MerkleView(r.digest_vec(), r.digest_vec(), r.digest_vec(), r.u32())


# levels of at most this many digests are merged on the host (hashlib)
HOST_LEVEL = 1 << 12


def tree_levels(storage: torch.Tensor) -> list[torch.Tensor]:
    """All levels from leaf digests in tree-bitrev storage order: each level
    merges its two contiguous halves, as tensors down to ``HOST_LEVEL``
    digests and with ``hashlib`` above that."""
    levels = [storage]
    cur = storage
    while cur.shape[0] > HOST_LEVEL:
        half = cur.shape[0] // 2
        cur = ksha.merge(cur[:half], cur[half:])
        levels.append(cur)
    digests = [bytes(row) for row in cur.cpu().numpy()]
    while len(digests) > 1:
        half = len(digests) // 2
        digests = [H.merge(a, b) for a, b in zip(digests[:half],
                                                  digests[half:])]
        levels.append(torch.frombuffer(bytearray(b"".join(digests)),
                                       dtype=torch.uint8)
                      .reshape(-1, 32).to(storage.device))
    return levels


class CommittedMerkleTree:
    """A built tree whose levels stay on the device; decommits fetch the
    needed nodes with one gather per level."""

    def __init__(self, levels: list[torch.Tensor]):
        self.levels = levels
        self.n = int(levels[0].shape[0])
        assert self.n & (self.n - 1) == 0 and self.n >= 2
        self._root = None

    @staticmethod
    def from_leaf_digests(leaves: torch.Tensor) -> "CommittedMerkleTree":
        """Leaves given in leaf order -> tree-bitrev storage (one permute)."""
        return CommittedMerkleTree(
            tree_levels(permute_bitrev(leaves, dim=0)))

    @property
    def height(self) -> int:
        return self.n.bit_length() - 1

    def _fetch_many(self, wants: dict) -> dict:
        """{level: indices} -> {(level, index): digest bytes}."""
        out = {}
        for lvl, ix in wants.items():
            if not ix:
                continue
            m = self.n >> lvl
            idx = torch.tensor([bit_reverse_index(m, i) for i in ix],
                               dtype=torch.int64,
                               device=self.levels[lvl].device)
            block = self.levels[lvl].index_select(0, idx).cpu().numpy()
            for i, row in zip(ix, block):
                out[(lvl, i)] = row.tobytes()
        return out

    def root(self) -> bytes:
        if self._root is None:
            self._root = self.levels[-1][0].cpu().numpy().tobytes()
        return self._root

    # -- multi-proof generation (queue algorithm, src/merkle.rs:149-207) -----

    def _plan(self, idx: list[int]):
        """Queue simulation on indices only: (initial leaf indices, sibling
        leaf indices, internal-node flat indices) in emission order."""
        n = self.n
        initial: list[int] = []
        siblings: list[int] = []
        node_queue: list[int] = []
        qi = 0
        leaf_queue = list(idx)
        while qi < len(leaf_queue):
            index = leaf_queue[qi]
            qi += 1
            initial.append(index)
            node_queue.append((n + index) >> 1)
            if qi < len(leaf_queue) and leaf_queue[qi] == index ^ 1:
                initial.append(index ^ 1)
                qi += 1
                continue
            siblings.append(index ^ 1)

        flat_nodes: list[int] = []
        qn = 0
        while qn < len(node_queue):
            index = node_queue[qn]
            qn += 1
            if index > 2:
                node_queue.append(index >> 1)
            if qn < len(node_queue) and node_queue[qn] == index ^ 1:
                qn += 1
                continue
            flat_nodes.append(index ^ 1)
        return initial, siblings, flat_nodes

    def prove(self, indices: list[int]) -> MerkleView:
        n = self.n
        for i in indices:
            if i >= n:
                raise IndexError(f"leaf index {i} out of bounds for {n} leaves")
        idx = sorted(set(indices))
        initial, siblings, flat_nodes = self._plan(idx)
        wants: dict[int, set[int]] = {0: set(initial) | set(siblings)}
        for flat in flat_nodes:
            if flat == 0:
                continue
            depth = flat.bit_length() - 1
            wants.setdefault(self.height - depth, set()).add(
                flat - (1 << depth))
        got = self._fetch_many({lvl: sorted(ix) for lvl, ix in wants.items()})

        def node_bytes(flat: int) -> bytes:
            # flat == 0 only occurs for the degenerate 2-leaf tree, where the
            # reference emits its default (all-zero) digest for the unused slot
            if flat == 0:
                return H.ZERO_DIGEST
            depth = flat.bit_length() - 1
            return got[(self.height - depth, flat - (1 << depth))]

        return MerkleView(
            [node_bytes(f) for f in flat_nodes],
            [got[(0, i)] for i in initial],
            [got[(0, i)] for i in siblings],
            self.height,
        )


def commit_matrix(values: torch.Tensor) -> CommittedMerkleTree:
    """Commit to an Fp matrix (ncols, n) whose columns are in NATURAL domain
    order; leaves follow the protocol's bit-reversed row order, whose
    tree-bitrev storage is the natural row digests themselves."""
    return CommittedMerkleTree(tree_levels(ksha.hash_rows(values.T)))


def commit_matrix_ext3(values: torch.Tensor) -> CommittedMerkleTree:
    """The same for an Fq3 matrix (ncols, 3, n): each row serializes its
    elements as c0 || c1 || c2."""
    return CommittedMerkleTree(tree_levels(ksha.hash_rows_ext3(values)))
