"""Merkle commitments: batched tree build on torch tensors plus host
multi-proofs (reference: src/merkle.rs; mirrors ``ministark_tpu.merkle``).

A tree hashes with SHA-256 (``hash``, the default) or RPO-256
(``hash_rpo``), the reference's MerkleTree associated type: `hashfn` is the
host module, and ``device_hash`` gives its batched device counterpart
(``ops.sha256`` or ``ops.rpo256``, the same interface).

Levels are stored in TREE-BITREV order, as the JAX package's lanes path
stores them: storage row p of a level holds node bitrev(p), so the two
children of every node sit in the two contiguous halves of the level below
and each level is one merge of two halves.  For the protocol's bit-reversed
leaf order the natural row digests ARE that storage.  Digests are
(m, 32) uint8 tensors (an RPO digest's four elements in little-endian
bytes, ``hash_rpo._digest_bytes``); only roots and queried nodes reach the
host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import hash as H
from . import hash_rpo
from .ntt import bit_reverse_index, permute_bitrev
from .ops import rpo256 as krpo
from .ops import sha256 as ksha

_DEVICE_HASH = {H: ksha, hash_rpo: krpo}


def device_hash(hashfn):
    """The batched device module of host hash `hashfn`: ``hash_rows``,
    ``hash_rows_ext3`` and ``merge`` over (n, 32) uint8 digests,
    ``grind(seed, bits, device)``, a coin's proof-of-work search on
    `device`, and ``tree_tops(level)``, every level above a level of at
    most ``TOPS_LEAVES`` digests of a CUDA tensor at once."""
    try:
        return _DEVICE_HASH[hashfn]
    except KeyError:
        raise ValueError(f"no device hash for {hashfn!r}: use the port's "
                         f"hash (SHA-256) or hash_rpo (RPO-256)") from None


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


def tree_levels(storage: torch.Tensor, hashfn=H) -> list[torch.Tensor]:
    """All levels from leaf digests in tree-bitrev storage order: each level
    merges its two contiguous halves (one kernel launch per level, and on
    the card one for all the levels of at most ``TOPS_LEAVES`` nodes)."""
    dh = device_hash(hashfn)
    levels = [storage]
    cur = storage
    while cur.shape[0] > 1:
        if cur.is_cuda and cur.shape[0] <= dh.TOPS_LEAVES:
            return levels + dh.tree_tops(cur)
        half = cur.shape[0] // 2
        cur = dh.merge(cur[:half], cur[half:])
        levels.append(cur)
    return levels


class CommittedMerkleTree:
    """A built tree whose levels stay on the device; decommits fetch the
    needed nodes with one gather per level."""

    def __init__(self, levels: list[torch.Tensor], hashfn=H):
        self.levels = levels
        self.hashfn = hashfn
        self.n = int(levels[0].shape[0])
        assert self.n & (self.n - 1) == 0 and self.n >= 2
        self._root = None

    @staticmethod
    def from_leaf_digests(leaves: torch.Tensor,
                          hashfn=H) -> "CommittedMerkleTree":
        """Leaves given in leaf order -> tree-bitrev storage (one permute)."""
        return CommittedMerkleTree(
            tree_levels(permute_bitrev(leaves, dim=0), hashfn), hashfn)

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
                return self.hashfn.ZERO_DIGEST
            depth = flat.bit_length() - 1
            return got[(self.height - depth, flat - (1 << depth))]

        return MerkleView(
            [node_bytes(f) for f in flat_nodes],
            [got[(0, i)] for i in initial],
            [got[(0, i)] for i in siblings],
            self.height,
        )


def commit_matrix(values: torch.Tensor, hashfn=H) -> CommittedMerkleTree:
    """Commit to an Fp matrix (ncols, n) whose columns are in NATURAL domain
    order; leaves follow the protocol's bit-reversed row order, whose
    tree-bitrev storage is the natural row digests themselves."""
    leaves = device_hash(hashfn).hash_rows(values.T)
    return CommittedMerkleTree(tree_levels(leaves, hashfn), hashfn)


def commit_matrix_ext3(values: torch.Tensor, hashfn=H) -> CommittedMerkleTree:
    """The same for an Fq3 matrix (ncols, 3, n): each row serializes its
    elements as c0 || c1 || c2 (merkle.py:96-101 of the JAX package), and
    RPO absorbs them in that order (merkle.py:173-189)."""
    leaves = device_hash(hashfn).hash_rows_ext3(values)
    return CommittedMerkleTree(tree_levels(leaves, hashfn), hashfn)


# ---------------------------------------------------------------------------
# verification (host; mirrors src/merkle.rs:209-288, 363-385)
# ---------------------------------------------------------------------------

class InvalidProof(Exception):
    pass


_NATIVE_VIEW_ERRS = {
    1: "leaf index out of bounds", 2: "missing sibling leaf",
    3: "extra sibling leaves", 4: "malformed proof", 5: "root mismatch",
    6: "missing node", 7: "proof did not reach root"}


def verify_view(root: bytes, proof: MerkleView, indices: list[int],
                hashfn=H) -> None:
    height = proof.height
    n = 1 << height
    for i in indices:
        if i >= n:
            raise InvalidProof(f"leaf index {i} out of bounds")
    idx = sorted(set(indices))
    if len(idx) != len(proof.initial_leaves):
        raise InvalidProof("wrong number of leaves")

    if hashfn is H:  # the native view check speaks SHA-256 only
        from . import native
        rc = native.mk_verify_view(root, height, idx, proof.initial_leaves,
                                   proof.sibling_leaves, proof.nodes)
        if rc is not None:
            if rc != 0:
                raise InvalidProof(_NATIVE_VIEW_ERRS[rc])
            return

    siblings = list(proof.sibling_leaves)
    si = 0
    leaf_queue = list(zip(idx, proof.initial_leaves))
    node_queue: list[tuple[int, bytes]] = []
    qi = 0
    while qi < len(leaf_queue):
        index, leaf = leaf_queue[qi]
        qi += 1
        node_index = (n + index) >> 1
        if qi < len(leaf_queue) and leaf_queue[qi][0] == index ^ 1:
            node_queue.append((node_index,
                               hashfn.merge(leaf, leaf_queue[qi][1])))
            qi += 1
            continue
        if si >= len(siblings):
            raise InvalidProof("missing sibling leaf")
        sib = siblings[si]
        si += 1
        h = (hashfn.merge(leaf, sib) if index % 2 == 0
             else hashfn.merge(sib, leaf))
        node_queue.append((node_index, h))
    if si != len(siblings):
        raise InvalidProof("extra sibling leaves")

    nodes = list(proof.nodes)
    ni = 0
    qn = 0
    while qn < len(node_queue):
        index, h = node_queue[qn]
        qn += 1
        if index == 1:
            if qn != len(node_queue):
                raise InvalidProof("malformed proof")
            if root != h:
                raise InvalidProof("root mismatch")
            return
        if qn < len(node_queue) and node_queue[qn][0] == index ^ 1:
            node_queue.append((index >> 1, hashfn.merge(h, node_queue[qn][1])))
            qn += 1
            continue
        if ni >= len(nodes):
            raise InvalidProof("missing node")
        sib = nodes[ni]
        ni += 1
        nh = hashfn.merge(h, sib) if index % 2 == 0 else hashfn.merge(sib, h)
        node_queue.append((index >> 1, nh))
    raise InvalidProof("proof did not reach root")


def verify_rows(root: bytes, row_ids: list[int], rows: list,
                proof: MerkleView, hashfn=H) -> None:
    """Verify matrix rows: dedupe/sort by id, hash each row with
    hash_elements, compare to initial leaves, then verify paths
    (src/merkle.rs:363-385)."""
    inst = sorted({rid: row for rid, row in zip(row_ids, rows)}.items())
    indices = [rid for rid, _ in inst]
    leaves = [hashfn.hash_elements(row) for _, row in inst]
    if leaves != proof.initial_leaves:
        raise InvalidProof("row hash mismatch")
    verify_view(root, proof, indices, hashfn)
