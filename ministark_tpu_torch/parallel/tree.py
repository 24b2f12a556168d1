"""A Merkle tree whose levels stay sharded over the ranks of a mesh.

In the tree-bitrev storage of ``merkle`` (each level merges its two
contiguous halves) the subtree under storage node r of the d-wide level
holds exactly the storage nodes s = r (mod d) of every level below it, at
local index s // d.  Rank r keeps that subtree, built from its own leaf
digests, and every rank keeps the tip: the levels of d nodes and fewer,
built from the gathered subtree roots.  The root comes from the tip.  A
decommit wants the same nodes on every rank (``CommittedMerkleTree._plan``
reads only the positions), so one gather (``fetch``) brings every wanted
node of the sharded levels from its owner.
"""

from __future__ import annotations

import torch

from .. import merkle
from ..ntt import bit_reverse_index
from .sharded import Mesh


def fetch(mesh: Mesh, parts: list, dim: int = 0) -> torch.Tensor:
    """Entries of tensors held cyclically along `dim` (entry s on rank s
    mod d at local index s // d), on every rank: `parts` is [(this rank's
    tensor, storage indices)], and the result holds the entries asked,
    part after part, `dim` moved to the front: (entries, ...).  Every rank
    knows every entry's owner, so one all_gather in which each rank sends
    only the entries it owns, padded to the most that any rank owns."""
    d, rank = mesh.d, mesh.rank
    owner, slot, picked = [], [], []
    count = [0] * d
    for local, storage in parts:
        mine = []
        for s in storage:
            o = s % d
            owner.append(o)
            slot.append(count[o])
            count[o] += 1
            if o == rank:
                mine.append(s // d)
        picked.append(local.index_select(dim, torch.tensor(
            mine, dtype=torch.int64, device=local.device)))
    sent = torch.cat(picked, dim) if len(picked) > 1 else picked[0]
    pad = max(count) - sent.shape[dim]
    if pad:
        shape = list(sent.shape)
        shape[dim] = pad
        sent = torch.cat([sent, sent.new_zeros(shape)], dim)
    got = mesh.all_gather(sent).movedim(dim + 1, 1)  # (d, max count, ...)
    return got[torch.tensor(owner, device=got.device),
               torch.tensor(slot, device=got.device)]


class ShardedMerkleTree(merkle.CommittedMerkleTree):
    """The tree of n leaves of which this rank holds the subtree under
    storage node rank of the d-wide level (``local_levels``: its levels
    from its n / d leaf digests, in local storage order, to its root) and
    the replicated tip.  ``levels`` lists the sharded levels (n / d rows
    each of the n, ..) and then the tip (d, .., 1 nodes)."""

    def __init__(self, mesh: Mesh, local_levels: list[torch.Tensor],
                 hashfn=merkle.H):
        self.mesh = mesh
        self.hashfn = hashfn
        roots = mesh.all_gather(local_levels[-1])  # (d, 1, 32)
        tip = merkle.tree_levels(roots.reshape(mesh.d, 32), hashfn)
        self.split = len(local_levels) - 1  # the first tip level
        self.levels = local_levels[:-1] + tip
        self.n = int(local_levels[0].shape[0]) * mesh.d
        assert self.n & (self.n - 1) == 0 and self.n >= 2
        self._root = None

    def _fetch_many(self, wants: dict) -> dict:
        """{level: indices} -> {(level, index): digest bytes}: the tip's
        nodes from this rank, the sharded levels' in one gather."""
        out, keys, parts = {}, [], []
        for lvl, ix in wants.items():
            if not ix:
                continue
            m = self.n >> lvl
            s = [bit_reverse_index(m, i) for i in ix]
            lv = self.levels[lvl]
            if lvl < self.split:
                keys += [(lvl, i) for i in ix]
                parts.append((lv, s))
                continue
            rows = lv.index_select(0, torch.tensor(
                s, dtype=torch.int64, device=lv.device)).cpu().numpy()
            out.update({(lvl, i): row.tobytes() for i, row in zip(ix, rows)})
        if parts:
            rows = fetch(self.mesh, parts).cpu().numpy()
            out.update({k: row.tobytes() for k, row in zip(keys, rows)})
        return out
