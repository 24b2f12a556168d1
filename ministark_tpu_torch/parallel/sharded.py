"""The process group a sharded prove runs on, and the column shard (mirrors
``ministark_tpu.parallel.sharded``).

A ``Mesh`` is the counterpart of the JAX ``Mesh`` with one axis: the
``torch.distributed`` process group, this process's ``rank``, the world
size ``d`` and the rank's device.  Every rank is one process that holds one
device.  The collectives the sharded phases use go through the mesh, which
counts them and the bytes each rank sends:

* ``all_to_all(x)``: x is (d, ...), block j goes to rank j, and block j of
  the result came from rank j;
* ``all_gather(x)``: (d, *x.shape), block j is rank j's x.

Design (the JAX package's, on ranks instead of chips):

* trace columns shard over the ranks through iNTT and coset NTT with no
  communication;
* at the Merkle commit one all_to_all turns the column shard into a row
  shard, each rank builds its subtree and the log2(d) tip is built from
  the gathered subtree roots;
* the FRI folds run the distributed six-step NTT (``parallel.ntt``), three
  all_to_alls of n/d elements each.

``shard_columns``, ``sharded_lde_and_commit`` and ``sharded_fri_fold``
keep the JAX names as thin calls into ``parallel.executor``.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist


def check_backend(backend: str, world_size: int, rank: int,
                  device: torch.device, device_count: int) -> None:
    """Raise where `backend` cannot run `world_size` ranks on `device`:
    NCCL needs a card of its own for every rank (two ranks on one card
    take ``gloo``)."""
    if backend != "nccl":
        return
    if device.type != "cuda":
        raise ValueError(f"backend 'nccl' needs a CUDA device, got {device}: "
                         f"use backend='gloo' for CPU ranks")
    if world_size > device_count or (world_size > 1
                                     and device.index != rank % device_count):
        raise ValueError(
            f"backend 'nccl' needs one card for each rank: {world_size} "
            f"ranks on {device_count} card(s) would share {device}; use "
            f"backend='gloo' to run several ranks on one card")


def rank_device(rank: int, device=None) -> torch.device:
    """The rank's device: cuda:{rank % cards} unless the caller names
    another ("cpu", or a card by its index).  Raises without CUDA, as
    ``fields.device.resolve_device`` does."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device='cpu' to "
                               "run the ranks on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


class Mesh:
    """One rank's view of the process group (see the module docstring)."""

    def __init__(self, group, rank: int, d: int, device: torch.device,
                 backend: str):
        self.group = group
        self.rank = rank
        self.d = d
        self.device = device
        self.backend = backend
        self.reset_stats()

    def reset_stats(self) -> None:
        self.collectives = 0
        self.collective_bytes = 0

    def _count(self, t: torch.Tensor) -> None:
        self.collectives += 1
        self.collective_bytes += t.numel() * t.element_size()

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        assert x.shape[0] == self.d, (tuple(x.shape), self.d)
        x = x.contiguous()
        out = torch.empty_like(x)
        self._count(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.d)]
        self._count(x)
        dist.all_gather(parts, x, group=self.group)
        return torch.stack(parts)


def make_mesh(backend: str | None = None, device=None, *,
              init_method: str = "env://", rank: int | None = None,
              world_size: int | None = None,
              timeout: float | None = None) -> Mesh:
    """The mesh of this process: call it after
    ``torch.distributed.init_process_group``, or let it initialise the
    group through `init_method` (default: the ``torchrun`` environment,
    MASTER_ADDR and MASTER_PORT) as `rank` of `world_size` (default: RANK
    and WORLD_SIZE from the environment), every collective bounded by
    `timeout` seconds (default: torch's).  `backend` defaults to the
    group's, else to ``nccl`` on the card and ``gloo`` on the CPU;
    `device` as ``rank_device``.  Raises where the backend cannot run the
    ranks on their devices (``check_backend``), before joining: nothing
    switches the backend or the device silently."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        have = dist.get_backend()
        if backend is not None and backend != have:
            raise ValueError(f"the process group runs {have!r}, not "
                             f"{backend!r}")
        backend = have
    else:
        try:
            rank = int(os.environ["RANK"]) if rank is None else rank
            world = (int(os.environ["WORLD_SIZE"]) if world_size is None
                     else world_size)
        except KeyError:
            raise RuntimeError(
                "no process group: call torch.distributed."
                "init_process_group first, pass rank and world_size, or "
                "start the ranks with torchrun") from None
    dev = rank_device(rank, device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    check_backend(backend, world, rank, dev,
                  torch.cuda.device_count() if dev.type == "cuda" else 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        extra = {} if timeout is None else {
            "timeout": timedelta(seconds=timeout)}
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world, **extra)
    return Mesh(dist.group.WORLD, rank, world, dev, backend)


def shard_columns(mesh: Mesh, values: torch.Tensor) -> torch.Tensor:
    """This rank's block of the columns of a (ncols, ...) matrix on its
    device, the column count padded with zero columns to a multiple of d:
    (ncp / d, ...) where ncp = ceil(ncols / d) * d."""
    ncols, d = values.shape[0], mesh.d
    cpd = -(-ncols // d)
    mine = values[mesh.rank * cpd:(mesh.rank + 1) * cpd].to(mesh.device)
    if mine.shape[0] < cpd:
        pad = mine.new_zeros((cpd - mine.shape[0],) + tuple(values.shape[1:]))
        mine = torch.cat([mine, pad])
    return mine


def sharded_lde_and_commit(mesh: Mesh, trace_dom, lde_dom):
    """fn(values) -> (natural-order LDE, root bytes) of a replicated
    (ncols, n) Fp or (ncols, 3, n) Fq3 trace matrix, sharded over the
    ranks (``ShardedExecutor.lde_commit``)."""
    from .executor import ShardedExecutor

    ex = ShardedExecutor(mesh)

    def call(values: torch.Tensor):
        lde, tree = ex.lde_commit(values, trace_dom, lde_dom)
        return lde, tree.root()

    return call


def sharded_fri_fold(mesh: Mesh, n: int, folding_factor: int):
    """fn(local evals, alpha) -> this rank's contiguous block of the folded
    evaluations (n / N / d of them): one FRI fold (``fri.fold_evals``) of
    an (n,) Fp or (3, n) Fq3 codeword held as contiguous (n / d) blocks,
    alpha an ``Fp`` or ``Fq3``."""
    from ..fri import alpha_powers
    from .executor import ShardedExecutor

    ex = ShardedExecutor(mesh)

    def call(local: torch.Tensor, alpha):
        powers = alpha_powers(alpha, folding_factor, local.device)
        return ex.fri_fold(local, n, folding_factor, powers, local=True)

    return call
