"""A pool of rank processes that run functions together.

    with RankPool(2, backend="gloo", device="cpu") as pool:
        proofs = pool.run(prove_fn, arg)   # prove_fn(mesh, arg) on each rank

Each rank is a process started with the spawn method (CUDA needs it) that
joins the process group through a file store (two pools never share a
port), makes its ``Mesh`` and then runs what ``run`` sends it, every rank
the same function, until the pool closes.  `fn` must be importable by
name (a module-level function) and should return host values (bytes,
numbers, CPU tensors).  A rank that raises, dies or overruns the timeout
fails ``run`` with its traceback; the pool is then closed, unless every
rank answered (an error raised outside any collective).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback


def _worker(rank, d, backend, device, store, timeout, threads, block,
            parent, tasks, results):
    if block:  # any later import of these now fails
        for name in block:
            sys.modules[name] = None
    try:
        import torch
        import torch.distributed as dist

        from .sharded import make_mesh

        if threads:
            torch.set_num_threads(threads)
        mesh = make_mesh(backend, device, init_method=f"file://{store}",
                         rank=rank, world_size=d, timeout=timeout)
    except (Exception, SystemExit):
        results.put((rank, "error", traceback.format_exc()))
        return
    results.put((rank, "ready", None))
    while True:
        try:
            item = tasks.get(timeout=1.0)
        except queue.Empty:
            if os.getppid() != parent:  # the parent is gone
                break
            continue
        if item is None:
            break
        fn, args = item
        try:
            results.put((rank, "ok", fn(mesh, *args)))
        except (Exception, SystemExit):  # SystemExit: a task's sys.exit
            results.put((rank, "error", traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """`world_size` rank processes on `backend` ("gloo" or "nccl") and
    `device` (as ``sharded.rank_device`` takes it).  `store`: a file path
    for the group's store that does not exist yet (default: a new one in
    a new temporary directory).  `threads` sets each rank's torch threads,
    `block` names modules each rank refuses to import, `timeout` bounds
    start-up, every ``run`` and every collective, in seconds."""

    def __init__(self, world_size: int, backend: str = "gloo", device=None,
                 store: str | None = None, *, threads: int | None = None,
                 block: tuple = (), timeout: float = 120.0):
        self.d = world_size
        self.timeout = timeout
        self._tmp = None
        if store is None:
            self._tmp = tempfile.mkdtemp(prefix="rankpool-")
            store = os.path.join(self._tmp, "store")
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(world_size)]
        self._procs = [
            ctx.Process(target=_worker, daemon=True, args=(
                r, world_size, backend, device, store, timeout, threads,
                tuple(block), os.getpid(), self._tasks[r], self._results))
            for r in range(world_size)]
        for p in self._procs:
            p.start()
        self._collect("ready", timeout)

    def _collect(self, what: str, timeout: float) -> list:
        """Every rank's answer in rank order.  A rank's error is raised
        once every rank has answered, or after a 1 s grace (the others may
        wait for it in a collective), and then the pool closes unless every
        rank answered."""
        got: dict = {}
        errors = []
        deadline = time.monotonic() + timeout
        try:
            while len(got) < self.d:
                try:
                    rank, status, value = self._results.get(timeout=0.2)
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(self._procs)
                            if p.exitcode is not None and r not in got]
                    if dead:
                        raise RuntimeError(f"rank(s) exited during {what}: "
                                           f"(rank, exit code) {dead}")
                    if time.monotonic() > deadline:
                        missing = sorted(set(range(self.d)) - set(got))
                        raise TimeoutError(f"{what}: ranks {missing} did "
                                           f"not answer within {timeout} s")
                    continue
                got[rank] = value
                if status == "error":
                    errors.append(f"rank {rank} failed in {what}:\n{value}")
                    deadline = min(deadline, time.monotonic() + 1.0)
        except BaseException as e:
            self.close()
            if errors:
                raise RuntimeError("\n".join(errors)) from e
            raise
        if errors:
            raise RuntimeError("\n".join(errors))
        return [got[r] for r in range(self.d)]

    @property
    def closed(self) -> bool:
        return not self._procs

    def run(self, fn, *args, timeout: float | None = None) -> list:
        """fn(mesh, *args) on every rank; the results in rank order."""
        if self.closed:
            raise RuntimeError("the pool is closed")
        for q in self._tasks:
            q.put((fn, args))
        return self._collect(getattr(fn, "__name__", repr(fn)),
                             timeout or self.timeout)

    def close(self) -> None:
        """Stop the ranks: ask each to leave, drain what they still write
        (a process does not exit with data in a queue's pipe), and end
        those still running after 10 s."""
        procs, self._procs = self._procs, []
        for q, p in zip(self._tasks, procs):
            if p.is_alive():
                q.put(None)
        deadline = time.monotonic() + 10
        while any(p.is_alive() for p in procs) and (
                time.monotonic() < deadline):
            try:
                self._results.get(timeout=0.1)
            except queue.Empty:
                pass
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
            p.join()
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
