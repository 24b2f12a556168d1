"""What the ranks of the sharded tests run (``parallel.spawn.RankPool``).

Each function takes the rank's mesh first and returns host values.  This
module imports torch and the port only, never ``jax`` or ``ministark_tpu``:
the ranks refuse both, and ``loaded`` reports what they hold.  Inputs are
made on every rank from the same numpy seed, so every rank starts from the
same replicated values, as the ranks of a prove do.
"""

import sys

import numpy as np

P = 0xFFFFFFFF00000001
GENERATOR = 7
BLOCK = ("jax", "ministark_tpu")  # modules the ranks refuse to import


class Pools:
    """One ``RankPool`` of CPU ranks over gloo for each world size (a test
    file's module fixture holds one ``Pools``), with each rank on one torch
    thread and a 120 s bound on every run.  The pools of `sizes` start
    together, while this process imports torch, the others at first use;
    a pool that a failed run closed is made again.  ``close`` stops them
    together."""

    def __init__(self, tmp_path_factory, sizes=(2, 4)):
        from concurrent.futures import ThreadPoolExecutor

        self._tmp = tmp_path_factory
        stores = [self._store(d) for d in sizes]  # mktemp is not threadsafe
        with ThreadPoolExecutor(len(sizes)) as ex:
            started = ex.map(self._start, sizes, stores)
            import torch  # noqa: F401  (the tests' import, as the ranks start)
            self._pools = dict(zip(sizes, started))

    def _store(self, d: int) -> str:
        return str(self._tmp.mktemp(f"store_d{d}") / "store")

    def _start(self, d: int, store: str):
        from ministark_tpu_torch.parallel.spawn import RankPool

        return RankPool(d, "gloo", "cpu", store, threads=1, block=BLOCK,
                        timeout=120)

    def __call__(self, d: int):
        pool = self._pools.get(d)
        if pool is None or pool.closed:
            pool = self._pools[d] = self._start(d, self._store(d))
        return pool

    def close(self):
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max(1, len(self._pools))) as ex:
            list(ex.map(lambda pool: pool.close(), self._pools.values()))


def loaded() -> list:
    return sorted(m for m, v in sys.modules.items() if v is not None and (
        m.split(".")[0] in ("jax", "jaxlib", "ministark_tpu")))


def values(seed, *shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint64)


def _tensor(a, device):
    from ministark_tpu_torch.fields.convert import from_u64_numpy

    return from_u64_numpy(np.ascontiguousarray(a)).to(device)


def _host(t):
    from ministark_tpu_torch.fields.convert import to_u64_numpy

    return to_u64_numpy(t.cpu())


def ntt(mesh, n, offset, ext, seed):
    """This rank's blocks of fft(x), ifft(x) and ifft(fft(x)) over the
    coset of `offset`, x (n,) Fp or (3, n) Fq3 from `seed`."""
    from ministark_tpu_torch.parallel.ntt import ShardedDomain

    x = values(seed, *((3, n) if ext else (n,)))
    m, r = n // mesh.d, mesh.rank
    block = _tensor(x[..., r * m:(r + 1) * m], mesh.device)
    dom = ShardedDomain(mesh, n, offset)
    fwd = dom.fft(block)
    return {"fft": _host(fwd), "ifft": _host(dom.ifft(block)),
            "back": _host(dom.ifft(fwd)), "mine": _host(block)}


def lde_commit(mesh, kind, rows, blowup, seed):
    """The sharded LDE + commit of a trace: "fib" (the fib trace of rows
    x 8 values), "fp5" (5 random Fp columns) or "ext3" (3 random Fq3
    columns); the LDE, every tree level, the root and the collectives."""
    from ministark_tpu_torch.models.fib import gen_trace
    from ministark_tpu_torch.ntt import Domain
    from ministark_tpu_torch.parallel.executor import ShardedExecutor
    from ministark_tpu_torch.parallel.sharded import sharded_lde_and_commit

    if kind == "fib":
        vals = gen_trace(rows * 8, device=mesh.device).matrix.values
    elif kind == "fp5":
        vals = _tensor(values(seed, 5, rows), mesh.device)
    else:
        vals = _tensor(values(seed, 3, 3, rows), mesh.device)
    trace_dom, lde_dom = Domain(rows), Domain(rows * blowup, GENERATOR)
    mesh.reset_stats()
    lde, tree = ShardedExecutor(mesh).lde_commit(vals, trace_dom, lde_dom)
    count = mesh.collectives
    thin_lde, thin_root = sharded_lde_and_commit(mesh, trace_dom,
                                                 lde_dom)(vals)
    assert bytes(thin_root) == tree.root()
    assert bool((thin_lde == lde).all())
    return {"trace": _host(vals), "lde": _host(lde),
            "levels": [lv.cpu().numpy() for lv in tree.levels],
            "root": tree.root(), "collectives": count}


def fri_fold(mesh, n, N, ext, alpha, seed):
    """One sharded fold of a codeword from `seed` with a fixed alpha (an
    int, or three for Fq3): this rank's block of the folded evaluations
    from the replicated codeword and from this rank's block, the gathered
    last-fold coefficients, and the thin API's block."""
    from ministark_tpu_torch.fields.scalar import Fp, Fq3
    from ministark_tpu_torch.fri import alpha_powers
    from ministark_tpu_torch.parallel.executor import ShardedExecutor
    from ministark_tpu_torch.parallel.sharded import sharded_fri_fold

    x = _tensor(values(seed, *((3, n) if ext else (n,))), mesh.device)
    a = Fq3(*[Fp(v) for v in alpha]) if ext else Fp(alpha)
    powers = alpha_powers(a, N, mesh.device)
    ex = ShardedExecutor(mesh)
    assert ex.fri_fold_supported(n, N)
    m = n // mesh.d
    block = x[..., mesh.rank * m:(mesh.rank + 1) * m]
    return {"from_whole": _host(ex.fri_fold(x, n, N, powers)),
            "from_block": _host(ex.fri_fold(block, n, N, powers,
                                            local=True)),
            "coeffs": _host(ex.fri_fold(x, n, N, powers, last=True)),
            "thin": _host(sharded_fri_fold(mesh, n, N)(block, a))}


def fri_commit(mesh, n, N, ext, local, seed):
    """A sharded FRI layer commit of a codeword from `seed`, from the
    replicated codeword or (local) this rank's block: the tree's levels
    and the rows in leaf order."""
    from ministark_tpu_torch.parallel.executor import ShardedExecutor

    x = _tensor(values(seed, *((3, n) if ext else (n,))), mesh.device)
    ex = ShardedExecutor(mesh)
    assert ex.fri_commit_supported(n, N)
    if local:
        m = n // mesh.d
        x = x[..., mesh.rank * m:(mesh.rank + 1) * m]
    tree, rows = ex.fri_commit_layer(x, n, N, local)
    return {"levels": [lv.cpu().numpy() for lv in tree.levels],
            "rows": _host(rows)}


def workload(which, device):
    """(claim, trace, options) of a configuration: "fib" (2^10 values,
    the golden options), "bf" (the golden brainfuck program), "rpo_full"
    (the fully algebraic fib, 2^7 values), "fib_fold8" (fib 2^10 folding
    by 8 down to 8 values: at d = 4 the last fold is one the executor does
    not support, after a sharded one), "fib_rpo_coin" (fib 2^10 with
    SHA-256 trees and the RPO-256 coin: the host coin between the FRI
    layers)."""
    from ministark_tpu_torch import hash_rpo
    from ministark_tpu_torch.air import ProofOptions
    from ministark_tpu_torch.models.fib import FibClaim, gen_trace

    if which == "bf":
        from ministark_tpu_torch.models.brainfuck import (
            BrainfuckClaim, BrainfuckTrace, simulate)

        program = "++>+++[<+>-]<."
        tables, output = simulate(program)
        return (BrainfuckClaim(program, b"", output),
                BrainfuckTrace(tables, device=device),
                ProofOptions(9, 16, 0, 4, 16))

    class FibClaimRpoFull(FibClaim):
        merkle_hash = hash_rpo
        coin_hash = hash_rpo

    class FibClaimRpoCoin(FibClaim):
        coin_hash = hash_rpo

    cls, n, opts = {
        "fib": (FibClaim, 1 << 10, ProofOptions(8, 4, 2, 4, 16)),
        "rpo_full": (FibClaimRpoFull, 1 << 7, ProofOptions(8, 4, 3, 4, 4)),
        "fib_fold8": (FibClaim, 1 << 10, ProofOptions(8, 4, 2, 8, 8)),
        "fib_rpo_coin": (FibClaimRpoCoin, 1 << 10,
                         ProofOptions(8, 4, 2, 4, 16)),
    }[which]
    trace = gen_trace(n, device=device)
    return cls(trace.last_value()), trace, opts


def prove(mesh, which):
    """prove_sharded of a configuration (``workload``): the bytes, the
    collectives and the loaded modules."""
    import os

    os.environ["MINISTARK_TPU_TIMERS"] = "0"
    from ministark_tpu_torch.parallel.prover import prove_sharded

    claim, trace, opts = workload(which, mesh.device)
    mesh.reset_stats()
    data = prove_sharded(claim, opts, trace, mesh).to_bytes(claim.fq)
    return {"proof": data, "collectives": mesh.collectives,
            "bytes": mesh.collective_bytes, "loaded": loaded()}


def fail_on(mesh, rank):
    """Raise on `rank`, return on the others (no collective)."""
    if mesh.rank == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return mesh.rank


def fail_before_gather(mesh, rank):
    """Raise on `rank`; the others wait for it in an all_gather."""
    import torch

    if mesh.rank == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return mesh.all_gather(torch.zeros(1)).tolist()
