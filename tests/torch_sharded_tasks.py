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

    @staticmethod
    def _start(d: int, store: str):
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


def spare_pool(tmp_path_factory, d: int):
    """A function that starts one more pool of d ranks as ``Pools`` starts
    its own, for a thread to call while the ``Pools`` start: its store is
    made here, in the calling thread (mktemp is not threadsafe).  The
    caller closes the pool."""
    store = str(tmp_path_factory.mktemp(f"spare_d{d}") / "store")
    return lambda: Pools._start(d, store)


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


def tree_hash(name):
    """The host hash module of a tree hash's name ("sha" or "rpo")."""
    from ministark_tpu_torch import hash as sha
    from ministark_tpu_torch import hash_rpo

    return {"sha": sha, "rpo": hash_rpo}[name]


def lde_commit(mesh, kind, rows, blowup, seed, hashname="sha"):
    """The sharded LDE + commit of a trace: "fib" (the fib trace of rows
    x 8 values), "fp5" (5 random Fp columns) or "ext3" (3 random Fq3
    columns), its trees hashing with `hashname`; this rank's rows of the
    LDE, its tree levels (the sharded ones, then the tip, from `split`
    on), the root, the collectives and the tree's proof at a few leaf
    positions.  The thin API (SHA-256 trees) runs beside the SHA-256
    commit."""
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
    lde, tree = ShardedExecutor(mesh, tree_hash(hashname)).lde_commit(
        vals, trace_dom, lde_dom)
    count = mesh.collectives
    if hashname == "sha":
        thin_lde, thin_root = sharded_lde_and_commit(mesh, trace_dom,
                                                     lde_dom)(vals)
        assert bytes(thin_root) == tree.root()
        assert bool((thin_lde == lde.values).all())
    n = lde_dom.size
    positions = [0, 1, 2, 5, n // 2 - 1, n // 2, n - 1]
    return {"trace": _host(vals), "lde": _host(lde.values),
            "levels": [lv.cpu().numpy() for lv in tree.levels],
            "split": tree.split, "root": tree.root(), "collectives": count,
            "positions": positions, "view": tree.prove(positions)}


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
            "from_block": _host(ex.fri_fold(block, n, N, powers, "block")),
            "from_cyclic": _host(ex.fri_fold(x[..., mesh.rank::mesh.d], n,
                                             N, powers, "cyclic")),
            "coeffs": _host(ex.fri_fold(x, n, N, powers, last=True)),
            "thin": _host(sharded_fri_fold(mesh, n, N)(block, a))}


def fri_commit(mesh, n, N, ext, layout, seed, hashname="sha"):
    """A sharded FRI layer commit of a codeword from `seed`, from the
    replicated codeword, this rank's block or its cyclic share (`layout`),
    the tree hashing with `hashname`: the tree's levels (the sharded
    ones, then the tip, from `split` on), this rank's rows (leaves rank +
    i d of tree-bitrev storage), and the rows and the tree's proof at a
    few leaf positions, fetched from their owners."""
    from ministark_tpu_torch.parallel.executor import ShardedExecutor

    x = _tensor(values(seed, *((3, n) if ext else (n,))), mesh.device)
    ex = ShardedExecutor(mesh, tree_hash(hashname))
    assert ex.fri_commit_supported(n, N)
    if layout == "block":
        m = n // mesh.d
        x = x[..., mesh.rank * m:(mesh.rank + 1) * m]
    elif layout == "cyclic":
        x = x[..., mesh.rank::mesh.d]
    tree, rows = ex.fri_commit_layer(x, n, N, layout)
    M = n // N
    positions = [0, 1, 2, M // 2 - 1, M // 2, M - 1]
    return {"levels": [lv.cpu().numpy() for lv in tree.levels],
            "split": tree.split, "rows": _host(rows.local),
            "positions": positions, "view": tree.prove(positions),
            "rows_at": [v.v if not hasattr(v, "c0") else
                        (v.c0.v, v.c1.v, v.c2.v)
                        for v in rows.rows_at(positions)]}


def workload(which, device):
    """(claim, trace, options) of a configuration: "fib" (2^10 values,
    the golden options), "bf" (the golden brainfuck program), "bf_rpo"
    (the same with RPO-256 trees and coin), "rescue" (the golden 4-link
    Rescue chain), "rpo_full"
    (the fully algebraic fib, 2^7 values), "fib_fold8" (fib 2^10 folding
    by 8 down to 8 values: at d = 4 the last fold is one the executor does
    not support, after a sharded one), "fib_rpo_coin" (fib 2^10 with
    SHA-256 trees and the RPO-256 coin: the host coin between the FRI
    layers)."""
    from ministark_tpu_torch import hash_rpo
    from ministark_tpu_torch.air import ProofOptions
    from ministark_tpu_torch.models.fib import FibClaim, gen_trace

    if which in ("bf", "bf_rpo"):
        from ministark_tpu_torch.models.brainfuck import (
            BrainfuckClaim, BrainfuckTrace, simulate)

        class BrainfuckClaimRpo(BrainfuckClaim):
            merkle_hash = hash_rpo
            coin_hash = hash_rpo

        program = "++>+++[<+>-]<."
        tables, output = simulate(program)
        cls = BrainfuckClaim if which == "bf" else BrainfuckClaimRpo
        return (cls(program, b"", output),
                BrainfuckTrace(tables, device=device),
                ProofOptions(9, 16, 0, 4, 16))
    if which == "rescue":
        from ministark_tpu_torch.models.rescue import RescueClaim
        from ministark_tpu_torch.models.rescue import gen_trace as chain

        trace, (d0, d1) = chain((7, 8), 4, device=device)
        return RescueClaim(7, 8, d0.v, d1.v), trace, ProofOptions(8, 8, 4, 4,
                                                                   16)

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


def deep_phase(mesh, which, seed):
    """The DEEP phase of `which`'s AIR on random LDE-domain matrices (base,
    extension where the AIR has one, composition; shapes the prove's) and
    a coin's z and DEEP coefficients: the OOD evaluations and DEEP vector
    of the one-process ``DeepPolyComposer`` on the whole matrices, and of
    the ``ShardedDeepPolyComposer`` on this rank's rows."""
    from ministark_tpu_torch.composer import DeepPolyComposer
    from ministark_tpu_torch.matrix import Matrix, MatrixExt3
    from ministark_tpu_torch.parallel.composer import ShardedDeepPolyComposer
    from ministark_tpu_torch.parallel.matrix import ShardedMatrix

    claim, trace, opts = workload(which, mesh.device)
    base = trace.base_columns()
    air = claim.build_air(base.num_rows, opts)
    n, d, r = air.lde_domain().size, mesh.d, mesh.rank
    ne = getattr(air.config, "NUM_EXTENSION_COLUMNS", 0)
    rng = np.random.default_rng(seed)
    ext3 = ne > 0

    def rand(*shape):
        return _tensor(rng.integers(0, P, size=shape, dtype=np.uint64),
                       mesh.device)

    cb = air.ce_blowup_factor
    whole = [Matrix(rand(base.num_cols, n)),
             MatrixExt3(rand(cb, 3, n)) if ext3 else Matrix(rand(cb, n)),
             MatrixExt3(rand(ne, 3, n)) if ext3 else None]
    coin = claim.gen_public_coin(air)
    z = coin.draw()
    coeffs = claim.gen_deep_coeffs(coin, air)
    out = {}
    for key, comp in (("one", DeepPolyComposer(air, z, *whole)),
                      ("sharded", ShardedDeepPolyComposer(
                          mesh, air, z, *[None if m is None else ShardedMatrix(
                              mesh, m.values[..., r::d].contiguous())
                              for m in whole]))):
        oods = comp.get_ood_evals()
        out[key] = {"oods": [[str(v) for v in o] for o in oods],
                    "deep": _host(comp.deep_lde(coeffs))}
    return out


POSITION_SETS = ([0], [0, 1], [1, 2], [3, 3, 4, 4, 9], [62, 63, 0, 1],
                 [5, 6, 7, 31, 32, 33, 34], [17, 17, 17],
                 list(range(0, 64, 3)), list(range(64)))


def decommit(mesh, seed):
    """A tree of 64 random leaf digests and 64-row Fp and Fq3 matrices,
    each whole (one process) and as this rank's share: the one-process and
    the sharded proofs (``prove``) and rows (``get_bit_reversed_rows``) at
    each of POSITION_SETS, and the gathers they took."""
    import torch

    from ministark_tpu_torch import merkle
    from ministark_tpu_torch.matrix import Matrix, MatrixExt3
    from ministark_tpu_torch.parallel.executor import ShardedExecutor
    from ministark_tpu_torch.parallel.matrix import ShardedMatrix

    rng = np.random.default_rng(seed)
    n, d, r = 64, mesh.d, mesh.rank
    digests = torch.from_numpy(rng.integers(0, 256, size=(n, 32),
                                            dtype=np.uint8)).to(mesh.device)
    one = merkle.CommittedMerkleTree(merkle.tree_levels(digests))
    mesh.reset_stats()
    tree = ShardedExecutor(mesh)._tree(digests[r::d])
    fp = _tensor(values(seed, 3, n), mesh.device)
    fq = _tensor(values(seed + 1, 2, 3, n), mesh.device)
    out = {"root": (one.root(), tree.root()), "proofs": [], "rows": [],
           "build_collectives": mesh.collectives}
    mesh.reset_stats()
    for pos in POSITION_SETS:
        out["proofs"].append((one.prove(pos), tree.prove(pos)))
        rows = []
        for whole, cls in ((fp, Matrix), (fq, MatrixExt3)):
            mine = ShardedMatrix(mesh, whole[..., r::d].contiguous())
            rows.append(([[str(v) for v in row] for row in
                          cls(whole).get_bit_reversed_rows(pos)],
                         [[str(v) for v in row] for row in
                          mine.get_bit_reversed_rows(pos)]))
        out["rows"].append(rows)
    out["decommit_collectives"] = mesh.collectives
    return out


def prove_shares(mesh, which):
    """prove_sharded of `which` with spies: the shapes of every matrix and
    tree level the executor commits (LDEs, composition, FRI layers), the
    largest collective, the bytes; the one-process constraint evaluation
    and DEEP composer are made to raise, so the prove shows it ran the
    sharded phases."""
    import os

    os.environ["MINISTARK_TPU_TIMERS"] = "0"
    from ministark_tpu_torch import prover
    from ministark_tpu_torch.parallel import executor as pex
    from ministark_tpu_torch.parallel.prover import prove_sharded

    seen = []
    ex = pex.ShardedExecutor
    commit, layer = ex._commit, ex.fri_commit_layer

    def spy_commit(self, lde, ncols, ce):
        n = lde.shape[-1]
        matrix, tree = commit(self, lde, ncols, ce)
        seen.append(("lde", n, tuple(matrix.values.shape),
                     [tuple(lv.shape) for lv in tree.levels], tree.split))
        return matrix, tree

    def spy_layer(self, evals, n, N, layout="whole"):
        tree, rows = layer(self, evals, n, N, layout)
        seen.append(("fri", n // N, tuple(rows.local.shape),
                     [tuple(lv.shape) for lv in tree.levels], tree.split))
        return tree, rows

    def replicated(*args, **kwargs):
        raise AssertionError("a replicated phase ran")

    claim, trace, opts = workload(which, mesh.device)
    saved = (prover.eval_composition, prover.DeepPolyComposer)
    pex.ShardedExecutor._commit = spy_commit
    pex.ShardedExecutor.fri_commit_layer = spy_layer
    prover.eval_composition = prover.DeepPolyComposer = replicated
    try:
        mesh.reset_stats()
        data = prove_sharded(claim, opts, trace, mesh).to_bytes(claim.fq)
    finally:
        pex.ShardedExecutor._commit = commit
        pex.ShardedExecutor.fri_commit_layer = layer
        prover.eval_composition, prover.DeepPolyComposer = saved
    return {"proof": data, "seen": seen,
            "max_bytes": mesh.max_collective_bytes,
            "lde_n": claim.build_air(trace.base_columns().num_rows,
                                     opts).lde_domain().size}


def prove_failing(mesh, which, target):
    """prove_sharded of `which` with `target` ("module:attr" of the port)
    made to raise on every rank: the exception must fail the prove."""
    import importlib
    import os

    os.environ["MINISTARK_TPU_TIMERS"] = "0"
    from ministark_tpu_torch.parallel.prover import prove_sharded

    mod, _, attr = target.partition(":")
    owner = importlib.import_module(mod)
    path = attr.split(".")
    for part in path[:-1]:
        owner = getattr(owner, part)
    saved = getattr(owner, path[-1])

    def boom(*args, **kwargs):
        raise ValueError(f"{target} fails on purpose")

    setattr(owner, path[-1], boom)
    try:
        claim, trace, opts = workload(which, mesh.device)
        return prove_sharded(claim, opts, trace, mesh).to_bytes(claim.fq)
    finally:
        setattr(owner, path[-1], saved)
