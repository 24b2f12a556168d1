"""The port's sharded LDE + commit and FRI executor
(``parallel.executor.ShardedExecutor``) in 2 and 4 CPU ranks over gloo,
against the one-process functions they stand for: ``merkle.commit_matrix``
/ ``commit_matrix_ext3`` of the one-process LDE (each rank's rows j = rank
mod d of the LDE, the root, each rank's nodes of every sharded tree level
and the replicated tip, node for node), ``fri.fold_evals`` /
``fold_coeffs`` with a fixed alpha, and ``fri.FriProver._commit_layer``
(each rank's rows and levels of the layer, and rows fetched at leaf
positions), and the trees' proofs at leaf positions.  The commits run with SHA-256 trees and with RPO-256 trees.  The thin API of ``parallel.sharded`` runs beside them, and
the support predicates are held against the JAX executor's.  Tolerance
0 throughout.
"""

import functools
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import pytest

import torch_sharded_tasks as tasks

ALPHA_FP = 123456789123456789 % tasks.P
ALPHA_FQ3 = (ALPHA_FP, 987654321987654321 % tasks.P, 5)


N_FRI, FOLD = 1 << 8, 4
LDE_CASES = [("fib", 128, 4), ("fp5", 32, 8), ("ext3", 32, 4)]
LAYOUTS = [("whole",), ("block",), ("cyclic",)]
HASH_SUFFIX = (("sha", ""), ("rpo", "-rpo"))


def _with_hashes(*cases):
    """Each case with SHA-256 trees (its plain id) and RPO-256 trees (id
    "-rpo")."""
    return [pytest.param(*case, h, id="-".join(map(str, case)) + suffix)
            for h, suffix in HASH_SUFFIX for case in cases]


def _pool_calls():
    """Every pool run of the tests below, in their order: (task, args)."""
    calls = [(tasks.lde_commit, (*case, 11, h))
             for h, _ in HASH_SUFFIX for case in LDE_CASES]
    for ext in (False, True):
        calls.append((tasks.fri_fold, (N_FRI, FOLD, ext,
                                       ALPHA_FQ3 if ext else ALPHA_FP, 5)))
    for ext in (False, True):
        calls += [(tasks.fri_commit, (N_FRI, FOLD, ext, local, 9, h))
                  for h, _ in HASH_SUFFIX for (local,) in LAYOUTS]
    return calls


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """run(d, task, *args): the ranks' results of a run of _pool_calls.
    The pools of d = 2 and 4 work through every run at once, from the
    file's first test on, while this process makes the one-process values
    the tests compare with (the plain RPO-256 permutation costs ~0.1 s a
    tree level on the CPU)."""
    pools = tasks.Pools(tmp_path_factory)
    calls = _pool_calls()
    futures = {(d, fn.__name__, args): Future()
               for d in (2, 4) for fn, args in calls}

    def run_all(d):
        for fn, args in calls:
            fut = futures[d, fn.__name__, args]
            try:
                fut.set_result(pools(d).run(fn, *args))
            except Exception as e:  # the test of this run raises it
                fut.set_exception(e)

    with ThreadPoolExecutor(2) as ex:
        for d in (2, 4):
            ex.submit(run_all, d)
        yield lambda d, fn, *args: futures[d, fn.__name__, args].result()
    pools.close()


def _tensor(a):
    return tasks._tensor(a, "cpu")


@functools.lru_cache(maxsize=None)
def _one_process_commit(trace_bytes, shape, blowup, hashname):
    """(LDE, tree) of the one-process prover, made once for every d."""
    from ministark_tpu_torch import merkle
    from ministark_tpu_torch.ntt import Domain

    trace = np.frombuffer(trace_bytes, np.uint64).reshape(shape)
    rows = shape[-1]
    lde = Domain(rows * blowup, tasks.GENERATOR).fft(
        Domain(rows).ifft(_tensor(trace)))
    commit = (merkle.commit_matrix_ext3 if len(shape) == 3
              else merkle.commit_matrix)
    return tasks._host(lde), commit(lde, tasks.tree_hash(hashname))


@functools.lru_cache(maxsize=None)
def _one_process_layer(n, N, ext, hashname):
    """(rows, tree) of the one-process FRI layer commit, made once for
    every d and every sharded input."""
    from ministark_tpu_torch.fri import FriOptions, FriProver

    x = _tensor(tasks.values(9, *((3, n) if ext else (n,))))
    tree, rows = FriProver(FriOptions(N, 4, 4), tasks.tree_hash(
        hashname))._commit_layer(x, n, N)
    return tasks._host(rows), tree


@pytest.mark.parametrize("kind,rows,blowup,hashname",
                         _with_hashes(*LDE_CASES))
@pytest.mark.parametrize("d", [2, 4])
def test_lde_commit_matches_one_process(runs, d, kind, rows, blowup,
                                        hashname):
    out = runs(d, tasks.lde_commit, kind, rows, blowup, 11, hashname)
    trace = out[0]["trace"]
    lde, tree = _one_process_commit(trace.tobytes(), trace.shape, blowup,
                                    hashname)
    for rank, r in enumerate(out):
        np.testing.assert_array_equal(r["trace"], trace)
        np.testing.assert_array_equal(r["lde"], lde[..., rank::d])
        assert r["root"] == tree.root()
        assert r["view"] == tree.prove(r["positions"])
        assert len(r["levels"]) == len(tree.levels)
        assert tree.levels[r["split"]].shape[0] == d
        for lvl, (got, want) in enumerate(zip(r["levels"], tree.levels)):
            want = want.numpy()
            if lvl < r["split"]:  # storage nodes rank + i d
                want = want[rank::d]
            np.testing.assert_array_equal(got, want)
        # an all_to_all a column of the rank's block, the subtree roots
        assert r["collectives"] == -(-trace.shape[0] // d) + 1


@pytest.mark.parametrize("ext", [False, True], ids=["fp", "fq3"])
@pytest.mark.parametrize("d", [2, 4])
def test_fri_fold_matches_fold_evals(runs, d, ext):
    from ministark_tpu_torch.fields.scalar import Fp, Fq3
    from ministark_tpu_torch.fri import alpha_powers, fold_coeffs, fold_evals

    n, N = N_FRI, FOLD
    out = runs(d, tasks.fri_fold, n, N, ext, ALPHA_FQ3 if ext else ALPHA_FP,
               5)
    x = _tensor(tasks.values(5, *((3, n) if ext else (n,))))
    a = Fq3(*[Fp(v) for v in ALPHA_FQ3]) if ext else Fp(ALPHA_FP)
    powers = alpha_powers(a, N, "cpu")
    want = tasks._host(fold_evals(x, n, N, powers))
    coeffs = tasks._host(fold_coeffs(x, n, N, powers))
    for key in ("from_whole", "from_block", "from_cyclic", "thin"):
        np.testing.assert_array_equal(
            np.concatenate([r[key] for r in out], axis=-1), want)
    for r in out:
        np.testing.assert_array_equal(r["coeffs"], coeffs)


@pytest.mark.parametrize("local,hashname", _with_hashes(*LAYOUTS))
@pytest.mark.parametrize("ext", [False, True], ids=["fp", "fq3"])
@pytest.mark.parametrize("d", [2, 4])
def test_fri_commit_layer_matches_one_process(runs, d, ext, local,
                                              hashname):
    """Each rank's rows are the leaves rank + i d of the one-process
    layer's tree-bitrev storage, and rows fetched at leaf positions are
    the one-process rows there."""
    import torch

    from ministark_tpu_torch.ntt import permute_bitrev

    n, N = N_FRI, FOLD
    out = runs(d, tasks.fri_commit, n, N, ext, local, 9, hashname)
    rows, tree = _one_process_layer(n, N, ext, hashname)
    leaf_dim = 2 if ext else 0
    storage = permute_bitrev(torch.from_numpy(rows.astype(np.int64)),
                             dim=leaf_dim).numpy().astype(np.uint64)
    for rank, r in enumerate(out):
        np.testing.assert_array_equal(
            r["rows"], storage[rank::d] if not ext else storage[..., rank::d])
        at = np.take(rows, r["positions"], axis=leaf_dim)
        at = at.reshape(-1) if not ext else at.transpose(2, 0, 1).reshape(
            -1, 3)
        assert r["rows_at"] == [tuple(map(int, v)) if ext else int(v)
                                for v in at]
        assert r["view"] == tree.prove(r["positions"])
        assert len(r["levels"]) == len(tree.levels)
        for lvl, (got, want) in enumerate(zip(r["levels"], tree.levels)):
            want = want.numpy()
            np.testing.assert_array_equal(
                got, want[rank::d] if lvl < r["split"] else want)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_predicates_match_the_jax_executor(d):
    """``commit_supported``, ``fri_commit_supported`` and
    ``fri_fold_supported`` (executor.py:104-117 of the JAX package)."""
    from types import SimpleNamespace

    from ministark_tpu.parallel.executor import ShardedExecutor as JaxEx
    from ministark_tpu_torch.parallel.executor import ShardedExecutor

    jax_ex = JaxEx(SimpleNamespace(devices=np.empty(d)))
    ex = ShardedExecutor(SimpleNamespace(d=d, rank=0, device="cpu"))
    for log_n in range(0, 13):
        n = 1 << log_n
        assert ex.commit_supported(n) == jax_ex.commit_supported(n), n
        for N in (2, 4, 8, 16):
            assert (ex.fri_commit_supported(n, N)
                    == jax_ex.fri_commit_supported(n, N)), (n, N)
            assert (ex.fri_fold_supported(n, N)
                    == jax_ex.fri_fold_supported(n, N)), (n, N)


def test_shard_columns_pads_to_a_multiple_of_d():
    from types import SimpleNamespace

    import torch

    from ministark_tpu_torch.parallel.sharded import shard_columns

    vals = _tensor(tasks.values(3, 5, 8))
    blocks = [shard_columns(SimpleNamespace(d=4, rank=r, device="cpu"), vals)
              for r in range(4)]
    assert all(b.shape == (2, 8) for b in blocks)
    whole = tasks._host(torch.cat(blocks))
    np.testing.assert_array_equal(whole[:5], tasks._host(vals))
    assert not whole[5:].any()
