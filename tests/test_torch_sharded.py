"""The port's sharded LDE + commit and FRI executor
(``parallel.executor.ShardedExecutor``) in 2 and 4 CPU ranks over gloo,
against the one-process functions they stand for: ``merkle.commit_matrix``
/ ``commit_matrix_ext3`` of the one-process LDE (the LDE, the root and
every tree level, node for node), ``fri.fold_evals`` / ``fold_coeffs``
with a fixed alpha, and ``fri.FriProver._commit_layer``.  The thin API of
``parallel.sharded`` runs beside them, and the support predicates are held
against the JAX executor's.  Tolerance 0 throughout.
"""

import functools

import numpy as np
import pytest

import torch_sharded_tasks as tasks

ALPHA_FP = 123456789123456789 % tasks.P
ALPHA_FQ3 = (ALPHA_FP, 987654321987654321 % tasks.P, 5)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    p = tasks.Pools(tmp_path_factory)
    yield p
    p.close()


def _tensor(a):
    return tasks._tensor(a, "cpu")


@functools.lru_cache(maxsize=None)
def _one_process_commit(trace_bytes, shape, blowup):
    """(LDE, tree) of the one-process prover, made once for every d."""
    from ministark_tpu_torch import merkle
    from ministark_tpu_torch.ntt import Domain

    trace = np.frombuffer(trace_bytes, np.uint64).reshape(shape)
    rows = shape[-1]
    lde = Domain(rows * blowup, tasks.GENERATOR).fft(
        Domain(rows).ifft(_tensor(trace)))
    commit = (merkle.commit_matrix_ext3 if len(shape) == 3
              else merkle.commit_matrix)
    return tasks._host(lde), commit(lde)


@functools.lru_cache(maxsize=None)
def _one_process_layer(n, N, ext):
    """(rows, tree) of the one-process FRI layer commit, made once for
    every d and both sharded inputs."""
    from ministark_tpu_torch.fri import FriOptions, FriProver

    x = _tensor(tasks.values(9, *((3, n) if ext else (n,))))
    tree, rows = FriProver(FriOptions(N, 4, 4))._commit_layer(x, n, N)
    return tasks._host(rows), tree


@pytest.mark.parametrize("kind,rows,blowup", [("fib", 128, 4),
                                              ("fp5", 32, 8),
                                              ("ext3", 32, 4)])
@pytest.mark.parametrize("d", [2, 4])
def test_lde_commit_matches_one_process(pools, d, kind, rows, blowup):
    out = pools(d).run(tasks.lde_commit, kind, rows, blowup, 11)
    trace = out[0]["trace"]
    lde, tree = _one_process_commit(trace.tobytes(), trace.shape, blowup)
    for r in out:
        np.testing.assert_array_equal(r["trace"], trace)
        np.testing.assert_array_equal(r["lde"], lde)
        assert r["root"] == tree.root()
        assert len(r["levels"]) == len(tree.levels)
        for got, want in zip(r["levels"], tree.levels):
            np.testing.assert_array_equal(got, want.numpy())
        # all_to_all of the rows, all_gather of the levels and of the LDE
        assert r["collectives"] == 3


@pytest.mark.parametrize("ext", [False, True], ids=["fp", "fq3"])
@pytest.mark.parametrize("d", [2, 4])
def test_fri_fold_matches_fold_evals(pools, d, ext):
    from ministark_tpu_torch.fields.scalar import Fp, Fq3
    from ministark_tpu_torch.fri import alpha_powers, fold_coeffs, fold_evals

    n, N = 1 << 8, 4
    out = pools(d).run(tasks.fri_fold, n, N, ext,
                       ALPHA_FQ3 if ext else ALPHA_FP, 5)
    x = _tensor(tasks.values(5, *((3, n) if ext else (n,))))
    a = Fq3(*[Fp(v) for v in ALPHA_FQ3]) if ext else Fp(ALPHA_FP)
    powers = alpha_powers(a, N, "cpu")
    want = tasks._host(fold_evals(x, n, N, powers))
    coeffs = tasks._host(fold_coeffs(x, n, N, powers))
    for key in ("from_whole", "from_block", "thin"):
        np.testing.assert_array_equal(
            np.concatenate([r[key] for r in out], axis=-1), want)
    for r in out:
        np.testing.assert_array_equal(r["coeffs"], coeffs)


@pytest.mark.parametrize("local", [False, True], ids=["whole", "block"])
@pytest.mark.parametrize("ext", [False, True], ids=["fp", "fq3"])
@pytest.mark.parametrize("d", [2, 4])
def test_fri_commit_layer_matches_one_process(pools, d, ext, local):
    n, N = 1 << 8, 4
    out = pools(d).run(tasks.fri_commit, n, N, ext, local, 9)
    rows, tree = _one_process_layer(n, N, ext)
    for r in out:
        np.testing.assert_array_equal(r["rows"], rows)
        assert len(r["levels"]) == len(tree.levels)
        for got, want in zip(r["levels"], tree.levels):
            np.testing.assert_array_equal(got, want.numpy())


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
