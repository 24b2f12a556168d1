"""The multi-process prover (``parallel.prover.prove_sharded``) end to end
in 2 and 4 CPU ranks over gloo: every rank's proof bytes must equal the
JAX-written golden files, which the one-process prove reproduces.

* fib at 2^10 values at d = 2 and 4 (``tests/golden/fib_2e10.proof``):
  the LDE + commit and the FRI layers run sharded;
* the golden brainfuck program at d = 2 (``brainfuck_2plus3.proof``): the
  Fq3 extension commit and Fq3 FRI layers run sharded;
* the fully algebraic fib at 2^7 values at d = 2
  (``fib_2e7_rpo_full.proof``): RPO-256 trees, so the executor stands
  aside and the prove makes no collective at all.

The ranks refuse to import ``jax`` and ``ministark_tpu`` and report the
modules they hold.  The backend checks run in this process: NCCL with two
ranks on one card raises, naming gloo.
"""

import os

import pytest

import torch_sharded_tasks as tasks

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    p = tasks.Pools(tmp_path_factory)
    yield p
    p.close()


def _golden(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


# the sharded proves of each pool, in the order they run
RUNS = {2: ("fib", "bf", "rpo_full"), 4: ("fib", "fib_fold8", "fib_rpo_coin")}
ONE_PROCESS = ("fib_fold8", "fib_rpo_coin")


@pytest.fixture(scope="module")
def proofs(pools):
    """Every rank's ``tasks.prove`` of each workload of RUNS, {(which, d):
    the ranks' results or the exception}, the pools working together while
    this process makes the one-process proofs of ONE_PROCESS, {which:
    bytes}."""
    from concurrent.futures import ThreadPoolExecutor

    def run_all(d):
        out = {}
        for which in RUNS[d]:
            try:
                out[which, d] = pools(d).run(tasks.prove, which)
            except Exception as e:  # the test of this run raises it
                out[which, d] = e
        return out

    with ThreadPoolExecutor(len(RUNS)) as ex:
        running = [ex.submit(run_all, d) for d in RUNS]
        one = {}
        for which in ONE_PROCESS:
            claim, trace, opts = tasks.workload(which, "cpu")
            one[which] = claim.prove(opts, trace).to_bytes(claim.fq)
        runs = {}
        for r in running:
            runs.update(r.result())
    return runs, one


def _ranks(proofs, which, d):
    out = proofs[0][which, d]
    if isinstance(out, Exception):
        raise out
    return out


@pytest.mark.parametrize("which,d,golden", [
    ("fib", 2, "fib_2e10.proof"), ("fib", 4, "fib_2e10.proof"),
    ("bf", 2, "brainfuck_2plus3.proof"),
    ("rpo_full", 2, "fib_2e7_rpo_full.proof")])
def test_prove_sharded_equals_golden_on_every_rank(proofs, which, d, golden):
    out = _ranks(proofs, which, d)
    want = _golden(golden)
    for rank, r in enumerate(out):
        assert r["proof"] == want, (which, d, rank)
        assert r["loaded"] == [], r["loaded"]
        if which == "rpo_full":
            assert r["collectives"] == 0  # the executor stands aside
        else:
            assert r["collectives"] > 0 and r["bytes"] > 0
    assert len({(r["collectives"], r["bytes"]) for r in out}) == 1


@pytest.mark.parametrize("which,d", [("fib_fold8", 4),
                                     ("fib_rpo_coin", 4)])
def test_prove_sharded_equals_one_process(proofs, which, d):
    """Steps the executor does not support fall back to the one-process
    code on the gathered codeword (fib_fold8's last fold at d = 4), and
    the host coin between the FRI layers takes the sharded layers too
    (fib_rpo_coin)."""
    for r in _ranks(proofs, which, d):
        assert r["proof"] == proofs[1][which] and r["collectives"] > 0


def test_a_failing_rank_fails_the_run(pools):
    pool = pools(2)
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        pool.run(tasks.fail_on, 1)
    assert not pool.closed  # every rank answered: the pool stays
    assert pool.run(tasks.fail_on, 5) == [0, 1]


def test_a_rank_stuck_in_a_collective_closes_the_pool(pools):
    """The last test of this file on the d = 2 pool: it ends the pool."""
    pool = pools(2)
    with pytest.raises(RuntimeError, match="rank 0 fails on purpose"):
        pool.run(tasks.fail_before_gather, 0)
    assert pool.closed


def _torchrun_env(monkeypatch, rank, world, cards):
    import torch

    monkeypatch.setenv("RANK", str(rank))
    monkeypatch.setenv("WORLD_SIZE", str(world))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)


@pytest.mark.parametrize("rank", [0, 1])
def test_nccl_with_two_ranks_on_one_card_raises(monkeypatch, rank):
    """make_mesh checks before it joins the group: nothing is initialised
    and nothing switches to gloo."""
    import torch.distributed as dist

    from ministark_tpu_torch.parallel.sharded import make_mesh

    _torchrun_env(monkeypatch, rank, 2, 1)
    with pytest.raises(ValueError, match="gloo"):
        make_mesh()
    with pytest.raises(ValueError, match="gloo"):
        make_mesh("nccl", "cuda:0")
    with pytest.raises(ValueError, match="gloo"):
        make_mesh("nccl", init_method="file:///nonexistent/store",
                  rank=rank, world_size=2)
    assert not dist.is_initialized()


@pytest.mark.parametrize("backend,world,rank,device,cards,ok", [
    ("nccl", 1, 0, "cuda:0", 1, True),
    ("nccl", 2, 1, "cuda:1", 2, True),
    ("nccl", 2, 1, "cuda:0", 2, False),
    ("nccl", 4, 3, "cuda:0", 2, False),
    ("nccl", 2, 0, "cpu", 0, False),
    ("gloo", 2, 1, "cuda:0", 1, True),
    ("gloo", 4, 2, "cpu", 0, True)])
def test_check_backend(backend, world, rank, device, cards, ok):
    import torch

    from ministark_tpu_torch.parallel.sharded import check_backend

    if ok:
        check_backend(backend, world, rank, torch.device(device), cards)
    else:
        with pytest.raises(ValueError, match="gloo"):
            check_backend(backend, world, rank, torch.device(device), cards)


def test_rank_device(monkeypatch):
    import torch

    from ministark_tpu_torch.parallel.sharded import rank_device

    assert rank_device(3, "cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rank_device(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert rank_device(3) == torch.device("cuda", 1)
    assert rank_device(3, "cuda:0") == torch.device("cuda", 0)


def test_make_mesh_without_a_group_or_torchrun_raises(monkeypatch):
    from ministark_tpu_torch.parallel.sharded import make_mesh

    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh(device="cpu")
