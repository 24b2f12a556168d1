"""The port's distributed six-step NTT (``parallel.ntt.ShardedDomain``) in
2 and 4 CPU ranks over gloo, against Horner's rule over the JAX package's
``Domain.element`` (host ints, no JAX compile) and the port's one-process
``Domain``.

Every rank transforms its contiguous block of the same seeded vector; the
blocks, put together in rank order, must equal the one-process transform
exactly.  Each world size's ranks are spawned once for the file, and each
(world size, n, offset, field) is transformed once, its fft, ifft and
round trip read by the tests below.
"""

import numpy as np
import pytest

from ministark_tpu.fields.scalar import GENERATOR, Fp
from ministark_tpu.ntt import Domain as JaxDomain
from ministark_tpu.utils.poly import horner_evaluate

import torch_sharded_tasks as tasks

CASES = [(d, n, offset, ext) for d in (2, 4) for n in (1 << 6, 1 << 8)
         for offset in (1, GENERATOR) for ext in (False, True)]
IDS = [f"d{d}-n{n}-off{o}-{'fq3' if e else 'fp'}" for d, n, o, e in CASES]


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    p = tasks.Pools(tmp_path_factory)
    yield p
    p.close()


@pytest.fixture(scope="module")
def transformed(pools):
    """(d, n, offset, ext) -> {"fft", "ifft", "back", "mine"}: the ranks'
    blocks in rank order, and "x", the whole input; each case runs once."""
    done = {}

    def get(d, n, offset, ext):
        key = (d, n, offset, ext)
        if key not in done:
            seed = n + 10 * offset + int(ext)
            blocks = pools(d).run(tasks.ntt, n, offset, ext, seed)
            done[key] = {k: np.concatenate([b[k] for b in blocks], axis=-1)
                         for k in ("fft", "ifft", "back", "mine")}
            done[key]["x"] = tasks.values(seed, *((3, n) if ext else (n,)))
        return done[key]
    return get


def _one_process(x, n, offset, inverse):
    from ministark_tpu_torch.fields.convert import from_u64_numpy, to_u64_numpy
    from ministark_tpu_torch.ntt import Domain

    dom = Domain(n, offset)
    t = from_u64_numpy(np.ascontiguousarray(x))
    return to_u64_numpy(dom.ifft(t) if inverse else dom.fft(t))


@pytest.mark.parametrize("d,n,offset,ext", CASES, ids=IDS)
def test_fft_matches_horner_and_one_process(transformed, d, n, offset, ext):
    r = transformed(d, n, offset, ext)
    np.testing.assert_array_equal(r["mine"], r["x"])
    np.testing.assert_array_equal(r["fft"], _one_process(r["x"], n, offset,
                                                         False))
    jd = JaxDomain(n, offset)
    points = range(n) if n <= 64 else range(0, n, 7)
    xs, got = np.atleast_2d(r["x"]), np.atleast_2d(r["fft"])
    for c in range(xs.shape[0]):
        coeffs = [Fp(int(v)) for v in xs[c]]
        for i in points:
            assert int(got[c, i]) == horner_evaluate(coeffs,
                                                     jd.element(i)).v, (c, i)


@pytest.mark.parametrize("d,n,offset,ext", CASES, ids=IDS)
def test_ifft_matches_one_process_and_inverts_fft(transformed, d, n, offset,
                                                  ext):
    r = transformed(d, n, offset, ext)
    np.testing.assert_array_equal(r["ifft"], _one_process(r["x"], n, offset,
                                                          True))
    np.testing.assert_array_equal(r["back"], r["x"])


class _OneRank:
    """A mesh of one rank whose collectives are the identity."""
    d, rank, device = 1, 0, "cpu"

    def all_to_all(self, x):
        return x.contiguous()


@pytest.mark.parametrize("offset", [1, GENERATOR])
@pytest.mark.parametrize("n", [2, 8, 1 << 7])
def test_one_rank_equals_domain(n, offset):
    from ministark_tpu_torch.parallel.ntt import ShardedDomain

    x = tasks.values(n + offset, 3, n)
    dom = ShardedDomain(_OneRank(), n, offset)
    t = tasks._tensor(x, "cpu")
    np.testing.assert_array_equal(tasks._host(dom.fft(t)),
                                  _one_process(x, n, offset, False))
    np.testing.assert_array_equal(tasks._host(dom.ifft(t)),
                                  _one_process(x, n, offset, True))


@pytest.mark.parametrize("d,n,ok", [(2, 4, True), (2, 2, False),
                                    (4, 16, True), (4, 8, False),
                                    (4, 32, True), (8, 32, False),
                                    (8, 64, True)])
def test_world_size_must_divide_both_factors(d, n, ok):
    """n1, n2 = 2^floor(k/2), 2^ceil(k/2) for n = 2^k
    (``parallel/ntt.py:131-132`` of the JAX package asserts the same)."""
    from ministark_tpu_torch.parallel.ntt import ShardedDomain

    mesh = _OneRank()
    mesh.d = d
    if ok:
        dom = ShardedDomain(mesh, n)
        assert dom.n1 % d == 0 and dom.n2 % d == 0
    else:
        with pytest.raises(AssertionError, match="six-step factors"):
            ShardedDomain(mesh, n)
