"""The port's NTT (plain versions of kernels B and C under the six-step
pipeline) against the JAX package's domain and a Horner reference.

Inputs are numpy draws from a fixed seed; equality is exact.  torch and
the port are imported inside the tests, so collecting this file stays cheap
in every pytest-xdist worker.
"""

import numpy as np
import pytest

from ministark_tpu.fields.scalar import Fp, P
from ministark_tpu.ntt import Domain as JaxDomain
from ministark_tpu.utils.poly import horner_evaluate


def _coeffs(seed, rows, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, P, size=(rows, n), dtype=np.uint64)


@pytest.mark.parametrize("offset", [1, 7])
@pytest.mark.parametrize("n", [2, 4, 8, 16, 32, 64])
def test_fft_matches_horner_over_jax_domain(n, offset):
    from ministark_tpu_torch.fields.convert import from_u64_numpy, to_u64_numpy
    from ministark_tpu_torch.ntt import Domain

    c = _coeffs(n * 10 + offset, 3, n)
    got = to_u64_numpy(Domain(n, offset).fft(from_u64_numpy(c)))
    jd = JaxDomain(n, offset)
    for r in range(3):
        coeffs = [Fp(int(v)) for v in c[r]]
        want = [horner_evaluate(coeffs, jd.element(i)).v for i in range(n)]
        assert [int(v) for v in got[r]] == want, (n, offset, r)


@pytest.mark.parametrize("offset", [1, 7])
def test_ifft_inverts_fft_and_short_inputs_pad(offset):
    from ministark_tpu_torch.fields.convert import from_u64_numpy, to_u64_numpy
    from ministark_tpu_torch.ntt import Domain

    n = 256
    c = _coeffs(3, 4, n)
    d = Domain(n, offset)
    t = from_u64_numpy(c)
    np.testing.assert_array_equal(to_u64_numpy(d.ifft(d.fft(t))), c)
    short = from_u64_numpy(c[:, : n // 4])
    padded = np.concatenate([c[:, : n // 4],
                             np.zeros((4, 3 * n // 4), np.uint64)], axis=1)
    np.testing.assert_array_equal(to_u64_numpy(d.fft(short)),
                                  to_u64_numpy(d.fft(from_u64_numpy(padded))))


def test_domain_elements_match_jax_domain():
    from ministark_tpu_torch.fields import device as fd
    from ministark_tpu_torch.ntt import Domain

    for n, off in ((16, 1), (64, 7), (512, 7)):
        d, jd = Domain(n, off), JaxDomain(n, off)
        assert fd.to_ints(d.elements("cpu")) == [jd.element(i).v
                                                 for i in range(n)]
        assert (d.group_gen, d.offset_pow_size()) == (
            jd.group_gen, jd.offset_pow_size())


def test_transpose_plain_matches_numpy():
    import torch

    from ministark_tpu_torch.ops import transpose as ktr

    a = np.random.default_rng(5).integers(-(1 << 63), (1 << 63) - 1,
                                          size=(3, 40, 72), dtype=np.int64)
    got = ktr.transpose(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, a.transpose(0, 2, 1))


def test_col_ntt_plain_is_a_dft_per_column():
    """Kernel B's contract: bit-reversed load, pre scale, all stages, tmat
    fold — checked column by column against the DFT definition."""
    from ministark_tpu_torch.fields.convert import from_u64_numpy, to_u64_numpy
    from ministark_tpu_torch.fields.scalar import get_root_of_unity
    from ministark_tpu_torch.ntt import powers
    from ministark_tpu_torch.ops import ntt as kntt

    B, n1, C = 2, 16, 8
    x = _coeffs(6, B * n1, C).reshape(B, n1, C)
    pre = _coeffs(7, n1, C)
    tmat = _coeffs(8, n1, C)
    w = get_root_of_unity(n1).v
    got = to_u64_numpy(kntt.col_ntt(
        from_u64_numpy(x), powers(w, n1 // 2, "cpu"),
        pre=from_u64_numpy(pre), tmat=from_u64_numpy(tmat)))
    for b in range(B):
        for c in range(C):
            for k in range(n1):
                acc = sum(int(x[b, j, c]) * int(pre[j, c]) * pow(w, j * k, P)
                          for j in range(n1)) % P
                assert int(got[b, k, c]) == acc * int(tmat[k, c]) % P
