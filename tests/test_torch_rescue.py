"""The Rescue slice: the port's Rescue-Prime hash-chain AIR against the JAX
package's, on the CPU.

- ``RescueParams`` (round constants, MDS, MDS^-1, alpha, alpha_inv) over
  Goldilocks and over the 252-bit field;
- the chain's trace and digest;
- the composition evaluation (periodic columns, powers of trace sums
  through ``gl_pow``) against ``eval_composition_numpy`` on random
  CE-domain inputs from a numpy seed, and the generated kernel E source
  built by g++ against the plain version;
- the 4-link proof, made in a subprocess that blocks ``jax`` and
  ``ministark_tpu``, against ``tests/golden/rescue_4links.proof`` (written
  by ``scripts/make_golden_rescue.py``), the JAX verifier and tampering.

Integer field arithmetic: every comparison is exact.  torch and the port
are imported inside the tests and fixtures, so collecting this file stays
cheap in every pytest-xdist worker.
"""

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from ministark_tpu.fields import npfield as nf
from ministark_tpu.fields.scalar import P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "rescue_4links.proof")
SEED = (7, 8)
OPTS = dict(num_queries=8, lde_blowup_factor=8, grinding_factor=4,
            fri_folding_factor=4, fri_max_remainder_coeffs=16)

_PORT_RUN = r"""
import json, sys
sys.modules["jax"] = None            # any import of JAX now fails
sys.modules["ministark_tpu"] = None  # and so does any of the JAX package
from ministark_tpu_torch.air import ProofOptions
from ministark_tpu_torch.fields.scalar import Fp
from ministark_tpu_torch.models.rescue import RescueClaim, gen_trace
from ministark_tpu_torch.proof import Proof
from ministark_tpu_torch.verifier import VerificationError

opts = ProofOptions(**json.loads(sys.argv[1]))
trace, digest = gen_trace((7, 8), 4, device="cpu")
claim = RescueClaim(7, 8, digest[0].v, digest[1].v)
data = claim.prove(opts, trace).to_bytes(Fp)
claim.verify(Proof.from_bytes(data, Fp, Fp), 8)
rejected = []
for pos in (21, len(data) - 1):  # base commitment; last composition OOD eval
    bad = bytearray(data)
    bad[pos] ^= 1
    try:
        claim.verify(Proof.from_bytes(bytes(bad), Fp, Fp), 8)
    except VerificationError:
        rejected.append(pos)
try:
    RescueClaim(7, 8, digest[0].v + 1, digest[1].v).verify(
        Proof.from_bytes(data, Fp, Fp), 8)
    wrong_digest = "accepted"
except VerificationError as e:
    wrong_digest = str(e)
loaded = sorted(m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "ministark_tpu")))
print(json.dumps({"proof": data.hex(), "rejected": rejected,
                  "positions": [21, len(data) - 1], "loaded": loaded,
                  "digest": [digest[0].v, digest[1].v],
                  "wrong_digest": wrong_digest}))
"""


@pytest.fixture(scope="module")
def port_run():
    """The port's 4-link prove in a subprocess without JAX, started first
    so that it runs while this process imports the JAX package."""
    env = dict(os.environ, PYTHONPATH=ROOT, MINISTARK_TPU_TIMERS="0",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", _PORT_RUN,
                             json.dumps(OPTS)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        import ministark_tpu.models.rescue  # noqa: F401
        import ministark_tpu.proof  # noqa: F401

        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def host_build():
    """The g++ build of the Rescue AIR's generated source, compiled while
    the other tests run: (source, future of the loaded library)."""
    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.ops import build

    source = teval._plan_for(_port_air(64))[1]
    with ThreadPoolExecutor(max_workers=1) as ex:
        yield source, ex.submit(build.build_host_library, "eval_rescue_check",
                                source)


def _port_air(trace_len, public_inputs=(7, 8, 1, 2)):
    from ministark_tpu_torch.air import Air, ProofOptions
    from ministark_tpu_torch.models.rescue import RescueAirConfig

    return Air(RescueAirConfig, trace_len, public_inputs,
               ProofOptions(**OPTS))


def _ints(values):
    return [v.v for v in values]


@pytest.mark.parametrize("field", ["goldilocks", "fp252"])
def test_params_match_jax(field):
    """Round constants (SHAKE-256), the MDS matrix and its inverse (Gauss-
    Jordan) and the exponents equal the JAX package's."""
    from ministark_tpu.models.rescue import RescueParams as JaxParams
    from ministark_tpu_torch.models.rescue import RescueParams

    if field == "goldilocks":
        from ministark_tpu.models.rescue import goldilocks_params as jax_gp
        from ministark_tpu_torch.models.rescue import goldilocks_params

        got, want = goldilocks_params(), jax_gp()
    else:
        from ministark_tpu.fields.fp252 import Fp252 as JaxFp252
        from ministark_tpu_torch.fields.fp252 import Fp252, P252

        # the reference's instantiation: m=4, capacity=2, N=14, security 256
        got = RescueParams(Fp252, P252, 3, 4, 2, 14, 256, 2)
        want = JaxParams(JaxFp252, P252, 3, 4, 2, 14, 256, 2)
    assert _ints(got.round_constants) == _ints(want.round_constants)
    assert [_ints(r) for r in got.mds] == [_ints(r) for r in want.mds]
    assert [_ints(r) for r in got.mds_inv] == [_ints(r) for r in want.mds_inv]
    assert (got.alpha, got.alpha_inv) == (want.alpha, want.alpha_inv)
    assert len(got.round_constants) == 2 * 4 * 14
    h = [got.field(1), got.field(2)]
    assert _ints(got.hash(h)) == _ints(want.hash([want.field(1),
                                                   want.field(2)]))


@pytest.mark.parametrize("num_links", [4, 16])
def test_gen_trace_matches_jax(num_links):
    """The chain on plain Python integers equals the JAX package's chain on
    field objects: every trace value and the digest."""
    from ministark_tpu.models.rescue import gen_trace as jax_gen_trace
    from ministark_tpu_torch.models.rescue import chain_digest, gen_trace

    trace, digest = gen_trace(SEED, num_links, device="cpu")
    jtrace, jdigest = jax_gen_trace(SEED, num_links)
    m = jtrace.base_columns()
    want = nf.from_limbs(np.asarray(m.lo), np.asarray(m.hi))
    np.testing.assert_array_equal(trace.base_columns().to_ints(), want)
    assert _ints(digest) == _ints(jdigest)
    assert _ints(chain_digest(SEED, num_links)) == _ints(jdigest)


def test_eval_composition_matches_numpy():
    """The port's evaluation of the Rescue composition (denominators through
    kernel A's plain version, the eleven periodic columns, the terms
    through kernel E's plain version) equals the JAX package's numpy
    evaluator at 64 rows, on a random CE-domain trace with random
    composition coefficients."""
    from ministark_tpu.air import Air as JaxAir
    from ministark_tpu.air import ProofOptions as JaxOptions
    from ministark_tpu.eval import eval_composition_numpy
    from ministark_tpu.fields.scalar import Fp as JaxFp
    from ministark_tpu.models.rescue import RescueAirConfig as JaxConfig
    from ministark_tpu.ntt import Domain as JaxDomain
    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.air import Challenges
    from ministark_tpu_torch.fields.convert import from_u64_numpy, to_u64_numpy
    from ministark_tpu_torch.fields.scalar import Fp

    rng = np.random.default_rng(71)
    pi = tuple(int(v) for v in rng.integers(0, P, 4, dtype=np.uint64))
    jair = JaxAir(JaxConfig, 64, pi, JaxOptions(**OPTS))
    air = _port_air(64, pi)
    n = 64 * jair.ce_blowup_factor
    assert air.ce_blowup_factor == jair.ce_blowup_factor == 8
    dom = JaxDomain(n, 7)
    x = np.array([dom.element(i).v for i in range(n)], dtype=np.uint64)
    base = rng.integers(0, P, size=(4, n), dtype=np.uint64)
    coeffs = [int(v) for v in rng.integers(
        0, P, jair.num_composition_constraint_coeffs(), dtype=np.uint64)]
    assert air.num_composition_constraint_coeffs() == len(coeffs) == 20
    want = eval_composition_numpy(
        jair, [JaxFp(v) for v in coeffs], [], jair.gen_hints([]),
        nf.to_limbs(x), nf.to_limbs(base), None)
    want = nf.from_limbs(np.asarray(want[0]), np.asarray(want[1]))
    got = teval.eval_composition(
        air, [Fp(v) for v in coeffs], Challenges(),
        air.gen_hints(Challenges()), from_u64_numpy(x), from_u64_numpy(base))
    np.testing.assert_array_equal(to_u64_numpy(got), want)


@pytest.mark.parametrize("trace_len", [64, 1 << 18])
def test_degree_bookkeeping_matches_jax(trace_len):
    """What follows from the constraints' degrees equals the JAX package's:
    the CE blowup (8), the composition degree and columns, the trace
    arguments (the OOD points and DEEP terms), the composition
    coefficients, the domains; both refuse an LDE blowup below 8."""
    from ministark_tpu.air import Air as JaxAir
    from ministark_tpu.air import ProofOptions as JaxOptions
    from ministark_tpu.models.rescue import RescueAirConfig as JaxConfig
    from ministark_tpu_torch.air import ProofOptions
    from ministark_tpu_torch.models.rescue import RescueAirConfig

    jair = JaxAir(JaxConfig, trace_len, (7, 8, 1, 2), JaxOptions(**OPTS))
    air = _port_air(trace_len)
    assert air.ce_blowup_factor == jair.ce_blowup_factor == 8
    assert air.composition_degree() == jair.composition_degree()
    assert air.trace_arguments() == jair.trace_arguments()
    assert len(air.trace_arguments()) == 8  # 4 columns at offsets 0 and 1
    assert (air.num_composition_constraint_coeffs()
            == jair.num_composition_constraint_coeffs() == 20)
    for dom, jdom in ((air.lde_domain(), jair.lde_domain()),
                      (air.ce_domain(), jair.ce_domain())):
        assert (dom.size, dom.offset, dom.group_gen) == (
            jdom.size, jdom.offset, jdom.group_gen)
    low = dict(OPTS, lde_blowup_factor=4)
    with pytest.raises(AssertionError, match="ce blowup 8"):
        JaxAir(JaxConfig, trace_len, (7, 8, 1, 2), JaxOptions(**low))
    with pytest.raises(AssertionError, match="ce blowup 8"):
        from ministark_tpu_torch.air import Air
        Air(RescueAirConfig, trace_len, (7, 8, 1, 2), ProofOptions(**low))


def _eval_args(air, seed):
    """Random kernel E inputs for the Rescue plan at the AIR's CE domain,
    with the plan's Pow exponents in the scalar table."""
    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.fields.convert import from_u64_numpy
    import torch

    plan, source, _ = teval._plan_for(air)
    n = air.ce_domain().size
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return from_u64_numpy(rng.integers(0, P, size=shape, dtype=np.uint64))

    s = rand(plan.num_slots)
    for what, e, _kind in plan.scalars:
        if what == "exp":
            s[plan.slot[("exp", e)]] = e
    empty = torch.zeros((0, 3, n), dtype=torch.int64)
    return plan, source, [rand(4, n), empty, air.ce_domain().elements("cpu"),
                          rand(len(plan.periodic), n),
                          rand(len(plan.inv_keys), n), empty, s]


@pytest.mark.parametrize("groups", [0, 1])
def test_generated_source_host_build_matches_plain(host_build, groups):
    """The Rescue source (eleven periodic inputs, eight runtime-exponent
    powers, the shared powers of X), built as host C++ by g++, equals
    the plain version point for point, in both of the launches' ways."""
    import torch

    from ministark_tpu_torch.ops import eval as keval

    air = _port_air(64)
    plan, source, args = _eval_args(air, 72)
    assert source == host_build[0]
    assert len(plan.periodic) == 11 and len(plan.groups) == 1
    n = args[2].shape[0]
    want = keval.eval_terms_plain(plan, air.ce_blowup_factor, *args)
    lib = host_build[1].result()
    out = torch.empty(n, dtype=torch.int64)
    part = torch.empty((len(plan.groups), n), dtype=torch.int64)
    lib.ms_eval_host.restype = None
    lib.ms_eval_host.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64,
                                                         ctypes.c_int]
    lib.ms_eval_host(*[t.data_ptr() for t in args], part.data_ptr(),
                     out.data_ptr(), n, groups)
    assert torch.equal(out, want)


@pytest.mark.parametrize("trace_len", [64, 256, 1 << 18])
def test_source_is_one_for_every_trace_length(trace_len, host_build):
    """A periodic column adds N/16 to a degree adjustment (x^(N + N/16 +
    5)); read as a linear function of N, every trace length gives the
    same source, with the two powers of X in the shared prologue."""
    from ministark_tpu_torch import eval as teval

    plan, source, _ = teval._plan_for(_port_air(trace_len))
    assert source == host_build[0]
    n = trace_len
    assert plan.power_of == {n + n // 16 + 5: ("per", 1, 1, 5, 16),
                             7 * n + 1: ("small", 7, 1)}
    assert plan.period == 16
    assert sorted(v for what, v, _k in plan.scalars if what == "exp") == [
        7, n]


def test_shared_powers_match_pow(host_build):
    """The prologue's powers at 2^18 rows, from the g++ build, equal
    pow(x, e, P) at random x (0 and 1 included)."""
    import torch

    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.fields.convert import from_u64_numpy, to_u64_numpy

    rows = 1 << 18
    plan = teval._plan_for(_port_air(rows))[0]
    s = torch.zeros(max(plan.num_slots, 1), dtype=torch.int64)
    s[plan.slot[("exp", rows)]] = rows
    rng = np.random.default_rng(73)
    xs = np.concatenate([np.array([0, 1, P - 1], dtype=np.uint64),
                         rng.integers(0, P, size=61, dtype=np.uint64)])
    m = xs.shape[0]
    pw = torch.empty(len(plan.powers) * m, dtype=torch.int64)
    lib = host_build[1].result()
    lib.ms_eval_powers_host.restype = None
    lib.ms_eval_powers_host.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int64, ctypes.c_void_p]
    xt = from_u64_numpy(xs)
    lib.ms_eval_powers_host(xt.data_ptr(), s.data_ptr(), m, pw.data_ptr())
    got = to_u64_numpy(pw).reshape(len(plan.powers), m)
    for e, key in plan.power_of.items():
        k = plan.powers.index(key)
        assert [int(v) for v in got[k]] == [pow(int(v), e, P) for v in xs]


@pytest.mark.parametrize("exps,exps_2n,want", [
    ([73, 449], [141, 897], {73: ("per", 1, 1, 5, 16),
                                      449: ("small", 7, 1)}),
    ([64 + 63, 5], [128 + 127, 5], {127: ("nm1", 1), 5: ("small", 0, 5)}),
    ([73, 127], [141, 255], {127: ("nm1", 1)}),   # r is x^(N - 1)
    ([73], [999], {}),                            # not linear in N / d
    ([73, 73], [151, 152], {}),                   # one node, two twins
])
def test_power_keys(exps, exps_2n, want):
    from ministark_tpu_torch.ops import eval as keval

    assert keval.power_keys(exps, exps_2n, 64, 16) == want


def test_port_proof_matches_golden_bytes(port_run):
    with open(GOLDEN, "rb") as f:
        want = f.read()
    assert bytes.fromhex(port_run["proof"]) == want


def test_jax_verifier_accepts_port_proof(port_run):
    from ministark_tpu.fields.scalar import Fp
    from ministark_tpu.models.rescue import RescueClaim, chain_digest
    from ministark_tpu.proof import Proof

    d0, d1 = chain_digest(SEED, 4)
    assert port_run["digest"] == [d0.v, d1.v]
    claim = RescueClaim(*SEED, d0.v, d1.v)
    claim.verify(Proof.from_bytes(bytes.fromhex(port_run["proof"]), Fp, Fp),
                 8)


def test_wrong_digest_fails_both_verifiers(port_run):
    from ministark_tpu.fields.scalar import Fp
    from ministark_tpu.models.rescue import RescueClaim
    from ministark_tpu.proof import Proof
    from ministark_tpu.verifier import VerificationError

    assert port_run["wrong_digest"] != "accepted"
    d0, d1 = port_run["digest"]
    with pytest.raises(VerificationError):
        RescueClaim(*SEED, d0 + 1, d1).verify(
            Proof.from_bytes(bytes.fromhex(port_run["proof"]), Fp, Fp), 8)


def test_port_verifier_rejects_flipped_byte(port_run):
    assert port_run["rejected"] == port_run["positions"]


def test_port_never_imports_jax(port_run):
    assert port_run["loaded"] == []
