"""The port's host modules against the JAX package's, on the CPU: the
constraint validator (``debug``), ``prove(..., validate=True)``, the
polynomial helpers and fixtures (``utils``), the big prime fields
(``fields/fp128.py``, ``fields/fp252.py``), the brainfuck CLI and its
fixed permutation initials.

Every input comes from a numpy seed; every comparison is exact.  The JAX
package is only given the port's values as limb arrays, so nothing here
compiles JAX.  The CLI round trip proves in a subprocess that blocks
``jax`` and ``ministark_tpu``, started with the first test so that it runs
while the others do.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ministark_tpu.fields.scalar import P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF_PROGRAM = "++>+++[<+>-]<."
# the CLI proves with its 96-bit options (a 20-bit grind, on the CPU in
# plain torch): this 32-row program's nonce is 363162, about 2 s of it
CLI_PROGRAM = "++[>+<-]>."

_CLI_RUN = r"""
import json, os, sys
sys.modules["jax"] = None            # any import of JAX now fails
sys.modules["ministark_tpu"] = None  # and so does any of the JAX package
from ministark_tpu_torch.models.brainfuck import cli

src, dst = sys.argv[1], sys.argv[2]
cli.main(["prove", src, "--dst", dst, "--device", "cpu"])
cli.main(["verify", src, "--proof", dst, "--output", "\x02"])
loaded = sorted(m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "ministark_tpu")))
print(json.dumps({"loaded": loaded}))
"""


@pytest.fixture(scope="module", autouse=True)
def cli_run(tmp_path_factory):
    """The port's CLI proving and verifying CLI_PROGRAM on the CPU, in a
    subprocess: (process, source path, proof path)."""
    d = tmp_path_factory.mktemp("cli")
    src, dst = d / "prog.bf", d / "prog.proof"
    src.write_text(CLI_PROGRAM)
    env = dict(os.environ, PYTHONPATH=ROOT, MINISTARK_TPU_TIMERS="0",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", _CLI_RUN, str(src),
                             str(dst)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        yield proc, src, dst
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# -- the constraint validator ---------------------------------------------------

def _witness(model: str, bad: bool):
    """(port claim, port trace, JAX claim, challenges as ints) for `model`'s
    small trace on the CPU; `bad` changes one base-trace value (row 3,
    column 0) before anything is built from it."""
    rng = np.random.default_rng(81)
    if model == "rescue":
        from ministark_tpu.models.rescue import RescueClaim as JaxClaim
        from ministark_tpu_torch.models.rescue import RescueClaim, gen_trace

        trace, (d0, d1) = gen_trace((7, 8), 4, device="cpu")
        if bad:
            trace.matrix.values[0, 3] += 1
        return (RescueClaim(7, 8, d0.v, d1.v), trace,
                JaxClaim(7, 8, d0.v, d1.v), [])
    if model == "fib":
        from ministark_tpu.fields.scalar import Fp as JaxFp
        from ministark_tpu.models.fib import FibClaim as JaxClaim
        from ministark_tpu_torch.models.fib import FibClaim, gen_trace

        trace = gen_trace(1 << 9, device="cpu")  # 2^6 rows
        if bad:
            trace.matrix.values[0, 3] += 1
        last = trace.last_value()
        return FibClaim(last), trace, JaxClaim(JaxFp(last.v)), []
    from ministark_tpu.models.brainfuck import BrainfuckClaim as JaxClaim
    from ministark_tpu_torch.models.brainfuck import (BrainfuckClaim,
                                                      BrainfuckTrace, simulate)

    tables, output = simulate(BF_PROGRAM)
    if bad:
        tables["processor"][3, 0] += 1
    claim = BrainfuckClaim(BF_PROGRAM, b"", output)
    trace = BrainfuckTrace(tables, device="cpu")
    k = claim.build_air(trace.base_columns().num_rows,
                        _opts(model)).num_challenges()
    ch = [[int(v) for v in rng.integers(0, P, 3, dtype=np.uint64)]
          for _ in range(k)]
    return claim, trace, JaxClaim(BF_PROGRAM, b"", output), ch


def _opts(model: str):
    from ministark_tpu_torch.air import ProofOptions

    return ProofOptions(*{"rescue": (8, 8, 0, 4, 16), "fib": (8, 4, 0, 4, 16),
                          "bf": (9, 16, 0, 4, 16)}[model])


def _validate_port(model, bad):
    from ministark_tpu_torch import debug
    from ministark_tpu_torch.air import Challenges
    from ministark_tpu_torch.fields.scalar import Fq3

    claim, trace, _jclaim, ch = _witness(model, bad)
    base = trace.base_columns()
    air = claim.build_air(base.num_rows, _opts(model))
    challenges = Challenges(Fq3(*c) for c in ch)
    ext = trace.build_extension_columns(challenges)
    try:
        debug.validate_constraints(air, challenges, air.gen_hints(challenges),
                                   base, ext)
    except debug.ConstraintViolation as e:
        return str(e), base, ext
    return None, base, ext


def _validate_jax(model, bad, base, ext):
    """The JAX validator on the port's trace values (limb arrays)."""
    from ministark_tpu import debug
    from ministark_tpu.air import Challenges, ProofOptions
    from ministark_tpu.fields import device as jfd
    from ministark_tpu.fields.scalar import Fq3
    from ministark_tpu.matrix import Matrix, MatrixExt3

    _claim, _trace, jclaim, ch = _witness(model, bad)
    jbase = Matrix.from_columns_np(base.to_ints())
    jext = None
    if ext is not None:
        e = ext.to_ints()
        jext = MatrixExt3(*(jfd.pack_np(e[:, k]) for k in range(3)))
    opts = _opts(model)
    air = jclaim.build_air(jbase.num_rows, ProofOptions(
        opts.num_queries, opts.lde_blowup_factor, opts.grinding_factor,
        opts.fri_folding_factor, opts.fri_max_remainder_coeffs))
    challenges = Challenges(Fq3(*c) for c in ch)
    try:
        debug.validate_constraints(air, challenges, air.gen_hints(challenges),
                                   jbase, jext)
    except debug.ConstraintViolation as e:
        return str(e)
    return None


@pytest.mark.parametrize("bad", [False, True], ids=["good", "bad"])
@pytest.mark.parametrize("model", ["rescue", "fib", "bf"])
def test_validate_constraints_agrees_with_jax(model, bad):
    """Both validators pass a good trace and stop at the same constraint
    and row, with the same message, on a bad one."""
    got, base, ext = _validate_port(model, bad)
    assert got == _validate_jax(model, bad, base, ext)
    assert (got is not None) == bad
    if bad:
        assert "is not satisfied at row" in got


@pytest.mark.parametrize("model", ["rescue", "fib", "bf"])
def test_prove_validate_raises_on_bad_trace(model):
    from ministark_tpu_torch import debug

    claim, trace, _jclaim, _ch = _witness(model, bad=True)
    with pytest.raises(debug.ConstraintViolation):
        claim.prove(_opts(model), trace, validate=True)


def test_validate_full_switch(monkeypatch):
    """MINISTARK_TPU_DEBUG_FULL=1 checks every row; past MAX_FULL_ROWS the
    default samples rows from seed 0 (a bad row outside the sample
    passes)."""
    from ministark_tpu_torch import debug
    from ministark_tpu_torch.air import Challenges
    from ministark_tpu_torch.models.rescue import RescueClaim, gen_trace

    links = 2 * debug.MAX_FULL_ROWS // 16
    trace, (d0, d1) = gen_trace((1, 2), links, device="cpu")
    n = trace.matrix.num_rows
    import random
    rng = random.Random(0)
    sample = {0, 1, n - 2, n - 1} | {rng.randrange(n) for _ in range(252)}
    row = next(r for r in range(5, n, 16)
               if r not in sample and r - 1 not in sample)
    trace.matrix.values[0, row] += 1
    claim = RescueClaim(1, 2, d0.v, d1.v)
    air = claim.build_air(n, _opts("rescue"))
    hints = air.gen_hints(Challenges())
    monkeypatch.delenv("MINISTARK_TPU_DEBUG_FULL", raising=False)
    debug.validate_constraints(air, Challenges(), hints, trace.matrix, None)
    monkeypatch.setenv("MINISTARK_TPU_DEBUG_FULL", "1")
    with pytest.raises(debug.ConstraintViolation, match=f"at row {row - 1} "):
        debug.validate_constraints(air, Challenges(), hints, trace.matrix,
                                   None)


# -- utils: polynomial helpers and fixtures --------------------------------------

def _fps(rng, k):
    return [int(v) for v in rng.integers(0, P, k, dtype=np.uint64)]


def test_poly_helpers_match_jax():
    from ministark_tpu.fields.scalar import Fp as JFp
    from ministark_tpu.ntt import Domain as JDomain
    from ministark_tpu.utils import poly as jpoly
    from ministark_tpu_torch.fields.scalar import Fp
    from ministark_tpu_torch.ntt import Domain
    from ministark_tpu_torch.utils import poly

    rng = np.random.default_rng(82)
    coeffs, (x, z, c) = _fps(rng, 17), _fps(rng, 3)

    def ints(vs):
        return [v.v for v in vs]

    assert (poly.horner_evaluate([Fp(v) for v in coeffs], Fp(x)).v
            == jpoly.horner_evaluate([JFp(v) for v in coeffs], JFp(x)).v)
    assert ints(poly.divide_out_point([Fp(v) for v in coeffs], Fp(z), Fp(c))) \
        == ints(jpoly.divide_out_point([JFp(v) for v in coeffs], JFp(z),
                                       JFp(c)))
    for size, offset in ((16, 7), (1 << 10, 1)):
        assert (poly.evaluate_vanishing_polynomial(Domain(size, offset),
                                                   Fp(x)).v
                == jpoly.evaluate_vanishing_polynomial(JDomain(size, offset),
                                                       JFp(x)).v)
    vals = _fps(rng, 32)
    assert poly.interleave(vals, 4) == jpoly.interleave(vals, 4)
    assert (poly.reduce_lde_blowup_factor(vals, 8, 2)
            == jpoly.reduce_lde_blowup_factor(vals, 8, 2))


@pytest.mark.parametrize("fixture", ["fib", "binary"])
def test_fixtures_match_jax(fixture):
    from ministark_tpu.fields import npfield as nf
    from ministark_tpu.utils import fixtures as jfix
    from ministark_tpu_torch.utils import fixtures

    if fixture == "fib":
        got, want = fixtures.gen_fib_matrix(100, device="cpu"), \
            jfix.gen_fib_matrix(100)
    else:
        got = fixtures.gen_binary_valued_matrix(64, 3, P + 5, seed=83,
                                                device="cpu")
        want = jfix.gen_binary_valued_matrix(64, 3, P + 5, seed=83)
    np.testing.assert_array_equal(
        got.to_ints(), nf.from_limbs(np.asarray(want.lo), np.asarray(want.hi)))


def test_utils_exports_match_jax():
    import ministark_tpu.utils as jutils
    import ministark_tpu_torch.utils as utils

    assert sorted(utils.__all__) == sorted(jutils.__all__)


# -- the big prime fields ---------------------------------------------------------

@pytest.mark.parametrize("op", ["add", "sub", "rsub", "mul", "div", "neg",
                                "pow", "inverse", "bytes", "eq"])
@pytest.mark.parametrize("field", ["fp128", "fp252"])
def test_big_prime_field_ops_match_jax(field, op):
    import importlib

    port = importlib.import_module(f"ministark_tpu_torch.fields.{field}")
    jax_mod = importlib.import_module(f"ministark_tpu.fields.{field}")
    name = {"fp128": "Fp128", "fp252": "Fp252"}[field]
    F, J = getattr(port, name), getattr(jax_mod, name)
    assert (F.MODULUS, F.GENERATOR, F.NUM_BYTES) == (J.MODULUS, J.GENERATOR,
                                                     J.NUM_BYTES)
    rng = np.random.default_rng(84)
    for _ in range(8):
        a, b, e = (int.from_bytes(rng.bytes(40), "little") for _ in range(3))
        fa, fb, ja, jb = F(a), F(b), J(a), J(b)
        got, want = {
            "add": lambda: (fa + fb, ja + jb),
            "sub": lambda: (fa - fb, ja - jb),
            "rsub": lambda: (b - fa, b - ja),
            "mul": lambda: (fa * fb, ja * jb),
            "div": lambda: (fa / fb, ja / jb),
            "neg": lambda: (-fa, -ja),
            "pow": lambda: (fa ** (e % 2**70), ja ** (e % 2**70)),
            "inverse": lambda: (fa.inverse(), ja.inverse()),
            "bytes": lambda: (F.from_bytes(fa.to_bytes()),
                              J.from_bytes(ja.to_bytes())),
            "eq": lambda: (F((fa == a) + 2 * (fa == fb) + 4 * (fa == F(a))),
                           J((ja == a) + 2 * (ja == jb) + 4 * (ja == J(a)))),
        }[op]()
        assert got.v == want.v
        assert got.to_bytes() == want.to_bytes()
    with pytest.raises(ZeroDivisionError):
        F(0).inverse()


# -- the brainfuck CLI and its initials --------------------------------------------

def test_cli_round_trip_verifies_in_both_packages(cli_run):
    """The port's CLI proves on the CPU and verifies its own file; the JAX
    CLI's verify accepts the same file, whose claim bytes are the JAX
    package's."""
    from ministark_tpu import serde as jserde
    from ministark_tpu.models.brainfuck import cli as jcli
    from ministark_tpu.models.brainfuck import BrainfuckClaim as JaxClaim
    from ministark_tpu_torch import serde
    from ministark_tpu_torch.models.brainfuck import BrainfuckClaim, cli

    proc, src, dst = cli_run
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    assert json.loads(out.strip().splitlines()[-1])["loaded"] == []
    assert "Proof verified in" in out
    jcli.cmd_verify(argparse.Namespace(src=str(src), proof=str(dst),
                                       input="", output="\x02"))
    w, jw = serde.Writer(), jserde.Writer()
    cli.serialize_claim(w, BrainfuckClaim(CLI_PROGRAM, b"", b"\x02"))
    jcli.serialize_claim(jw, JaxClaim(CLI_PROGRAM, b"", b"\x02"))
    assert w.bytes() == jw.bytes()
    assert dst.read_bytes().startswith(w.bytes())
    assert cli.OPTIONS.to_bytes() == jcli.OPTIONS.to_bytes()


@pytest.mark.parametrize("mode", ["fixed", None])
def test_perm_initials_match_jax(monkeypatch, mode):
    """MINISTARK_TPU_BF_INITIALS=fixed gives the JAX package's fixed
    constants, read on each call; unset, the reference's ChaCha12 draws."""
    from ministark_tpu.models.brainfuck import trace as jtrace
    from ministark_tpu_torch.models.brainfuck import trace

    if mode is None:
        monkeypatch.delenv("MINISTARK_TPU_BF_INITIALS", raising=False)
    else:
        monkeypatch.setenv("MINISTARK_TPU_BF_INITIALS", mode)
    got, want = trace.perm_initials(), jtrace._perm_initials()
    assert [(v.c0.v, v.c1.v, v.c2.v) for v in got] == \
        [(v.c0.v, v.c1.v, v.c2.v) for v in want]
    monkeypatch.setenv("MINISTARK_TPU_BF_INITIALS",
                       "default" if mode else "fixed")
    assert trace.perm_initials() != got
