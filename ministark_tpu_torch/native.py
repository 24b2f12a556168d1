"""ctypes bindings for the repository's native host runtime
(native/ministark_native.cpp): PoW grinding, Merkle multi-proof
verification, the verifier's FRI and DEEP scalar math, and the fib trace.

Loads ``native/libministark_native.so``; if that fails, builds
``native/ministark_native.cpp`` with g++ into ``ministark_tpu_torch/_build``
(never into ``native/``).  Every entry point returns None when no library
can be had, and callers fall back to Python.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
_REPO_LIB = os.path.join(_NATIVE_DIR, "libministark_native.so")
_BUILD_LIB = os.path.join(_PKG, "_build", "libministark_native.so")

_lib = None
_tried = False


def _load():
    try:
        return ctypes.CDLL(_REPO_LIB)
    except OSError:
        pass
    if not os.path.exists(_BUILD_LIB):
        os.makedirs(os.path.dirname(_BUILD_LIB), exist_ok=True)
        tmp = _BUILD_LIB + f".{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-o",
                        tmp, os.path.join(_NATIVE_DIR, "ministark_native.cpp")],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, _BUILD_LIB)
    return ctypes.CDLL(_BUILD_LIB)


def get_lib():
    """The loaded library, or None (callers fall back to Python)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = _load()
    except (OSError, subprocess.SubprocessError):
        return None
    U64P = ctypes.POINTER(ctypes.c_uint64)
    lib.pow_grind.restype = ctypes.c_uint64
    lib.pow_grind.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
    lib.mk_verify_view.restype = ctypes.c_int
    lib.mk_verify_view.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, U64P, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t]
    lib.fri_fold_rows.restype = None
    lib.fri_fold_rows.argtypes = [
        U64P, ctypes.c_size_t, ctypes.c_uint32, U64P, ctypes.c_uint64,
        U64P, U64P]
    lib.deep_evals.restype = None
    lib.deep_evals.argtypes = [
        U64P, ctypes.c_size_t,
        ctypes.c_size_t, U64P, U64P, U64P, U64P,
        ctypes.c_size_t, U64P, U64P, U64P,
        U64P, U64P, U64P, U64P]
    lib.gen_fib_trace.restype = None
    lib.gen_fib_trace.argtypes = [U64P, ctypes.c_size_t]
    _lib = lib
    return _lib


def pow_grind(seed: bytes, bits: int) -> int | None:
    """Smallest nonce >= 1 meeting the PoW target; None without the lib."""
    lib = get_lib()
    if lib is None:
        return None
    return int(lib.pow_grind(seed, bits))


def _u64_arr(vals):
    return (ctypes.c_uint64 * len(vals))(*vals)


def _fq3_flat(scalars) -> list[int]:
    """Flatten Fp/Fq3 scalars to (c0, c1, c2) canonical u64 triples."""
    out = []
    for s in scalars:
        if hasattr(s, "c0"):
            out.extend([s.c0.v, s.c1.v, s.c2.v])
        else:
            out.extend([s.v if hasattr(s, "v") else int(s), 0, 0])
    return out


def mk_verify_view(root: bytes, height: int, indices: list[int],
                   initial_leaves: list[bytes], sibling_leaves: list[bytes],
                   nodes: list[bytes]) -> int | None:
    """Native Merkle multi-proof check: 0 = valid, >0 = the Python
    verify_view failure modes in order; None without the lib."""
    lib = get_lib()
    if lib is None:
        return None
    return int(lib.mk_verify_view(
        root, height, _u64_arr(indices), len(indices),
        b"".join(initial_leaves), b"".join(sibling_leaves),
        len(sibling_leaves), b"".join(nodes), len(nodes)))


def fri_fold_rows(rows_flat: list, N: int, offsets: list[int], w: int,
                  alpha) -> list[tuple[int, int, int]] | None:
    """Native FRI next-layer evals; rows_flat = n*N scalars (row-major)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(rows_flat) // N
    out = (ctypes.c_uint64 * (3 * n))()
    lib.fri_fold_rows(_u64_arr(_fq3_flat(rows_flat)), n, N,
                      _u64_arr(offsets), w, _u64_arr(_fq3_flat([alpha])), out)
    return [(out[3 * i], out[3 * i + 1], out[3 * i + 2]) for i in range(n)]


def deep_evals(xs: list[int], n_args: int, trace_vals: list, oods: list,
               alphas: list, zshifts: list, n_comp: int, comp_vals: list,
               coods: list, betas: list, zn, da, db):
    """Native DEEP quotient evaluations; n (c0, c1, c2) triples or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(xs)
    out = (ctypes.c_uint64 * (3 * n))()
    lib.deep_evals(
        _u64_arr(xs), n,
        n_args, _u64_arr(_fq3_flat(trace_vals)), _u64_arr(_fq3_flat(oods)),
        _u64_arr(_fq3_flat(alphas)), _u64_arr(_fq3_flat(zshifts)),
        n_comp, _u64_arr(_fq3_flat(comp_vals)), _u64_arr(_fq3_flat(coods)),
        _u64_arr(_fq3_flat(betas)),
        _u64_arr(_fq3_flat([zn])), _u64_arr(_fq3_flat([da])),
        _u64_arr(_fq3_flat([db])), out)
    return [(out[3 * i], out[3 * i + 1], out[3 * i + 2]) for i in range(n)]


def gen_fib_trace(out_ptr, num_rows: int) -> bool:
    """Fill a row-major (num_rows, 8) u64 buffer with the fib chain; False
    without the lib."""
    lib = get_lib()
    if lib is None:
        return False
    lib.gen_fib_trace(ctypes.cast(out_ptr, ctypes.POINTER(ctypes.c_uint64)),
                      num_rows)
    return True
