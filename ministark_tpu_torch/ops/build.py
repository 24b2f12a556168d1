"""Build, load and launch the hand-written CUDA kernels.

Each kernel library is compiled by ``nvcc`` for ``sm_90a`` into a shared
object with a plain C interface (``csrc/launch.cuh``) and loaded with
ctypes.  Libraries land in ``ministark_tpu_torch/_build/``, keyed by a hash
of the sources, the headers and the flags, so an unchanged kernel is built
once per checkout.  Pointers come from ``Tensor.data_ptr()`` and the stream
from ``current_stream()``; each entry point's library and ctypes prototype
are looked up and set once.  Every entry point returns
``cudaGetLastError()`` and ``CudaKernel.launch`` raises if it is not 0.

The CPU tests build host C++ from the same headers with g++
(``build_host_library``): the per-element math is tested even where no
kernel can run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# -O1: the host builds only check the math on small inputs, and a generated
# evaluator group compiles in about half the time it takes at -O2
HOST_FLAGS = ("-O1", "-std=c++17", "-shared", "-fPIC")


def _headers() -> str:
    return "".join(_read(os.path.join(CSRC, f))
                   for f in sorted(os.listdir(CSRC)) if f.endswith(".cuh"))


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def find_nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _compile(compiler, flags, name: str, source: str, suffix: str) -> str:
    """Compile `source` into BUILD_DIR (once per content hash)."""
    key = hashlib.sha256(
        "\0".join([source, _headers(), *flags]).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, f"{name}-{key}.so")
    if os.path.exists(lib):
        return lib
    src = os.path.join(BUILD_DIR, f"{name}-{key}{suffix}")
    with open(src, "w") as f:
        f.write(source)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *flags, "-I", CSRC, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {name} failed:\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def build_host_library(name: str, source: str) -> ctypes.CDLL:
    """g++ build of host C++ that includes the csrc headers (tests)."""
    cxx = os.environ.get("CXX", "g++")
    return ctypes.CDLL(_compile(cxx, HOST_FLAGS, name, source, ".cpp"))


_LIBS: dict[str, ctypes.CDLL] = {}   # source text -> loaded library
_LIB_LOCKS: dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()


def _load_cuda(name: str, text: str) -> float:
    """nvcc-build and load `text` once per process, whichever kernel asks
    first (two kernels may share one source file); returns the seconds."""
    with _LOCKS_LOCK:
        lock = _LIB_LOCKS.setdefault(text, threading.Lock())
    with lock:
        if text in _LIBS:
            return 0.0
        t0 = time.perf_counter()
        lib = ctypes.CDLL(_compile(find_nvcc(), NVCC_FLAGS, name, text, ".cu"))
        lib.ms_error_string.restype = ctypes.c_char_p
        lib.ms_error_string.argtypes = [ctypes.c_int]
        _LIBS[text] = lib
        return time.perf_counter() - t0


class CudaKernel:
    """One hand-written kernel: its source, its built library and its count
    of launches.  ``launches`` grows by one each time the wrapper launches
    the kernel on the card, and nowhere else.

    `source` is a file under csrc/; kernels generated at run time (the
    constraint evaluator) pass their source text to ``launch`` instead."""

    def __init__(self, name: str, source: str | None, replaces: str,
                 prototypes: dict | None = None):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._file_text: str | None = None
        # entry point -> its ctypes argument types, stream excluded, for
        # entry points that take plain ints (pointers from data_ptr())
        self._prototypes = prototypes or {}
        # (entry point, source text) -> (typed ctypes function, library)
        self._entries: dict = {}

    def _text(self, source_text):
        if source_text is not None:
            return source_text
        if self._file_text is None:
            self._file_text = _read(os.path.join(CSRC, self.source))
        return self._file_text

    def build(self, source_text: str | None = None) -> float:
        """Compile and load (once); returns the seconds it took."""
        return _load_cuda(self.name, self._text(source_text))

    def _entry(self, fn: str, args, source_text):
        """Entry point `fn`, built, loaded and typed (once), and its
        library: typed by its prototype, else by the ctypes types of its
        first call's arguments."""
        key = (fn, source_text)
        hit = self._entries.get(key)
        if hit is None:
            self.build(source_text)
            lib = _LIBS[self._text(source_text)]
            f = getattr(lib, fn)
            f.restype = ctypes.c_int
            types = self._prototypes.get(fn) or [type(a) for a in args]
            f.argtypes = [*types, ctypes.c_void_p]
            hit = self._entries[key] = (f, lib)
        return hit

    def query(self, fn: str, *args: int) -> int:
        """Entry point `fn` of the kernel's library called on int64 args,
        no stream and no launch (a host-side answer such as a launch's
        shape): its int64 result."""
        self.build()
        f = getattr(_LIBS[self._text(None)], fn)
        f.restype = ctypes.c_int64
        f.argtypes = [ctypes.c_int64] * len(args)
        return f(*args)

    def launch(self, fn: str, *args, source_text: str | None = None):
        """Call entry point `fn` with its args (ctypes-typed, or plain ints
        where the kernel declared its prototype) plus the current stream;
        raise on any CUDA error the launch reports."""
        f, lib = self._entry(fn, args, source_text)
        rc = f(*args, current_stream())
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.name}.{fn} failed: "
                               f"{lib.ms_error_string(rc).decode()} ({rc})")
        self.launches += 1


KERNELS: dict[str, CudaKernel] = {}

# ctypes types for a kernel's declared prototype
PTR, I64 = ctypes.c_void_p, ctypes.c_int64


def current_stream() -> int:
    """The handle of the current CUDA stream, as an int: torch's own
    accessor (the one Triton's launcher reads); building a
    torch.cuda.Stream object instead costs several microseconds a launch,
    more than a small kernel runs."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def register(name: str, source: str | None, replaces: str,
             prototypes: dict | None = None) -> CudaKernel:
    k = CudaKernel(name, source, replaces, prototypes)
    KERNELS[name] = k
    return k


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def i64(v: int) -> ctypes.c_int64:
    return ctypes.c_int64(int(v))


def check_cuda(t: torch.Tensor, *, dtype=torch.int64, name="input"):
    """Validate a tensor handed to a kernel: on CUDA, dtype, contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr_or_null(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def c_int(v: int) -> ctypes.c_int:
    return ctypes.c_int(int(v))
