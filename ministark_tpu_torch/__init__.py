"""ministark_tpu_torch: the ministark_tpu STARK prover on PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A second package beside ``ministark_tpu``: the same protocol and the same
proof bytes, with field elements held as u64 values in ``torch.int64``
tensors.  It imports ``torch`` and numpy, never ``jax`` and never
``ministark_tpu``.  Kernels are built from ``csrc/`` with ``nvcc`` at first
use (``ops/build.py``); on CPU tensors every kernel wrapper runs its plain
PyTorch version instead.
"""

__version__ = "0.1.0"
