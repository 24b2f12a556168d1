"""Multi-process proving (mirrors ``ministark_tpu.parallel.prover``).

``prove_sharded`` runs the unchanged ``prover.default_prove`` on every rank
of a mesh, on a Stark proxy that puts the trace on the rank's device and
carries a ``ShardedExecutor`` hashing with the Stark's tree hash.  The
prover finds the executor on the Stark and, where ``phases_supported``
holds, runs every phase from the base commit to the decommit on the rank's
share (``parallel.executor``), with SHA-256 trees and with RPO-256 trees
alike: a rank holds 1/d of every LDE, tree and FRI layer, evaluates the
constraints on its block of the CE domain and DEEP on its rows, and
fetches the queried rows and nodes from their owners.  The trace, the
composition's CE-sized evaluations, the grind and the host coin's replay
are replicated.  Every rank generates the same trace (the trace
generators are deterministic) and returns the same proof, byte for byte
the one-process prove's.

The JAX package's ``runtime.py`` has no counterpart here.  Its flags guard
JAX compile-time choices the port does not make: ``spmd``, ``spmd_mode``
and ``spmd_off`` (runtime.py:13-17, :73-105) keep Pallas kernels and host
callbacks out of GSPMD-partitioned programs, ``fused_ok`` (:20-33) picks
interpret mode on XLA:CPU, and ``cpu_no_persistent_cache`` (:39-70) works
around an XLA:CPU cache fault.  In the port every ``ops/*.py`` wrapper
chooses its kernel or its plain version by the tensor's device, and the
prover finds the executor on the Stark.
"""

from __future__ import annotations

from ..prover import default_prove
from .executor import ShardedExecutor
from .sharded import Mesh


def _on_device(m, device):
    return m if m.device == device else type(m)(m.values.to(device))


class _ShardedTrace:
    """Trace proxy whose matrices lie on the rank's device."""

    def __init__(self, inner, mesh: Mesh):
        self._inner = inner
        self._mesh = mesh

    def base_columns(self):
        return _on_device(self._inner.base_columns(), self._mesh.device)

    def build_extension_columns(self, challenges):
        ext = self._inner.build_extension_columns(challenges)
        return None if ext is None else _on_device(ext, self._mesh.device)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __len__(self):
        return len(self._inner)


class _ShardedStark:
    """Stark proxy that carries the executor and wraps the trace."""

    def __init__(self, inner, mesh: Mesh):
        self._inner = inner
        self._mesh = mesh
        self.sharded_executor = ShardedExecutor(mesh, inner.merkle_hash)

    def generate_trace(self, witness):
        return _ShardedTrace(self._inner.generate_trace(witness), self._mesh)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def prove_sharded(stark, options, witness, mesh: Mesh,
                  validate: bool = False, phase_log: list | None = None):
    """Prove over the ranks of `mesh`; call it on every rank.  Returns the
    Proof that ``stark.prove(options, witness)`` gives in one process.
    `phase_log` and `validate` as ``prover.default_prove`` takes them."""
    return default_prove(_ShardedStark(stark, mesh), options, witness,
                         phase_log, validate)
