"""A frozen plain prover: the benchmark's reference for the STARK proofs
that the measured program makes.

It is a copy of the measured package's protocol code with every
hand-written kernel taken out: each device step is its plain PyTorch
version (radix-2 NTT stages, SHA-256 rounds as tensor ops, Fermat
inverses), the Fiat-Shamir coin runs on the host between the FRI layers,
the proof-of-work nonce is searched with ``hashlib`` and the constraint
composition is evaluated from the AIR's expression DAG a block of points
at a time.  The fib trace is worked out from a closed form
(``models.fib``).  It imports torch and numpy only: no JAX, and nothing
of the measured package.  Field arithmetic is exact, so a sound prover
gives the same bytes.
"""
