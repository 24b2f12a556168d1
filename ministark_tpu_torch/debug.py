"""Constraint debugging: a per-row trace validator (mirrors
``ministark_tpu.debug``).

The reference ships an empty stub here (src/debug.rs:17-127, all
commented out); this implements what that dead code intended: evaluate every
constraint on every trace row with 0/0-tolerant division and report the
first (constraint, row) that fails.  Rows are subsampled beyond
`MAX_FULL_ROWS` to keep debug proving fast; pass `full=True` (or set
MINISTARK_TPU_DEBUG_FULL=1) to check every row.  The trace is read on the
host once, as numpy uint64 (``Matrix.to_ints``).
"""

from __future__ import annotations

import os
import random

from .expression import Challenge, Constant, Hint, Periodic, Trace, X
from .fields.scalar import Fp, Fq3

MAX_FULL_ROWS = 1 << 12


class ConstraintViolation(Exception):
    pass


def validate_constraints(air, challenges, hints, base_trace, extension_trace,
                         full=None):
    """Check every constraint on the trace.

    `full=True` (or MINISTARK_TPU_DEBUG_FULL=1) checks EVERY row; the
    default subsamples beyond MAX_FULL_ROWS to keep debug proving fast."""
    if full is None:
        full = os.environ.get("MINISTARK_TPU_DEBUG_FULL", "0") == "1"
    n = base_trace.num_rows
    trace_dom = air.trace_domain()

    base_vals = base_trace.to_ints()  # (ncols, n)
    ext_vals = (extension_trace.to_ints() if extension_trace is not None
                else None)  # (ncols, 3, n)

    if full or n <= MAX_FULL_ROWS:
        rows = range(n)
    else:
        rng = random.Random(0)
        rows = sorted({0, 1, n - 2, n - 1} | {rng.randrange(n) for _ in range(252)})

    nb = base_trace.num_cols
    for ci, constraint in enumerate(air.constraints):
        for row in rows:
            x = trace_dom.element(row)

            def leaf_value(leaf):
                if isinstance(leaf, X):
                    return x
                if isinstance(leaf, Constant):
                    return leaf.value
                if isinstance(leaf, Challenge):
                    return challenges[leaf.index]
                if isinstance(leaf, Hint):
                    return hints[leaf.index]
                if isinstance(leaf, Trace):
                    r = (row + leaf.offset) % n
                    if leaf.column < nb:
                        return Fp(int(base_vals[leaf.column, r]))
                    c = ext_vals[leaf.column - nb, :, r]
                    return Fq3(int(c[0]), int(c[1]), int(c[2]))
                if isinstance(leaf, Periodic):
                    point = x ** (n // leaf.interval_size)
                    acc = type(point).zero()
                    for c in reversed(leaf.coeffs):
                        acc = acc * point + c
                    return acc
                raise TypeError(leaf)

            # `check` returns None exactly when some division hit
            # nonzero/zero — i.e. the numerator fails to vanish on its
            # constraint domain (src/constraints.rs:168-171). Elsewhere the
            # rational constraint legitimately takes arbitrary values.
            result = constraint.check(leaf_value)
            if result is None:
                raise ConstraintViolation(
                    f"constraint {ci} is not satisfied at row {row} "
                    f"(nonzero numerator over vanishing denominator)")
