"""Which of the profiler's device operations are the measured program's
hand-written kernels (``csrc/*.cu`` and the generated constraint
evaluator) and which are the libraries' under the protocol glue.

A device operation is a library's where the qualified name of its
function (the name before its template arguments and parameters) carries
one of ``LIBRARY``'s marks: PyTorch's own operations, CUB and thrust under
them, NCCL's collectives, and the copies and fills.  Every other device
operation is a hand-written kernel, so a kernel that a later change adds
counts as one without an edit here."""

import re

LIBRARY = ("at::", "at_cuda_detail::", "c10::", "cub::", "thrust::",
           "nccl", "Memcpy", "Memset")


def function_name(name: str) -> str:
    """`name` without its template arguments and parameters."""
    return re.split(r"[<(]", name.replace("(anonymous namespace)", "anon"),
                    maxsplit=1)[0]


def is_own(name: str) -> bool:
    fn = function_name(name)
    return not any(m in fn for m in LIBRARY)
