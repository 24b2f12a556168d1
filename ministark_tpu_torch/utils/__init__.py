from .timer import Timer
from .fixtures import gen_binary_valued_matrix, gen_fib_matrix
from .poly import (
    divide_out_point,
    evaluate_vanishing_polynomial,
    horner_evaluate,
    interleave,
    reduce_lde_blowup_factor,
)

__all__ = [
    "Timer",
    "gen_fib_matrix",
    "gen_binary_valued_matrix",
    "horner_evaluate",
    "divide_out_point",
    "evaluate_vanishing_polynomial",
    "interleave",
    "reduce_lde_blowup_factor",
]
