"""BrainSTARK constraint sets (reference: examples/brainfuck/constraints.rs).

All constraints are raw expressions here; air.py wraps them with the
transition/boundary/terminal domain factors."""

from __future__ import annotations

from ...constraints import challenge, constant, curr, hint, next
from ...expression import Expr
from ...fields.scalar import Fp
from . import tables as T
from .vm import OPCODES, OP_DEC, OP_DEC_PTR, OP_INC, OP_INC_PTR, OP_LOOP_BEGIN, \
    OP_LOOP_END, OP_READ, OP_WRITE

ONE = constant(Fp(1))
TWO = constant(Fp(2))


def instr_zerofier(instr: Expr) -> Expr:
    """Zero at every opcode value (constraints.rs:479-486)."""
    acc = None
    for op in OPCODES:
        f = instr - constant(Fp(op))
        acc = f if acc is None else acc * f
    return acc


def if_not_instr(op_keep: int, instr: Expr) -> Expr:
    """Zero at every opcode except `op_keep` (constraints.rs:490-505)."""
    acc = None
    for op in OPCODES:
        if op == op_keep:
            continue
        f = instr - constant(Fp(op))
        acc = f if acc is None else acc * f
    return acc


def if_instr(op: int, instr: Expr) -> Expr:
    return instr - constant(Fp(op))


# ---------------------------------------------------------------------------
# processor table
# ---------------------------------------------------------------------------

def processor_base_boundary():
    return [
        curr(T.PROC_CYCLE), curr(T.PROC_IP), curr(T.PROC_MP),
        curr(T.PROC_MEM_VAL), curr(T.PROC_MEM_VAL_INV), curr(T.PROC_DUMMY),
    ]


def processor_base_transition():
    mem_val_is_zero = curr(T.PROC_MEM_VAL) * curr(T.PROC_MEM_VAL_INV) - ONE
    c = [None, None, None]
    for op in OPCODES:
        ic = [None, None, None]
        ip_step = next(T.PROC_IP) - curr(T.PROC_IP) - ONE
        mp_same = next(T.PROC_MP) - curr(T.PROC_MP)
        mv_same = next(T.PROC_MEM_VAL) - curr(T.PROC_MEM_VAL)
        if op == OP_INC_PTR:
            ic[0] = ip_step
            ic[1] = next(T.PROC_MP) - curr(T.PROC_MP) - ONE
        elif op == OP_DEC_PTR:
            ic[0] = ip_step
            ic[1] = next(T.PROC_MP) - curr(T.PROC_MP) + ONE
        elif op == OP_INC:
            ic[0] = ip_step
            ic[1] = mp_same
            ic[2] = next(T.PROC_MEM_VAL) - curr(T.PROC_MEM_VAL) - ONE
        elif op == OP_DEC:
            ic[0] = ip_step
            ic[1] = mp_same
            ic[2] = next(T.PROC_MEM_VAL) - curr(T.PROC_MEM_VAL) + ONE
        elif op == OP_WRITE:
            ic[0] = ip_step
            ic[1] = mp_same
        elif op == OP_READ:
            ic[0] = ip_step
            ic[1] = mp_same
            ic[2] = mv_same
        elif op == OP_LOOP_BEGIN:
            ic[0] = (curr(T.PROC_MEM_VAL) * (next(T.PROC_IP) - curr(T.PROC_IP) - TWO)
                     + mem_val_is_zero * (next(T.PROC_IP) - curr(T.PROC_NEXT_INSTR)))
            ic[1] = mp_same
            ic[2] = mv_same
        elif op == OP_LOOP_END:
            ic[0] = (mem_val_is_zero * (next(T.PROC_IP) - curr(T.PROC_IP) - TWO)
                     + curr(T.PROC_MEM_VAL) * (next(T.PROC_IP) - curr(T.PROC_NEXT_INSTR)))
            ic[1] = mp_same
            ic[2] = mv_same

        deselector = if_not_instr(op, curr(T.PROC_CURR_INSTR))
        for k in range(3):
            if ic[k] is None:
                continue
            term = deselector * ic[k] * curr(T.PROC_CURR_INSTR)
            c[k] = term if c[k] is None else c[k] + term

    return [
        c[0], c[1], c[2],
        next(T.PROC_CYCLE) - curr(T.PROC_CYCLE) - ONE,
        curr(T.PROC_MEM_VAL) * (curr(T.PROC_MEM_VAL) * curr(T.PROC_MEM_VAL_INV) - ONE),
        curr(T.PROC_MEM_VAL_INV) * (curr(T.PROC_MEM_VAL) * curr(T.PROC_MEM_VAL_INV) - ONE),
        (next(T.PROC_DUMMY) - ONE) * next(T.PROC_DUMMY),
        (instr_zerofier(curr(T.PROC_CURR_INSTR)) * (curr(T.PROC_DUMMY) - ONE)
         + curr(T.PROC_CURR_INSTR) * curr(T.PROC_DUMMY)),
    ]


def processor_ext_boundary():
    return [curr(T.PROC_INPUT_EVAL), curr(T.PROC_OUTPUT_EVAL)]


def _instr_combo(ip, ci, ni):
    return (challenge(T.CH_ALPHA)
            - challenge(T.CH_A) * ip
            - challenge(T.CH_B) * ci
            - challenge(T.CH_C) * ni)


def _mem_combo(cy, mp, mv):
    return (challenge(T.CH_BETA)
            - challenge(T.CH_D) * cy
            - challenge(T.CH_E) * mp
            - challenge(T.CH_F) * mv)


def processor_ext_transition():
    instr_combo = _instr_combo(curr(T.PROC_IP), curr(T.PROC_CURR_INSTR),
                               curr(T.PROC_NEXT_INSTR))
    mem_combo = _mem_combo(curr(T.PROC_CYCLE), curr(T.PROC_MP), curr(T.PROC_MEM_VAL))
    return [
        (curr(T.PROC_CURR_INSTR)
         * (curr(T.PROC_INSTR_PERMUTATION) * instr_combo - next(T.PROC_INSTR_PERMUTATION))
         + curr(T.PROC_DUMMY)
         * (curr(T.PROC_INSTR_PERMUTATION) - next(T.PROC_INSTR_PERMUTATION))),
        # NOTE: the reference has `... * Dummy.curr() * (...)` (a product, not
        # a sum) here (constraints.rs:249-258) — replicated verbatim.
        (curr(T.PROC_CURR_INSTR)
         * (curr(T.PROC_MEM_PERMUTATION) * mem_combo - next(T.PROC_MEM_PERMUTATION))
         * curr(T.PROC_DUMMY)
         * (curr(T.PROC_MEM_PERMUTATION) - next(T.PROC_MEM_PERMUTATION))),
        (curr(T.PROC_CURR_INSTR)
         * if_not_instr(OP_READ, curr(T.PROC_CURR_INSTR))
         * (next(T.PROC_INPUT_EVAL)
            - challenge(T.CH_GAMMA) * curr(T.PROC_INPUT_EVAL)
            - next(T.PROC_MEM_VAL))
         + if_instr(OP_READ, curr(T.PROC_CURR_INSTR))
         * (next(T.PROC_INPUT_EVAL) - curr(T.PROC_INPUT_EVAL))),
        (curr(T.PROC_CURR_INSTR)
         * if_not_instr(OP_WRITE, curr(T.PROC_CURR_INSTR))
         * (next(T.PROC_OUTPUT_EVAL)
            - curr(T.PROC_OUTPUT_EVAL) * challenge(T.CH_DELTA)
            - curr(T.PROC_MEM_VAL))
         + if_instr(OP_WRITE, curr(T.PROC_CURR_INSTR))
         * (next(T.PROC_OUTPUT_EVAL) - curr(T.PROC_OUTPUT_EVAL))),
    ]


def processor_ext_terminal():
    """Cross-table linking terminals (constraints.rs:136-225)."""
    instr_combo_proc = _instr_combo(curr(T.PROC_IP), curr(T.PROC_CURR_INSTR),
                                    curr(T.PROC_NEXT_INSTR))
    instr_combo_ins = _instr_combo(curr(T.INSTR_IP), curr(T.INSTR_CURR_INSTR),
                                   curr(T.INSTR_NEXT_INSTR))
    mem_combo_proc = _mem_combo(curr(T.PROC_CYCLE), curr(T.PROC_MP),
                                curr(T.PROC_MEM_VAL))
    mem_combo_mem = _mem_combo(curr(T.MEM_CYCLE), curr(T.MEM_MP),
                               curr(T.MEM_MEM_VAL))
    d = curr(T.PROC_DUMMY)
    md = curr(T.MEM_DUMMY)
    izf = instr_zerofier(curr(T.INSTR_CURR_INSTR))
    return [
        (curr(T.INSTR_CURR_INSTR) * (d - ONE)
         * (curr(T.INSTR_PROCESSOR_PERMUTATION) * instr_combo_ins
            - curr(T.PROC_INSTR_PERMUTATION) * instr_combo_proc)
         + izf * (d - ONE)
         * (curr(T.INSTR_PROCESSOR_PERMUTATION)
            - curr(T.PROC_INSTR_PERMUTATION) * instr_combo_proc)
         + curr(T.INSTR_CURR_INSTR) * d
         * (curr(T.INSTR_PROCESSOR_PERMUTATION) * instr_combo_ins
            - curr(T.PROC_INSTR_PERMUTATION))
         + izf * d
         * (curr(T.INSTR_PROCESSOR_PERMUTATION) - curr(T.PROC_INSTR_PERMUTATION))),
        ((md - ONE) * (d - ONE)
         * (curr(T.MEM_PERMUTATION) * mem_combo_mem
            - curr(T.PROC_MEM_PERMUTATION) * mem_combo_proc)
         + md * (d - ONE)
         * (curr(T.MEM_PERMUTATION) - curr(T.PROC_MEM_PERMUTATION) * mem_combo_proc)
         + (md - ONE) * d
         * (curr(T.MEM_PERMUTATION) * mem_combo_mem - curr(T.PROC_MEM_PERMUTATION))
         + md * d
         * (curr(T.MEM_PERMUTATION) - curr(T.PROC_MEM_PERMUTATION))),
        curr(T.PROC_INPUT_EVAL) - hint(T.HINT_INPUT),
        curr(T.PROC_OUTPUT_EVAL) - hint(T.HINT_OUTPUT),
    ]


# ---------------------------------------------------------------------------
# memory table
# ---------------------------------------------------------------------------

def memory_base_boundary():
    return [curr(T.MEM_CYCLE), curr(T.MEM_MP), curr(T.MEM_MEM_VAL)]


def memory_base_transition():
    mp_step = next(T.MEM_MP) - curr(T.MEM_MP)
    return [
        (mp_step - ONE) * mp_step,
        mp_step * next(T.MEM_MEM_VAL),
        (next(T.MEM_DUMMY) - ONE) * next(T.MEM_DUMMY),
        mp_step * curr(T.MEM_DUMMY),
        (next(T.MEM_MEM_VAL) - curr(T.MEM_MEM_VAL)) * curr(T.MEM_DUMMY),
        (mp_step - ONE) * (next(T.MEM_CYCLE) - curr(T.MEM_CYCLE) - ONE),
    ]


def memory_ext_transition():
    combo = _mem_combo(curr(T.MEM_CYCLE), curr(T.MEM_MP), curr(T.MEM_MEM_VAL))
    return [
        ((next(T.MEM_PERMUTATION) - curr(T.MEM_PERMUTATION) * combo)
         * (curr(T.MEM_DUMMY) - ONE)
         + (next(T.MEM_PERMUTATION) - curr(T.MEM_PERMUTATION)) * curr(T.MEM_DUMMY)),
    ]


# ---------------------------------------------------------------------------
# instruction table
# ---------------------------------------------------------------------------

def instruction_base_boundary():
    return [curr(T.INSTR_IP)]


def instruction_base_transition():
    ip_step = next(T.INSTR_IP) - curr(T.INSTR_IP)
    return [
        (ip_step - ONE) * ip_step,
        (ip_step - ONE) * (next(T.INSTR_CURR_INSTR) - curr(T.INSTR_CURR_INSTR)),
        (ip_step - ONE) * (next(T.INSTR_NEXT_INSTR) - curr(T.INSTR_NEXT_INSTR)),
    ]


def instruction_ext_boundary():
    return [
        curr(T.INSTR_PROGRAM_EVAL)
        - challenge(T.CH_A) * curr(T.INSTR_IP)
        - challenge(T.CH_B) * curr(T.INSTR_CURR_INSTR)
        - challenge(T.CH_C) * curr(T.INSTR_NEXT_INSTR),
    ]


def instruction_ext_transition():
    next_combo = _instr_combo(next(T.INSTR_IP), next(T.INSTR_CURR_INSTR),
                              next(T.INSTR_NEXT_INSTR))
    ip_step = curr(T.INSTR_IP) - next(T.INSTR_IP)
    return [
        (curr(T.INSTR_CURR_INSTR) * (ip_step + ONE)
         * (next(T.INSTR_PROCESSOR_PERMUTATION)
            - curr(T.INSTR_PROCESSOR_PERMUTATION) * next_combo)
         + instr_zerofier(curr(T.INSTR_CURR_INSTR))
         * (next(T.INSTR_PROCESSOR_PERMUTATION) - curr(T.INSTR_PROCESSOR_PERMUTATION))
         + ip_step
         * (curr(T.INSTR_PROCESSOR_PERMUTATION) - next(T.INSTR_PROCESSOR_PERMUTATION))),
        ((next(T.INSTR_IP) - curr(T.INSTR_IP) - ONE)
         * (next(T.INSTR_PROGRAM_EVAL) - curr(T.INSTR_PROGRAM_EVAL))
         + (next(T.INSTR_IP) - curr(T.INSTR_IP))
         * (next(T.INSTR_PROGRAM_EVAL)
            - curr(T.INSTR_PROGRAM_EVAL) * challenge(T.CH_ETA)
            - challenge(T.CH_A) * next(T.INSTR_IP)
            - challenge(T.CH_B) * next(T.INSTR_CURR_INSTR)
            - challenge(T.CH_C) * next(T.INSTR_NEXT_INSTR))),
    ]


def instruction_ext_terminal():
    return [curr(T.INSTR_PROGRAM_EVAL) - hint(T.HINT_INSTRUCTION)]


# ---------------------------------------------------------------------------
# input / output tables
# ---------------------------------------------------------------------------

def input_ext_boundary():
    return [curr(T.INPUT_EVAL) - curr(T.INPUT_VALUE)]


def input_ext_transition():
    return [curr(T.INPUT_EVAL) * challenge(T.CH_GAMMA) + next(T.INPUT_VALUE)
            - next(T.INPUT_EVAL)]


def input_ext_terminal():
    return [curr(T.INPUT_EVAL) - hint(T.HINT_INPUT) * hint(T.HINT_INPUT_OFFSET)]


def output_ext_boundary():
    return [curr(T.OUTPUT_EVAL) - curr(T.OUTPUT_VALUE)]


def output_ext_transition():
    return [curr(T.OUTPUT_EVAL) * challenge(T.CH_DELTA) + next(T.OUTPUT_VALUE)
            - next(T.OUTPUT_EVAL)]


def output_ext_terminal():
    return [curr(T.OUTPUT_EVAL) - hint(T.HINT_OUTPUT) * hint(T.HINT_OUTPUT_OFFSET)]
