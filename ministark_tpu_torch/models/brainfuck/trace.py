"""BrainfuckTrace: base matrix assembly + extension columns
(reference: examples/brainfuck/trace.rs; mirrors
``ministark_tpu.models.brainfuck.trace``).

The reference builds the 9 extension columns with sequential per-row loops
of running products/evaluation sums (:108-289).  Every one of them is an
affine recurrence s' = a*s + b with per-row (a, b) computable elementwise
from the base columns, so here all nine are one batched device affine
scan (scan.py).

Permutation initials: the reference draws them from ``ark_std::test_rng()``
(trace.rs:82-84), a fixed ChaCha12 stream replicated byte-exactly by
``ark_rng``, so the proofs are bit-compatible with the reference's.  Set
MINISTARK_TPU_BF_INITIALS=fixed to use the JAX package's fixed public
constants instead (either choice is sound: the cross-table terminal
constraints compare running products seeded with the SAME initial).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ...fields import device as fd
from ...fields.scalar import Fq3, P
from ...matrix import Matrix, MatrixExt3
from ...scan import affine_scan_ext3
from ...stark import Trace
from . import tables as T
from .vm import OP_READ, OP_WRITE


@functools.lru_cache(maxsize=4)
def _perm_initials_for(mode: str | None) -> tuple[Fq3, Fq3]:
    if mode == "fixed":
        return (
            Fq3(0x6D696E69737461726B % P, 0x747075_1,
                0x696E7374725F696E6974 % P),
            Fq3(0x6D656D5F696E6974 % P, 0x747075_2, 0x6272665F6D656D % P),
        )
    from ...ark_rng import rand_fq3, test_rng

    rng = test_rng()
    return rand_fq3(rng), rand_fq3(rng)


def perm_initials() -> tuple[Fq3, Fq3]:
    """(instr_initial, mem_initial): the reference's two
    ``Fq3::rand(ark_std::test_rng())`` draws (trace.rs:82-84), or the fixed
    constants under MINISTARK_TPU_BF_INITIALS=fixed, read on each trace
    build."""
    return _perm_initials_for(os.environ.get("MINISTARK_TPU_BF_INITIALS"))


class BrainfuckTrace(Trace):
    """The five tables as one 17-column base matrix on `device` (the card
    unless the caller names another)."""

    def __init__(self, tables: dict, device=None):
        self.tables = tables
        n = tables["processor"].shape[0]
        cols = np.zeros((T.NUM_BASE_COLUMNS, n), dtype=np.uint64)
        cols[T.PROC_CYCLE:T.PROC_DUMMY + 1] = tables["processor"].T
        cols[T.MEM_CYCLE:T.MEM_DUMMY + 1] = tables["memory"].T
        cols[T.INSTR_IP:T.INSTR_NEXT_INSTR + 1] = tables["instruction"].T
        cols[T.INPUT_VALUE] = tables["input"].T[0]
        cols[T.OUTPUT_VALUE] = tables["output"].T[0]
        self.base = Matrix.from_columns_np(cols, device)

    def base_columns(self) -> Matrix:
        return self.base

    def build_extension_columns(self, challenges) -> MatrixExt3:
        return MatrixExt3(build_extension_columns(self.base.values,
                                                  challenges))


# per extension column 17..25: whether it is the inclusive scan
_INCLUSIVE = [False, False, False, False, False, True, True, True, True]


def build_extension_columns(base: torch.Tensor, challenges) -> torch.Tensor:
    """The 9 extension columns, global order 17..25, as a (9, 3, n) Fq3
    tensor: one (a, b, init) recurrence per column, then one scan."""
    return affine_scan_ext3(*extension_maps(base, challenges), _INCLUSIVE)


def extension_maps(base: torch.Tensor, challenges):
    """The 9 extension columns' recurrences s' = a s + b from init, in
    plain torch: a, b (9, 3, n) and init (9, 3)."""
    n, dev = base.shape[1], base.device
    instr_init, mem_init = perm_initials()

    def ch(i):
        return fd.ext3_scalar(challenges[i], dev)

    one = fd.ext3_scalar(Fq3(1), dev).expand(3, n)
    zero = torch.zeros((3, n), dtype=torch.int64, device=dev)

    def col(i):
        return base[i]

    def lincomb3(c0, x0, c1, x1, c2, x2):
        return fd.add(fd.add(fd.ext3_mul_base(ch(c0), x0),
                             fd.ext3_mul_base(ch(c1), x1)),
                      fd.ext3_mul_base(ch(c2), x2))

    def sel(mask, a, b):
        return torch.where(mask, a.expand(3, n), b.expand(3, n))

    proc_curr = col(T.PROC_CURR_INSTR)
    next_mv = fd.ext3_from_base(torch.roll(col(T.PROC_MEM_VAL), -1))
    ins_ip = col(T.INSTR_IP)
    same_ip = (ins_ip == torch.roll(ins_ip, 1)) & (
        torch.arange(n, device=dev) > 0)
    ins_lin = lincomb3(T.CH_A, ins_ip, T.CH_B, col(T.INSTR_CURR_INSTR),
                       T.CH_C, col(T.INSTR_NEXT_INSTR))
    read, write = proc_curr == OP_READ, proc_curr == OP_WRITE

    ab = [
        # processor: instruction permutation (exclusive)
        (sel(proc_curr != 0, fd.sub(ch(T.CH_ALPHA), lincomb3(
            T.CH_A, col(T.PROC_IP), T.CH_B, proc_curr, T.CH_C,
            col(T.PROC_NEXT_INSTR))), one), zero, instr_init),
        # processor: memory permutation (exclusive)
        (sel(proc_curr != 0, fd.sub(ch(T.CH_BETA), lincomb3(
            T.CH_D, col(T.PROC_CYCLE), T.CH_E, col(T.PROC_MP), T.CH_F,
            col(T.PROC_MEM_VAL))), one), zero, mem_init),
        # processor: input / output running evaluations (exclusive), of the
        # next row's memory value (the roll by -1)
        (sel(read, ch(T.CH_GAMMA), one), sel(read, next_mv, zero), Fq3(0)),
        (sel(write, ch(T.CH_DELTA), one), sel(write, next_mv, zero), Fq3(0)),
        # memory: permutation (exclusive)
        (sel(col(T.MEM_DUMMY) == 0, fd.sub(ch(T.CH_BETA), lincomb3(
            T.CH_D, col(T.MEM_CYCLE), T.CH_E, col(T.MEM_MP), T.CH_F,
            col(T.MEM_MEM_VAL))), one), zero, mem_init),
        # instruction: processor permutation (inclusive); row 0 has no
        # previous row, so it never counts as the same address
        (sel((col(T.INSTR_CURR_INSTR) != 0) & same_ip,
             fd.sub(ch(T.CH_ALPHA), ins_lin), one), zero, instr_init),
        # instruction: program evaluation (inclusive); row 0's previous
        # address is -1, so it always changes there
        (sel(~same_ip, ch(T.CH_ETA), one), sel(~same_ip, ins_lin, zero),
         Fq3(0)),
        # input / output tables (inclusive)
        (ch(T.CH_GAMMA), fd.ext3_from_base(col(T.INPUT_VALUE)), Fq3(0)),
        (ch(T.CH_DELTA), fd.ext3_from_base(col(T.OUTPUT_VALUE)), Fq3(0)),
    ]
    a = torch.stack([x.expand(3, n) for x, _, _ in ab])
    b = torch.stack([y.expand(3, n) for _, y, _ in ab])
    init = torch.cat([fd.ext3_scalar(s, dev).T for _, _, s in ab])
    return a, b, init
