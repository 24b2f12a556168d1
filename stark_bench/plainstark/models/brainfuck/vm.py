"""Brainf**k lexer/compiler/VM producing the five-table execution trace
(reference: examples/brainfuck/vm.rs).

The simulator is inherently sequential and cheap (one Python step per VM
cycle).  The memory table, which holds one row per cycle of each touched
cell's lifetime and is usually the largest, is derived with one stable sort
and one vectorized gap-filling pass; the padding is vectorized too."""

from __future__ import annotations

import numpy as np

from ...fields.scalar import P

OP_INC_PTR = ord(">")
OP_DEC_PTR = ord("<")
OP_INC = ord("+")
OP_DEC = ord("-")
OP_WRITE = ord(".")
OP_READ = ord(",")
OP_LOOP_BEGIN = ord("[")
OP_LOOP_END = ord("]")

OPCODES = [OP_INC_PTR, OP_DEC_PTR, OP_INC, OP_DEC, OP_WRITE, OP_READ,
           OP_LOOP_BEGIN, OP_LOOP_END]


def lex(source: str) -> list[int]:
    return [ord(c) for c in source if ord(c) in OPCODES]


def compile_program(source: str) -> list[int]:
    """Opcode stream with loop targets inlined after '[' and ']'."""
    program: list[int] = []
    stack: list[int] = []
    for op in lex(source):
        program.append(op)
        if op == OP_LOOP_BEGIN:
            program.append(0)  # placeholder: position after matching ]
            stack.append(len(program) - 1)
        elif op == OP_LOOP_END:
            last = stack.pop()
            program.append(last + 1)
            program[last] = len(program)
    assert not stack, "unbalanced loops"
    return program


def ceil_pow2(v: int) -> int:
    return 1 << (v - 1).bit_length() if v > 1 else 1


_MEM_VAL_INV = [0] + [pow(v, P - 2, P) for v in range(1, 256)]


def simulate(source: str, input_bytes: bytes = b""):
    """Run the program; returns (tables dict of numpy uint64 row-major
    arrays padded to a common power-of-two length, output bytes)."""
    program = compile_program(source)
    tape = [0] * 1024

    cycle = 0
    ip = 0
    mp = 0
    curr_instr = program[0]
    next_instr = program[1] if len(program) > 1 else 0

    in_pos = 0
    output = bytearray()

    processor_rows = []
    # program load rows
    instruction_rows = [[i, program[i], program[i + 1] if i + 1 < len(program)
                         else 0] for i in range(len(program))]
    input_rows = []
    output_rows = []

    while ip < len(program):
        mem_val = tape[mp]
        processor_rows.append([
            cycle, ip, curr_instr, next_instr, mp, mem_val,
            _MEM_VAL_INV[mem_val], int(curr_instr == 0)])
        instruction_rows.append([ip, curr_instr, next_instr])

        if curr_instr == OP_LOOP_BEGIN:
            ip = program[ip + 1] if tape[mp] == 0 else ip + 2
        elif curr_instr == OP_LOOP_END:
            ip = program[ip + 1] if tape[mp] != 0 else ip + 2
        elif curr_instr == OP_DEC_PTR:
            ip += 1
            mp -= 1
        elif curr_instr == OP_INC_PTR:
            ip += 1
            mp += 1
        elif curr_instr == OP_INC:
            ip += 1
            tape[mp] = (tape[mp] + 1) % 256
        elif curr_instr == OP_DEC:
            ip += 1
            tape[mp] = (tape[mp] - 1) % 256
        elif curr_instr == OP_WRITE:
            ip += 1
            output.append(tape[mp])
            output_rows.append(tape[mp])
        elif curr_instr == OP_READ:
            ip += 1
            tape[mp] = input_bytes[in_pos]
            in_pos += 1
            input_rows.append(tape[mp])
        else:
            raise ValueError(f"unrecognized instruction at ip {ip}")

        cycle += 1
        curr_instr = program[ip] if ip < len(program) else 0
        next_instr = program[ip + 1] if ip + 1 < len(program) else 0

    # final-state rows
    mem_val = tape[mp]
    processor_rows.append([
        cycle, ip, curr_instr, next_instr, mp, mem_val,
        _MEM_VAL_INV[mem_val], int(curr_instr == 0)])
    instruction_rows.append([ip, curr_instr, next_instr])

    processor = np.asarray(processor_rows, dtype=np.uint64)
    instruction = np.asarray(instruction_rows, dtype=np.uint64)
    instruction = instruction[np.argsort(instruction[:, 0], kind="stable")]
    memory = derive_memory_rows(processor)

    n = ceil_pow2(max(len(processor), len(memory), len(instruction),
                      len(input_rows), len(output_rows)))
    tables = {
        "processor": pad_processor(processor, n),
        "memory": pad_memory(memory, n),
        "instruction": pad_instruction(instruction, n),
        "input": _pad_io(input_rows, n),
        "output": _pad_io(output_rows, n),
    }
    return tables, bytes(output)


def derive_memory_rows(processor: np.ndarray) -> np.ndarray:
    """Memory table = the non-padding processor rows (cycle, mp, mem_val,
    dummy 0) sorted by (mp, cycle), with dummy rows (cycle + k, mp, the
    same mem_val, 1) filling the cycle gaps between consecutive rows of one
    cell (vm.rs:338-381): each row is repeated once per missing cycle after
    it, then the copies' cycles are advanced, all in one pass."""
    rows = processor[processor[:, 2] != 0][:, [0, 4, 5, 7]].copy()
    rows[:, 3] = 0
    rows = rows[np.lexsort((rows[:, 0], rows[:, 1]))]
    cyc = rows[:, 0].astype(np.int64)
    gaps = np.zeros(len(rows), dtype=np.int64)
    same = rows[1:, 1] == rows[:-1, 1]
    gaps[:-1] = np.where(same, cyc[1:] - cyc[:-1] - 1, 0)
    counts = gaps + 1
    out = np.repeat(rows, counts, axis=0)
    starts = np.cumsum(counts) - counts
    k = np.arange(len(out), dtype=np.int64) - np.repeat(starts, counts)
    out[:, 0] += k.astype(np.uint64)
    out[:, 3] = (k > 0).astype(np.uint64)
    return out


def _extend(rows: np.ndarray, n: int, tail: np.ndarray) -> np.ndarray:
    return np.concatenate([rows, tail]) if n > len(rows) else rows


def pad_processor(rows: np.ndarray, n: int) -> np.ndarray:
    """Rows (cycle + k, ip, 0, 0, mp, mem_val, mem_val_inv, 1) after the
    last row."""
    k = np.arange(1, n - len(rows) + 1, dtype=np.uint64)
    tail = np.repeat(rows[-1:], len(k), axis=0)
    tail[:, 0] += k
    tail[:, [2, 3]] = 0
    tail[:, 7] = 1
    return _extend(rows, n, tail)


def pad_memory(rows: np.ndarray, n: int) -> np.ndarray:
    """Rows (cycle + k, mp, mem_val, 1) after the last row."""
    k = np.arange(1, n - len(rows) + 1, dtype=np.uint64)
    tail = np.repeat(rows[-1:], len(k), axis=0)
    tail[:, 0] += k
    tail[:, 3] = 1
    return _extend(rows, n, tail)


def pad_instruction(rows: np.ndarray, n: int) -> np.ndarray:
    """Rows (last ip, 0, 0) after the last row."""
    tail = np.zeros((max(n - len(rows), 0), 3), dtype=np.uint64)
    tail[:, 0] = rows[-1, 0]
    return _extend(rows, n, tail)


def _pad_io(values: list, n: int) -> np.ndarray:
    out = np.zeros((n, 1), dtype=np.uint64)
    out[:len(values), 0] = values
    return out
