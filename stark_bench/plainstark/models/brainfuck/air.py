"""BrainfuckAirConfig + BrainfuckClaim (reference: examples/brainfuck/air.rs,
main.rs:55-105)."""

from __future__ import annotations

from ... import serde
from ...air import Hints
from ...constraints import Constraint, constant, x
from ...fields.scalar import Fp, Fq3
from ...ntt import Domain
from ...stark import Stark
from . import constraints as C
from . import tables as T
from .trace import BrainfuckTrace
from .vm import compile_program


class BrainfuckClaim(Stark):
    """Public inputs = (source_code, input, output); Fq = the cubic extension."""

    air_config = None  # set below (forward ref)
    fp = Fp
    fq = Fq3

    def __init__(self, source_code: str, input_bytes: bytes, output_bytes: bytes):
        self.source_code = source_code
        self.input = input_bytes
        self.output = output_bytes

    def get_public_inputs(self):
        return self

    def generate_trace(self, witness: BrainfuckTrace) -> BrainfuckTrace:
        return witness

    def serialize_public_inputs(self, w: serde.Writer):
        # ark: String = u64 len + utf8 bytes; Vec<u8> = u64 len + bytes
        src = self.source_code.encode()
        w.u64(len(src))
        w.raw(src)
        w.u64(len(self.input))
        w.raw(self.input)
        w.u64(len(self.output))
        w.raw(self.output)


class BrainfuckAirConfig:
    NUM_BASE_COLUMNS = T.NUM_BASE_COLUMNS
    NUM_EXTENSION_COLUMNS = T.NUM_EXTENSION_COLUMNS
    fp_type = Fp
    fq_type = Fq3

    @staticmethod
    def gen_hints(trace_len: int, claim: BrainfuckClaim, challenges) -> Hints:
        gamma = challenges[T.CH_GAMMA]
        delta = challenges[T.CH_DELTA]
        input_arg, input_offset = _io_terminal(claim.input, gamma, trace_len)
        output_arg, output_offset = _io_terminal(claim.output, delta, trace_len)
        instr_arg = _instruction_evaluation_argument(claim.source_code, challenges)
        return Hints.new([
            (T.HINT_INSTRUCTION, instr_arg),
            (T.HINT_INPUT, input_arg),
            (T.HINT_INPUT_OFFSET, input_offset),
            (T.HINT_OUTPUT, output_arg),
            (T.HINT_OUTPUT_OFFSET, output_offset),
        ])

    @staticmethod
    def constraints(trace_len: int) -> list[Constraint]:
        dom = Domain(trace_len)
        first_x = constant(dom.element(0))
        last_x = constant(dom.element(trace_len - 1))
        one = constant(Fp(1))

        transition = (
            C.processor_base_transition()
            + C.processor_ext_transition()
            + C.memory_base_transition()
            + C.memory_ext_transition()
            + C.instruction_base_transition()
            + C.instruction_ext_transition()
            + C.input_ext_transition()
            + C.output_ext_transition()
        )
        transition = [
            c * ((x() - last_x) / (x().pow(trace_len) - one)) for c in transition
        ]

        boundary = (
            C.processor_base_boundary()
            + C.processor_ext_boundary()
            + C.memory_base_boundary()
            + C.instruction_base_boundary()
            + C.instruction_ext_boundary()
            + C.input_ext_boundary()
            + C.output_ext_boundary()
        )
        boundary = [c / (x() - first_x) for c in boundary]

        terminal = (
            C.processor_ext_terminal()
            + C.instruction_ext_terminal()
            + C.input_ext_terminal()
            + C.output_ext_terminal()
        )
        terminal = [c / (x() - last_x) for c in terminal]

        return [Constraint(c) for c in transition + boundary + terminal]


BrainfuckClaim.air_config = BrainfuckAirConfig


def _instruction_evaluation_argument(source_code: str, challenges) -> Fq3:
    """Program evaluation terminal (air.rs:129-147)."""
    program = compile_program(source_code) + [0]
    acc = Fq3.zero()
    for ip, curr_instr in enumerate(program):
        next_instr = program[ip + 1] if ip + 1 < len(program) else 0
        acc = (acc * challenges[T.CH_ETA]
               + challenges[T.CH_A] * Fp(ip)
               + challenges[T.CH_B] * Fp(curr_instr)
               + challenges[T.CH_C] * Fp(next_instr))
    return acc


def _io_terminal(symbols: bytes, challenge, trace_len: int):
    """(evaluation_argument, offset=challenge^(n - len)) (air.rs:151-164)."""
    acc = Fq3.zero()
    for s in symbols:
        acc = challenge * acc + Fp(s)
    return acc, challenge ** (trace_len - len(symbols))
