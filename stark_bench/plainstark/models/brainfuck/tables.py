"""Column layout, challenges and hints (reference: examples/brainfuck/tables.rs).

Global column indices: the five tables' columns are packed consecutively —
base columns 0..16, extension columns 17..25."""

# -- processor base (8) -------------------------------------------------------
PROC_CYCLE = 0
PROC_IP = 1
PROC_CURR_INSTR = 2
PROC_NEXT_INSTR = 3
PROC_MP = 4
PROC_MEM_VAL = 5
PROC_MEM_VAL_INV = 6
PROC_DUMMY = 7

# -- memory base (4) ----------------------------------------------------------
MEM_CYCLE = 8
MEM_MP = 9
MEM_MEM_VAL = 10
MEM_DUMMY = 11

# -- instruction base (3) -----------------------------------------------------
INSTR_IP = 12
INSTR_CURR_INSTR = 13
INSTR_NEXT_INSTR = 14

# -- input/output base (1 each) -----------------------------------------------
INPUT_VALUE = 15
OUTPUT_VALUE = 16

NUM_BASE_COLUMNS = 17

# -- extension columns (9) ----------------------------------------------------
PROC_INSTR_PERMUTATION = 17
PROC_MEM_PERMUTATION = 18
PROC_INPUT_EVAL = 19
PROC_OUTPUT_EVAL = 20
MEM_PERMUTATION = 21
INSTR_PROCESSOR_PERMUTATION = 22
INSTR_PROGRAM_EVAL = 23
INPUT_EVAL = 24
OUTPUT_EVAL = 25

NUM_EXTENSION_COLUMNS = 9

# -- challenges (11) ----------------------------------------------------------
CH_A, CH_B, CH_C, CH_D, CH_E, CH_F = range(6)
CH_ALPHA, CH_BETA, CH_GAMMA, CH_DELTA, CH_ETA = range(6, 11)
NUM_CHALLENGES = 11

# -- hints (5) ----------------------------------------------------------------
HINT_INSTRUCTION = 0
HINT_INPUT = 1
HINT_INPUT_OFFSET = 2
HINT_OUTPUT = 3
HINT_OUTPUT_OFFSET = 4
