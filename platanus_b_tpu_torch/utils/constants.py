"""Global constants mirroring the reference's ConstParam and per-class statics.

Every value is taken from Platanus_B v1.3.2 sources (file:line cited) so that
parity-relevant thresholds are honored exactly.

Port copy of platanus_b_tpu/utils/constants.py, unchanged.
"""

VERSION = "1.3.2"  # common.cpp:26

# --- platanus::ConstParam (common.cpp:26-40) ---
MAX_READ_LEN = 500_000          # common.cpp:28
SCAFFOLD_HASH_OVERLAP = 32      # common.cpp:29
OUTPUT_LINE_LENGTH = 80         # common.cpp:30
MAX_FILE_NUM = 100              # common.cpp:31
MAX_FILE_LEN = 200              # common.cpp:32
MAX_THREAD = 100                # common.cpp:33
DOUBLE_HASH_MAX_LOAD_FACTOR = 0.9  # common.cpp:34
DEFAULT_CONTIG_READ_LEN = 100   # common.cpp:35
SHORT_READ_INS_SIZE_LOWER_BOUND_FACTOR = 0.25  # common.cpp:36
SHORT_READ_INS_SIZE_UPPER_BOUND_FACTOR = 1.75  # common.cpp:37
LONG_READ_INS_SIZE_LOWER_BOUND_FACTOR = 0.25   # common.cpp:38
LONG_READ_INS_SIZE_UPPER_BOUND_FACTOR = 10.0   # common.cpp:39

# --- base coding (common.h:256-257) ---
# Char2Bin: A->0 C->1 G->2 T->3 N->4 ; Bin2Char: "ACGTN"
BASE_A, BASE_C, BASE_G, BASE_T, BASE_N = 0, 1, 2, 3, 4

# --- assemble defaults (assemble.cpp:55-70) ---
ASSEMBLE_DEFAULT_K = 32              # -k 32 (initial k-mer size)
ASSEMBLE_DEFAULT_MAX_K_FACTOR = 0.5  # -K 0.5 (max-k = 0.5 * read length)
ASSEMBLE_DEFAULT_STEP_K = 10         # -s 10 (k step)
ASSEMBLE_DEFAULT_NUM_THREAD = 1
ASSEMBLE_DEFAULT_MEM_GB = 16         # -m 16
ASSEMBLE_DEFAULT_COVERAGE_CUTOFF = 0   # -c 0 (0 => auto)
ASSEMBLE_DEFAULT_LOW_COV_RATIO = 2.0   # -u bubble/branch: see below
# branch cutting threshold ratio (assemble.cpp:62 "-d 0.5")
ASSEMBLE_DEFAULT_BRANCH_CUT_RATIO = 0.5
# bubble crush identity threshold (assemble.cpp:61 "-u 0.1")
ASSEMBLE_DEFAULT_BUBBLE_IDENTITY = 0.1

# --- graph cleaning (graph.h) ---
# short/low-coverage straight-node deletion: length <= 2*k and
# coverage < sqrt(averageCoverage) -> delete (graph.h:2033-2106)
# bubble: banded alignment width and max bubble length are derived from k.

# --- mapper (mapper.cpp:29-31) ---
MAPPER_SEED_LEN = 32                  # keyLength used for contig index
MAPPER_MIN_IDENTITY_UNGAP = 0.95      # mapper.cpp:29-31 (polish path)

# --- gap close (gapClose.cpp:37-42) ---
GAPCLOSE_HEAD_TAIL_SEQ_LEN = 150      # gapClose.cpp:37
GAPCLOSE_BRUIJN_MIN_KMER = 20         # gapClose.cpp:41
GAPCLOSE_BRUIJN_MAX_KMER = 80         # gapClose.cpp:42
GAPCLOSE_DEFAULT_OLC_THRESHOLD = 1000  # -d default (gapClose.cpp)

# --- polish (polish.cpp) ---
POLISH_DEFAULT_MIN_IDENTITY = 0.97    # -e default
POLISH_DEFAULT_ODD_RATIO = 0.5        # -r default

# --- iterate (iterate.cpp:43) ---
ITERATE_DEFAULT_TIMES = 6

# --- long-read alignment filters (solveDBG.cpp:44-46) ---
LONGREAD_MIN_ALIGNMENT_IDENTITY = 0.8
LONGREAD_MIN_ALIGNMENT_LENGTH = 1000
