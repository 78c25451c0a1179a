"""Default parameters.

Mirrors the semantics of the reference's defaults (see
src/lofreq/defaults.h) so that default runs of the two tools
are comparable.
"""

SANGER_PHRED_MAX = 93

DEFAULT_MIN_MQ = 0
DEFAULT_MAX_MQ = 255

DEFAULT_MIN_BQ = 6
DEFAULT_MIN_ALT_BQ = 6
DEFAULT_DEF_ALT_BQ = 0          # -1: ref median, 0: keep, >0: replace

DEFAULT_MIN_JQ = 0
DEFAULT_MIN_ALT_JQ = 0
DEFAULT_DEF_ALT_JQ = 0

DEFAULT_DEF_NM_QUAL = -1        # non-match quality for source qual

DEFAULT_MIN_COV = 1
DEFAULT_MAX_PLP_DEPTH = 1_000_000

DEFAULT_MIN_PLP_BQ = 3          # pileup-level base-quality blindness threshold
DEFAULT_MIN_PLP_IDQ = 0

DEFAULT_SIG = 0.01

NUM_NT4 = 5                     # A C G T N
NUM_NONCONS_BASES = 3

# merged-quality model: MQ==0 is translated to this error prob
# (reference: snpcaller.c:64)
MQ0_ERRPROB = 0.5

# aux tags (reference: defaults.h:84-109)
BAQ_TAG = "lb"
AI_TAG = "ai"
AD_TAG = "ad"
BI_TAG = "BI"
BD_TAG = "BD"
SRC_QUAL_TAG = "sq"

# default indel quality used for indel ops in source-qual computation
# (reference: samutils.h INDEL_QUAL_DEFAULT)
INDEL_QUAL_DEFAULT = 45

MAX_INDELSIZE = 256

# strand-bias compound filter ratio (reference: lofreq_filter.c:57)
ALT_STRAND_RATIO = 0.85

# device-BAQ screening deflation (phred added to approximate BAQ values in
# the screening merge; lowers every err prob => the screened tail is a
# lower bound on the exact p-value, so screen discards are safe as long as
# |device BAQ - exact BAQ| <= this).  Empirically the f32 device kernel
# stays within 2 phred of the exact C kernel (tests/test_baq_jax.py); 6
# leaves a 3x safety band.
import os as _os

BAQ_SCREEN_DELTA = int(_os.environ.get("LOFREQ_TPU_BAQ_DELTA", "6"))
