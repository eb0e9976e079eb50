"""speechrecognition_tpu — a classical-ASR framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
kkromberg/SpeechRecognition reference (RWTH ASR lab): MFCC front-end,
GMM-HMM acoustic models trained with EM, Viterbi forced alignment,
time-synchronous word-loop beam decoding, WER scoring, a hybrid MLP
scorer, and n-gram language modelling — all expressed as dense, batched,
mask-padded tensor programs for an accelerator instead of the
reference's per-frame C++ pointer chasing.

Precision policy:
  * Model parameters and EM finalization live on the host in float64,
    matching the reference's double arithmetic bit-for-bit where possible.
  * Device compute (scoring, DP scans) defaults to float32 for speed with
    an optional float64 "exact" mode used by the parity test-suite.
"""

import jax as _jax

# Host-side parameter math must run in float64 to match the reference's
# double-precision EM (see Mixtures.cpp accumulators). Device hot paths
# request float32 explicitly.
_jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"

from . import config as config  # noqa: E402,F401
from . import lexicon as lexicon  # noqa: E402,F401
