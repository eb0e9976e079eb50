"""Sprint (rwth-asr-0.5) compatible infrastructure, re-designed as dense tensor programs.

This subpackage covers the LVCSR toolkit tier of the reference: the
hierarchical config system, Bliss XML corpora/lexica, Sprint file archives
and Flow feature caches, CART state tying, LDA front-end transforms, the
per-state-type transition model, and the word-conditioned tree search —
with all per-frame compute expressed as batched JAX programs.
"""

from .config import SprintConfig  # noqa: F401
from .archive import FileArchive  # noqa: F401
from .flow_cache import FeatureCache  # noqa: F401
from .bliss import BlissLexicon, BlissCorpus  # noqa: F401
from .cart import DecisionTree  # noqa: F401
from .lda import read_matrix_xml, SlidingWindowLDA  # noqa: F401
from .mc import ModelCombination, ScaledComponent  # noqa: F401
