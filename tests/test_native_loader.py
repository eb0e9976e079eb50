"""Native C++ corpus loader must agree bit-for-bit with the Python path."""

import glob

import numpy as np
import pytest

from speechrecognition_tpu.corpus import Corpus, CorpusDescription
from speechrecognition_tpu.features.frontend import SignalAnalysisConfig
from speechrecognition_tpu.native.loader import load_corpus_native, native_available


@pytest.mark.skipif(not native_available(), reason="no C++ toolchain")
def test_native_matches_python(lexicon, fixtures_dir):
    desc = CorpusDescription.read(
        str(fixtures_dir / "demo_corpus.json"), lexicon)
    cfg = SignalAnalysisConfig()
    norm = str(fixtures_dir / "normalization-demo.bin")
    py = Corpus.read(desc, str(fixtures_dir / "demo_features") + "/", cfg,
                     normalization_path=norm, use_native=False)
    nat = Corpus.read(desc, str(fixtures_dir / "demo_features") + "/", cfg,
                      normalization_path=norm, use_native=True)
    np.testing.assert_array_equal(py.feature_offsets, nat.feature_offsets)
    np.testing.assert_array_equal(py.features, nat.features)


@pytest.mark.skipif(not native_available(), reason="no C++ toolchain")
def test_native_no_normalization(lexicon, fixtures_dir):
    desc = CorpusDescription.read(
        str(fixtures_dir / "demo_corpus.json"), lexicon)
    cfg = SignalAnalysisConfig()
    py = Corpus.read(desc, str(fixtures_dir / "demo_features") + "/", cfg,
                     use_native=False)
    nat = Corpus.read(desc, str(fixtures_dir / "demo_features") + "/", cfg,
                      use_native=True)
    np.testing.assert_array_equal(py.features, nat.features)
