"""Test configuration: run JAX on CPU with 8 virtual devices so the
multi-device sharding paths can be exercised without accelerators."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_num_cpu_devices", 8)

from speechrecognition_tpu.compile_cache import enable_compile_cache  # noqa: E402

# the EM/decoder scans cost minutes of XLA compile on a small CPU box;
# re-runs of the suite hit the persistent cache
enable_compile_cache()

import json  # noqa: E402
import pathlib  # noqa: E402

import pytest  # noqa: E402

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
DEMO_CORPUS = FIXTURES / "demo_corpus.json"


@pytest.fixture(scope="session")
def fixtures_dir() -> pathlib.Path:
    return FIXTURES


@pytest.fixture(scope="session")
def lexicon():
    from speechrecognition_tpu.lexicon import build_sietill_lexicon
    return build_sietill_lexicon()


@pytest.fixture(scope="session")
def demo_description(lexicon):
    from speechrecognition_tpu.corpus import CorpusDescription
    return CorpusDescription.read(str(DEMO_CORPUS), lexicon)


@pytest.fixture(scope="session")
def demo_corpus(demo_description):
    """The 35-utterance demo corpus with oracle-extracted features and
    oracle normalization stats."""
    from speechrecognition_tpu.corpus import Corpus
    from speechrecognition_tpu.features.frontend import SignalAnalysisConfig

    return Corpus.read(demo_description, str(FIXTURES / "demo_features") + "/",
                       SignalAnalysisConfig(),
                       normalization_path=str(FIXTURES / "normalization-demo.bin"))


@pytest.fixture(scope="session")
def demo_recognition():
    with open(FIXTURES / "demo_recognition.json") as f:
        return json.load(f)
