"""Decoder parity on the demo corpus: transcripts must be identical to the
reference C++ decoder run on the same model (oracle fixture)."""

import numpy as np
import pytest

from speechrecognition_tpu.config import Configuration
from speechrecognition_tpu.io import read_mixture_set
from speechrecognition_tpu.models.gmm import MixtureModel, VarianceModel
from speechrecognition_tpu.search.decoder import Recognizer
from speechrecognition_tpu.search.edit_distance import edit_distance
from speechrecognition_tpu.tdp import TdpModel


@pytest.fixture(scope="module")
def recognizer(lexicon, fixtures_dir, demo_recognition):
    raw = read_mixture_set(str(fixtures_dir / "iter-2.mix"), 25)
    model = MixtureModel.from_raw(raw, VarianceModel.MIXTURE_POOLING, max_approx=True)
    c = demo_recognition["config"]
    tdp = TdpModel(silence_state=lexicon.silence_state,
                   loop=c["tdp"][0], forward=c["tdp"][1], skip=c["tdp"][2])
    import jax.numpy as jnp
    config = Configuration({"am-threshold": c["am_threshold"],
                            "word-penalty": c["word_penalty"],
                            "pruned-search": True,
                            "max-recognition-runs": 10000})
    return Recognizer(config, lexicon, tdp, model.pack(dtype=jnp.float64),
                      dtype=jnp.float64)


def test_transcript_parity(recognizer, demo_corpus, demo_recognition):
    result = recognizer.recognize_corpus(demo_corpus, batch_size=35)
    mismatches = []
    for utt in demo_recognition["utts"]:
        mine = result["hyps"][utt["idx"]]
        if mine != utt["hyp"]:
            mismatches.append((utt["idx"], mine, utt["hyp"]))
    assert not mismatches, f"{len(mismatches)} transcript mismatches: {mismatches[:5]}"


def test_corpus_metrics_parity(recognizer, demo_corpus, demo_recognition):
    result = recognizer.recognize_corpus(demo_corpus, batch_size=35)
    ref = demo_recognition["corpus"]
    assert abs(result["wer"] - ref["wer"]) < 1e-3
    assert abs(result["ser"] - ref["ser"]) < 1e-3
    s, i, d = ref["sid"]
    assert result["substitutions"] == s
    assert result["insertions"] == i
    assert result["deletions"] == d


def test_per_utt_edit_distance_parity(demo_recognition):
    """Our edit-distance must reproduce the reference's S/I/D per utterance
    given the same hyp/ref pairs (including its quirky first column)."""
    for utt in demo_recognition["utts"]:
        ed = edit_distance(utt["ref"], utt["hyp"])
        assert [ed.substitute_count, ed.insert_count, ed.delete_count] == utt["sid"], utt


def test_unpruned_decoder_agrees(recognizer, demo_corpus, lexicon, fixtures_dir,
                                 demo_recognition):
    """Cross-check: the full (unpruned) decoder must produce the same
    transcripts as the pruned one at this wide beam (reference has the same
    A/B pair, Recognizer.cpp:52-56)."""
    from speechrecognition_tpu.config import Configuration as Cfg
    raw = read_mixture_set(str(fixtures_dir / "iter-2.mix"), 25)
    model = MixtureModel.from_raw(raw, VarianceModel.MIXTURE_POOLING, max_approx=True)
    c = demo_recognition["config"]
    tdp = TdpModel(silence_state=lexicon.silence_state,
                   loop=c["tdp"][0], forward=c["tdp"][1], skip=c["tdp"][2])
    import jax.numpy as jnp
    config = Cfg({"am-threshold": c["am_threshold"],
                  "word-penalty": c["word_penalty"],
                  "pruned-search": False, "max-recognition-runs": 10000})
    full = Recognizer(config, lexicon, tdp, model.pack(dtype=jnp.float64),
                      dtype=jnp.float64)
    r_full = full.recognize_corpus(demo_corpus, batch_size=35)
    r_pruned = recognizer.recognize_corpus(demo_corpus, batch_size=35)
    assert r_full["hyps"] == r_pruned["hyps"]


def test_df32_transcript_parity(lexicon, fixtures_dir, demo_corpus,
                                demo_recognition):
    """The double-float (two-f32) decode path must reproduce the oracle
    transcripts exactly — it is the f32-only stand-in for the f64 path
    (Mixtures.cpp:590-628 double accumulation)."""
    raw = read_mixture_set(str(fixtures_dir / "iter-2.mix"), 25)
    model = MixtureModel.from_raw(raw, VarianceModel.MIXTURE_POOLING,
                                  max_approx=True)
    c = demo_recognition["config"]
    tdp = TdpModel(silence_state=lexicon.silence_state,
                   loop=c["tdp"][0], forward=c["tdp"][1], skip=c["tdp"][2])
    config = Configuration({"am-threshold": c["am_threshold"],
                            "word-penalty": c["word_penalty"],
                            "pruned-search": True,
                            "max-recognition-runs": 10000})
    rec = Recognizer(config, lexicon, tdp, model.pack_df(), dtype="df32")
    result = rec.recognize_corpus(demo_corpus, batch_size=35)
    mismatches = []
    for utt in demo_recognition["utts"]:
        if result["hyps"][utt["idx"]] != utt["hyp"]:
            mismatches.append((utt["idx"], result["hyps"][utt["idx"]],
                               utt["hyp"]))
    assert not mismatches, f"df32 mismatches: {mismatches[:5]}"


def test_df32_am_scores_match_f64(lexicon, fixtures_dir, demo_corpus):
    """DF acoustic scores track the f64 expansion path to ~2^-40."""
    import jax.numpy as jnp
    from speechrecognition_tpu.models.gmm import am_scores, am_scores_df
    from speechrecognition_tpu.ops import doublefloat as dfm

    raw = read_mixture_set(str(fixtures_dir / "iter-2.mix"), 25)
    model = MixtureModel.from_raw(raw, VarianceModel.MIXTURE_POOLING,
                                  max_approx=True)
    feats = demo_corpus.features[:2000].astype(np.float32)
    ref = np.asarray(am_scores(model.pack(dtype=jnp.float64),
                               jnp.asarray(feats)))
    got = dfm.to_f64(am_scores_df(model.pack_df(), jnp.asarray(feats)))
    err = np.abs(got - ref)
    tol = np.abs(ref) * 2.0 ** -38 + 2.0 ** -30
    worst = (err - tol).max()
    assert (err <= tol).all(), f"worst excess {worst}, max err {err.max()}"
