"""Full-corpus discriminative training (MPE) on SieTill.

Starts from the framework-self-trained ML model (bench/model.mix, the
415 s EM run whose test decode is bit-identical to the C++ oracle at
WER 4.5017 %) and runs MPE iterations over the full 13,036-utterance
training corpus: denominator word lattices from the zerogram word-loop
decode, approximate-accuracy payloads against the ML forced alignment,
accuracy-weighted forward-backward (gamma^MPE), sign-split EBW update
with I-smoothing (train/mpe.py; reference machinery:
Mm/EbwDiscriminativeMixtureSetEstimator.cc, Speech/AccuracyFsaBuilder.cc,
Lattice/Accuracy.cc:351-369).

After each iteration the TEST corpus (13,117 utts) is decoded with the
production recognizer and the WER delta vs 4.501682 % is recorded.

Usage:
  python tools/mpe_run.py [--iters 2] [--max-segments N] [--out bench/mpe_run]
                          [--e 2.0] [--tau 50]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
REFERENCE = "/root/reference"


def log(*a):
    print(f"[mpe {time.strftime('%H:%M:%S')}]", *a, file=sys.stderr,
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--max-segments", type=int, default=0,
                    help="train-corpus subset (0 = all 13,036)")
    ap.add_argument("--out", default=os.path.join(REPO, "bench", "mpe_run"))
    ap.add_argument("--e", type=float, default=2.0)
    ap.add_argument("--tau", type=float, default=50.0)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--posterior-threshold", type=float, default=5.0)
    ap.add_argument("--skip-test-decode", action="store_true")
    ap.add_argument("--holdout", type=int, default=0,
                    help="hold out the LAST N train segments from MPE "
                         "training and decode them each iteration: "
                         "iteration selection from held-out-train WER "
                         "instead of the test corpus (the round-4 "
                         "robustness gap: selection on test re-rolls "
                         "the dice on every recipe change)")
    ap.add_argument("--init-model", default=None,
                    help="resume from a saved mpe-<k>.mix instead of the "
                         "ML model (alignment stays the ML alignment, as "
                         "the reference keeps the numerator fixed)")
    ap.add_argument("--start-iter", type=int, default=0)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    import jax
    import jax.numpy as jnp

    from speechrecognition_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()

    from speechrecognition_tpu.config import Configuration
    from speechrecognition_tpu.corpus import Corpus, CorpusDescription
    from speechrecognition_tpu.features.frontend import SignalAnalysisConfig
    from speechrecognition_tpu.io import read_mixture_set, write_mixture_set
    from speechrecognition_tpu.lexicon import (build_segment_automaton,
                                               build_sietill_lexicon)
    from speechrecognition_tpu.models.gmm import MixtureModel, VarianceModel
    from speechrecognition_tpu.search.decoder import Recognizer
    from speechrecognition_tpu.tdp import TdpModel
    from speechrecognition_tpu.train.em import Trainer, TrainerConfig
    from speechrecognition_tpu.train.mpe import MpeTrainer
    from speechrecognition_tpu.train.ebw import EbwConfig
    from speechrecognition_tpu.align.viterbi import AlignerTables
    from speechrecognition_tpu.tools.partition import subset_corpus

    log(f"devices: {jax.devices()}")
    lex = build_sietill_lexicon()
    feature_path = os.path.join(REFERENCE, "data/new_features/")
    norm_path = os.path.join(REFERENCE,
                             "src/sietill/Normalization-eugen.bin")
    train_desc = CorpusDescription.read(
        os.path.join(REFERENCE, "src/sietill/corpora/corpus_train.json"), lex)
    corpus = Corpus.read(train_desc, feature_path, SignalAnalysisConfig(),
                         normalization_path=norm_path)
    if args.max_segments:
        corpus = subset_corpus(corpus, list(range(args.max_segments)))
    holdout_corpus = None
    if args.holdout:
        n = corpus.num_segments
        holdout_corpus = subset_corpus(
            corpus, list(range(n - args.holdout, n)))
        corpus = subset_corpus(corpus, list(range(n - args.holdout)))
        log(f"holding out the last {args.holdout} train segments for "
            f"iteration selection")
    log(f"train corpus: {corpus.num_segments} segments, "
        f"{corpus.total_frames} frames")

    with open(os.path.join(REPO, "bench", "model.mix.json")) as f:
        meta = json.load(f)
    model = MixtureModel.from_raw(
        read_mixture_set(os.path.join(REPO, "bench", "model.mix"), 25),
        VarianceModel.from_string(meta.get("pooling", "none")),
        max_approx=True)
    tdp_vals = meta.get("tdp", [3.0, 0.0, 30.0])
    tdp = TdpModel(silence_state=lex.silence_state, loop=tdp_vals[0],
                   forward=tdp_vals[1], skip=tdp_vals[2])
    log(f"ML model: {model.num_densities()} densities, tdp {tdp_vals}")

    # numerator forced alignment with the ML model (the reference's
    # numerator side comes from exactly this alignment). Cached on disk
    # keyed by corpus size so per-iteration resume runs skip the ~150 s
    # realignment (the ML alignment never changes across MPE iters).
    t0 = time.perf_counter()
    align_cache = os.path.join(args.out,
                               f"ml_alignment_{corpus.total_frames}.npy")
    if os.path.exists(align_cache):
        alignment = np.load(align_cache)
        log(f"forced alignment: loaded from {align_cache}")
    else:
        automata = [build_segment_automaton(lex, orth)
                    for orth in corpus.orths]
        tables_all = AlignerTables.build(automata, tdp)
        alignment = np.zeros(corpus.total_frames, np.int32)
        aligner = Trainer(TrainerConfig(pruning_threshold=200.0,
                                        batch_size=args.batch),
                          lex, model, tdp, dtype="df32", log=log)
        aligner._realign(corpus, tables_all, alignment)
        np.save(align_cache, alignment)
        log(f"forced alignment: {time.perf_counter() - t0:.1f}s "
            f"(silence "
            f"{100.0 * (alignment == lex.silence_state).mean():.1f}%)")

    if args.init_model:
        model = MixtureModel.from_raw(
            read_mixture_set(args.init_model, 25),
            VarianceModel.from_string(meta.get("pooling", "none")),
            max_approx=True)
        log(f"resumed model from {args.init_model} "
            f"({model.num_densities()} densities)")

    cfg = EbwConfig(e_constant=args.e, i_smoothing_tau=args.tau,
                    posterior_threshold=args.posterior_threshold,
                    word_penalty=float(meta.get("word_penalty", 80.0)),
                    am_threshold=float(meta.get("am_threshold", 200.0)),
                    batch_size=args.batch)
    trainer = MpeTrainer(cfg, lex, model, tdp, dtype=jnp.float32)

    test_corpus_cache = []
    #: one Recognizer per corpus, reused across iterations (keeps the
    #: DeviceCorpus upload one-time); only the pack is swapped
    rec_cache = {}

    def _decode(which, tag):
        if which == "test":
            if not test_corpus_cache:   # load the 13k-utt corpus once
                test_desc = CorpusDescription.read(
                    os.path.join(REFERENCE,
                                 "src/sietill/corpora/corpus_test.json"),
                    lex)
                test_corpus_cache.append(Corpus.read(
                    test_desc, feature_path, SignalAnalysisConfig(),
                    normalization_path=norm_path))
            c = test_corpus_cache[0]
        else:
            c = holdout_corpus
        rec = rec_cache.get(which)
        if rec is None:
            config = Configuration({
                "am-threshold": meta.get("am_threshold", 200.0),
                "word-penalty": meta.get("word_penalty", 80.0),
                "pruned-search": True, "max-recognition-runs": 10 ** 9})
            rec = Recognizer(config, lex, tdp, model.pack_df(),
                             dtype="df32")
            rec_cache[which] = rec
        else:
            rec.pack = model.pack_df()
        t = time.perf_counter()
        res = rec.recognize_corpus(c, batch_size=512)
        log(f"{which} decode [{tag}]: WER {res['wer']:.4f}% "
            f"SER {res['ser']:.4f}% S/I/D {res['substitutions']}/"
            f"{res['insertions']}/{res['deletions']} "
            f"({time.perf_counter() - t:.1f}s)")
        return {"wer": res["wer"], "ser": res["ser"],
                "sid": [res["substitutions"], res["insertions"],
                        res["deletions"]]}

    def test_wer(tag):
        if args.skip_test_decode:
            return None
        return _decode("test", tag)

    def holdout_wer(tag):
        if holdout_corpus is None:
            return None
        return _decode("holdout", tag)

    results_path = os.path.join(args.out, "results.json")
    if args.start_iter > 0 and os.path.exists(results_path):
        with open(results_path) as f:
            results = json.load(f)
    else:
        results = {"segments": corpus.num_segments,
                   "config": {"E": args.e, "tau": args.tau, "holdout": args.holdout,
                              "posterior_threshold":
                                  args.posterior_threshold},
                   "baseline_test": {"wer": 4.501682},
                   "align_silence_pct":
                       float(100.0 * (alignment == lex.silence_state).mean()),
                   "iterations": []}
    for it in range(args.start_iter, args.start_iter + args.iters):
        t0 = time.perf_counter()
        # acc_after is only decoded on the LAST iteration (iteration k's
        # after == iteration k+1's before otherwise)
        diag = trainer.iterate(
            corpus, alignment,
            compute_after=(it == args.start_iter + args.iters - 1))
        dt = time.perf_counter() - t0
        n_seg = corpus.num_segments

        def _j(x):
            """NaN (the skipped after-pass) → null, keeping results.json
            valid for strict JSON parsers."""
            import math as _math
            return None if isinstance(x, float) and _math.isnan(x) else x

        row = {"iteration": it + 1, "seconds": dt,
               "expected_accuracy_before": diag["expected_accuracy_before"],
               "expected_accuracy_after": _j(diag["expected_accuracy_after"]),
               "per_utt_acc_before": diag["expected_accuracy_before"] / n_seg,
               "per_utt_acc_after": _j(diag["expected_accuracy_after"]
                                       / n_seg),
               "num_mass": diag["num_mass"], "den_mass": diag["den_mass"]}
        after = (f"{row['per_utt_acc_after']:.4f}"
                 if row['per_utt_acc_after'] is not None else "(next iter)")
        log(f"iter {it + 1}: {dt:.1f}s, expected accuracy "
            f"{row['per_utt_acc_before']:.4f} -> {after} "
            f"per utt, masses num {diag['num_mass']:.0f} den "
            f"{diag['den_mass']:.0f}")
        row["holdout"] = holdout_wer(f"iter{it + 1}")
        row["test"] = test_wer(f"iter{it + 1}")
        results["iterations"].append(row)
        write_mixture_set(os.path.join(args.out, f"mpe-{it + 1}.mix"),
                          model.to_raw())
        with open(results_path, "w") as f:
            json.dump(results, f, indent=1)
    log("done")


if __name__ == "__main__":
    main()
