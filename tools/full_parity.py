"""Full test-corpus transcript parity vs the reference C++ decoder.

Decodes all 13117 test utterances with the committed bench model and
compares 1-best transcripts against the oracle fixture
(tests/fixtures/test_recognition_full.json.gz).

Usage: python tools/full_parity.py [--dtype f32|f64|df32]
"""

import argparse
import gzip
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="f32", choices=["f32", "f64", "df32"])
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--model", default="",
                    help="mixture-set path (default: bench/model.mix)")
    ap.add_argument("--buckets", default="",
                    help="comma-separated T buckets (fewer = fewer compiles)")
    args = ap.parse_args()

    from speechrecognition_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from speechrecognition_tpu.config import Configuration
    from speechrecognition_tpu.corpus import Corpus, CorpusDescription
    from speechrecognition_tpu.features.frontend import SignalAnalysisConfig
    from speechrecognition_tpu.io import read_mixture_set
    from speechrecognition_tpu.lexicon import build_sietill_lexicon
    from speechrecognition_tpu.models.gmm import MixtureModel, VarianceModel
    from speechrecognition_tpu.search.decoder import Recognizer
    from speechrecognition_tpu.tdp import TdpModel

    with gzip.open(os.path.join(REPO, "tests/fixtures/test_recognition_full.json.gz"), "rt") as f:
        golden = json.load(f)
    cfgm = golden["config"]

    lex = build_sietill_lexicon()
    desc = CorpusDescription.read(
        "/root/reference/src/sietill/corpora/corpus_test.json", lex)
    corpus = Corpus.read(desc, "/root/reference/data/new_features/",
                         SignalAnalysisConfig(),
                         normalization_path="/root/reference/src/sietill/Normalization-eugen.bin")
    raw = read_mixture_set(args.model or os.path.join(REPO, "bench/model.mix"), 25)
    model = MixtureModel.from_raw(raw, VarianceModel.from_string(cfgm["pooling"]),
                                  max_approx=True)
    if args.dtype == "df32":
        dtype = "df32"
        pack = model.pack_df()
    else:
        dtype = jnp.float64 if args.dtype == "f64" else jnp.float32
        pack = model.pack(dtype=dtype)
    tdp = TdpModel(silence_state=lex.silence_state, loop=cfgm["tdp"][0],
                   forward=cfgm["tdp"][1], skip=cfgm["tdp"][2])
    config = Configuration({"am-threshold": cfgm["am_threshold"],
                            "word-penalty": cfgm["word_penalty"],
                            "pruned-search": True, "max-recognition-runs": 10**9})
    rec = Recognizer(config, lex, tdp, pack, dtype=dtype)
    if args.buckets:
        rec.buckets = tuple(int(b) for b in args.buckets.split(","))
    rec.warmup(corpus, batch_size=args.batch_size)
    t0 = time.perf_counter()
    res = rec.recognize_corpus(corpus, batch_size=args.batch_size)
    elapsed = time.perf_counter() - t0

    mism = []
    for utt in golden["utts"]:
        if res["hyps"][utt["idx"]] != utt["hyp"]:
            mism.append(utt["idx"])
    print(f"dtype={args.dtype}")
    print(f"transcript mismatches: {len(mism)}/13117 "
          f"({100.0 * len(mism) / 13117:.4f}%)")
    if mism[:10]:
        for i in mism[:10]:
            print("  utt", i, "mine:", res["hyps"][i],
                  "oracle:", golden["utts"][i]["hyp"])
    print(f"WER {res['wer']:.6f}% (oracle {golden['corpus']['wer']}%)  "
          f"SER {res['ser']:.4f}%")
    print(f"S/I/D {res['substitutions']}/{res['insertions']}/{res['deletions']} "
          f"(oracle {golden['corpus']['sid']})")
    print(f"decode {res['time']:.2f}s, RTF {res['rtf']:.6f}, "
          f"total incl. host {elapsed:.1f}s")


if __name__ == "__main__":
    main()
