"""WER sweep driver: pruning-threshold and word-penalty/TDP tuning curves.

Reproduces the reference's tuning workflows as one batched device driver:

  * threshold mode — WER vs am-threshold, the wer-plotting data format
    ``<threshold> <wer>`` (src/wer-plotting/gnuplot/test/time.data:1-6);
    with --time also appends decode seconds per line.
  * tuning mode — WER/SER over a (tdp, word-penalty) grid, the
    presentation's tuning table format ``<l>-<f>-<s> <wp> <wer> <ser>``
    (presentation.13-07-2016/tuning_parameters/tuning_word_penalty.data).

The am-threshold is a traced scalar and the word penalty only changes the
small host-side entry tables, so the whole sweep reuses ONE compiled
decoder: sweeping 6 thresholds costs ~6 decode passes, no recompiles.

Usage:
  python tools/wer_sweep.py --mode threshold --model bench/model.mix \
      --thresholds 25,50,100,250,500 [--max-segments 2000] [--out f.data]
  python tools/wer_sweep.py --mode tuning --model bench/model.mix \
      --tdps 3-0-30,1-0-10 --word-penalties 60,80,100
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
REFERENCE = "/root/reference"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("threshold", "tuning"),
                    default="threshold")
    ap.add_argument("--model", default=os.path.join(REPO, "bench/model.mix"))
    ap.add_argument("--corpus", default=os.path.join(
        REFERENCE, "src/sietill/corpora/corpus_test.json"))
    ap.add_argument("--features", default=os.path.join(
        REFERENCE, "data/new_features/"))
    ap.add_argument("--normalization", default=os.path.join(
        REFERENCE, "src/sietill/Normalization-eugen.bin"))
    ap.add_argument("--thresholds", default="25,50,100,250,500,1000000")
    ap.add_argument("--tdps", default="3-0-30",
                    help="comma list of loop-forward-skip triples")
    ap.add_argument("--word-penalties", default="60,80,100,120")
    ap.add_argument("--pooling", default="none")
    ap.add_argument("--max-segments", type=int, default=None)
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    ap.add_argument("--time", action="store_true",
                    help="append decode seconds to threshold lines")
    ap.add_argument("--out", default=None)
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

    dtype = jnp.float64 if args.dtype == "f64" else jnp.float32
    lex = build_sietill_lexicon()
    desc = CorpusDescription.read(args.corpus, lex)
    corpus = Corpus.read(desc, args.features, SignalAnalysisConfig(),
                         normalization_path=args.normalization)
    raw = read_mixture_set(args.model, 25)
    model = MixtureModel.from_raw(raw, VarianceModel.from_string(args.pooling),
                                  max_approx=True)
    pack = model.pack(dtype=dtype)
    out = open(args.out, "w") if args.out else sys.stdout
    n = args.max_segments

    def decode(tdp_triple, wp, thr):
        l, f, s = tdp_triple
        tdp = TdpModel(silence_state=lex.silence_state,
                       loop=l, forward=f, skip=s)
        cfg = Configuration({"am-threshold": thr, "word-penalty": wp,
                             "pruned-search": True,
                             "max-recognition-runs": 10 ** 9})
        rec = Recognizer(cfg, lex, tdp, pack, dtype=dtype)
        t0 = time.perf_counter()
        r = rec.recognize_corpus(corpus, batch_size=512, max_segments=n)
        r["wall"] = time.perf_counter() - t0
        return r

    if args.mode == "threshold":
        for thr in (float(x) for x in args.thresholds.split(",")):
            tdp = tuple(float(x) for x in args.tdps.split(",")[0].split("-"))
            wp = float(args.word_penalties.split(",")[0])
            r = decode(tdp, wp, thr)
            line = f"{thr:g} {r['wer']:.6f}"
            if args.time:
                line += f" {r['time']:.2f}"
            print(line, file=out, flush=True)
            print(f"# thr={thr:g}: WER {r['wer']:.4f}% RTF {r['rtf']:.6f}",
                  file=sys.stderr)
    else:
        print("TDP # WP # WER # SER", file=out)
        for tdp_s in args.tdps.split(","):
            tdp = tuple(float(x) for x in tdp_s.split("-"))
            for wp in (float(x) for x in args.word_penalties.split(",")):
                thr = float(args.thresholds.split(",")[0])
                r = decode(tdp, wp, thr)
                print(f"{tdp_s} {wp:g} {r['wer']:.2f} {r['ser']:.2f}",
                      file=out, flush=True)
                print(f"# tdp={tdp_s} wp={wp:g}: WER {r['wer']:.4f}%",
                      file=sys.stderr)
    if args.out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
