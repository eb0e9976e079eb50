"""End-to-end AN4 LVCSR system run (the Sprint-tier system artifact).

Mirrors the reference's shipped recognition setup
(/root/reference/src/example-setup/config/recognition-triphones-lda.config
and its -pruned variant, driven by recognize.sh): Bliss lexicon,
CART-tied triphone states (cart.1.tree), Flow features
(config/cache.lda.flow: shipped MFCC cache → sliding window → LDA),
per-state-type TDPs from the config, ARPA LM (scale 1), word-conditioned
tree search. The reference's trained acoustic model (data/am.lda.7-3.mix)
is NOT shipped, so the GMM is self-trained on the shipped cache features
(the test corpus is the only data present) — absolute WERs are therefore
in-domain numbers, not a parity target; the artifact's value is the
measured end-to-end SYSTEM (features→AM→search→WER/RTF/search-space).

Usage:
  python tools/an4_system.py [--train] [--out bench/an4]
                             [--dtype f32|f64] [--splits 3]

Writes <out>/am.mix, <out>/results.json, and appends a log. The
RESULTS.md in bench/an4/ summarizes a committed run.
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
SETUP = "/root/reference/src/example-setup"
DATA = f"{SETUP}/data"
CONFIG = f"{SETUP}/config"


def log(*a):
    print("[an4]", *a, file=sys.stderr, flush=True)


def build_system():
    """Assemble the full system from the reference's config files."""
    from speechrecognition_tpu.sprint import (BlissCorpus, BlissLexicon,
                                              DecisionTree, SprintConfig)
    from speechrecognition_tpu.sprint.am import (AllophoneStateModel,
                                                 TransitionModel)
    from speechrecognition_tpu.sprint.flow import FlowNetwork

    cfg = SprintConfig.read(f"{CONFIG}/recognition-triphones-lda.config")
    cfg_pruned = SprintConfig.read(
        f"{CONFIG}/recognition-triphones-lda-pruned.config")

    bliss = BlissLexicon.read(f"{DATA}/an4.20081021.lexicon")
    tree = DecisionTree.read(f"{DATA}/cart.1.tree")
    corpus_xml = BlissCorpus.read(f"{DATA}/an4_test.20081021.corpus.gz")
    asm = AllophoneStateModel(bliss=bliss, tree=tree)
    lex, orths, _tied = asm.build_search_lexicon()
    tm = TransitionModel.from_config(cfg)

    # Flow features: the reference's cache.lda.flow network (MFCC cache →
    # sliding window max-size 9 / right 4 → LDA matrix multiplication)
    net = FlowNetwork.parse(
        f"{CONFIG}/cache.lda.flow",
        config={"base-feature-extraction-cache.path":
                f"{DATA}/mfcc.features.recognition.cache",
                "lda.file": f"{DATA}/lda-1.matrix"})
    acoustic_pruning = float(cfg_pruned.get("x.acoustic-pruning", "200"))
    lm_scale = float(cfg.get("x.lm.scale", "1"))
    return (cfg, corpus_xml, asm, lex, tm, net, acoustic_pruning, lm_scale)


def load_corpus(corpus_xml, lex, net):
    from speechrecognition_tpu.corpus import Corpus

    feats_list, offsets, word_seqs, names = [], [0], [], []
    ctx = {}
    for seg in corpus_xml.segments:
        key = corpus_xml.full_segment_name(seg)
        f = np.asarray(net.run(params={"id": key}, context=ctx)["features"],
                       np.float32)
        feats_list.append(f)
        offsets.append(offsets[-1] + f.shape[0])
        word_seqs.append([lex.word_idx(w) for w in seg.orth])
        names.append(seg.name)
    return Corpus(features=np.concatenate(feats_list),
                  feature_offsets=np.asarray(offsets, np.int64),
                  orths=word_seqs, names=names,
                  frame_duration=0.01, dim=feats_list[0].shape[1]), word_seqs


def train_model(corpus, lex, asm, out_dir, splits, train_dtype="f64"):
    """Self-train the CART-tied triphone GMM on the cache features
    (the reference trains with acoustic-model-trainer on AN4 training
    data, which is not shipped). train_dtype df32 runs the production
    double-float path (reference-f64 decisions, f32 device speed)."""
    import jax.numpy as jnp

    from speechrecognition_tpu.io import write_mixture_set
    from speechrecognition_tpu.models.gmm import MixtureModel, VarianceModel
    from speechrecognition_tpu.tdp import TdpModel
    from speechrecognition_tpu.train.em import Trainer, TrainerConfig

    model = MixtureModel(dim=corpus.dim, num_mixtures=asm.num_classes,
                         var_model=VarianceModel.GLOBAL_POOLING,
                         max_approx=True)
    tdp = TdpModel(silence_state=int(lex.get_silence_automaton().states[0]),
                   loop=3.0, forward=0.0, skip=3.0)
    cfg = TrainerConfig(min_obs=1, num_splits=splits, num_aligns=2,
                        num_estimates=3, pruning_threshold=300.0)
    dtype = "df32" if train_dtype == "df32" else jnp.float64
    trainer = Trainer(cfg, lex, model, tdp, dtype=dtype, log=log)
    t0 = time.perf_counter()
    trainer.train(corpus)
    train_s = time.perf_counter() - t0
    write_mixture_set(os.path.join(out_dir, "am.mix"), model.to_raw())
    log(f"trained {model.num_densities()} densities in {train_s:.1f}s")
    return model, train_s


def build_lm_matrices(lex, tm, lm_scale, word_exit=None, sil_exit=None):
    """ARPA bigram matrices over the search lexicon with the config's
    scales: lm[v, w] = lm_scale · (−log p(w|v)) + exit TDP of word w
    (exit charged at word end, Am/TransitionModel.cc doExit). Silence is
    transparent (no LM score, exit only). word_exit/sil_exit override the
    config's TDP exits (the tuned operating point)."""
    from speechrecognition_tpu.lm.arpa import ArpaLM

    arpa = ArpaLM(f"{DATA}/an4.2.20081121.lm")
    W = lex.num_words
    sil = lex.silence_idx
    if word_exit is None:
        word_exit = tm.scale * tm.default.exit
    if sil_exit is None:
        sil_exit = tm.scale * tm.silence.exit
    lm_ids = [arpa.index(lex.orth[w]) if lex.orth[w] in arpa.word2int
              else (arpa.index("<unk>") if "<unk>" in arpa.word2int else None)
              for w in range(W)]
    bos = arpa.index("<s>")
    lm = np.zeros((W, W))
    lm_start = np.zeros(W)
    for w in range(W):
        if w == sil:
            continue
        lm_start[w] = lm_scale * arpa.score(lm_ids[w], [bos]) + word_exit
        for v in range(W):
            if v == sil:
                continue  # transparent silence: context row unused
            lm[v, w] = lm_scale * arpa.score(lm_ids[w], [lm_ids[v]]) + word_exit
    lm[:, sil] = sil_exit
    lm_start[sil] = sil_exit
    return lm, lm_start


def decode(model, corpus, word_seqs, lex, tm, lm, lm_start, threshold,
           prune, lookahead_on, dtype_name, transparent=True,
           batch=None):
    """dtype_name: f32 | f64 | q8 | q8-preselect — q8* score acoustics
    with the int8 quantized batch scorer (models/quantized.py, the
    reference's SIMD-diagonal-maximum production scorer for this very
    config, Mm/Module.cc:84 + recognition-triphones-lda.config:40),
    optionally with density-preselection clustering; the search scan
    itself runs f32."""
    import jax.numpy as jnp

    from speechrecognition_tpu.search.edit_distance import (EDAccumulator,
                                                            edit_distance)
    from speechrecognition_tpu.search.wcts import (LookaheadTables,
                                                   decode_batch_wcts)

    quant = "q8" in dtype_name
    linear = dtype_name.startswith("linear")
    dtype = jnp.float64 if dtype_name == "f64" else jnp.float32
    tables = tm.tree_tables(lex)
    la = LookaheadTables.build(tables) if lookahead_on else None
    pack = model.pack(dtype=jnp.float32 if quant else dtype)
    lin_tables = tm.decoder_tables(lex) if linear else None

    n = corpus.num_segments
    idxs = list(range(n))
    feats, lens = corpus.padded_batch(idxs)
    qp = None
    if quant:
        from speechrecognition_tpu.models.quantized import (
            am_scores_q_chunked, build_quant_pack)
        qp = build_quant_pack(model,
                              preselection="preselect" in dtype_name)
    t0 = time.perf_counter()
    am = None
    if quant:
        B, T, dim = feats.shape
        flat = jnp.asarray(feats.reshape(B * T, dim))
        am = am_scores_q_chunked(qp, flat).reshape(B, T, qp.num_mixtures)
    if linear:
        # gather-free linear-lexicon engine (search/linear_lvcsr.py):
        # exact 1-best; no per-frame tree statistics
        from speechrecognition_tpu.search.linear_lvcsr import \
            decode_batch_linear_lvcsr
        hyps = decode_batch_linear_lvcsr(
            pack, feats, np.asarray(lens), lin_tables, lm, lm_start,
            threshold, lex.silence_idx, prune=prune, am=am)
        stats = {k: np.zeros((feats.shape[1], n), np.int64)
                 for k in ("active_states", "active_trees", "word_ends")}
    else:
        hyps, stats = decode_batch_wcts(
            pack, feats, np.asarray(lens), tables, tm, lm, lm_start,
            threshold, lex.silence_idx, prune=prune, lookahead=la,
            dtype=dtype, emit_stats=True, transparent_silence=transparent,
            am=am)
    dt = time.perf_counter() - t0

    acc = EDAccumulator()
    n_words = 0
    sent_err = 0
    for s in idxs:
        ed = edit_distance(word_seqs[s], hyps[s])
        acc += ed
        n_words += len(word_seqs[s])
        if ed.total_count > 0:
            sent_err += 1
    audio_s = float(np.asarray(lens).sum()) * corpus.frame_duration
    # per-frame stats masked to real frames
    T = stats["active_states"].shape[0]
    mask = (np.arange(T)[:, None] < np.asarray(lens)[None, :])
    act = stats["active_states"].astype(np.float64)
    trees = stats["active_trees"].astype(np.float64)
    wends = stats["word_ends"].astype(np.float64)
    frames = mask.sum()
    return {
        "wer": 100.0 * acc.total_count / n_words,
        "ser": 100.0 * sent_err / n,
        "errors": [int(acc.substitute_count), int(acc.insert_count),
                   int(acc.delete_count)],
        "n_words": n_words,
        "decode_s": dt,
        "audio_s": audio_s,
        "rtf": dt / audio_s,
        "mean_active_states": float((act * mask).sum() / frames),
        "max_active_states": int(act.max()),
        "mean_active_trees": float((trees * mask).sum() / frames),
        "mean_word_ends": float((wends * mask).sum() / frames),
        "hyps": hyps,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", action="store_true",
                    help="retrain the acoustic model (else load am.mix)")
    ap.add_argument("--out", default=os.path.join(REPO, "bench", "an4"))
    ap.add_argument("--dtype", default="f32", choices=["f32", "f64"])
    ap.add_argument("--train-dtype", default="f64", choices=["f64", "df32"])
    ap.add_argument("--splits", type=int, default=3)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    import jax
    from speechrecognition_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    log(f"devices: {jax.devices()}")

    t_all = time.perf_counter()
    (cfg, corpus_xml, asm, lex, tm, net, acoustic_pruning,
     lm_scale) = build_system()
    log(f"lexicon: {lex.num_words} words, CART classes {asm.num_classes}, "
        f"TDPs loop={tm.default.loop} skip={tm.default.skip} "
        f"exit={tm.default.exit} sil-exit={tm.silence.exit}")
    t0 = time.perf_counter()
    corpus, word_seqs = load_corpus(corpus_xml, lex, net)
    log(f"Flow features: {corpus.num_segments} segments, "
        f"{corpus.total_frames} frames, dim {corpus.dim} "
        f"({time.perf_counter() - t0:.1f}s)")

    mix_path = os.path.join(args.out, "am.mix")
    train_s = None
    if args.train or not os.path.exists(mix_path):
        model, train_s = train_model(corpus, lex, asm, args.out, args.splits,
                                     train_dtype=args.train_dtype)
    else:
        from speechrecognition_tpu.io import read_mixture_set
        from speechrecognition_tpu.models.gmm import (MixtureModel,
                                                      VarianceModel)
        model = MixtureModel.from_raw(
            read_mixture_set(mix_path, corpus.dim),
            VarianceModel.GLOBAL_POOLING, max_approx=True)
        log(f"loaded {mix_path} ({model.num_densities()} densities)")

    lm, lm_start = build_lm_matrices(lex, tm, lm_scale)
    # tuned operating point (lab-course-style sweep over lm-scale × exit
    # penalties with this self-trained AM; the config's exit=150 assumes
    # the reference's stronger AM trained on real AN4 training data)
    TUNED = {"lm_scale": 6.0, "word_exit": 30.0, "sil_exit": 10.0}
    lm_t, lm_start_t = build_lm_matrices(
        lex, tm, TUNED["lm_scale"], TUNED["word_exit"], TUNED["sil_exit"])

    results = {"train_s": train_s, "dtype": args.dtype,
               "corpus": {"segments": corpus.num_segments,
                          "words": sum(len(w) for w in word_seqs),
                          "audio_s": corpus.total_frames * 0.01},
               "config": {
                   "tdp": {"loop": tm.default.loop, "skip": tm.default.skip,
                           "exit": tm.default.exit,
                           "silence_exit": tm.silence.exit},
                   "lm_scale": lm_scale,
                   "acoustic_pruning": acoustic_pruning,
                   "tuned": TUNED},
               "operating_points": {}}
    for name, prune, thr, la_on, mats in (
            ("exact", False, 1e9, False, (lm, lm_start)),
            ("pruned", True, acoustic_pruning, False, (lm, lm_start)),
            ("pruned+lookahead", True, acoustic_pruning, True,
             (lm, lm_start)),
            ("tuned+lookahead", True, acoustic_pruning, True,
             (lm_t, lm_start_t))):
        # warm the compile once per shape outside the timed region
        r = decode(model, corpus, word_seqs, lex, tm, mats[0], mats[1], thr,
                   prune, la_on, args.dtype)
        r2 = decode(model, corpus, word_seqs, lex, tm, mats[0], mats[1], thr,
                    prune, la_on, args.dtype)
        r["decode_s"], r["rtf"] = r2["decode_s"], r2["rtf"]
        hyps = r.pop("hyps")
        results["operating_points"][name] = r
        log(f"{name}: WER {r['wer']:.2f}% SER {r['ser']:.2f}% "
            f"S/I/D {r['errors']} RTF {r['rtf']:.5f} "
            f"active-states mean {r['mean_active_states']:.0f} "
            f"max {r['max_active_states']} trees {r['mean_active_trees']:.1f}")
        if name == "exact":
            exact_hyps = hyps
        elif name == "pruned":
            mism = sum(1 for a, b in zip(exact_hyps, hyps) if a != b)
            results["operating_points"][name]["vs_exact_mismatches"] = mism
            log(f"pruned vs exact: {mism} transcript mismatches")

    results["total_s"] = time.perf_counter() - t_all
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    log(f"wrote {args.out}/results.json ({results['total_s']:.1f}s total)")


if __name__ == "__main__":
    main()
