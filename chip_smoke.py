"""Smoke test of the recognizer's main paths on an NVIDIA GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --multi   # a host with 4 cards: the sharded paths only

Phases, each a function that the tests also call on the CPU:

  df32_exact         the error-free transforms of ops/doublefloat.py, jitted
                     and fused, bitwise against float64
  golden_demo        demo corpus, df32 decode: transcripts == the C++ oracle
  cli_recognize      the CLI's `recognize` action (f32 quadratic-expansion
                     scorer) == the same call on the CPU device
  production_decode  bench/model.mix, 1024-utterance df32 batch == an f64
                     decode on the CPU device
  em_train           df32 EM on the demo corpus == the oracle AM-score
                     trajectory
  nn_hybrid          MLP + prior hybrid decode == the same on the CPU device
  multi (--multi)    sharded df32 decode and sharded E-step over a 4-card
                     ("data",) mesh == the single-card results

Reads only files in this repository. Each phase prints its name, seconds
and verdict; a failing phase raises, so the script exits non-zero. The
last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
BENCH = os.path.join(REPO, "bench")

#: the production decode batch (bench.py)
PRODUCTION_BATCH = 1024
#: AM-score agreement of the f32 NN hybrid between the card and the CPU,
#: absolute, on scores of magnitude <= ~100 (about 2**-17 relative)
NN_SCORE_TOL = 1e-3
#: oracle AM scores are printed with %g (6 significant digits)
EM_SCORE_TOL = 1e-4


class PhaseFailed(AssertionError):
    pass


def _check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def _cpu():
    import jax
    return jax.devices("cpu")[0]


# -- shared inputs -------------------------------------------------------------


def _lexicon():
    from speechrecognition_tpu.lexicon import build_sietill_lexicon
    return build_sietill_lexicon()


def _golden():
    with open(os.path.join(FIXTURES, "demo_recognition.json")) as f:
        return json.load(f)


def _demo_corpus(lex):
    from speechrecognition_tpu.corpus import Corpus, CorpusDescription
    from speechrecognition_tpu.features.frontend import SignalAnalysisConfig

    desc = CorpusDescription.read(
        os.path.join(FIXTURES, "demo_corpus.json"), lex)
    return Corpus.read(desc, os.path.join(FIXTURES, "demo_features") + "/",
                       SignalAnalysisConfig(),
                       normalization_path=os.path.join(
                           FIXTURES, "normalization-demo.bin"))


def _replicate(corpus, n):
    """The corpus' utterances repeated round-robin to n segments."""
    from speechrecognition_tpu.corpus import Corpus

    ids = [i % corpus.num_segments for i in range(n)]
    feats = np.concatenate([corpus.feature_sequence(i) for i in ids])
    offsets = np.concatenate(
        [[0], np.cumsum([corpus.seq_length(i) for i in ids])]).astype(np.int64)
    return Corpus(features=feats, feature_offsets=offsets,
                  orths=[corpus.orths[i] for i in ids],
                  names=[f"{corpus.names[i]}#{k}" for k, i in enumerate(ids)],
                  frame_duration=corpus.frame_duration, dim=corpus.dim)


def _mixture_model(path, pooling):
    from speechrecognition_tpu.io import read_mixture_set
    from speechrecognition_tpu.models.gmm import MixtureModel

    return MixtureModel.from_raw(read_mixture_set(path, 25), pooling,
                                 max_approx=True)


def _recognizer(lex, pack, dtype, tdp, word_penalty, am_threshold):
    from speechrecognition_tpu.config import Configuration
    from speechrecognition_tpu.search.decoder import Recognizer
    from speechrecognition_tpu.tdp import TdpModel

    config = Configuration({"am-threshold": am_threshold,
                            "word-penalty": word_penalty,
                            "pruned-search": True,
                            "max-recognition-runs": 10 ** 9})
    tdp_model = TdpModel(silence_state=lex.silence_state, loop=tdp[0],
                         forward=tdp[1], skip=tdp[2])
    return Recognizer(config, lex, tdp_model, pack, dtype=dtype)


def _production_setup():
    from speechrecognition_tpu.models.gmm import VarianceModel

    with open(os.path.join(BENCH, "model.mix.json")) as f:
        meta = json.load(f)
    model = _mixture_model(os.path.join(BENCH, "model.mix"),
                           VarianceModel.from_string(meta["pooling"]))
    return model, meta


def _timed(fn, reps=3):
    """Median seconds of fn() (which blocks on its result) after one warm
    call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


# -- phases --------------------------------------------------------------------


def df32_exact(n=1 << 20, seed=0):
    """two_sum, fast_two_sum, split and two_prod on n seeded f32 pairs with
    exponents in [-30, 30], in one jitted program, checked bitwise against
    float64; DF add and mul within 2**-44 relative."""
    import jax
    import jax.numpy as jnp
    from speechrecognition_tpu.ops import doublefloat as dfm

    rng = np.random.default_rng(seed)

    def draw():
        m = rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)
        return np.ldexp(m, rng.integers(-30, 31, n)).astype(np.float32)

    def draw_df():
        x = draw().astype(np.float64) * (1.0 + rng.uniform(-1, 1, n) * 2.0 ** -25)
        hi = x.astype(np.float32)
        return hi, (x - hi).astype(np.float32)

    a, b = draw(), draw()
    xh, xl = draw_df()
    yh, yl = draw_df()

    @jax.jit
    def run(a, b, xh, xl, yh, yl):
        s, e = dfm.two_sum(a, b)
        a_big = jnp.abs(a) >= jnp.abs(b)
        big, small = jnp.where(a_big, a, b), jnp.where(a_big, b, a)
        fs, fe = dfm.fast_two_sum(big, small)
        hi, lo = dfm.split(a)
        p, pe = dfm.two_prod(a, b)
        ad = dfm.add(dfm.DF(xh, xl), dfm.DF(yh, yl))
        mu = dfm.mul(dfm.DF(xh, xl), dfm.DF(yh, yl))
        return s, e, big, small, fs, fe, hi, lo, p, pe, ad.hi, ad.lo, mu.hi, mu.lo

    out = [np.asarray(o) for o in jax.block_until_ready(
        run(*map(jnp.asarray, (a, b, xh, xl, yh, yl))))]
    s, e, big, small, fs, fe, hi, lo, p, pe, adh, adl, muh, mul = out
    f64 = lambda v: v.astype(np.float64)  # noqa: E731
    a64, b64 = f64(a), f64(b)
    # a + b is exact in float64 when the exponents differ by at most 28
    exp_gap = np.abs(np.frexp(a)[1] - np.frexp(b)[1])
    sum_exact = exp_gap <= 28

    def sum_mismatches(x, y, s, e):
        x64, y64, s64, e64 = f64(x), f64(y), f64(s), f64(e)
        bad = s != (x + y)                     # fl32(x + y), computed by numpy
        bad |= (s64 + e64) != (x64 + y64)
        bad |= sum_exact & (e64 != (x64 + y64) - s64)
        return int(bad.sum())

    # a Dekker split of a 24-bit significand: two halves of at most 12
    # significant bits that add up to a exactly
    bits = lambda v: v.view(np.uint32) & np.uint32(0xFFF)  # noqa: E731
    split_bad = (f64(hi) + f64(lo) != a64) | (bits(hi) != 0) | (bits(lo) != 0)
    prod = a64 * b64                           # exact: 48 significant bits
    prod_bad = (p != a * b) | (f64(p) + f64(pe) != prod) | (f64(pe) != prod - f64(p))
    mismatches = {
        "two_sum": sum_mismatches(a, b, s, e),
        "fast_two_sum": sum_mismatches(big, small, fs, fe),
        "split": int(split_bad.sum()),
        "two_prod": int(prod_bad.sum()),
    }
    x64, y64 = f64(xh) + f64(xl), f64(yh) + f64(yl)

    def rel_err(h, l, ref):
        return float(np.max(np.abs(f64(h) + f64(l) - ref) / np.abs(ref)))

    err = {"add": rel_err(adh, adl, x64 + y64), "mul": rel_err(muh, mul, x64 * y64)}
    _check(not any(mismatches.values()), f"error-free transforms: {mismatches}")
    _check(max(err.values()) <= 2.0 ** -44, f"DF add/mul error {err} > 2**-44")
    return {"pairs": n, "mismatches": mismatches,
            "max_rel_err_log2": {k: round(float(np.log2(v)), 2) if v else None
                                 for k, v in err.items()}}


def golden_demo():
    """Demo corpus, iter-2.mix, TDP 3-0-30, WP 80, threshold 200, df32:
    transcripts and WER/SER/S-I-D equal to the C++ oracle's."""
    from speechrecognition_tpu.models.gmm import VarianceModel

    lex = _lexicon()
    golden = _golden()
    c = golden["config"]
    corpus = _demo_corpus(lex)
    model = _mixture_model(os.path.join(FIXTURES, c["mix"]),
                           VarianceModel.MIXTURE_POOLING)
    rec = _recognizer(lex, model.pack_df(), "df32", c["tdp"],
                      c["word_penalty"], c["am_threshold"])
    res = rec.recognize_corpus(corpus, batch_size=corpus.num_segments)
    bad = [u["idx"] for u in golden["utts"] if res["hyps"][u["idx"]] != u["hyp"]]
    _check(not bad, f"transcripts differ from the oracle at {bad}")
    ref = golden["corpus"]
    got = {"wer": round(res["wer"], 6), "ser": round(res["ser"], 6),
           "sid": [res["substitutions"], res["insertions"], res["deletions"]]}
    _check(got == ref, f"corpus metrics {got} != oracle {ref}")
    return {"utterances": corpus.num_segments, **got}


_CLI_RESULT = re.compile(
    r"WER: ([0-9.]+)% \(S/I/D\) (\d+)/(\d+)/(\d+)\nSER: ([0-9.]+)%")


def _run_cli_recognize(config_path):
    from speechrecognition_tpu.cli import main as cli_main

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli_main([config_path, "recognize"])
    _check(rc == 0, f"cli exited {rc}: {err.getvalue()[-500:]}")
    m = _CLI_RESULT.search(err.getvalue())
    _check(m is not None, f"no WER/SER lines in: {err.getvalue()[-500:]}")
    return {"wer": m.group(1), "sid": "/".join(m.group(2, 3, 4)),
            "ser": m.group(5)}


def cli_recognize():
    """The `recognize` CLI action in-process on the default device and on
    the CPU device: the printed WER, SER and S/I/D must be equal."""
    import jax

    c = _golden()["config"]
    config = {
        "pooling": "mixture", "max-approx": True,
        "corpus": os.path.join(FIXTURES, "demo_corpus.json"),
        "feature-path": os.path.join(FIXTURES, "demo_features") + "/",
        "normalization-path": os.path.join(FIXTURES, "normalization-demo.bin"),
        "tdp-loop": c["tdp"][0], "tdp-forward": c["tdp"][1],
        "tdp-skip": c["tdp"][2],
        "load-mixtures-from": os.path.join(FIXTURES, c["mix"]),
        "feature-scorer": "gmm",
        "am-threshold": c["am_threshold"], "word-penalty": c["word_penalty"],
        "pruned-search": True,
    }
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "recognize.json")
        with open(path, "w") as f:
            json.dump(config, f)
        got = _run_cli_recognize(path)
        with jax.default_device(_cpu()):
            ref = _run_cli_recognize(path)
    _check(got == ref, f"device {got} != CPU {ref}")
    return got


def production_decode(n_segments=PRODUCTION_BATCH, batch_size=PRODUCTION_BATCH):
    """bench/model.mix (df32) on the demo utterances replicated to
    n_segments: every transcript equal to an f64 decode of the distinct
    utterances on the CPU device. Also times the batch and splits one
    time-chunk into acoustic scoring and the scan."""
    import jax
    import jax.numpy as jnp
    from speechrecognition_tpu.models.gmm import am_scores_df
    from speechrecognition_tpu.search.decoder import (DECODE_CHUNK,
                                                      _decode_scan_df,
                                                      df_scan_args)

    lex = _lexicon()
    demo = _demo_corpus(lex)
    corpus = _replicate(demo, n_segments)
    model, meta = _production_setup()
    setting = (meta["tdp"], meta["word_penalty"], meta["am_threshold"])

    packdf = model.pack_df()
    rec = _recognizer(lex, packdf, "df32", *setting)
    t0 = time.perf_counter()
    rec.warmup(corpus, batch_size=batch_size)
    compile_s = time.perf_counter() - t0
    res = rec.recognize_corpus(corpus, batch_size=batch_size)

    with jax.default_device(_cpu()):
        ref = _recognizer(lex, model.pack(dtype=jnp.float64), jnp.float64,
                          *setting).recognize_corpus(
                              demo, batch_size=demo.num_segments)["hyps"]
    bad = [s for s in range(n_segments)
           if res["hyps"][s] != ref[s % demo.num_segments]]
    _check(not bad, f"{len(bad)} of {n_segments} transcripts differ from "
                    f"the f64 CPU decode, first at {bad[:5]}")

    # one time-chunk of the batch, split into its two device programs
    B, C = batch_size, DECODE_CHUNK
    ids = [i % corpus.num_segments for i in range(B)]
    feats = rec._device_corpus.batch(ids, C).reshape(B * C, corpus.dim)
    am = am_scores_df(packdf, feats)
    am_hi, am_lo = (v.reshape(B, C, -1) for v in am)
    lens = jnp.asarray(np.minimum(corpus.lengths[ids], C), jnp.int32)
    args = df_scan_args(rec.tables, meta["am_threshold"])
    am_s = _timed(lambda: jax.block_until_ready(am_scores_df(packdf, feats)))
    scan_s = _timed(lambda: jax.block_until_ready(
        _decode_scan_df(am_hi, am_lo, lens, *args)))
    return {"segments": n_segments, "batch": batch_size,
            "distinct_transcripts_equal": demo.num_segments,
            "audio_s": res["audio_seconds"], "decode_s": res["time"],
            "warmup_compile_s": compile_s,
            "chunk_frames": C, "chunk_am_scoring_s": am_s,
            "chunk_scan_s": scan_s,
            "densities": int(packdf.mu.hi.shape[0])}


def em_train():
    """The df32 EM recipe of tests/test_em_df32.py on the demo corpus: the
    AM-score trajectory equal to the C++ trainer's within its %g
    rounding."""
    from speechrecognition_tpu.models.gmm import MixtureModel, VarianceModel
    from speechrecognition_tpu.tdp import TdpModel
    from speechrecognition_tpu.train.em import Trainer, TrainerConfig

    with open(os.path.join(FIXTURES, "em_demo_am_scores.json")) as f:
        oracle = json.load(f)
    want = {(i, j, k): s for i, j, k, s in oracle["trajectory"]}
    lex = _lexicon()
    corpus = _demo_corpus(lex)
    model = MixtureModel(dim=25, num_mixtures=lex.num_states,
                         var_model=VarianceModel.MIXTURE_POOLING,
                         max_approx=True)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = TrainerConfig(min_obs=1, num_splits=2, num_aligns=1,
                            num_estimates=3, pruning_threshold=120.0,
                            mixture_path=os.path.join(tmp, "iter-"),
                            alignment_path=os.path.join(tmp, "alignment-"))
        trainer = Trainer(cfg, lex, model,
                          TdpModel(silence_state=lex.silence_state,
                                   **oracle["tdp"]),
                          max_approx=True, dtype="df32", log=lambda *a: None)
        trainer.train(corpus)
    got = {}
    for line in trainer.stats_lines:
        i, j, k, s = line.split()
        got[(int(i), int(j), int(k))] = float(s)
    _check(set(got) == set(want), f"trajectory keys {sorted(got)}")
    worst = max(abs(got[k] - want[k]) for k in want)
    _check(worst < EM_SCORE_TOL, f"AM-score trajectory off by {worst}")
    return {"stats_lines": len(got), "max_abs_err": worst,
            "phase_s": {k: round(v, 3) for k, v in trainer.phase_seconds.items()}}


def _nn_scorer(lex):
    from speechrecognition_tpu.config import Configuration
    from speechrecognition_tpu.models.nn import (MLP, NNScorer,
                                                 layer_specs_from_config)

    with open(os.path.join(BENCH, "nn_run", "model.json")) as f:
        nnm = json.load(f)
    ctx = int(nnm["context_frames"])
    mlp = MLP(layer_specs_from_config(Configuration({"layers": nnm["layers"]})),
              input_dim=25 * (2 * ctx + 1))
    params = mlp.load(os.path.join(REPO, nnm["model_path"]))
    prior = NNScorer.load_prior(os.path.join(REPO, nnm["prior_file"]),
                                lex.num_states, float(nnm["prior_scale"]))
    return NNScorer(mlp, params, prior, ctx), nnm


def _nn_decode(lex, corpus):
    import jax.numpy as jnp

    scorer, nnm = _nn_scorer(lex)
    feats, _ = corpus.padded_batch(list(range(corpus.num_segments)))
    am = np.asarray(scorer.am_batch(feats, corpus.dim))
    rec = _recognizer(lex, None, jnp.float32, nnm["tdp"], nnm["word_penalty"],
                      nnm["am_threshold"])
    rec.nn_scorer = scorer
    res = rec.recognize_corpus(corpus, batch_size=corpus.num_segments)
    return am, res


def nn_hybrid():
    """bench/nn_run's MLP + prior on the demo utterances in f32: AM scores
    within NN_SCORE_TOL of the CPU device's and identical transcripts."""
    import jax

    lex = _lexicon()
    corpus = _demo_corpus(lex)
    am, res = _nn_decode(lex, corpus)
    with jax.default_device(_cpu()):
        am_ref, res_ref = _nn_decode(lex, corpus)
    err = float(np.max(np.abs(am - am_ref)))
    _check(err <= NN_SCORE_TOL, f"NN AM scores differ by {err} > {NN_SCORE_TOL}")
    _check(res["hyps"] == res_ref["hyps"], "NN transcripts differ from the CPU")
    return {"am_max_abs_diff": err, "am_max_abs": float(np.max(np.abs(am_ref))),
            "wer": res["wer"]}


def multi(n_devices=4, n_segments=PRODUCTION_BATCH):
    """Data-parallel df32 decode and E-step over a 1-D ("data",) mesh of
    n_devices, against the single-device Recognizer and accumulate_chunk."""
    import jax
    import jax.numpy as jnp
    from speechrecognition_tpu.models.gmm import accumulate_chunk
    from speechrecognition_tpu.parallel.mesh import (accumulate_sharded,
                                                     make_mesh,
                                                     recognize_corpus_sharded,
                                                     shard_batch)

    mesh = make_mesh(n_devices, ("data",))
    mesh_ids = sorted(d.id for d in mesh.devices.flat)
    _check(len(set(mesh_ids)) == n_devices, f"mesh devices {mesh_ids}")
    probe = shard_batch(mesh, np.zeros((n_devices * 2, 3), np.float32))
    shard_ids = sorted(s.device.id for s in probe.addressable_shards)
    _check(shard_ids == mesh_ids, f"batch shards on devices {shard_ids}")

    lex = _lexicon()
    demo = _demo_corpus(lex)
    corpus = _replicate(demo, n_segments)
    model, meta = _production_setup()
    packdf = model.pack_df()
    rec = _recognizer(lex, packdf, "df32", meta["tdp"], meta["word_penalty"],
                      meta["am_threshold"])
    single = rec.recognize_corpus(corpus, batch_size=n_segments)
    sharded = recognize_corpus_sharded(
        mesh, packdf, corpus, rec.tables, meta["am_threshold"],
        lex.silence_idx, batch_size=n_segments, dtype="df32")
    bad = [s for s in range(n_segments)
           if sharded["hyps"][s] != single["hyps"][s]]
    _check(not bad, f"{len(bad)} sharded transcripts differ, first {bad[:5]}")

    # f64 scores, so that a near-tie cannot flip a density choice between
    # the two matmul shapes
    pack = model.pack(dtype=jnp.float64)
    n = n_devices * 2048
    feats = corpus.features[:n]
    states = np.random.default_rng(0).integers(
        0, model.num_mixtures, n).astype(np.int32)
    mask = np.ones(n, np.float32)
    got = accumulate_sharded(mesh, pack, feats, states, mask, first_pass=False)
    want = [np.asarray(v) for v in accumulate_chunk(
        pack, jnp.asarray(feats), jnp.asarray(states), jnp.asarray(mask),
        False)]
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-9)
    return {"devices": mesh_ids, "segments": n_segments,
            "transcript_mismatches": len(bad),
            "single_s": single["time"], "sharded_s": sharded["time"],
            "estep_frames": n, "device_kinds": sorted(
                {d.device_kind for d in jax.devices()})}


PHASES = (df32_exact, golden_demo, cli_recognize, production_decode,
          em_train, nn_hybrid)


# -- driver --------------------------------------------------------------------


def card_line():
    """`nvidia-smi --query-gpu=name,power.limit` of every card, one per line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def run_phase(fn):
    t0 = time.perf_counter()
    try:
        info = fn()
    except Exception:
        print(f"phase {fn.__name__}: {time.perf_counter() - t0:.3f} s FAIL",
              flush=True)
        raise
    print(f"phase {fn.__name__}: {time.perf_counter() - t0:.3f} s pass "
          f"{json.dumps(info)}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded decode and E-step over 4 cards")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    from speechrecognition_tpu.compile_cache import enable_compile_cache
    from speechrecognition_tpu.native.loader import native_available

    cache = enable_compile_cache()
    loader = "native (g++)" if native_available() else "python"
    print(f"card: {card_line()}", flush=True)
    print(f"jax {jax.__version__}, {len(jax.devices())} x {dev.device_kind}, "
          f"compile cache {cache}, XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, "
          f"corpus loader {loader}", flush=True)
    if args.multi:
        _check(len(jax.devices()) >= 4, f"--multi needs 4 cards, "
                                        f"found {len(jax.devices())}")
        run_phase(multi)
        count = 4
    else:
        for fn in PHASES:
            run_phase(fn)
        count = len(jax.devices())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
