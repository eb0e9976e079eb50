"""Benchmark: batched GMM decode throughput on the SieTill test corpus.

Prints ONE JSON line:
  {"metric": "decode_rtf_per_chip", "value": <rtf>, "unit": "rtf",
   "vs_baseline": <0.21 / rtf>}

Baseline: the reference C++ decoder at RTF 0.21 single-thread
(presentation.13-07-2016/main.tex:265). vs_baseline is the speedup factor
per chip. WER and throughput are reported on stderr for context.

The decode runs in double-float (two-f32 pairs, ops/doublefloat.py) —
pure f32 device arithmetic that reproduces the reference's
double-precision decisions: 1-best transcripts identical to the C++
decoder's (tools/full_parity.py --dtype df32 checks all 13117 test
utterances). BENCH_DTYPE=f32|f64 selects the other paths; plain f32
differs on ~0.5% of utterances.

Budget: the decode runs two device programs (per-chunk acoustic scoring
and the chunked decode scan; search/decoder.py), compiled on one dummy
batch, and the corpus loop stops early if the wall-clock budget
(BENCH_BUDGET, default 480s) would be crossed — the JSON metric line is
emitted in every case (RTF is throughput-defined, so partial coverage
measures the same quantity; the `coverage` field reports it).
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
REFERENCE = "/root/reference"
BASELINE_RTF = 0.21
T_START = time.perf_counter()


def log(*a):
    print(f"[bench {time.perf_counter() - T_START:7.1f}s]", *a,
          file=sys.stderr, flush=True)


def main():
    budget = float(os.environ.get("BENCH_BUDGET", "480"))
    import jax
    import jax.numpy as jnp
    from speechrecognition_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    from speechrecognition_tpu.config import Configuration
    from speechrecognition_tpu.corpus import Corpus, CorpusDescription
    from speechrecognition_tpu.features.frontend import SignalAnalysisConfig
    from speechrecognition_tpu.io import read_mixture_set
    from speechrecognition_tpu.lexicon import build_sietill_lexicon
    from speechrecognition_tpu.models.gmm import MixtureModel, VarianceModel
    from speechrecognition_tpu.search.decoder import Recognizer
    from speechrecognition_tpu.tdp import TdpModel

    log(f"devices: {jax.devices()}")
    lex = build_sietill_lexicon()

    model_path = os.path.join(REPO, "bench", "model.mix")
    test_corpus = os.path.join(REFERENCE, "src/sietill/corpora/corpus_test.json")
    feature_path = os.path.join(REFERENCE, "data/new_features/")
    norm_path = os.path.join(REFERENCE, "src/sietill/Normalization-eugen.bin")

    if os.path.exists(model_path) and os.path.exists(test_corpus):
        corpus_path, pooling = test_corpus, VarianceModel.NO_POOLING
        meta_path = model_path + ".json"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            pooling = VarianceModel.from_string(meta.get("pooling", "none"))
        else:
            meta = {}
    else:  # fallback: demo fixtures (self-contained)
        corpus_path = os.path.join(REPO, "tests/fixtures/demo_corpus.json")
        feature_path = os.path.join(REPO, "tests/fixtures/demo_features/")
        norm_path = os.path.join(REPO, "tests/fixtures/normalization-demo.bin")
        model_path = os.path.join(REPO, "tests/fixtures/iter-2.mix")
        pooling = VarianceModel.MIXTURE_POOLING
        meta = {"tdp": [3.0, 0.0, 30.0], "word_penalty": 80.0, "am_threshold": 200.0}

    desc = CorpusDescription.read(corpus_path, lex)
    corpus = Corpus.read(desc, feature_path, SignalAnalysisConfig(),
                         normalization_path=norm_path)
    log(f"corpus: {corpus.num_segments} segments, "
        f"{corpus.total_audio_seconds:.0f}s audio")

    raw = read_mixture_set(model_path, 25)
    model = MixtureModel.from_raw(raw, pooling, max_approx=True)
    bench_dtype = os.environ.get("BENCH_DTYPE", "df32")
    # 1024 amortizes the per-batch fixed costs (dispatch + traceback
    # fetch) once the corpus features are device-resident
    # (search/decoder.DeviceCorpus)
    batch_size = int(os.environ.get("BENCH_BATCH", "1024"))
    tdp_vals = meta.get("tdp", [3.0, 0.0, 30.0])
    tdp = TdpModel(silence_state=lex.silence_state, loop=tdp_vals[0],
                   forward=tdp_vals[1], skip=tdp_vals[2])
    config = Configuration({
        "am-threshold": meta.get("am_threshold", 200.0),
        "word-penalty": meta.get("word_penalty", 80.0),
        "pruned-search": True,
        "max-recognition-runs": 10 ** 9,
    })
    if bench_dtype == "df32":
        dtype, pack = "df32", model.pack_df()
    else:
        dtype = jnp.float64 if bench_dtype == "f64" else jnp.float32
        pack = model.pack(dtype=dtype)
    rec = Recognizer(config, lex, tdp, pack, dtype=dtype)
    log(f"model packed ({bench_dtype}); warming up (one dummy batch)")

    if os.environ.get("BENCH_MESH"):
        # multi-chip submission as a flag: shard utterance batches over
        # ALL local devices (parallel/mesh.py). df32 scores on this path
        # too — the sharded decode reproduces the single-chip transcripts.
        from speechrecognition_tpu.parallel.mesh import (
            make_mesh, recognize_corpus_sharded)
        mesh = make_mesh()
        log(f"sharded decode over {mesh.shape} mesh")
        res = recognize_corpus_sharded(
            mesh, pack if bench_dtype == "df32" else model.pack(
                dtype=jnp.float32),
            corpus, rec.tables,
            meta.get("am_threshold", 200.0), lex.silence_idx,
            batch_size=batch_size, dtype=dtype)
    else:
        t0 = time.perf_counter()
        rec.warmup(corpus, batch_size=batch_size)
        log(f"warmup/compile: {time.perf_counter() - t0:.1f}s")

        deadline = budget - (time.perf_counter() - T_START) - 20.0
        log(f"decode starts; deadline {deadline:.0f}s")
        res = rec.recognize_corpus(corpus, batch_size=batch_size,
                                   deadline_s=deadline, log=log)
    rtf = res["rtf"]
    cov = res.get("coverage", 1.0)
    log(f"coverage {100 * cov:.1f}% ({res.get('num_decoded', '?')} utts)")
    log(f"WER {res['wer']:.4f}%  SER {res['ser']:.4f}%  "
        f"S/I/D {res['substitutions']}/{res['insertions']}/{res['deletions']}")
    log(f"decode {res['time']:.2f}s for {res['audio_seconds']:.0f}s audio "
        f"→ {res['audio_seconds']/res['time']:.0f} audio-s/s, RTF {rtf:.6f} "
        f"(steady {res.get('rtf_steady', rtf):.6f})")
    # full-corpus WER fields are reserved for coverage == 1.0; a
    # deadline-truncated subset WER goes under *_partial so consumers
    # never compare it against the full-corpus baseline by accident
    if cov >= 1.0:
        wer_fields = {"wer": res["wer"]}
    else:
        wer_fields = {"wer": None, "wer_partial": res["wer"]}

    # scaling report (BASELINE.md: audio-s/s per chip at 1 chip / 1 host /
    # N hosts). On a one-device host the first two rows coincide; the
    # N-host path is exercised by tests/test_multihost.py (2 processes).
    n_local = len(jax.local_devices())
    n_hosts = jax.process_count()
    rows = [{"row": "1 chip", "chips": 1,
             "audio_s_per_s_per_chip": res["audio_seconds"] / res["time"]}]
    rows.append({"row": "1 host", "chips": n_local,
                 "audio_s_per_s_per_chip":
                     res["audio_seconds"] / res["time"] / n_local})
    if n_hosts > 1:
        rows.append({"row": f"{n_hosts} hosts", "chips": n_local * n_hosts,
                     "audio_s_per_s_per_chip":
                         res["audio_seconds"] / res["time"] / n_local})
    for r in rows:
        log(f"scaling: {r['row']:>8s}  "
            f"{r['audio_s_per_s_per_chip']:.0f} audio-s/s per chip")

    # real N=2-host row: two localhost processes over jax.distributed
    # (coordinator + per-host stripes + cross-process allgather),
    # golden-WER equality checked — BASELINE.md's "N hosts" reporting;
    # the multi-process machinery is what this row certifies. Bounded;
    # skipped without failing the bench if the budget ran out.
    remaining_mh = budget - (time.perf_counter() - T_START)
    if remaining_mh > 90 and not os.environ.get("BENCH_MESH"):
        mh = _bench_multihost_row(log)
        if mh is not None:
            rows.append(mh)

    # NN-hybrid decode row (reference: RTF 0.31, WER 25.34%, main.tex:266)
    nn_meta = {}
    nn_meta_path = os.path.join(REPO, "bench", "nn_run", "model.json")
    remaining = budget - (time.perf_counter() - T_START)
    if (os.path.exists(nn_meta_path) and not os.environ.get("BENCH_MESH")
            and remaining > 150):
        import numpy as _np
        from speechrecognition_tpu.models.nn import (MLP, NNScorer,
                                                     layer_specs_from_config)
        with open(nn_meta_path) as f:
            nnm = json.load(f)
        nn_cfg = Configuration({"layers": nnm["layers"]})
        ctx = int(nnm.get("context_frames", 2))
        mlp = MLP(layer_specs_from_config(nn_cfg), input_dim=25 * (2 * ctx + 1))
        params = mlp.load(os.path.join(REPO, nnm["model_path"]))
        prior = NNScorer.load_prior(os.path.join(REPO, nnm["prior_file"]),
                                    lex.num_states,
                                    float(nnm.get("prior_scale", 1.2)))
        nn_tdp_vals = nnm.get("tdp", [4.0, 0.0, 30.0])
        nn_tdp = TdpModel(silence_state=lex.silence_state,
                          loop=nn_tdp_vals[0], forward=nn_tdp_vals[1],
                          skip=nn_tdp_vals[2])
        nn_config = Configuration({
            "am-threshold": nnm.get("am_threshold", 200.0),
            "word-penalty": nnm.get("word_penalty", 105.0),
            "pruned-search": True, "max-recognition-runs": 10 ** 9})
        rec_nn = Recognizer(nn_config, lex, nn_tdp,
                            model.pack(dtype=jnp.float32),
                            dtype=jnp.float32)
        rec_nn.nn_scorer = NNScorer(mlp, params, prior, ctx)
        log("NN-hybrid decode row")
        nn_deadline = budget - (time.perf_counter() - T_START) - 15.0
        res_nn = rec_nn.recognize_corpus(corpus, batch_size=batch_size,
                                         deadline_s=nn_deadline, log=log)
        nn_meta = {"nn_rtf": res_nn["rtf"],
                   "nn_rtf_steady": res_nn.get("rtf_steady"),
                   "nn_vs_baseline": 0.31 / res_nn["rtf"],
                   "nn_coverage": res_nn["coverage"]}
        if res_nn["coverage"] >= 1.0:
            nn_meta["nn_wer"] = res_nn["wer"]
        else:
            nn_meta["nn_wer"] = None
            nn_meta["nn_wer_partial"] = res_nn["wer"]
        log(f"NN: WER {res_nn['wer']:.4f}%  RTF {res_nn['rtf']:.6f} "
            f"({0.31 / res_nn['rtf']:.0f}x the 0.31 reference), "
            f"coverage {100 * res_nn['coverage']:.1f}%")

    train_meta = {}
    if os.environ.get("BENCH_TRAIN"):
        train_meta.update(_bench_train_slice(log, budget))
    if os.environ.get("BENCH_AN4"):
        train_meta.update(_bench_an4(log))

    roofline = None
    if budget - (time.perf_counter() - T_START) > 30 \
            and not os.environ.get("BENCH_MESH"):
        try:
            roofline = _bench_roofline(log, model, lex, rec.tables)
        except Exception as e:          # never fail the metric line
            log(f"roofline: skipped ({e})")

    print(json.dumps({
        "metric": "decode_rtf_per_chip",
        "value": rtf,
        "unit": "rtf",
        "vs_baseline": BASELINE_RTF / rtf,
        "rtf_steady": res.get("rtf_steady"),
        "dtype": bench_dtype,
        "coverage": cov,
        "scaling": rows,
        "roofline": roofline,
        **wer_fields,
        **nn_meta,
        **train_meta,
    }))


def _bench_roofline(log, model, lex, tables):
    """Attribute the decode phases to the hardware: achieved FLOP/s of
    the AM scoring matmul and effective bytes/s of the decode scan, so
    regressions in either phase are visible.

    Numbers are measured on one synthetic (B=512, T=320) batch; FLOP
    and byte counts are analytic (matmul 2·N·K·J; scan ≈ 25 passes over
    the [B, W, P] state per frame)."""
    import time as _time

    import jax
    import jax.numpy as jnp

    from speechrecognition_tpu.models import gmm as gmm_mod
    from speechrecognition_tpu.search import decoder as D

    B, T = 512, 320
    dim = model.dim
    rng = np.random.RandomState(0)
    feats = jnp.asarray(rng.randn(B * T, dim).astype(np.float32))

    pack32 = model.pack(dtype=jnp.float32)
    J = int(pack32.P.shape[1])
    K = int(pack32.P.shape[0])            # 2·dim+1
    r = gmm_mod.am_scores(pack32, feats)
    r.block_until_ready()
    t0 = _time.perf_counter()
    for _ in range(3):
        r = gmm_mod.am_scores(pack32, feats)
        r.block_until_ready()
    t_am = (_time.perf_counter() - t0) / 3
    am_flops = 2.0 * (B * T) * K * J
    am_flops_per_s = am_flops / t_am

    am = r.reshape(B, T, pack32.num_mixtures)
    args = (jnp.asarray(np.full(B, T, np.int32)),
            jnp.asarray(tables.state_table), jnp.asarray(tables.last_pos),
            jnp.asarray(tables.word_len), jnp.asarray(tables.first_state),
            jnp.asarray(tables.tdp_within), jnp.asarray(tables.entry_pen),
            jnp.asarray(200.0, jnp.float32))
    scan = jax.jit(D._decode_scan)
    out = scan(am, *args)
    jax.block_until_ready(out[1][0])
    t0 = _time.perf_counter()
    for _ in range(3):
        out = scan(am, *args)
        jax.block_until_ready(out[1][0])
    t_scan = (_time.perf_counter() - t0) / 3
    W, P = tables.state_table.shape
    scan_bytes = 25.0 * 2 * 4 * B * W * P * T      # ~25 rw passes/frame
    scan_bytes_per_s = scan_bytes / max(t_scan, 1e-9)
    roofline = {
        "am_matmul_flops_per_s": am_flops_per_s,
        "am_matmul_seconds_per_chunk": t_am,
        "scan_effective_bytes_per_s": scan_bytes_per_s,
        "scan_seconds_per_chunk": t_scan,
    }
    log(f"roofline: AM matmul {am_flops_per_s/1e12:.3f} TFLOP/s, "
        f"scan {scan_bytes_per_s/1e9:.1f} GB/s effective")
    return roofline


def _bench_multihost_row(log):
    """Spawn two localhost processes through jax.distributed (the same
    coordinator/stripe/allgather path a multi-host run uses) scoring
    golden-striped hypotheses; returns the N=2-hosts scaling row with
    the golden-WER equality verdict, or None on any failure."""
    import socket
    import subprocess
    import sys as _sys

    golden_path = os.path.join(REPO, "tests/fixtures/demo_recognition.json")
    if not os.path.exists(golden_path):
        return None
    with open(golden_path) as f:
        golden_wer = json.load(f)["corpus"]["wer"]
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port_no = sock.getsockname()[1]
    sock.close()
    out = os.path.join(REPO, "bench", "multihost_row.json")
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({
            "JAX_PLATFORMS": "cpu",
            "SPEECH_TPU_NUM_CPU_DEVICES": "2",
            "SPEECH_TPU_COORDINATOR": f"localhost:{port_no}",
            "SPEECH_TPU_NUM_PROCS": "2",
            "SPEECH_TPU_PROC_ID": str(pid),
        })
        procs.append(subprocess.Popen(
            [_sys.executable, "-m",
             "speechrecognition_tpu.parallel.multihost",
             "--out", out, "--fixtures",
             os.path.join(REPO, "tests/fixtures"),
             "--golden-hyps", golden_path],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    try:
        outs = [p.communicate(timeout=150) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        log("multihost row: timed out (skipped)")
        return None
    for p, (_so, se) in zip(procs, outs):
        if p.returncode != 0:
            log(f"multihost row: worker failed (skipped): "
                f"{se.decode()[-300:]}")
            return None
    with open(out) as f:
        mh = json.load(f)
    equal = abs(mh["wer"] - golden_wer) < 1e-6
    log(f"scaling:  2 hosts  localhost jax.distributed collectives, "
        f"WER {mh['wer']:.4f}% (golden equality: {equal})")
    return {"row": "2 hosts (localhost)", "hosts": 2,
            "devices": mh.get("devices"), "wer": mh["wer"],
            "golden_wer_equal": bool(equal),
            "mode": "jax.distributed collectives over striped golden "
                    "hypotheses (no decode)"}


def _bench_train_slice(log, budget):
    """Bounded live re-measurement of EM training (BENCH_TRAIN=1): the
    full recipe's split-0 phase (linear segmentation + first accumulate +
    2 realigns with one estimate each — num-aligns=2 as in the full
    recipe; split 0 caps num-estimates at 1) over the full
    13,036-utterance train corpus, df32."""
    import time as _time
    from speechrecognition_tpu.corpus import Corpus, CorpusDescription
    from speechrecognition_tpu.features.frontend import SignalAnalysisConfig
    from speechrecognition_tpu.lexicon import build_sietill_lexicon
    from speechrecognition_tpu.models.gmm import MixtureModel, VarianceModel
    from speechrecognition_tpu.tdp import TdpModel
    from speechrecognition_tpu.train.em import Trainer, TrainerConfig

    lex = build_sietill_lexicon()
    train_corpus = os.path.join(REFERENCE,
                                "src/sietill/corpora/corpus_train.json")
    if not os.path.exists(train_corpus):
        return {}
    desc = CorpusDescription.read(train_corpus, lex)
    corpus = Corpus.read(
        desc, os.path.join(REFERENCE, "data/new_features/"),
        SignalAnalysisConfig(),
        normalization_path=os.path.join(
            REFERENCE, "src/sietill/Normalization-eugen.bin"))
    model = MixtureModel(dim=25, num_mixtures=lex.num_states,
                         var_model=VarianceModel.NO_POOLING, max_approx=True)
    tdp = TdpModel(silence_state=lex.silence_state, loop=20.0, forward=0.0,
                   skip=20.0)
    cfg = TrainerConfig(min_obs=1, num_splits=0, num_aligns=2,
                        num_estimates=10, pruning_threshold=200.0,
                        segmentation_variant="running-sums")
    trainer = Trainer(cfg, lex, model, tdp, max_approx=True, dtype="df32",
                      log=lambda *a: None)
    log("BENCH_TRAIN: measuring split-0 EM on the full train corpus (df32)")
    t0 = _time.perf_counter()
    trainer.train(corpus)
    dt = _time.perf_counter() - t0
    log(f"BENCH_TRAIN: split-0 took {dt:.1f}s "
        f"(phases: {trainer.phase_seconds})")
    return {"train_split0_s": dt, "train_split0_source": "measured"}


def _bench_an4(log):
    """Live AN4 LVCSR system row (BENCH_AN4=1): the full 130-utterance
    test corpus through Flow features + CART tying + config TDPs + ARPA
    LM + WCTS + lookahead at the tuned operating point, with the
    committed self-trained model (bench/an4/; RESULTS.md records the
    full operating-point table)."""
    import sys

    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import an4_system as A
        from speechrecognition_tpu.io import read_mixture_set
        from speechrecognition_tpu.models.gmm import (MixtureModel,
                                                      VarianceModel)
        am_path = os.path.join(REPO, "bench", "an4", "am.mix")
        if not os.path.exists(am_path):
            return {}
        (_cfg, corpus_xml, asm, lex, tm, net, ap_thr, _s) = A.build_system()
        corpus, word_seqs = A.load_corpus(corpus_xml, lex, net)
        model = MixtureModel.from_raw(
            read_mixture_set(am_path, corpus.dim),
            VarianceModel.GLOBAL_POOLING, max_approx=True)
        lm, lm_start = A.build_lm_matrices(lex, tm, 6.0, 30.0, 10.0)
        r = A.decode(model, corpus, word_seqs, lex, tm, lm, lm_start,
                     ap_thr, True, True, "f32")
        log(f"AN4: WER {r['wer']:.2f}% SER {r['ser']:.2f}% "
            f"RTF {r['rtf']:.5f}")
        return {"an4_wer": r["wer"], "an4_ser": r["ser"],
                "an4_rtf": r["rtf"]}
    except Exception as e:  # the AN4 row must not sink the main metric
        log(f"AN4 row failed: {e!r}")
        return {}


if __name__ == "__main__":
    main()
