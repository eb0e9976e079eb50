"""Multi-device sharding: sharded decode/EM must equal single-device results."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from speechrecognition_tpu.io import read_mixture_set
from speechrecognition_tpu.models.gmm import MixtureModel, VarianceModel, accumulate_chunk
from speechrecognition_tpu.parallel.mesh import (accumulate_sharded, decode_sharded,
                                                 make_mesh)
from speechrecognition_tpu.search.decoder import DecoderTables, decode_batch
from speechrecognition_tpu.tdp import TdpModel


@pytest.fixture(scope="module")
def pack(fixtures_dir):
    raw = read_mixture_set(str(fixtures_dir / "iter-2.mix"), 25)
    model = MixtureModel.from_raw(raw, VarianceModel.MIXTURE_POOLING, max_approx=True)
    return model.pack(dtype=jnp.float32)


def test_eight_devices_available():
    assert len(jax.devices()) >= 8


def test_sharded_decode_matches_single(pack, lexicon, demo_corpus):
    tdp = TdpModel(silence_state=0, loop=3.0, forward=0.0, skip=30.0)
    tables = DecoderTables.build(lexicon, tdp, word_penalty=80.0)
    ids = list(range(8))
    feats, lens = demo_corpus.padded_batch(ids)
    mesh = make_mesh(8, ("data",))
    scores, words, bkps = decode_sharded(mesh, pack, feats, lens, tables,
                                         am_threshold=200.0)
    hyps_single = decode_batch(pack, feats, lens, tables, 200.0,
                               lexicon.silence_idx)
    # traceback from the sharded outputs must give identical hypotheses
    for b in range(len(ids)):
        t = int(lens[b])
        seq = []
        while t > 0:
            w = int(words[t - 1, b])
            if w != lexicon.silence_idx:
                seq.append(w)
            t = int(bkps[t - 1, b])
        seq.reverse()
        assert seq == hyps_single[b]


def test_sharded_accumulate_matches_single(pack, demo_corpus):
    n = 8 * 300
    feats = demo_corpus.features[:n]
    states = np.random.default_rng(0).integers(0, 106, n).astype(np.int32)
    mask = np.ones(n, np.float32)
    mesh = make_mesh(8, ("data",))
    w_s, xs_s, x2s_s = accumulate_sharded(mesh, pack, feats, states, mask,
                                          first_pass=False)
    w1, xs1, x2s1 = accumulate_chunk(pack, jnp.asarray(feats),
                                     jnp.asarray(states), jnp.asarray(mask),
                                     False)
    np.testing.assert_allclose(w_s, np.asarray(w1), rtol=0, atol=0)
    np.testing.assert_allclose(xs_s, np.asarray(xs1), rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(x2s_s, np.asarray(x2s1), rtol=1e-12, atol=1e-9)


def test_dryrun_multichip_entrypoints():
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "graft_entry",
        pathlib.Path(__file__).resolve().parents[1] / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    mod.dryrun_multichip(4)


def test_wcts_sharded_matches_single(pack, lexicon, demo_corpus):
    """Decode-graph sharding: tree copies (predecessor contexts) split over
    the model axis with pmin beam floors + all_gather word-end
    recombination must be bit-identical to the single-device WCTS scan."""
    from speechrecognition_tpu.parallel.mesh import wcts_sharded
    from speechrecognition_tpu.search.tree_decoder import TreeTables
    from speechrecognition_tpu.search.wcts import (_wcts_scan,
                                                   build_entry_tables,
                                                   extend_lm)
    from speechrecognition_tpu.models import gmm as gmm_mod

    tdp = TdpModel(silence_state=lexicon.silence_state,
                   loop=3.0, forward=0.0, skip=30.0)
    tables = TreeTables.build(lexicon, tdp, word_penalty=0.0)
    W = lexicon.num_words
    rng = np.random.default_rng(1)
    lm = rng.uniform(20.0, 120.0, (W, W))
    lm[:, lexicon.silence_idx] = 0.0
    lm_start = rng.uniform(20.0, 120.0, W)
    lm_start[lexicon.silence_idx] = 0.0

    ids = list(range(8))
    feats, lens = demo_corpus.padded_batch(ids)
    mesh = make_mesh(8, ("model",))
    books_s, bkps_s, preds_s = wcts_sharded(
        mesh, pack, feats, lens, tables, tdp, lm, lm_start,
        am_threshold=200.0, axis="model")

    lm_ext = extend_lm(lm, lm_start)
    entry_state, entry_pen = build_entry_tables(tables, tdp)
    B, T, dim = feats.shape
    am = gmm_mod.am_scores(pack, jnp.asarray(feats.reshape(B * T, dim)))
    am = am.reshape(B, T, -1).astype(jnp.float32)
    _c, (books1, bkps1, preds1, _off1) = _wcts_scan(
        am, jnp.asarray(lens, jnp.int32),
        jnp.asarray(tables.state), jnp.asarray(tables.parent),
        jnp.asarray(tables.grand), jnp.asarray(tables.tdp),
        jnp.asarray(tables.loop_allowed), jnp.asarray(entry_state),
        jnp.asarray(entry_pen), jnp.asarray(tables.end_node),
        jnp.asarray(lm_ext), jnp.zeros((lm_ext.shape[0], tables.num_nodes)),
        jnp.asarray(200.0, jnp.float32), prune=True, use_lookahead=False)

    np.testing.assert_array_equal(books_s, np.asarray(books1))
    np.testing.assert_array_equal(bkps_s, np.asarray(bkps1))
    np.testing.assert_array_equal(preds_s, np.asarray(preds1))


def test_recognize_corpus_sharded_matches_recognizer(pack, lexicon, demo_corpus):
    """The whole-corpus sharded driver (bench.py BENCH_MESH path) must give
    the single-path Recognizer's transcripts and WER on the demo corpus."""
    from speechrecognition_tpu.config import Configuration
    from speechrecognition_tpu.parallel.mesh import recognize_corpus_sharded
    from speechrecognition_tpu.search.decoder import Recognizer

    tdp = TdpModel(silence_state=0, loop=3.0, forward=0.0, skip=30.0)
    cfg = Configuration({"am-threshold": 200.0, "word-penalty": 80.0,
                         "pruned-search": True,
                         "max-recognition-runs": 10 ** 9})
    rec = Recognizer(cfg, lexicon, tdp, pack, dtype=jnp.float32)
    single = rec.recognize_corpus(demo_corpus, batch_size=8)

    mesh = make_mesh(8, ("data",))
    sharded = recognize_corpus_sharded(
        mesh, pack, demo_corpus, rec.tables, 200.0, lexicon.silence_idx,
        batch_size=8)
    assert sharded["hyps"] == single["hyps"]
    assert sharded["wer"] == single["wer"]
    assert sharded["ser"] == single["ser"]


def test_recognize_corpus_sharded_df32_matches_recognizer(fixtures_dir,
                                                          lexicon,
                                                          demo_corpus):
    """df32 sharded decode (the bench's production path under BENCH_MESH)
    must reproduce the single-chip df32 bit-parity transcripts on 8
    devices (VERDICT r2 #5)."""
    from speechrecognition_tpu.config import Configuration
    from speechrecognition_tpu.parallel.mesh import recognize_corpus_sharded
    from speechrecognition_tpu.search.decoder import Recognizer

    raw = read_mixture_set(str(fixtures_dir / "iter-2.mix"), 25)
    model = MixtureModel.from_raw(raw, VarianceModel.MIXTURE_POOLING,
                                  max_approx=True)
    packdf = model.pack_df()
    tdp = TdpModel(silence_state=0, loop=3.0, forward=0.0, skip=30.0)
    cfg = Configuration({"am-threshold": 200.0, "word-penalty": 80.0,
                         "pruned-search": True,
                         "max-recognition-runs": 10 ** 9})
    rec = Recognizer(cfg, lexicon, tdp, packdf, dtype="df32")
    single = rec.recognize_corpus(demo_corpus, batch_size=8)

    mesh = make_mesh(8, ("data",))
    sharded = recognize_corpus_sharded(
        mesh, packdf, demo_corpus, rec.tables, 200.0, lexicon.silence_idx,
        batch_size=8, dtype="df32")
    assert sharded["hyps"] == single["hyps"]
    assert sharded["wer"] == single["wer"]
    assert sharded["ser"] == single["ser"]
