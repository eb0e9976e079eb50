"""Multi-device scaling: data-parallel decode/EM over a device mesh.

The reference's only parallelism is an OpenMP loop over test segments
(src/sietill/Recognizer.cpp:46) and over MLP timesteps. The equivalents
here:

  * decode: utterance batches sharded over the mesh's ``data`` axis — the
    per-frame lattice scan runs independently per utterance, so this is
    pure data parallelism with no collectives until WER aggregation;
  * EM accumulation: per-shard sufficient statistics + ``psum`` over the
    mesh, reproducing the reference's sequential accumulators exactly
    (summation is associative in f64 up to reordering);
  * model (density) sharding for very large codebooks: the score matmul
    splits over the ``model`` axis and per-shard minima are combined with
    ``jax.lax.pmin`` — wired into ``accumulate_sharded`` when the packed
    density table exceeds a per-chip threshold.

Everything uses `jax.sharding.Mesh` + `jax.jit` with `NamedSharding` so
XLA inserts the collectives; no hand-written NCCL-style code.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(num_devices: Optional[int] = None,
              axis_names: Tuple[str, ...] = ("data",)) -> Mesh:
    """1-D data mesh by default; pass ("data", "model") with a factorable
    device count for 2-D density sharding."""
    devices = jax.devices()[: num_devices or len(jax.devices())]
    if len(axis_names) == 1:
        arr = np.asarray(devices)
    else:
        n = len(devices)
        model = 1
        while n % 2 == 0 and model < 4:
            model *= 2
            n //= 2
        arr = np.asarray(devices).reshape(-1, model)
    return Mesh(arr, axis_names)


def shard_batch(mesh: Mesh, x: np.ndarray, batch_axis: int = 0) -> jax.Array:
    """Place a host array with its batch dim sharded over the data axis."""
    spec = [None] * x.ndim
    spec[batch_axis] = "data"
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(*spec)))


def decode_sharded(mesh: Mesh, pack, feats: np.ndarray, feat_len: np.ndarray,
                   tables, am_threshold: float, prune: bool = True,
                   dtype=jnp.float32):
    """Data-parallel batched decode: [B, T, dim] with B sharded over the
    mesh. Returns (book_score, book_word, book_bkp), each [T, B] on host.

    B must be divisible by the data-axis size (pad with repeats).
    """
    from ..models import gmm as gmm_mod
    from ..search.decoder import _decode_scan

    B, T, dim = feats.shape
    n_data = mesh.shape["data"]
    if B % n_data:
        raise ValueError(f"batch {B} not divisible by data axis {n_data}")

    feats_d = shard_batch(mesh, feats)
    len_d = shard_batch(mesh, feat_len.astype(np.int32))

    @partial(jax.jit, static_argnames=())
    def run(feats_d, len_d):
        flat = feats_d.reshape(B * T, dim)
        am = gmm_mod.am_scores(pack, flat).reshape(B, T, pack.num_mixtures)
        _carry, outs = _decode_scan(
            am.astype(dtype), len_d,
            jnp.asarray(tables.state_table), jnp.asarray(tables.last_pos),
            jnp.asarray(tables.word_len), jnp.asarray(tables.first_state),
            jnp.asarray(tables.tdp_within), jnp.asarray(tables.entry_pen),
            jnp.asarray(am_threshold, dtype), prune=prune)
        return outs

    with mesh:
        scores, words, bkps = run(feats_d, len_d)
    return (np.asarray(scores), np.asarray(words), np.asarray(bkps))


@partial(jax.jit, static_argnames=("prune",))
def _sharded_decode_run(pack, feats_d, len_d, state_table, last_pos, word_len,
                        first_state, tdp_within, entry_pen, thr, prune=True):
    """Module-level jit so every batch of the same (B, T) bucket reuses one
    compiled executable (a closure-per-call jit would recompile per batch)."""
    from ..models import gmm as gmm_mod
    from ..search.decoder import _decode_scan

    B, T, dim = feats_d.shape
    flat = feats_d.reshape(B * T, dim)
    am = gmm_mod.am_scores(pack, flat).reshape(B, T, pack.num_mixtures)
    _carry, outs = _decode_scan(
        am.astype(thr.dtype), len_d, state_table, last_pos, word_len,
        first_state, tdp_within, entry_pen, thr, prune=prune)
    return outs


@partial(jax.jit, static_argnames=("prune",))
def _sharded_decode_run_df(packdf, feats_d, len_d, state_table, last_pos,
                           word_len, first_state, tdp_hi, tdp_lo, ent_hi,
                           ent_lo, thr, prune=True):
    """Double-float twin of `_sharded_decode_run`: the sharded corpus
    decode reproduces the single-chip df32 bit-parity path (per-utterance
    decisions are independent of the data sharding; tests/test_parallel.py
    asserts transcript equality against `decode_batch_df` on 8 devices)."""
    from ..models import gmm as gmm_mod
    from ..search.decoder import _decode_scan_df

    B, T, dim = feats_d.shape
    flat = feats_d.reshape(B * T, dim)
    am = gmm_mod.am_scores_df(packdf, flat)
    S = packdf.num_mixtures
    _carry, outs = _decode_scan_df(
        am.hi.reshape(B, T, S), am.lo.reshape(B, T, S), len_d,
        state_table, last_pos, word_len, first_state,
        tdp_hi, tdp_lo, ent_hi, ent_lo, thr, prune=prune)
    return outs


def recognize_corpus_sharded(mesh: Mesh, pack, corpus, tables,
                             am_threshold: float, silence_idx: int,
                             batch_size: int = 512, dtype=jnp.float32,
                             max_segments: Optional[int] = None,
                             buckets: Tuple[int, ...] = (320, 640, 960,
                                                         1280, 1600)) -> dict:
    """Whole-corpus decode with utterance batches sharded over the mesh's
    ``data`` axis — the multi-chip form of `Recognizer.recognize_corpus`
    (the reference's OpenMP segment loop, Recognizer.cpp:46-79). Returns
    the same WER/SER/RTF result dict.

    ``dtype="df32"`` (with ``pack`` a ScorePackDF) runs the double-float
    bit-parity path sharded: per-utterance results are independent, so
    sharding never changes a transcript (tests/test_parallel.py asserts
    equality against `decode_batch`/`decode_batch_df` on 8 devices)."""
    import time

    from ..search.edit_distance import EDAccumulator, edit_distance

    is_df = dtype == "df32"
    n = min(corpus.num_segments, max_segments or corpus.num_segments)
    n_data = mesh.shape["data"]
    if batch_size % n_data:
        batch_size += n_data - batch_size % n_data

    def bucket(length: int) -> int:
        for b in buckets:
            if length <= b:
                return b
        return -(-length // buckets[-1]) * buckets[-1]

    if is_df:
        from ..search.decoder import df_scan_args
        targs = df_scan_args(tables, am_threshold)
    else:
        targs = (jnp.asarray(tables.state_table), jnp.asarray(tables.last_pos),
                 jnp.asarray(tables.word_len), jnp.asarray(tables.first_state),
                 jnp.asarray(tables.tdp_within), jnp.asarray(tables.entry_pen),
                 jnp.asarray(am_threshold, dtype))
    hyps: dict = {}
    t0 = time.perf_counter()
    order = np.argsort(corpus.lengths[:n], kind="stable")
    for i in range(0, n, batch_size):
        ids = order[i: i + batch_size].tolist()
        n_real = len(ids)
        while len(ids) < batch_size:         # keep shapes static
            ids.append(ids[-1])
        T = bucket(max(corpus.seq_length(s) for s in ids))
        feats, lens = corpus.padded_batch(ids, pad_to=T)
        lens = np.asarray(lens).copy()
        lens[n_real:] = 0                    # mask duplicate tail slots
        feats_d = shard_batch(mesh, feats)
        len_d = shard_batch(mesh, lens.astype(np.int32))
        with mesh:
            if is_df:
                scores, words, bkps = _sharded_decode_run_df(
                    pack, feats_d, len_d, *targs)
            else:
                scores, words, bkps = _sharded_decode_run(
                    pack, feats_d, len_d, *targs)
        words = np.asarray(words)
        bkps = np.asarray(bkps)
        for b, s in enumerate(ids[:n_real]):
            t = int(lens[b])
            seq = []
            while t > 0:
                w = int(words[t - 1, b])
                if w != silence_idx:
                    seq.append(w)
                t = int(bkps[t - 1, b])
            seq.reverse()
            hyps[s] = seq
    elapsed = time.perf_counter() - t0

    acc = EDAccumulator()
    ref_total = 0
    sentence_errors = 0
    for s in range(n):
        ed = edit_distance(corpus.orths[s], hyps[s])
        acc += ed
        ref_total += len(corpus.orths[s])
        if ed.total_count > 0:
            sentence_errors += 1
    audio_seconds = float(corpus.lengths[:n].sum()) * corpus.frame_duration
    return {
        "wer": 100.0 * acc.total_count / ref_total,
        "ser": 100.0 * sentence_errors / n,
        "substitutions": acc.substitute_count,
        "insertions": acc.insert_count,
        "deletions": acc.delete_count,
        "time": elapsed,
        "rtf": elapsed / audio_seconds,
        "audio_seconds": audio_seconds,
        "hyps": hyps,
    }


def wcts_sharded(mesh: Mesh, pack, feats: np.ndarray, feat_len: np.ndarray,
                 tree_tables, tdp_model, lm_matrix: np.ndarray,
                 lm_start: np.ndarray, am_threshold: float,
                 prune: bool = True, dtype=jnp.float32,
                 axis: str = "model"):
    """Decode-graph sharding with collective beam exchange: the
    word-conditioned tree search's predecessor-context axis (C tree
    copies) is split over the mesh's model axis.  Each device advances
    its own tree copies; per frame the devices exchange

      * the global beam floor (renormalization + pruning base) via
        ``lax.pmin`` over the local (contexts × nodes) minima, and
      * word-end candidates via ``lax.all_gather`` of the per-device
        [B, W] book minima (+ traceback payloads), recombined by a
        replicated argmin — the reference's bigramRecombination as an
        ICI collective instead of a shared-memory array pass
        (Teaching/WordConditionedTreeSearch.cc:919-956, SURVEY §2.4).

    Semantics are identical to search/wcts._wcts_scan (same tie-breaking:
    device order == ascending context ids); returns (books, bkps, preds)
    as [T, B, W] host arrays.
    """
    from jax import shard_map
    from ..search.wcts import build_entry_tables, extend_lm
    from ..search.decoder import BIG
    from ..models import gmm as gmm_mod

    n_dev = mesh.shape[axis]
    B, T, dim = feats.shape
    lm_ext = extend_lm(lm_matrix, lm_start)           # [C, W]
    C, W = lm_ext.shape
    C_pad = -(-C // n_dev) * n_dev
    lm_pad = np.full((C_pad, W), float(BIG))
    lm_pad[:C] = lm_ext
    entry_state, entry_pen = build_entry_tables(tree_tables, tdp_model)

    N = tree_tables.num_nodes
    state = jnp.asarray(tree_tables.state)
    parent = jnp.asarray(tree_tables.parent)
    grand = jnp.asarray(tree_tables.grand)
    tdp = jnp.asarray(tree_tables.tdp).astype(dtype)
    loop_allowed = jnp.asarray(tree_tables.loop_allowed)
    end_node = jnp.asarray(tree_tables.end_node)
    entry_state_j = jnp.asarray(entry_state)
    entry_pen_j = jnp.asarray(entry_pen).astype(dtype)
    big = jnp.asarray(BIG, dtype)
    thr = jnp.asarray(am_threshold, dtype)
    n_local = C_pad // n_dev

    am_all = np.asarray(
        gmm_mod.am_scores(pack, jnp.asarray(feats.reshape(B * T, dim)))
    ).reshape(B, T, -1).astype(np.float64)

    def kernel(am, lens, lm_local):
        """Per-device body; lm_local [n_local, W]."""
        dev = jax.lax.axis_index(axis)
        ctx_ids = dev * n_local + jnp.arange(n_local)          # global ctx ids
        lm_loc = lm_local.astype(dtype)

        hyp0 = jnp.full((B, n_local, N), big, dtype)
        bkp0 = jnp.zeros((B, n_local, N), jnp.int32)
        book0 = jnp.full((B, W), big, dtype)

        def step(carry, inputs):
            hyp, bkp, book_prev = carry
            am_t, t = inputs

            # entry scores for the local contexts from the replicated book
            is_word = ctx_ids < W
            is_start = ctx_ids == W
            gathered = book_prev[:, jnp.clip(ctx_ids, 0, W - 1)]   # [B, n_local]
            start_val = jnp.where(t == 1, jnp.zeros((), dtype), big)
            ext = jnp.where(is_word[None, :], gathered,
                            jnp.where(is_start[None, :], start_val, big))

            loop = jnp.where(loop_allowed[None, None, :],
                             hyp + tdp[None, None, :, 0], big)
            fwd = hyp[:, :, parent] + tdp[None, None, :, 1]
            skip = hyp[:, :, grand] + tdp[None, None, :, 2]
            within = skip
            wbkp = bkp[:, :, grand]
            for c, b in ((fwd, bkp[:, :, parent]), (loop, bkp)):
                take = c < within
                within = jnp.where(take, c, within)
                wbkp = jnp.where(take, b, wbkp)
            within = within + am_t[:, None, state]

            entry = (ext[:, :, None] + entry_pen_j[None, None, :]
                     + am_t[:, None, entry_state_j])
            take_entry = entry <= within
            new = jnp.where(take_entry, entry, within)
            nbkp = jnp.where(take_entry, (t - 1).astype(jnp.int32), wbkp)
            new = new.at[:, :, 0].set(big)
            new = jnp.minimum(new, big)

            # collective beam floor: global per-(batch) min over all copies
            local_best = new.min(axis=(1, 2))                   # [B]
            best = jax.lax.pmin(local_best, axis)[:, None, None]
            best = jnp.where(best >= big * 0.5, 0.0, best)
            new = jnp.where(new >= big * 0.5, big, new - best)
            if prune:
                new = jnp.where(new > thr, big, new)

            # local word-end candidates + collective recombination
            ends = new[:, :, end_node]                          # [B, n_local, W]
            cand = jnp.where(ends >= big * 0.5, big,
                             ends + lm_loc[None, :, :])
            arg_l = jnp.argmin(cand, axis=1)                    # [B, W] local
            score_l = jnp.take_along_axis(cand, arg_l[:, None, :], axis=1)[:, 0]
            bkp_l = jnp.take_along_axis(nbkp[:, :, end_node],
                                        arg_l[:, None, :], axis=1)[:, 0]
            pred_l = ctx_ids[arg_l].astype(jnp.int32)

            g_score = jax.lax.all_gather(score_l, axis)         # [n, B, W]
            g_bkp = jax.lax.all_gather(bkp_l, axis)
            g_pred = jax.lax.all_gather(pred_l, axis)
            win = jnp.argmin(g_score, axis=0)                   # [B, W]
            book_new = jnp.take_along_axis(g_score, win[None], axis=0)[0]
            book_bkp = jnp.take_along_axis(g_bkp, win[None], axis=0)[0]
            book_pred = jnp.take_along_axis(g_pred, win[None], axis=0)[0]
            book_new = jnp.where(book_new >= big * 0.5, big, book_new)

            alive = (t <= lens)
            hyp_out = jnp.where(alive[:, None, None], new, hyp)
            bkp_out = jnp.where(alive[:, None, None], nbkp, bkp)
            book_out = jnp.where(alive[:, None], book_new, book_prev)
            return ((hyp_out, bkp_out, book_out),
                    (book_new, book_bkp, book_pred))

        _, outs = jax.lax.scan(step, (hyp0, bkp0, book0),
                               (jnp.moveaxis(am, 1, 0), jnp.arange(1, T + 1)))
        return outs

    sharded = shard_map(
        kernel, mesh=mesh,
        in_specs=(P(), P(), P(axis, None)),
        out_specs=(P(), P(), P()),
        check_vma=False)

    with mesh:
        books, bkps, preds = sharded(
            jnp.asarray(am_all).astype(dtype),
            jnp.asarray(feat_len, jnp.int32),
            jnp.asarray(lm_pad))
    return np.asarray(books), np.asarray(bkps), np.asarray(preds)


def accumulate_sharded(mesh: Mesh, pack, feats: np.ndarray, states: np.ndarray,
                       mask: np.ndarray, first_pass: bool):
    """Data-parallel E-step: frames sharded over the data axis; the
    segment-sum statistics are reduced across chips by XLA (the output is
    replicated, which forces an all-reduce == the reference's global
    accumulators)."""
    from ..models.gmm import accumulate_chunk

    feats_d = shard_batch(mesh, feats)
    states_d = shard_batch(mesh, states.astype(np.int32))
    mask_d = shard_batch(mesh, mask.astype(np.float32))

    out_sharding = NamedSharding(mesh, P())  # replicate → psum inserted by XLA

    @partial(jax.jit, out_shardings=(out_sharding, out_sharding, out_sharding))
    def run(f, s, m):
        return accumulate_chunk(pack, f, s, m, first_pass)

    with mesh:
        w, xs, x2s = run(feats_d, states_d, mask_d)
    return np.asarray(w), np.asarray(xs), np.asarray(x2s)
