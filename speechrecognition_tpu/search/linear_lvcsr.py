"""Fast LVCSR decode: linear-lexicon time-synchronous Viterbi with
bigram recombination and per-predecessor transparent-silence copies.

JAX counterpart of the reference's COMPLETE teaching decoder
(rwth-asr-0.5/src/Teaching/LinearSearch.cc:211-436: time-sync Viterbi
over a linear word lexicon, bigram recombination at boundaries, beam
pruning, and SILENCE COPIES PER WORD so the LM history passes through
silence), with Sprint per-state-type transition semantics
(sprint/am.TransitionModel.decoder_tables — source-state TDPs, entry-m1
entries, per-type exit TDPs).

Why this exists next to search/wcts.py: the word-conditioned tree
search carries a [B, C, N] per-predecessor tree-copy tensor whose
per-step parent/grand GATHERS dominated decode time on the accelerator
this was first written for (the cost ratio on a GPU is not measured). For the 1-BEST result the tree copies are unnecessary:
applying the bigram score at word ENTRY via a min-plus product over the
word-end books is exact — the only context that must stay materialized
is the silence word's predecessor, kept as dense per-predecessor
silence copies exactly like the reference's LinearSearch. The state
shrinks from [B, C, N] (20 M slots at AN4 sizes) to
[B, W, P] + [B, W+1, Ps] (~0.6 M), and every per-step op is an
elementwise shift — no gathers.

Cost convention: the word-entry matrix `lm_ext[v, w]` carries
EVERYTHING charged at the v→w boundary (LM score and, as
tools/an4_system.build_lm_matrices does, word w's exit TDP); silence
boundaries charge only `sil_exit`. This matches decode_batch_wcts's
lm_ext contract, so the two engines consume identical matrices.

Exactness: with pruning off this produces the same 1-best transcripts
as the exact WCTS decode (A/B-tested on the full AN4 corpus); with
beam pruning the threshold acts on a different (smaller) active set,
so pruned operating points are near- but not bit-identical between the
engines — the same relationship the reference's LinearSearch and
WordConditionedTreeSearch have to each other.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..models import gmm as gmm_mod
from .decoder import BIG, DecoderTables


@partial(jax.jit, static_argnames=("prune",))
def _decode_scan_linear_ts(am: jnp.ndarray, feat_len: jnp.ndarray,
                           state_table: jnp.ndarray, last_pos: jnp.ndarray,
                           word_len: jnp.ndarray,
                           tdp_within: jnp.ndarray, entry_pen: jnp.ndarray,
                           sil_states: jnp.ndarray, sil_tdp: jnp.ndarray,
                           sil_entry_pen: jnp.ndarray,
                           sil_exit: jnp.ndarray,
                           lm_ext: jnp.ndarray,
                           am_threshold: jnp.ndarray, prune: bool = True):
    """am [B, T, S]. Real-word tables are [W, P] (silence EXCLUDED from
    the word axis); silence tables: sil_states [Ps] tied classes,
    sil_tdp [Ps, 3], sil_entry_pen [2], sil_exit scalar (charged at the
    silence end). lm_ext [W+1, W] = boundary cost v→w, last row the
    sentence start.

    Per-frame outputs: book [T,B,W] (renormalized; word w ended at this
    frame, boundary+LM costs included), bkp [T,B,W] (entry boundary),
    pred [T,B,W] (chosen predecessor, W = sentence start), via [T,B,W]
    (that predecessor's book was reached through a trailing silence),
    origin [T,B,W+1] (per silence copy: frame its predecessor's real
    word ended), silend [T,B,W+1] (silence copy end scores incl. exit),
    silorg [T,B,W+1] (this frame's origin), offset [T,B].
    """
    B, T, S = am.shape
    dtype = am.dtype
    W, P = state_table.shape
    V = W + 1                                   # predecessors + start
    Ps = sil_states.shape[0]
    big = jnp.asarray(BIG, dtype)
    tdpw = tdp_within.astype(dtype)             # [W, P, 3]
    entp = entry_pen.astype(dtype)              # [W, 2]
    stdp = sil_tdp.astype(dtype)                # [Ps, 3]
    sentp = sil_entry_pen.astype(dtype)         # [2]
    sexit = sil_exit.astype(dtype)
    lm_ext = lm_ext.astype(dtype)               # [V, W]
    slot_valid = jnp.arange(P)[None, :] < word_len[:, None]
    entry_states = state_table[:, :2]           # [W, 2]
    sil_entry_states = sil_states[:min(2, Ps)]

    hyp0 = jnp.full((B, W, P), big, dtype)
    bkp0 = jnp.zeros((B, W, P), jnp.int32)
    pred0 = jnp.full((B, W, P), W, jnp.int32)
    shyp0 = jnp.full((B, V, Ps), big, dtype)
    sorg0 = jnp.zeros((B, V, Ps), jnp.int32)
    book0 = jnp.full((B, W), big, dtype)
    silend0 = jnp.full((B, V), big, dtype)
    silorg0 = jnp.zeros((B, V), jnp.int32)

    inf_col = jnp.full((B, W, 1), big, dtype)
    sinf_col = jnp.full((B, V, 1), big, dtype)

    def step(carry, inputs):
        (hyp, bkp, pred, shyp, sorg, book_prev, silend_prev,
         silorg_prev) = carry
        am_t, t = inputs

        # -- real-word within-word 0-1-2 recursion ------------------------
        ams = am_t[:, state_table]                       # [B, W, P]
        c0 = hyp + tdpw[None, :, :, 0]
        c1 = jnp.concatenate([inf_col, hyp[:, :, :-1] + tdpw[None, :, 1:, 1]],
                             axis=2)
        c2 = jnp.concatenate([inf_col, inf_col,
                              hyp[:, :, :-2] + tdpw[None, :, 2:, 2]], axis=2)
        b0 = jnp.concatenate([bkp0[:, :, :1], bkp[:, :, :-1]], axis=2)
        b00 = jnp.concatenate([bkp0[:, :, :2], bkp[:, :, :-2]], axis=2)
        p0 = jnp.concatenate([pred0[:, :, :1], pred[:, :, :-1]], axis=2)
        p00 = jnp.concatenate([pred0[:, :, :2], pred[:, :, :-2]], axis=2)
        within, wbkp, wpred = c2, b00, p00
        for c, b, p in ((c1, b0, p0), (c0, bkp, pred)):
            take = c < within
            within = jnp.where(take, c, within)
            wbkp = jnp.where(take, b, wbkp)
            wpred = jnp.where(take, p, wpred)
        within = within + ams

        # -- effective predecessor books (word end OR its trailing
        #    silence; the start context opens at the first frame) --------
        start_col = jnp.where(t == 1, jnp.zeros((B, 1), dtype),
                              jnp.full((B, 1), big, dtype))
        ebook = jnp.concatenate([book_prev, start_col], axis=1)   # [B, V]
        via_prev = silend_prev < ebook
        ebook = jnp.minimum(ebook, silend_prev)
        # when the book wins, the predecessor's real end is this very
        # frame boundary; when its silence wins, it is the silence
        # copy's carried origin
        origin_prev = jnp.where(via_prev, silorg_prev,
                                (t - 1).astype(jnp.int32)[None, None]
                                .repeat(B, 0).repeat(V, 1))

        # -- bigram recombination (min-plus over predecessors) ------------
        cand = ebook[:, :, None] + lm_ext[None, :, :]    # [B, V, W]
        entry_base = cand.min(axis=1)                    # [B, W]
        entry_pred = jnp.argmin(cand, axis=1).astype(jnp.int32)

        am_entry = am_t[:, entry_states]                 # [B, W, 2]
        entry = (entry_base[:, :, None] + entp[None, :, :] + am_entry)
        entry = jnp.concatenate(
            [entry, jnp.full((B, W, P - 2), big, dtype)], axis=2)
        entry_pred3 = jnp.concatenate(
            [entry_pred[:, :, None].repeat(2, 2),
             jnp.full((B, W, P - 2), W, jnp.int32)], axis=2)

        take_entry = entry <= within
        new = jnp.where(take_entry, entry, within)
        nbkp = jnp.where(take_entry, (t - 1).astype(jnp.int32), wbkp)
        npred = jnp.where(take_entry, entry_pred3, wpred)
        new = jnp.where(slot_valid[None, :, :], new, big)
        new = jnp.minimum(new, big)

        # -- silence copies (per predecessor, LM-transparent) -------------
        sams = am_t[:, sil_states][:, None, :]           # [B, 1, Ps]
        s0 = shyp + stdp[None, None, :, 0]
        s1 = jnp.concatenate([sinf_col, shyp[:, :, :-1]
                              + stdp[None, None, 1:, 1]], axis=2)[:, :, :Ps]
        s2 = jnp.concatenate([sinf_col, sinf_col, shyp[:, :, :-2]
                              + stdp[None, None, 2:, 2]], axis=2)[:, :, :Ps]
        so0 = jnp.concatenate([sorg0[:, :, :1], sorg[:, :, :-1]],
                              axis=2)[:, :, :Ps]
        so00 = jnp.concatenate([sorg0[:, :, :2], sorg[:, :, :-2]],
                               axis=2)[:, :, :Ps]
        swithin, sworg = s2, so00
        for c, o in ((s1, so0), (s0, sorg)):
            take = c < swithin
            swithin = jnp.where(take, c, swithin)
            sworg = jnp.where(take, o, sworg)
        swithin = swithin + sams

        # silence entry per copy v from v's effective book (silence may
        # chain after silence, like the WCTS's re-opened contexts)
        sam_entry = am_t[:, sil_entry_states][:, None, :]  # [B, 1, ≤2]
        sentry = (ebook[:, :, None] + sentp[None, None, :len(
            sil_entry_states)] + sam_entry)
        if Ps > sentry.shape[2]:
            sentry = jnp.concatenate(
                [sentry, jnp.full((B, V, Ps - sentry.shape[2]), big,
                                  dtype)], axis=2)
        sorigin3 = origin_prev[:, :, None].repeat(Ps, 2)
        stake = sentry <= swithin
        snew = jnp.where(stake, sentry, swithin)
        snorg = jnp.where(stake, sorigin3, sworg)
        snew = jnp.minimum(snew, big)

        # -- renormalize + prune over the JOINT hypothesis set ------------
        best = jnp.minimum(new.min(axis=(1, 2)), snew.min(axis=(1, 2)))
        best = jnp.where(best >= big * 0.5, 0.0, best)[:, None, None]
        new = jnp.where(new >= big * 0.5, big, new - best)
        snew = jnp.where(snew >= big * 0.5, big, snew - best)
        if prune:
            new = jnp.where(new > am_threshold, big, new)
            snew = jnp.where(snew > am_threshold, big, snew)

        # -- bookkeeping: boundary costs live in lm_ext (already charged
        #    at entry); silence ends charge their exit here -------------
        li = last_pos[None, :, None].astype(jnp.int32)
        ends = jnp.take_along_axis(new, li, axis=2)[:, :, 0]
        book_new = jnp.where(ends >= big * 0.5, big, ends)
        book_bkp = jnp.take_along_axis(nbkp, li, axis=2)[:, :, 0]
        book_pred = jnp.take_along_axis(npred, li, axis=2)[:, :, 0]

        sil_ends = snew[:, :, Ps - 1]
        silend_new = jnp.where(sil_ends >= big * 0.5, big,
                               sil_ends + sexit)
        silorg_new = snorg[:, :, Ps - 1]

        alive = (t <= feat_len)
        a3 = alive[:, None, None]
        a2 = alive[:, None]
        hyp_out = jnp.where(a3, new, hyp)
        bkp_out = jnp.where(a3, nbkp, bkp)
        pred_out = jnp.where(a3, npred, pred)
        shyp_out = jnp.where(a3, snew, shyp)
        sorg_out = jnp.where(a3, snorg, sorg)
        book_out = jnp.where(a2, book_new, book_prev)
        silend_out = jnp.where(a2, silend_new, silend_prev)
        silorg_out = jnp.where(a2, silorg_new, silorg_prev)
        offset = jnp.where(alive, best[:, 0, 0], 0.0)

        # via/origin for the CHOSEN predecessor of each word entered at
        # this frame (consumers index these by book_pred)
        via_taken = jnp.take_along_axis(
            jnp.concatenate([via_prev, jnp.zeros((B, 0), bool)], axis=1),
            book_pred, axis=1)
        return ((hyp_out, bkp_out, pred_out, shyp_out, sorg_out,
                 book_out, silend_out, silorg_out),
                (book_new, book_bkp, book_pred, via_taken, origin_prev,
                 silend_new, silorg_new, offset))

    init = (hyp0, bkp0, pred0, shyp0, sorg0, book0, silend0, silorg0)
    _carry, outs = jax.lax.scan(
        step, init, (jnp.moveaxis(am, 1, 0), jnp.arange(1, T + 1)))
    return outs


def decode_batch_linear_lvcsr(pack, feats: np.ndarray,
                              feat_len: np.ndarray,
                              tables: DecoderTables,
                              lm_matrix: np.ndarray, lm_start: np.ndarray,
                              am_threshold: float, silence_idx: int,
                              prune: bool = True,
                              am: Optional[jnp.ndarray] = None,
                              dtype=jnp.float32) -> List[List[int]]:
    """Decode → word sequences (silence removed; word indices are the
    original lexicon indices).

    `tables` from TransitionModel.decoder_tables over the full lexicon;
    lm_matrix/lm_start as built by tools/an4_system.build_lm_matrices:
    boundary costs (LM·scale + target word exit) on the full word axis,
    with lm[:, silence] = the silence exit cost."""
    B, T, dim = feats.shape
    Wfull = tables.num_words
    real = np.asarray([w for w in range(Wfull) if w != silence_idx],
                      np.int32)
    st = tables.state_table[real]
    wl = tables.word_len[real]
    lp = tables.last_pos[real]
    tw = tables.tdp_within[real]
    ep = tables.entry_pen[real]
    sl = int(tables.word_len[silence_idx])
    sil_states = tables.state_table[silence_idx, :sl]
    sil_tdp = tables.tdp_within[silence_idx, :sl]
    sil_entry = tables.entry_pen[silence_idx]
    sil_exit = float(lm_matrix[real[0], silence_idx])
    lm_r = lm_matrix[np.ix_(real, real)]
    lm_ext = np.concatenate([lm_r, lm_start[real][None, :]], axis=0)

    if am is None:
        flat = jnp.asarray(feats.reshape(B * T, dim))
        am = gmm_mod.am_scores(pack, flat).reshape(B, T, pack.num_mixtures)
    am = am.astype(dtype)

    outs = _decode_scan_linear_ts(
        am, jnp.asarray(feat_len, jnp.int32),
        jnp.asarray(st), jnp.asarray(lp), jnp.asarray(wl),
        jnp.asarray(tw), jnp.asarray(ep),
        jnp.asarray(sil_states), jnp.asarray(sil_tdp),
        jnp.asarray(sil_entry), jnp.asarray(sil_exit, jnp.float32),
        jnp.asarray(lm_ext), jnp.asarray(am_threshold, dtype),
        prune=prune)
    # traceback ON DEVICE: the per-frame [T, B, W]/[T, B, V] outputs are
    # ~hundreds of MB, while the walk itself is max_words tiny gathers, so
    # only the [max_words, B] word ids are fetched to the host.
    words_dev = _traceback_device(
        outs, jnp.asarray(feat_len, jnp.int32), len(real))
    words_np = np.asarray(words_dev)                # [max_words, B]
    W = len(real)
    results: List[List[int]] = []
    for b in range(B):
        seq = [int(real[w]) for w in words_np[:, b] if w >= 0]
        seq.reverse()
        results.append(seq)
    return results


MAX_TRACE_WORDS = 128


@partial(jax.jit, static_argnames=("W",))
def _traceback_device(outs, feat_len: jnp.ndarray, W: int) -> jnp.ndarray:
    """Backward word walk over the scan outputs, vectorized over the
    batch; returns [MAX_TRACE_WORDS, B] real-word indices in reverse
    order (−1 padding)."""
    books, bkps, preds, _vias, origins, silends, silorgs, _off = outs
    T, B = books.shape[0], books.shape[1]
    bi = jnp.arange(B)
    tb = jnp.maximum(feat_len, 1)
    fb = books[tb - 1, bi]                          # [B, W]
    fsil = silends[tb - 1, bi]                      # [B, V]
    w_best = jnp.argmin(fb, axis=1).astype(jnp.int32)
    sil_v = jnp.argmin(fsil, axis=1).astype(jnp.int32)
    use_sil = fsil.min(axis=1) < fb[bi, w_best]
    cur = jnp.where(use_sil, sil_v, w_best)
    t = jnp.where(use_sil, silorgs[tb - 1, bi, sil_v], tb)
    done = (cur >= W) | (t <= 0) | (feat_len == 0)

    def step(carry, _):
        cur, t, done = carry
        word = jnp.where(done, -1, cur)
        tc = jnp.clip(t - 1, 0, T - 1)
        cc = jnp.clip(cur, 0, W - 1)
        boundary = bkps[tc, bi, cc]
        v = preds[tc, bi, cc]
        bc = jnp.clip(boundary, 0, T - 1)
        vc = jnp.clip(v, 0, W)                       # origins has V=W+1
        t_next = origins[bc, bi, vc]
        new_done = done | (v >= W) | (t_next <= 0)
        nxt = (jnp.where(done, cur, v).astype(jnp.int32),
               jnp.where(done, t, t_next).astype(jnp.int32), new_done)
        return nxt, word.astype(jnp.int32)

    _c, words = jax.lax.scan(step, (cur.astype(jnp.int32),
                                    t.astype(jnp.int32), done),
                             None, length=MAX_TRACE_WORDS)
    return words
