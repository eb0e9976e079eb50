"""Word-conditioned time-synchronous decoder with bigram LM recombination.

JAX counterpart of the reference lab decoder
(rwth-asr-0.5/src/Teaching/LinearSearch.cc:211-436): a linear word lexicon
where word entries are conditioned on the predecessor word through bigram
scores, with exact recombination at word boundaries.

Dense formulation per frame (one lax.scan step over the batch):

    entry[b, w]  = min_v (book_prev[b, v] + lm[v, w])      (min-plus matmul)
    hyp[b, w, s] = 0-1-2 recursion + entry into positions {0, 1}
    book[b, w]   = hyp[b, w, last(w)]                      (per-WORD word-end)

The per-word book (instead of the zerogram decoder's single best word-end)
carries the bigram context; the min-plus product over the [W, W] LM matrix
is the reference's bigram recombination, vectorized over the batch.
Traceback records the boundary frame *and* predecessor word per entry.

LM matrices may come from any scorer: CountLM / ArpaLM score tables
(−log p), or a uniform row (≡ constant word penalty: with
lm[v, w] = wp(w) this decoder reduces exactly to the zerogram word-loop
decoder in search/decoder.py — a tested invariant).
"""

from __future__ import annotations

from functools import partial
from typing import List

import numpy as np

import jax
import jax.numpy as jnp

from ..models import gmm as gmm_mod
from .decoder import BIG, DecoderTables


@partial(jax.jit, static_argnames=("prune",))
def _decode_scan_bigram(am: jnp.ndarray, feat_len: jnp.ndarray,
                        state_table: jnp.ndarray, last_pos: jnp.ndarray,
                        word_len: jnp.ndarray, first_state: jnp.ndarray,
                        tdp_within: jnp.ndarray, entry_tdp: jnp.ndarray,
                        lm: jnp.ndarray, lm_start: jnp.ndarray,
                        am_threshold: jnp.ndarray, prune: bool = True):
    """am [B, T, S]; lm [W, W] = −log p(w|v); lm_start [W] = −log p(w|start).
    Returns per-frame (book_score [T,B,W], book_bkp [T,B,W], book_pred [T,B,W]);
    book_pred = −1 marks entries from the virtual start."""
    B, T, S = am.shape
    dtype = am.dtype
    W, P = state_table.shape
    big = jnp.asarray(BIG, dtype)
    lm = lm.astype(dtype)
    lm_start = lm_start.astype(dtype)

    tdpw = tdp_within.astype(dtype)
    entp = entry_tdp.astype(dtype)          # [W, 2] entry TDP (word pen excluded)
    slot_valid = jnp.arange(P)[None, :] < word_len[:, None]

    hyp0 = jnp.full((B, W, P), big, dtype)
    bkp0 = jnp.zeros((B, W, P), jnp.int32)
    pred0 = jnp.full((B, W, P), -1, jnp.int32)
    book0 = jnp.full((B, W), big, dtype)    # no word has ended yet

    inf_col = jnp.full((B, W, 1), big, dtype)

    def step(carry, inputs):
        hyp, bkp, pred, book_prev = carry
        am_t, t = inputs

        ams = am_t[:, state_table]
        c0 = hyp + tdpw[None, :, :, 0]
        c1 = jnp.concatenate([inf_col, hyp[:, :, :-1] + tdpw[None, :, 1:, 1]], axis=2)
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

        # bigram recombination: min-plus product book_prev ⊗ lm, plus the
        # virtual sentence-start context at the first frame
        cand = book_prev[:, :, None] + lm[None, :, :]        # [B, v, w]
        rec = cand.min(axis=1)
        rec_pred = jnp.argmin(cand, axis=1).astype(jnp.int32)
        start = jnp.where(t == 1, lm_start[None, :].repeat(B, 0),
                          jnp.full((B, W), big, dtype))
        take_start = start < rec
        entry_base = jnp.where(take_start, start, rec)
        entry_pred = jnp.where(take_start, jnp.int32(-1), rec_pred)

        # acoustic score of the ENTERED position's own state (for the
        # SieTill lexicon positions 0/1 share a state, so this equals
        # the reference's first-state charge bit-for-bit; for
        # repetition-1 lexica the skip entry lands in a different state
        # and must pay that state's emission — Sprint semantics)
        am_entry = am_t[:, state_table[:, :2]]               # [B, W, 2]
        entry = (entry_base[:, :, None] + entp[None, :, :]
                 + am_entry)                                 # [B, W, 2]
        entry = jnp.concatenate(
            [entry, jnp.full((B, W, P - 2), big, dtype)], axis=2)
        entry_pred3 = jnp.concatenate(
            [entry_pred[:, :, None].repeat(2, 2),
             jnp.full((B, W, P - 2), -1, jnp.int32)], axis=2)

        take_entry = entry <= within
        new = jnp.where(take_entry, entry, within)
        new_bkp = jnp.where(take_entry, (t - 1).astype(jnp.int32), wbkp)
        new_pred = jnp.where(take_entry, entry_pred3, wpred)
        new = jnp.where(slot_valid[None, :, :], new, big)
        new = jnp.minimum(new, big)

        # per-frame renormalization (see decoder.py)
        best = new.min(axis=(1, 2), keepdims=True)
        best = jnp.where(best >= big * 0.5, 0.0, best)
        new = jnp.where(new >= big * 0.5, big, new - best)
        if prune:
            new = jnp.where(new > am_threshold, big, new)

        li = last_pos[None, :, None].astype(jnp.int32)
        end_scores = jnp.take_along_axis(new, li, axis=2)[:, :, 0]
        end_bkp = jnp.take_along_axis(new_bkp, li, axis=2)[:, :, 0]
        end_pred = jnp.take_along_axis(new_pred, li, axis=2)[:, :, 0]
        end_scores = jnp.where(end_scores >= big * 0.5, big, end_scores)

        alive = (t <= feat_len)[:, None]
        hyp_out = jnp.where(alive[:, :, None], new, hyp)
        bkp_out = jnp.where(alive[:, :, None], new_bkp, bkp)
        pred_out = jnp.where(alive[:, :, None], new_pred, pred)
        book_out = jnp.where(alive, end_scores, book_prev)
        offset = jnp.where(alive[:, 0], best[:, 0, 0], 0.0)
        return ((hyp_out, bkp_out, pred_out, book_out),
                (end_scores, end_bkp, end_pred, offset))

    init = (hyp0, bkp0, pred0, book0)
    _, (scores, bkps, preds, offsets) = jax.lax.scan(
        step, init, (jnp.moveaxis(am, 1, 0), jnp.arange(1, T + 1)))
    return scores, bkps, preds, offsets


def decode_batch_bigram(pack: gmm_mod.ScorePack, feats: np.ndarray,
                        feat_len: np.ndarray, tables: DecoderTables,
                        lm_matrix: np.ndarray, lm_start: np.ndarray,
                        am_threshold: float, silence_idx: int,
                        prune: bool = True, dtype=jnp.float32,
                        am=None) -> List[List[int]]:
    """Bigram decode → word sequences (silence removed).

    Build `tables` with word_penalty=0 — word costs live in lm_matrix /
    lm_start (−log p; fold silence exemptions there). ``am`` may carry
    precomputed [B, T, S] acoustic scores (pack is then unused).
    """
    B, T, dim = feats.shape
    if am is None:
        flat = jnp.asarray(feats.reshape(B * T, dim))
        am = gmm_mod.am_scores(pack, flat).reshape(B, T, pack.num_mixtures)
    am = am.astype(dtype)
    scores, bkps, preds, _offsets = _decode_scan_bigram(
        am, jnp.asarray(feat_len, jnp.int32),
        jnp.asarray(tables.state_table), jnp.asarray(tables.last_pos),
        jnp.asarray(tables.word_len), jnp.asarray(tables.first_state),
        jnp.asarray(tables.tdp_within), jnp.asarray(tables.entry_pen),
        jnp.asarray(lm_matrix), jnp.asarray(lm_start),
        jnp.asarray(am_threshold, dtype), prune=prune)
    scores_np = np.asarray(scores)   # [T, B, W]
    bkps_np = np.asarray(bkps)
    preds_np = np.asarray(preds)

    out: List[List[int]] = []
    for b in range(B):
        t = int(feat_len[b])
        if t == 0 or not np.isfinite(scores_np[t - 1, b]).any() \
                or scores_np[t - 1, b].min() >= BIG * 0.5:
            out.append([])
            continue
        w = int(np.argmin(scores_np[t - 1, b]))
        seq: List[int] = []
        while t > 0 and w >= 0:
            if w != silence_idx:
                seq.append(w)
            t, w = int(bkps_np[t - 1, b, w]), int(preds_np[t - 1, b, w])
        seq.reverse()
        out.append(seq)
    return out
