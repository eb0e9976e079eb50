"""Batched Viterbi forced alignment as a masked max-plus `lax.scan`.

The reference aligns one utterance at a time with per-frame beam maps
(src/sietill/Alignment.cpp:149-288). Here the whole batch advances one
frame per scan step over a dense [B, A] position lattice; beam pruning is a
per-row threshold mask, so the result is *exactly* the reference's pruned
semantics (threshold-only pruning keeps a dense lattice exact).

Tie-breaking: the reference's pruned aligner inserts hypotheses in
ascending predecessor order with strict-< updates, so on equal scores the
*smallest predecessor* (largest jump) wins (Alignment.cpp:173-207); the
full DP prefers the loop (Alignment.cpp:96-113). Both orders are provided.

Final state: the pruned aligner backtracks from the *highest reached*
position in the last frame (Alignment.cpp:248-256); the full DP forces the
last position.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..lexicon import MarkovAutomaton
from ..tdp import TdpModel

BIG = np.float64(1e30)  # pseudo-infinity that stays NaN-free under adds


@dataclass
class AlignerTables:
    """Static per-batch tables for a set of segment automata."""

    states: np.ndarray   # int32 [B, A_max] global state per position (padded w/ last)
    lengths: np.ndarray  # int32 [B] automaton positions
    tdp: np.ndarray      # f64 [B, A_max, 3] penalty into position a with jump j

    @staticmethod
    def build(automata: List[MarkovAutomaton], tdp_model: TdpModel,
              pad_to: Optional[int] = None) -> "AlignerTables":
        B = len(automata)
        A = pad_to or max(a.num_states for a in automata)
        states = np.zeros((B, A), dtype=np.int32)
        lengths = np.zeros(B, dtype=np.int32)
        for i, a in enumerate(automata):
            states[i, : a.num_states] = a.states
            states[i, a.num_states:] = a.last_state
            lengths[i] = a.num_states
        from ..contracts import require

        # the aligned-state fetch is int16 (_states_from_positions);
        # larger inventories would wrap silently
        require(states.max(initial=0) < 1 << 15,
                f"state inventory too large for int16 alignment states: "
                f"max id {states.max(initial=0)}")
        tdp = tdp_model.table_for_states(states)
        return AlignerTables(states=states, lengths=lengths, tdp=tdp)


@partial(jax.jit, static_argnames=("tie_pruned", "use_pruning"))
def _align_scan(ams: jnp.ndarray, tdp: jnp.ndarray, pos_valid: jnp.ndarray,
                feat_len: jnp.ndarray, aut_len: jnp.ndarray,
                pruning_threshold: jnp.ndarray,
                tie_pruned: bool = True, use_pruning: bool = True,
                ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Core DP. ams f [B, T, A] emission scores per position; returns
    (positions int32 [B, T], best_costs [B], final_pos [B])."""
    B, T, A = ams.shape
    dtype = ams.dtype
    big = jnp.asarray(BIG, dtype)
    inf_row = jnp.full((B, 1), big, dtype)

    invalid = ~pos_valid  # [B, A]
    init = jnp.where(
        jnp.arange(A)[None, :] == 0, ams[:, 0, :], big)  # only position 0 live

    def step(prev, inputs):
        am_t, t = inputs
        c0 = prev + tdp[:, :, 0]
        c1 = jnp.concatenate([inf_row, prev[:, :-1] + tdp[:, 1:, 1]], axis=1)
        c2 = jnp.concatenate([inf_row.repeat(2, 1), prev[:, :-2] + tdp[:, 2:, 2]], axis=1)
        if tie_pruned:  # largest jump wins ties (first writer)
            best, jump = c2, jnp.full((B, A), 2, jnp.int8)
            for c, j in ((c1, 1), (c0, 0)):
                take = c < best
                best = jnp.where(take, c, best)
                jump = jnp.where(take, jnp.int8(j), jump)
        else:           # loop preferred (full DP, Alignment.cpp:96-113)
            best, jump = c0, jnp.zeros((B, A), jnp.int8)
            for c, j in ((c1, 1), (c2, 2)):
                take = c < best
                best = jnp.where(take, c, best)
                jump = jnp.where(take, jnp.int8(j), jump)
        cost = jnp.where(invalid, big, best + am_t)
        cost = jnp.minimum(cost, big)
        # renormalize per frame: decisions are invariant under a shared
        # offset, and the float32 carry stays O(threshold) instead of
        # drifting over hundreds of frames (see decoder.py)
        row_best = cost.min(axis=1, keepdims=True)
        row_best = jnp.where(row_best >= big * 0.5, 0.0, row_best)
        cost = jnp.where(cost >= big * 0.5, big, cost - row_best)
        if use_pruning:
            cost = jnp.where(cost > pruning_threshold, big, cost)
        # freeze rows whose utterance already ended
        alive = (t < feat_len)[:, None]
        cost = jnp.where(alive, cost, prev)
        return cost, jump

    final_cost, jumps = jax.lax.scan(
        step, init, (jnp.moveaxis(ams[:, 1:, :], 1, 0), jnp.arange(1, T)))
    # jumps: [T-1, B, A] for frames 1..T-1

    pos_ids = jnp.arange(A)[None, :]
    finite = final_cost < big * 0.5
    if tie_pruned:
        # highest reached finite position (Alignment.cpp:248-253)
        final_pos = jnp.max(jnp.where(finite, pos_ids, -1), axis=1)
        final_pos = jnp.maximum(final_pos, 0).astype(jnp.int32)
    else:
        final_pos = (aut_len - 1).astype(jnp.int32)
    best_costs = jnp.take_along_axis(final_cost, final_pos[:, None], axis=1)[:, 0]

    def back_step(cur, inputs):
        jump_t, t = inputs  # jump_t: [B, A] jumps taken INTO frame t
        active = t <= feat_len - 1  # does frame t exist for this utterance?
        emit = cur                   # position at frame t (valid when active)
        prev_pos = cur - jnp.take_along_axis(
            jump_t.astype(jnp.int32), cur[:, None], axis=1)[:, 0]
        new_cur = jnp.where(active, prev_pos, final_pos)
        return new_cur, emit

    # walk t = T-1 .. 1, emitting the position at frame t
    ts = jnp.arange(T - 1, 0, -1)
    pos0, rev_positions = jax.lax.scan(
        back_step, final_pos, (jumps[::-1], ts))
    positions = jnp.concatenate(
        [pos0[:, None], rev_positions.T[:, ::-1]], axis=1)  # [B, T]
    return positions.astype(jnp.int32), best_costs, final_pos


@partial(jax.jit, static_argnames=("tie_pruned", "use_pruning"))
def _align_scan_df(ams_hi: jnp.ndarray, ams_lo: jnp.ndarray,
                   tdp_hi: jnp.ndarray, tdp_lo: jnp.ndarray,
                   pos_valid: jnp.ndarray, feat_len: jnp.ndarray,
                   aut_len: jnp.ndarray, thr_hi: jnp.ndarray,
                   thr_lo: jnp.ndarray, tie_pruned: bool = True,
                   use_pruning: bool = True,
                   ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Double-float (two-f32) variant of `_align_scan`: carries (hi, lo)
    score pairs through the scan so every comparison resolves exactly as
    the reference's C++ double DP would (same EFT toolkit and parity
    argument as the decoder's df32 path, ops/doublefloat.py)."""
    from ..ops import doublefloat as dfm

    B, T, A = ams_hi.shape
    bigf = jnp.float32(BIG)
    big_row = dfm.DF(jnp.full((B, 1), bigf), jnp.zeros((B, 1), jnp.float32))
    tdp = dfm.DF(tdp_hi, tdp_lo)
    thr = dfm.DF(thr_hi, thr_lo)
    invalid = ~pos_valid

    def big_like(x: jnp.ndarray) -> dfm.DF:
        return dfm.DF(jnp.full_like(x, bigf), jnp.zeros_like(x))

    init = dfm.where(jnp.arange(A)[None, :] == 0,
                     dfm.DF(ams_hi[:, 0, :], ams_lo[:, 0, :]),
                     big_like(ams_hi[:, 0, :]))

    def cat(pad: dfm.DF, x: dfm.DF) -> dfm.DF:
        return dfm.DF(jnp.concatenate([pad.hi, x.hi], axis=1),
                      jnp.concatenate([pad.lo, x.lo], axis=1))

    def step(prev_pair, inputs):
        am_hi_t, am_lo_t, t = inputs
        prev = dfm.DF(*prev_pair)
        am_t = dfm.DF(am_hi_t, am_lo_t)
        c0 = dfm.add(prev, dfm.DF(tdp.hi[:, :, 0], tdp.lo[:, :, 0]))
        c1 = cat(big_row, dfm.add(dfm.DF(prev.hi[:, :-1], prev.lo[:, :-1]),
                                  dfm.DF(tdp.hi[:, 1:, 1], tdp.lo[:, 1:, 1])))
        pad2 = dfm.DF(big_row.hi.repeat(2, 1), big_row.lo.repeat(2, 1))
        c2 = cat(pad2, dfm.add(dfm.DF(prev.hi[:, :-2], prev.lo[:, :-2]),
                               dfm.DF(tdp.hi[:, 2:, 2], tdp.lo[:, 2:, 2])))
        if tie_pruned:  # largest jump wins ties (first writer)
            best, jump = c2, jnp.full((B, A), 2, jnp.int8)
            for c, j in ((c1, 1), (c0, 0)):
                take = dfm.less(c, best)
                best = dfm.where(take, c, best)
                jump = jnp.where(take, jnp.int8(j), jump)
        else:           # loop preferred (full DP, Alignment.cpp:96-113)
            best, jump = c0, jnp.zeros((B, A), jnp.int8)
            for c, j in ((c1, 1), (c2, 2)):
                take = dfm.less(c, best)
                best = dfm.where(take, c, best)
                jump = jnp.where(take, jnp.int8(j), jump)
        cost = dfm.where(invalid, big_like(best.hi), dfm.add(best, am_t))
        cost = dfm.where(cost.hi >= bigf * 0.5, big_like(cost.hi), cost)
        # renormalize per frame (shared offset; decisions invariant)
        row_best = dfm.min_axis(cost, axis=1)
        row_dead = row_best.hi >= bigf * 0.5
        row_best = dfm.DF(jnp.where(row_dead, 0.0, row_best.hi)[:, None],
                          jnp.where(row_dead, 0.0, row_best.lo)[:, None])
        shifted = dfm.sub(cost, dfm.DF(jnp.broadcast_to(row_best.hi, cost.hi.shape),
                                       jnp.broadcast_to(row_best.lo, cost.lo.shape)))
        cost = dfm.where(cost.hi >= bigf * 0.5, big_like(cost.hi), shifted)
        if use_pruning:
            over = ~dfm.less_equal(
                cost, dfm.DF(jnp.broadcast_to(thr.hi, cost.hi.shape),
                             jnp.broadcast_to(thr.lo, cost.lo.shape)))
            cost = dfm.where(over, big_like(cost.hi), cost)
        alive = (t < feat_len)[:, None]
        cost = dfm.where(alive, cost, prev)
        return (cost.hi, cost.lo), jump

    (final_hi, final_lo), jumps = jax.lax.scan(
        step, (init.hi, init.lo),
        (jnp.moveaxis(ams_hi[:, 1:, :], 1, 0),
         jnp.moveaxis(ams_lo[:, 1:, :], 1, 0), jnp.arange(1, T)))

    pos_ids = jnp.arange(A)[None, :]
    finite = final_hi < bigf * 0.5
    if tie_pruned:
        final_pos = jnp.max(jnp.where(finite, pos_ids, -1), axis=1)
        final_pos = jnp.maximum(final_pos, 0).astype(jnp.int32)
    else:
        final_pos = (aut_len - 1).astype(jnp.int32)
    best_costs = (
        jnp.take_along_axis(final_hi, final_pos[:, None], axis=1)[:, 0]
        .astype(jnp.float64)
        + jnp.take_along_axis(final_lo, final_pos[:, None], axis=1)[:, 0]
        .astype(jnp.float64)
        if jax.config.read("jax_enable_x64")
        else jnp.take_along_axis(final_hi, final_pos[:, None], axis=1)[:, 0])

    def back_step(cur, inputs):
        jump_t, t = inputs
        active = t <= feat_len - 1
        emit = cur
        prev_pos = cur - jnp.take_along_axis(
            jump_t.astype(jnp.int32), cur[:, None], axis=1)[:, 0]
        new_cur = jnp.where(active, prev_pos, final_pos)
        return new_cur, emit

    ts = jnp.arange(T - 1, 0, -1)
    pos0, rev_positions = jax.lax.scan(back_step, final_pos, (jumps[::-1], ts))
    positions = jnp.concatenate(
        [pos0[:, None], rev_positions.T[:, ::-1]], axis=1)
    return positions.astype(jnp.int32), best_costs, final_pos


def align_batch(pack, feats: np.ndarray, feat_len: np.ndarray,
                tables: AlignerTables, pruning_threshold: Optional[float] = 50.0,
                tie_pruned: bool = True, dtype=jnp.float32,
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Align a padded batch. Returns (states int32 [B, T], costs f [B]).

    pack: gmm.ScorePack (or gmm.ScorePackDF with dtype="df32"). feats f32
    [B, T, dim] zero-padded, feat_len [B]. pruning_threshold None → full
    DP (no pruning, forced final position). dtype "df32" runs acoustic
    scoring and the DP in double-float pairs — reference-f64 decisions at
    f32 device speed (no emulated f64 op on the device).
    """
    from ..models import gmm as gmm_mod

    B, T, dim = feats.shape
    flat = jnp.asarray(feats.reshape(B * T, dim))
    states_tbl = jnp.asarray(tables.states)
    A = tables.states.shape[1]
    pos_valid = jnp.arange(A)[None, :] < jnp.asarray(tables.lengths)[:, None]
    use_pruning = pruning_threshold is not None

    if dtype == "df32":
        from ..ops import doublefloat as dfm

        am = gmm_mod.am_scores_df(pack, flat)
        S = pack.num_mixtures
        idx = states_tbl[:, None, :].astype(jnp.int32)
        ams_hi = jnp.take_along_axis(am.hi.reshape(B, T, S), idx, axis=2)
        ams_lo = jnp.take_along_axis(am.lo.reshape(B, T, S), idx, axis=2)
        thr = dfm.from_f64(np.float64(
            pruning_threshold if use_pruning else 0.0))
        tdp_df = dfm.from_f64(tables.tdp)
        positions, costs, _ = _align_scan_df(
            ams_hi, ams_lo, tdp_df.hi, tdp_df.lo, pos_valid,
            jnp.asarray(feat_len, jnp.int32),
            jnp.asarray(tables.lengths, jnp.int32), thr.hi, thr.lo,
            tie_pruned=tie_pruned, use_pruning=use_pruning)
    else:
        am = gmm_mod.am_scores(pack, flat).reshape(B, T, pack.num_mixtures)
        am = am.astype(dtype)
        ams = jnp.take_along_axis(am, states_tbl[:, None, :].astype(jnp.int32), axis=2)
        thr = jnp.asarray(pruning_threshold if use_pruning else 0.0, dtype)
        positions, costs, _ = _align_scan(
            ams, jnp.asarray(tables.tdp, dtype), pos_valid,
            jnp.asarray(feat_len, jnp.int32), jnp.asarray(tables.lengths, jnp.int32),
            thr, tie_pruned=tie_pruned, use_pruning=use_pruning)
    states = jnp.take_along_axis(states_tbl, positions, axis=1)
    return np.asarray(states), np.asarray(costs)


# -- time-chunked alignment (fixed program shapes) ---------------------------
#: ONE compiled (B, ALIGN_CHUNK) forward/backward program pair serves
#: utterances of any length by streaming chunks through the carried DP row
#: (same design as search/decoder.DECODE_CHUNK: a fixed program count,
#: whatever the utterance lengths)
ALIGN_CHUNK = 320


@partial(jax.jit, static_argnames=("tie_pruned", "use_pruning"))
def _align_fwd_chunk(prev: jnp.ndarray, ams: jnp.ndarray, tdp: jnp.ndarray,
                     pos_valid: jnp.ndarray, feat_len: jnp.ndarray,
                     pruning_threshold: jnp.ndarray, t0: jnp.ndarray,
                     tie_pruned: bool = True, use_pruning: bool = True):
    """One forward chunk of the banded Viterbi DP. prev: f [B, A] cost row
    entering the chunk (ignored when t0 == 0); ams f [B, C, A]; returns
    (cost row after the chunk, jumps int8 [C, B, A]). Global frame t0+i is
    initialized (not recursed) at t == 0, exactly like `_align_scan`'s
    init row."""
    B, C, A = ams.shape
    dtype = ams.dtype
    big = jnp.asarray(BIG, dtype)
    inf_row = jnp.full((B, 1), big, dtype)
    invalid = ~pos_valid

    def step(prev, inputs):
        am_t, t = inputs
        c0 = prev + tdp[:, :, 0]
        c1 = jnp.concatenate([inf_row, prev[:, :-1] + tdp[:, 1:, 1]], axis=1)
        c2 = jnp.concatenate([inf_row.repeat(2, 1), prev[:, :-2] + tdp[:, 2:, 2]], axis=1)
        if tie_pruned:  # largest jump wins ties (first writer)
            best, jump = c2, jnp.full((B, A), 2, jnp.int8)
            for c, j in ((c1, 1), (c0, 0)):
                take = c < best
                best = jnp.where(take, c, best)
                jump = jnp.where(take, jnp.int8(j), jump)
        else:           # loop preferred (full DP, Alignment.cpp:96-113)
            best, jump = c0, jnp.zeros((B, A), jnp.int8)
            for c, j in ((c1, 1), (c2, 2)):
                take = c < best
                best = jnp.where(take, c, best)
                jump = jnp.where(take, jnp.int8(j), jump)
        cost = jnp.where(invalid, big, best + am_t)
        cost = jnp.minimum(cost, big)
        row_best = cost.min(axis=1, keepdims=True)
        row_best = jnp.where(row_best >= big * 0.5, 0.0, row_best)
        cost = jnp.where(cost >= big * 0.5, big, cost - row_best)
        if use_pruning:
            cost = jnp.where(cost > pruning_threshold, big, cost)
        # frame 0: fresh init at position 0, no renorm/prune (like the
        # _align_scan init row); jump value at t == 0 is never read back
        init0 = jnp.where((jnp.arange(A)[None, :] == 0) & ~invalid, am_t, big)
        cost = jnp.where(t == 0, init0, cost)
        alive = (t < feat_len)[:, None]
        cost = jnp.where(alive, cost, prev)
        return cost, jump

    out, jumps = jax.lax.scan(
        step, prev, (jnp.moveaxis(ams, 1, 0), t0 + jnp.arange(C)))
    return out, jumps


@partial(jax.jit, static_argnames=("tie_pruned", "use_pruning"))
def _align_fwd_chunk_df(prev_hi, prev_lo, ams_hi, ams_lo, tdp_hi, tdp_lo,
                        pos_valid, feat_len, thr_hi, thr_lo, t0,
                        tie_pruned: bool = True, use_pruning: bool = True):
    """Double-float twin of `_align_fwd_chunk` (same EFT toolkit and
    parity argument as `_align_scan_df`)."""
    from ..ops import doublefloat as dfm

    B, C, A = ams_hi.shape
    bigf = jnp.float32(BIG)
    big_row = dfm.DF(jnp.full((B, 1), bigf), jnp.zeros((B, 1), jnp.float32))
    tdp = dfm.DF(tdp_hi, tdp_lo)
    thr = dfm.DF(thr_hi, thr_lo)
    invalid = ~pos_valid

    def big_like(x):
        return dfm.DF(jnp.full_like(x, bigf), jnp.zeros_like(x))

    def cat(pad, x):
        return dfm.DF(jnp.concatenate([pad.hi, x.hi], axis=1),
                      jnp.concatenate([pad.lo, x.lo], axis=1))

    def step(prev_pair, inputs):
        am_hi_t, am_lo_t, t = inputs
        prev = dfm.DF(*prev_pair)
        am_t = dfm.DF(am_hi_t, am_lo_t)
        c0 = dfm.add(prev, dfm.DF(tdp.hi[:, :, 0], tdp.lo[:, :, 0]))
        c1 = cat(big_row, dfm.add(dfm.DF(prev.hi[:, :-1], prev.lo[:, :-1]),
                                  dfm.DF(tdp.hi[:, 1:, 1], tdp.lo[:, 1:, 1])))
        pad2 = dfm.DF(big_row.hi.repeat(2, 1), big_row.lo.repeat(2, 1))
        c2 = cat(pad2, dfm.add(dfm.DF(prev.hi[:, :-2], prev.lo[:, :-2]),
                               dfm.DF(tdp.hi[:, 2:, 2], tdp.lo[:, 2:, 2])))
        if tie_pruned:
            best, jump = c2, jnp.full((B, A), 2, jnp.int8)
            for c, j in ((c1, 1), (c0, 0)):
                take = dfm.less(c, best)
                best = dfm.where(take, c, best)
                jump = jnp.where(take, jnp.int8(j), jump)
        else:
            best, jump = c0, jnp.zeros((B, A), jnp.int8)
            for c, j in ((c1, 1), (c2, 2)):
                take = dfm.less(c, best)
                best = dfm.where(take, c, best)
                jump = jnp.where(take, jnp.int8(j), jump)
        cost = dfm.where(invalid, big_like(best.hi), dfm.add(best, am_t))
        cost = dfm.where(cost.hi >= bigf * 0.5, big_like(cost.hi), cost)
        row_best = dfm.min_axis(cost, axis=1)
        row_dead = row_best.hi >= bigf * 0.5
        row_best = dfm.DF(jnp.where(row_dead, 0.0, row_best.hi)[:, None],
                          jnp.where(row_dead, 0.0, row_best.lo)[:, None])
        shifted = dfm.sub(cost, dfm.DF(jnp.broadcast_to(row_best.hi, cost.hi.shape),
                                       jnp.broadcast_to(row_best.lo, cost.lo.shape)))
        cost = dfm.where(cost.hi >= bigf * 0.5, big_like(cost.hi), shifted)
        if use_pruning:
            over = ~dfm.less_equal(
                cost, dfm.DF(jnp.broadcast_to(thr.hi, cost.hi.shape),
                             jnp.broadcast_to(thr.lo, cost.lo.shape)))
            cost = dfm.where(over, big_like(cost.hi), cost)
        init_mask = (jnp.arange(A)[None, :] == 0) & ~invalid
        init0 = dfm.where(init_mask, am_t, big_like(cost.hi))
        cost = dfm.where(t == 0, init0, cost)
        alive = (t < feat_len)[:, None]
        cost = dfm.where(alive, cost, prev)
        return (cost.hi, cost.lo), jump

    (out_hi, out_lo), jumps = jax.lax.scan(
        step, (prev_hi, prev_lo),
        (jnp.moveaxis(ams_hi, 1, 0), jnp.moveaxis(ams_lo, 1, 0),
         t0 + jnp.arange(C)))
    return out_hi, out_lo, jumps


@jax.jit
def _align_bwd_chunk(cur: jnp.ndarray, jumps: jnp.ndarray,
                     feat_len: jnp.ndarray, final_pos: jnp.ndarray,
                     t0: jnp.ndarray):
    """One backward chunk: walk global frames t0+C-1 .. t0, emitting the
    aligned position per frame. cur int32 [B]; jumps int8 [C, B, A].
    Returns (cur entering the previous chunk, positions int16 [C, B])."""
    C, B, A = jumps.shape

    def step(cur, inputs):
        jump_t, t = inputs
        emit = cur
        prev_pos = cur - jnp.take_along_axis(
            jump_t.astype(jnp.int32), cur[:, None], axis=1)[:, 0]
        active = t <= feat_len - 1
        new_cur = jnp.where(t == 0, cur,
                            jnp.where(active, prev_pos, final_pos))
        return new_cur, emit.astype(jnp.int16)

    ts = t0 + jnp.arange(C - 1, -1, -1)
    cur, rev_emit = jax.lax.scan(step, cur, (jumps[::-1], ts))
    return cur, rev_emit[::-1]


def align_batch_chunked(pack, feats, feat_len: np.ndarray,
                        tables: AlignerTables,
                        pruning_threshold: Optional[float] = 50.0,
                        tie_pruned: bool = True, dtype=jnp.float32,
                        chunk: int = ALIGN_CHUNK,
                        return_device: bool = False,
                        ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """`align_batch` with time-chunked fixed-shape programs: ONE forward
    program (per dtype path), ONE backward program, and the shared
    per-chunk acoustic scoring program cover every padded length.

    feats may be a host array or a device-resident f32 [B, T, dim] array
    (the trainer passes device gathers). Returns (states int32 [B, T],
    costs [B]) — identical to `align_batch` (cross-checked by the EM
    parity suite, which drives the trainer through this path).

    ``return_device=True`` keeps the ENTIRE pass (final-position rule,
    backtrack, state gather) on device and returns the [B, T] int16
    device states array WITHOUT blocking (costs None): the caller batches
    its fetches so a whole realign pass pays one synchronization, not one
    per batch."""
    from ..models import gmm as gmm_mod
    from ..ops import doublefloat as dfm

    B, T, dim = feats.shape
    n_chunks = -(-T // chunk)
    Tp = n_chunks * chunk
    feats_d = jnp.asarray(feats)
    if T < Tp:
        feats_d = jnp.pad(feats_d, ((0, 0), (0, Tp - T), (0, 0)))
    states_tbl = jnp.asarray(tables.states)
    A = tables.states.shape[1]
    pos_valid = jnp.arange(A)[None, :] < jnp.asarray(tables.lengths)[:, None]
    use_pruning = pruning_threshold is not None
    lens = jnp.asarray(feat_len, jnp.int32)
    is_df = dtype == "df32"
    idx = states_tbl[:, None, :].astype(jnp.int32)

    if is_df:
        thr = dfm.from_f64(np.float64(
            pruning_threshold if use_pruning else 0.0))
        tdp_df = dfm.from_f64(tables.tdp)
        prev = (jnp.full((B, A), BIG, jnp.float32),
                jnp.zeros((B, A), jnp.float32))
    else:
        thr = jnp.asarray(pruning_threshold if use_pruning else 0.0, dtype)
        tdp_j = jnp.asarray(tables.tdp, dtype)
        prev = jnp.full((B, A), BIG, dtype)

    jumps_chunks = []
    for ci in range(n_chunks):
        fl = feats_d[:, ci * chunk:(ci + 1) * chunk].reshape(B * chunk, dim)
        t0 = jnp.asarray(ci * chunk, jnp.int32)
        if is_df:
            am = gmm_mod.am_scores_df(pack, fl)
            S = pack.num_mixtures
            ams_hi = jnp.take_along_axis(am.hi.reshape(B, chunk, S), idx, axis=2)
            ams_lo = jnp.take_along_axis(am.lo.reshape(B, chunk, S), idx, axis=2)
            hi, lo, jumps = _align_fwd_chunk_df(
                prev[0], prev[1], ams_hi, ams_lo, tdp_df.hi, tdp_df.lo,
                pos_valid, lens, thr.hi, thr.lo, t0,
                tie_pruned=tie_pruned, use_pruning=use_pruning)
            prev = (hi, lo)
        else:
            am = gmm_mod.am_scores(pack, fl).reshape(
                B, chunk, pack.num_mixtures).astype(dtype)
            ams = jnp.take_along_axis(am, idx, axis=2)
            prev, jumps = _align_fwd_chunk(
                prev, ams, tdp_j, pos_valid, lens, thr, t0,
                tie_pruned=tie_pruned, use_pruning=use_pruning)
        jumps_chunks.append(jumps)

    aut_len_dev = jnp.asarray(tables.lengths, jnp.int32)
    final_hi_dev = prev[0] if is_df else prev
    if return_device:
        fp = _final_pos_dev(final_hi_dev.astype(jnp.float32), aut_len_dev,
                            tie_pruned=tie_pruned)
        cur = fp
        pos_chunks = [None] * n_chunks
        for ci in range(n_chunks - 1, -1, -1):
            cur, pos = _align_bwd_chunk(cur, jumps_chunks[ci], lens, fp,
                                        jnp.asarray(ci * chunk, jnp.int32))
            pos_chunks[ci] = pos
        pos_cat = (pos_chunks[0] if n_chunks == 1
                   else jnp.concatenate(pos_chunks, axis=0))[:T]
        return _states_from_positions(pos_cat, states_tbl), None

    final_hi = np.asarray(final_hi_dev)
    finite = final_hi < BIG * 0.5
    pos_ids = np.arange(A)[None, :]
    if tie_pruned:
        final_pos = np.max(np.where(finite, pos_ids, -1), axis=1)
        final_pos = np.maximum(final_pos, 0).astype(np.int32)
    else:
        final_pos = (tables.lengths - 1).astype(np.int32)
    if is_df:
        costs = (np.take_along_axis(final_hi, final_pos[:, None], axis=1)[:, 0]
                 .astype(np.float64)
                 + np.take_along_axis(np.asarray(prev[1]),
                                      final_pos[:, None], axis=1)[:, 0]
                 .astype(np.float64))
    else:
        costs = np.take_along_axis(final_hi, final_pos[:, None], axis=1)[:, 0]

    cur = jnp.asarray(final_pos)
    fp = jnp.asarray(final_pos)
    pos_chunks = [None] * n_chunks
    for ci in range(n_chunks - 1, -1, -1):
        cur, pos = _align_bwd_chunk(cur, jumps_chunks[ci], lens, fp,
                                    jnp.asarray(ci * chunk, jnp.int32))
        pos_chunks[ci] = pos
    positions = np.concatenate([np.asarray(p) for p in pos_chunks],
                               axis=0).T[:, :T]          # [B, T]
    states = np.take_along_axis(tables.states, positions.astype(np.int64),
                                axis=1)
    return states.astype(np.int32), costs


@partial(jax.jit, static_argnames=("tie_pruned",))
def _final_pos_dev(final_hi: jnp.ndarray, aut_len: jnp.ndarray,
                   tie_pruned: bool = True) -> jnp.ndarray:
    """Device-side final-position rule (pruned: highest reached finite
    position, Alignment.cpp:248-253; full DP: forced last position) — so
    the chunked aligner needs NO mid-pass host fetch."""
    B, A = final_hi.shape
    if tie_pruned:
        finite = final_hi < jnp.float32(BIG * 0.5)
        pos = jnp.max(jnp.where(finite, jnp.arange(A)[None, :], -1), axis=1)
        return jnp.maximum(pos, 0).astype(jnp.int32)
    return (aut_len - 1).astype(jnp.int32)


@jax.jit
def _states_from_positions(pos_cat: jnp.ndarray, states_tbl: jnp.ndarray,
                           ) -> jnp.ndarray:
    """[T, B] int16 positions + [B, A] state table → [B, T] int16 aligned
    states (the only array the host ever fetches per batch)."""
    positions = pos_cat.T.astype(jnp.int32)            # [B, T]
    return jnp.take_along_axis(states_tbl, positions, axis=1).astype(jnp.int16)


@partial(jax.jit, static_argnames=("T", "chunk", "tie_pruned", "use_pruning"))
def _realign_batch_dev(pack, dev_flat: jnp.ndarray, idx: jnp.ndarray,
                       lens: jnp.ndarray, states_tbl: jnp.ndarray,
                       tdp_hi: jnp.ndarray, tdp_lo: jnp.ndarray,
                       pos_valid: jnp.ndarray, aut_len: jnp.ndarray,
                       thr_hi: jnp.ndarray, thr_lo: jnp.ndarray,
                       T: int, chunk: int = ALIGN_CHUNK,
                       tie_pruned: bool = True,
                       use_pruning: bool = True) -> jnp.ndarray:
    """One whole realign batch as ONE device program: feature gather from
    the resident corpus, df32 acoustic scoring, chunked forward DP,
    device-side final-position rule, chunked backtrack, and the
    states-from-positions gather — a single dispatch + a single fetch per
    batch instead of ~10 separate calls. ``pack`` is a ScorePackDF
    (pytree); the f32/f64 trainer paths keep the unfused route."""
    from ..models import gmm as gmm_mod

    B = idx.shape[0]
    dim = dev_flat.shape[1]
    n_chunks = -(-T // chunk)
    Tp = n_chunks * chunk
    feats = dev_flat[idx]                                   # [B, T, dim]
    feats = feats * (jnp.arange(T)[None, :, None] < lens[:, None, None])
    if T < Tp:
        feats = jnp.pad(feats, ((0, 0), (0, Tp - T), (0, 0)))
    sidx = states_tbl[:, None, :].astype(jnp.int32)
    A = states_tbl.shape[1]

    prev = (jnp.full((B, A), BIG, jnp.float32), jnp.zeros((B, A), jnp.float32))
    jumps_chunks = []
    for ci in range(n_chunks):
        fl = feats[:, ci * chunk:(ci + 1) * chunk].reshape(B * chunk, dim)
        am = gmm_mod.am_scores_df(pack, fl)
        S = pack.num_mixtures
        ams_hi = jnp.take_along_axis(am.hi.reshape(B, chunk, S), sidx, axis=2)
        ams_lo = jnp.take_along_axis(am.lo.reshape(B, chunk, S), sidx, axis=2)
        hi, lo, jumps = _align_fwd_chunk_df(
            prev[0], prev[1], ams_hi, ams_lo, tdp_hi, tdp_lo,
            pos_valid, lens, thr_hi, thr_lo,
            jnp.asarray(ci * chunk, jnp.int32),
            tie_pruned=tie_pruned, use_pruning=use_pruning)
        prev = (hi, lo)
        jumps_chunks.append(jumps)

    fp = _final_pos_dev(prev[0], aut_len, tie_pruned=tie_pruned)
    cur = fp
    pos_chunks = [None] * n_chunks
    for ci in range(n_chunks - 1, -1, -1):
        cur, pos = _align_bwd_chunk(cur, jumps_chunks[ci], lens, fp,
                                    jnp.asarray(ci * chunk, jnp.int32))
        pos_chunks[ci] = pos
    pos_cat = (pos_chunks[0] if n_chunks == 1
               else jnp.concatenate(pos_chunks, axis=0))[:T]
    return _states_from_positions(pos_cat, states_tbl)
