"""Word-conditioned tree search with bigram LM contexts and LM lookahead.

JAX counterpart of the reference's production decoder
(rwth-asr-0.5/src/Search/WordConditionedTreeSearch.cc + StateTree.cc +
LanguageModelLookahead.cc, and the Teaching skeleton
Teaching/WordConditionedTreeSearch.cc:262-345,590-810): one copy of the
lexical prefix tree per predecessor-word context, with the bigram LM score
applied when a word END is reached (word identity is only known at the
tree leaf), and exact recombination over predecessors into a per-word book.

Dense formulation: hypotheses live in a [B, C, N] tensor (C = W + 1
contexts: every word plus the virtual sentence start, N = prefix-tree
nodes).  Per frame, one scan step does

    tree copy c:  0-1-2 max-plus recursion through parent/grand gathers;
                  word entries into depth-1/2 nodes from book_prev[b, c]
                  (first state's emission charged for both entry depths —
                  the reference's expansion quirk, Recognizer.cpp:133-158)
    word ends:    cand[b, c, w] = hyp[b, c, end_node[w]] + lm_ext[c, w]
                  book[b, w]    = min_c cand[b, c, w]       (recombination)

which is the reference's bigramRecombination over tree-copy word ends
(Teaching/WordConditionedTreeSearch.cc:919-956 skeleton; LinearSearch.cc:
211-436 is the complete semantics), vectorized over batch and contexts.

LM lookahead (Search/LanguageModelLookahead.cc): each tree node n is
assigned the anticipated LM score  la[c, n] = min over words reachable
below n of lm_ext[c, w].  The lookahead structure is *compressed* the way
the reference compresses it: nodes with identical reachable-word sets
share a lookahead id (nodeId_ mapping), and an optional cutoff depth maps
deep nodes to their ancestor's id (paramTreeCutoff).  Lookahead scores are
added only inside the pruning decision (anticipated score vs anticipated
best), never to the carried path scores — the reference's semantics, which
keeps the search exact when the beam is wide.

Unlike search/ngram_decoder.py (LinearSearch: LM charged at word ENTRY,
per-word copies of a linear lexicon), this decoder shares prefixes across
words, so in-flight scores differ by the LM amount until the leaf; on a
lexicon without whole-word prefixes the tracebacks are identical — a
tested invariant.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..models import gmm as gmm_mod
from ..tdp import TdpModel
from .decoder import BIG
from .histogram import DEFAULT_BINS, histogram_prune
from .tree_decoder import TreeTables


def extend_lm(lm: np.ndarray, lm_start: np.ndarray) -> np.ndarray:
    """[W, W] bigram matrix + [W] start row → [W+1, W] context-extended
    matrix (last row = virtual sentence-start context)."""
    return np.concatenate([np.asarray(lm, np.float64),
                           np.asarray(lm_start, np.float64)[None, :]], axis=0)


def build_entry_tables(tables: TreeTables, tdp_model):
    """Word-entry tables: entries reach depth-1 nodes (jump 1) and depth-2
    nodes (jump 2), each charging the ENTERED node's own emission.

    (For the SieTill lexicon this equals the reference's first-state
    charge bit-for-bit — repetitions make depth-1/2 nodes share a state,
    Recognizer.cpp:135-151 scores `am_cache[first_state]` for both init
    states. For repetition-1 lexica the skip entry lands in a different
    state and must pay that state's emission: charging the parent's here
    made the round-4 WCTS miss the true optimum on 2/130 AN4 utterances,
    caught by the linear_lvcsr/restricted-path A/B.)

    ``tdp_model`` may also be a Sprint TransitionModel (sprint/am.py):
    entries then charge the entry-m1 forward/skip TDPs regardless of the
    target state's type (Am/TransitionModel.cc entry handling,
    Am/TransitionModel.hh:64-76), scaled by the model's tdp scale."""
    N = tables.num_nodes
    entry_state = tables.state.copy()
    entry_pen = np.full(N, float(BIG))
    if hasattr(tdp_model, "entry_m1"):  # Sprint TransitionModel
        scale = getattr(tdp_model, "scale", 1.0)

        def clean(v: float) -> float:
            return float(BIG) if not np.isfinite(v) else scale * float(v)

        for n in range(N):
            d = int(tables.depth[n])
            if d == 1:
                entry_pen[n] = clean(tdp_model.entry_m1.forward)
            elif d == 2:
                entry_pen[n] = clean(tdp_model.entry_m1.skip)
        return entry_state.astype(np.int32), entry_pen
    for n in range(N):
        d = int(tables.depth[n])
        if d == 1:
            entry_pen[n] = tdp_model.score(int(tables.state[n]), 1)
        elif d == 2:
            entry_pen[n] = tdp_model.score(int(tables.state[tables.parent[n]]), 2)
    return entry_state.astype(np.int32), entry_pen


@dataclass
class LookaheadTables:
    """Compressed LM-lookahead structure (Search/LanguageModelLookahead.cc:
    buildCompressesLookaheadStructure + computeScores)."""

    node_id: np.ndarray      # int32 [N] tree node → lookahead id
    word_sets: np.ndarray    # bool [U, W] reachable words per lookahead id
    num_tables: int          # U (compressed entries, reference nEntries_)

    @staticmethod
    def build(tables: TreeTables, cutoff_depth: Optional[int] = None,
              ) -> "LookaheadTables":
        N, W = tables.num_nodes, tables.num_words
        parent = tables.parent
        reach = np.zeros((N, W), bool)
        for w in range(W):
            n = int(tables.end_node[w])
            while n != 0:
                reach[n, w] = True
                n = int(parent[n])
        reach[0, :] = True   # root anticipates every word

        if cutoff_depth is not None:
            # nodes deeper than the cutoff share their ancestor's table
            anc = np.arange(N)
            depth = tables.depth.copy()
            while (depth > cutoff_depth).any():
                deep = depth > cutoff_depth
                anc[deep] = parent[anc[deep]]
                depth[deep] -= 1
            reach = reach[anc]

        word_sets, node_id = np.unique(reach, axis=0, return_inverse=True)
        return LookaheadTables(node_id=node_id.astype(np.int32),
                               word_sets=word_sets,
                               num_tables=word_sets.shape[0])

    def scores(self, lm_ext: np.ndarray) -> np.ndarray:
        """Per-context lookahead scores la[c, n] = min_{w below n} lm_ext[c, w]
        (the reference computes one ContextLookahead table per LM history;
        here all C contexts are materialized at once for the dense scan)."""
        masked = np.where(self.word_sets[None, :, :],
                          np.asarray(lm_ext, np.float64)[:, None, :], BIG)
        la_u = masked.min(axis=2)                 # [C, U]
        return la_u[:, self.node_id]              # [C, N]


@partial(jax.jit, static_argnames=("prune", "use_lookahead", "state_limit",
                                   "histogram_bins", "emit_ends",
                                   "emit_stats", "transparent_silence"))
def _wcts_scan(am: jnp.ndarray, feat_len: jnp.ndarray,
               state: jnp.ndarray, parent: jnp.ndarray, grand: jnp.ndarray,
               tdp: jnp.ndarray, loop_allowed: jnp.ndarray,
               entry_state: jnp.ndarray, entry_pen: jnp.ndarray,
               end_node: jnp.ndarray, lm_ext: jnp.ndarray, la: jnp.ndarray,
               am_threshold: jnp.ndarray, prune: bool = True,
               use_lookahead: bool = False, state_limit: int = 0,
               histogram_bins: int = 0, emit_ends: bool = False,
               emit_stats: bool = False, transparent_silence: int = -1,
               carry_in=None, t0: jnp.ndarray = None):
    """am [B, T, S]; lm_ext [C, W] (last context row = sentence start);
    la [C, N] lookahead scores (ignored unless use_lookahead).
    Returns per-frame (book [T,B,W], bkp [T,B,W], pred [T,B,W],
    offset [T,B]) — offset is the per-frame renormalization subtraction
    (cumulate to recover absolute scores). With ``emit_ends`` two more
    outputs follow: the pre-recombination per-context word-end books
    cand [T,B,C,W] and their boundary frames [T,B,C,W] — every surviving
    (predecessor, word, end-frame) hypothesis, i.e. the raw material of a
    search-derived lattice with exact arc scores
    (Lattice/Lattice.hh word boundaries; Flf lattice generation).
    pred == C−1 marks entries from the virtual start.

    ``transparent_silence`` >= 0 names the silence word: its word ends
    then do NOT become a recombination context — a silence ending inside
    tree copy c re-opens context c, so the LM history passes through
    silence unchanged (the reference's per-word silence copies,
    Teaching/LinearSearch.cc:211-436 / the Bliss lexicon's empty
    syntactic-token silence lemma). lm_ext[:, silence] should then hold
    only the silence exit cost (no LM score). Two extra per-frame outputs
    follow everything else: via_sil [T,B,C] (this frame's entries into
    context c came from a silence end, not the word-c book) and
    sil_bkp [T,B,C] (that silence's own entry boundary) — consumed by
    the transparent-silence traceback in decode_batch_wcts."""
    B, T, S = am.shape
    dtype = am.dtype
    C, W = lm_ext.shape
    N = state.shape[0]
    big = jnp.asarray(BIG, dtype)
    tdp = tdp.astype(dtype)
    entry_pen = entry_pen.astype(dtype)
    lm_ext = lm_ext.astype(dtype)
    la = la.astype(dtype)
    transparent = transparent_silence >= 0

    # chunked/streaming decoding: carry_in/t0 continue a previous chunk's
    # lattice state with one compiled (B, T) shape (search/online.py),
    # exactly like the word-loop scan's carries (decoder._decode_scan)
    if carry_in is not None:
        hyp0, bkp0, book0, silp0, silb0 = carry_in
    else:
        hyp0 = jnp.full((B, C, N), big, dtype)
        bkp0 = jnp.zeros((B, C, N), jnp.int32)
        book0 = jnp.full((B, W), big, dtype)
        silp0 = jnp.full((B, C), big, dtype)
        silb0 = jnp.zeros((B, C), jnp.int32)
    if t0 is None:
        t0 = jnp.asarray(0, jnp.int32)

    def step(carry, inputs):
        hyp, bkp, book_prev, silp, silb = carry
        am_t, t = inputs

        # entry scores per context: ended words carry their book; the
        # virtual-start context is open only at the first frame
        start_col = jnp.where(t == 1, jnp.zeros((B, 1), dtype),
                              jnp.full((B, 1), big, dtype))
        ext = jnp.concatenate([book_prev, start_col], axis=1)   # [B, C]
        if transparent:
            # a silence that ended in tree c re-opens context c
            via_sil = silp < ext
            ext = jnp.minimum(ext, silp)

        # within-tree 0-1-2 recursion (node 0 = root stays at big, so
        # parent/grand gathers from the root contribute nothing here)
        loop = jnp.where(loop_allowed[None, None, :],
                         hyp + tdp[None, None, :, 0], big)
        fwd = hyp[:, :, parent] + tdp[None, None, :, 1]
        skip = hyp[:, :, grand] + tdp[None, None, :, 2]
        # larger jumps win ties (word-loop decoder semantics)
        within = skip
        wbkp = bkp[:, :, grand]
        for c, b in ((fwd, bkp[:, :, parent]), (loop, bkp)):
            take = c < within
            within = jnp.where(take, c, within)
            wbkp = jnp.where(take, b, wbkp)
        within = within + am_t[:, None, state]

        # word entries into depth-1/2 nodes; entries win ties
        entry = (ext[:, :, None] + entry_pen[None, None, :]
                 + am_t[:, None, entry_state])
        take_entry = entry <= within
        new = jnp.where(take_entry, entry, within)
        nbkp = jnp.where(take_entry, (t - 1).astype(jnp.int32), wbkp)
        new = new.at[:, :, 0].set(big)
        new = jnp.minimum(new, big)

        # per-frame renormalization + pruning (anticipated scores when
        # lookahead is on: LanguageModelLookahead semantics)
        best = new.min(axis=(1, 2), keepdims=True)
        best = jnp.where(best >= big * 0.5, 0.0, best)
        new = jnp.where(new >= big * 0.5, big, new - best)
        if prune:
            if use_lookahead:
                ant = jnp.where(new >= big * 0.5, big, new + la[None, :, :])
                ant_best = ant.min(axis=(1, 2), keepdims=True)
                ant_best = jnp.where(ant_best >= big * 0.5, 0.0, ant_best)
                ant_rel = jnp.where(ant >= big * 0.5, big, ant - ant_best)
                new = jnp.where(ant_rel > am_threshold, big, new)
                # histogram pruning must rank by *prospect* (score incl.
                # lookahead), like the reference
                # (Search/WordConditionedTreeSearch.cc:1256-1264)
                prune_scores = jnp.where(new >= big * 0.5, big, ant_rel)
            else:
                new = jnp.where(new > am_threshold, big, new)
                prune_scores = new
            if state_limit:
                # acoustic histogram pruning: tighten the beam to keep at
                # most ~state_limit hypotheses per utterance
                # (Search/WordConditionedTreeSearch.cc:1260-1264)
                keep, _ = jax.vmap(
                    lambda s, v: histogram_prune(
                        s, v, state_limit, jnp.asarray(0.0, dtype),
                        am_threshold.astype(dtype),
                        histogram_bins or DEFAULT_BINS))(
                    prune_scores.reshape(B, -1),
                    (prune_scores < big * 0.5).reshape(B, -1))
                new = jnp.where(keep.reshape(new.shape), new, big)

        # word-end recombination over predecessor contexts
        ends = new[:, :, end_node]                       # [B, C, W]
        cand = jnp.where(ends >= big * 0.5, big,
                         ends + lm_ext[None, :, :])      # [B, C, W]
        ends_bkp = nbkp[:, :, end_node]
        if transparent:
            # silence ends stay per-context (they re-open their own
            # context next frame) and never recombine into a context row
            sil_new = cand[:, :, transparent_silence]     # [B, C]
            silb_new = ends_bkp[:, :, transparent_silence]
            cand = cand.at[:, :, transparent_silence].set(big)
        pred_new = jnp.argmin(cand, axis=1).astype(jnp.int32)
        book_new = jnp.take_along_axis(cand, pred_new[:, None, :], axis=1)[:, 0]
        book_bkp = jnp.take_along_axis(ends_bkp, pred_new[:, None, :],
                                       axis=1)[:, 0]
        book_new = jnp.where(book_new >= big * 0.5, big, book_new)

        alive = (t <= feat_len)
        hyp_out = jnp.where(alive[:, None, None], new, hyp)
        bkp_out = jnp.where(alive[:, None, None], nbkp, bkp)
        book_out = jnp.where(alive[:, None], book_new, book_prev)
        if transparent:
            silp_out = jnp.where(alive[:, None], sil_new, silp)
            silb_out = jnp.where(alive[:, None], silb_new, silb)
        else:
            silp_out, silb_out = silp, silb
        outs = (book_new, book_bkp, pred_new, best[:, 0, 0])
        if emit_ends:
            outs = outs + (cand, ends_bkp)
        if emit_stats:
            # post-pruning search-space occupancy, the reference's
            # statistics channel ("states before/after pruning", "active
            # trees" — Search/WordConditionedTreeSearch.cc logStatistics)
            live = new < big * 0.5                        # [B, C, N]
            live = live & alive[:, None, None]
            outs = outs + (live.sum(axis=(1, 2)).astype(jnp.int32),
                           live.any(axis=2).sum(axis=1).astype(jnp.int32),
                           (book_new < big * 0.5).sum(axis=1)
                           .astype(jnp.int32) * alive.astype(jnp.int32))
        if transparent:
            # via_sil/silb resolve entry chains (previous frame's silence);
            # silp_out/silb_out expose this frame's per-context silence
            # ends for the final-frame "utterance ends in silence" case
            outs = outs + (via_sil, silb, silp_out, silb_out)
        return (hyp_out, bkp_out, book_out, silp_out, silb_out), outs

    carry_out, outs = jax.lax.scan(
        step, (hyp0, bkp0, book0, silp0, silb0),
        (jnp.moveaxis(am, 1, 0), t0 + jnp.arange(1, T + 1)))
    return carry_out, outs


def decode_batch_wcts(pack: gmm_mod.ScorePack, feats: np.ndarray,
                      feat_len: np.ndarray, tables: TreeTables,
                      tdp_model: TdpModel,
                      lm_matrix: np.ndarray, lm_start: np.ndarray,
                      am_threshold: float, silence_idx: int,
                      prune: bool = True,
                      lookahead: Optional[LookaheadTables] = None,
                      state_limit: int = 0,
                      histogram_bins: int = DEFAULT_BINS,
                      dtype=jnp.float32, emit_lattice: bool = False,
                      emit_stats: bool = False,
                      transparent_silence: bool = False, am=None):
    """Word-conditioned tree decode → word sequences (silence removed).

    Build `tables` with word_penalty=0 — all word costs live in
    lm_matrix/lm_start (−log p; fold silence exemptions and word penalties
    there, exactly as for search/ngram_decoder.decode_batch_bigram).

    With ``emit_lattice`` returns (hyps, [ContextLattice per utterance]):
    search-derived word lattices holding every surviving (predecessor,
    word, boundary) hypothesis with exact arc scores.

    With ``emit_stats`` returns (hyps, stats): per-frame search-space
    occupancy {active_states [T,B], active_trees [T,B], word_ends [T,B]}
    — the reference's statistics channel quantities
    (Search/WordConditionedTreeSearch.cc logStatistics).

    With ``transparent_silence`` the LM history passes through silence
    unchanged (the reference's semantics: silence has no syntactic token,
    LinearSearch keeps per-word silence copies). lm_matrix[:, silence]
    should then hold only the silence exit cost; a silence that ends in
    tree copy c re-opens context c, and the final best may end in a
    silence (checked against the per-context silence books).

    ``am`` may carry precomputed [B, T, S] acoustic scores (pack unused)."""
    B, T, dim = feats.shape
    lm_ext = extend_lm(lm_matrix, lm_start)
    C = lm_ext.shape[0]
    entry_state, entry_pen = build_entry_tables(tables, tdp_model)
    if lookahead is not None:
        la = lookahead.scores(lm_ext)
    else:
        la = np.zeros((C, tables.num_nodes))
    if am is None:
        flat = jnp.asarray(feats.reshape(B * T, dim))
        am = gmm_mod.am_scores(pack, flat).reshape(B, T, pack.num_mixtures)
    am = am.astype(dtype)
    _carry, outs = _wcts_scan(
        am, jnp.asarray(feat_len, jnp.int32),
        jnp.asarray(tables.state), jnp.asarray(tables.parent),
        jnp.asarray(tables.grand),
        jnp.asarray(tables.tdp), jnp.asarray(tables.loop_allowed),
        jnp.asarray(entry_state), jnp.asarray(entry_pen),
        jnp.asarray(tables.end_node), jnp.asarray(lm_ext), jnp.asarray(la),
        jnp.asarray(am_threshold, dtype), prune=prune,
        use_lookahead=lookahead is not None,
        state_limit=state_limit, histogram_bins=histogram_bins,
        emit_ends=emit_lattice, emit_stats=emit_stats,
        transparent_silence=silence_idx if transparent_silence else -1)
    books_np = np.asarray(outs[0])   # [T, B, W]
    bkps_np = np.asarray(outs[1])
    preds_np = np.asarray(outs[2])
    if transparent_silence:
        via_np = np.asarray(outs[-4])       # [T, B, C]
        silb_np = np.asarray(outs[-3])      # [T, B, C]
        sil_book_np = np.asarray(outs[-2])  # [T, B, C]
        sil_bkp_np = np.asarray(outs[-1])   # [T, B, C]

    def _skip_silences(b: int, t: int, c: int) -> int:
        """Walk backwards through a chain of transparent silences ending
        at boundary frame t in context c; returns the frame where word c
        (or the virtual start) actually ended."""
        while t > 0 and via_np[t, b, c]:
            t = int(silb_np[t, b, c])
        return t

    out: List[List[int]] = []
    for b in range(B):
        t = int(feat_len[b])
        if t == 0:
            out.append([])
            continue
        seq: List[int] = []
        best_w = float(books_np[t - 1, b].min())
        if transparent_silence:
            # the utterance may END in a silence: the per-context silence
            # books at the final frame compete with the word books
            best_s = float(sil_book_np[t - 1, b].min())
            if min(best_w, best_s) >= BIG * 0.5:
                out.append([])
                continue
            if best_s < best_w:
                c = int(np.argmin(sil_book_np[t - 1, b]))
                t = _skip_silences(b, int(sil_bkp_np[t - 1, b, c]), c)
                w = c
            else:
                w = int(np.argmin(books_np[t - 1, b]))
        else:
            if best_w >= BIG * 0.5:
                out.append([])
                continue
            w = int(np.argmin(books_np[t - 1, b]))
        while t > 0 and w < C - 1:
            if w != silence_idx:
                seq.append(w)
            t, c = int(bkps_np[t - 1, b, w]), int(preds_np[t - 1, b, w])
            if transparent_silence:
                t = _skip_silences(b, t, c)
            w = c
        seq.reverse()
        out.append(seq)
    if emit_stats:
        n_extra = 2 if emit_lattice else 0
        stats = {
            "active_states": np.asarray(outs[4 + n_extra]),   # [T, B]
            "active_trees": np.asarray(outs[5 + n_extra]),    # [T, B]
            "word_ends": np.asarray(outs[6 + n_extra]),       # [T, B]
        }
        if not emit_lattice:
            return out, stats
    if not emit_lattice:
        return out

    from .context_lattice import ContextLattice
    offsets_np = np.asarray(outs[3])        # [T, B]
    cands_np = np.asarray(outs[4])          # [T, B, C, W]
    ebkps_np = np.asarray(outs[5])
    lats = [ContextLattice.from_wcts(
        books_np[:, b], cands_np[:, b], ebkps_np[:, b], offsets_np[:, b],
        int(feat_len[b]), np.asarray(lm_ext), silence_idx)
        for b in range(B)]
    if emit_stats:
        return out, lats, stats
    return out, lats
