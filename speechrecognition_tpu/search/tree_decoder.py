"""Lexical prefix-tree time-synchronous decoder (tree search).

JAX counterpart of the reference's tree decoders
(rwth-asr-0.5/src/Search/WordConditionedTreeSearch.cc, StateTree.cc and
the Teaching variant): the lexicon's word automata are merged into a
prefix tree over (tied-)state sequences, flattened into dense index
arrays. Because every tree node has a unique parent and grandparent, the
0-1-2 HMM recursion over the whole tree is three gathers:

    cost[n] = min(cost[n] + loop(n),
                  cost[parent(n)] + forward(n),
                  cost[grand(n)]  + skip(n)) + am[state(n)]

with word entries flowing from the previous frame's best word-end (the
book) through the virtual root. Word identity is only known at word-end
nodes, so the word penalty is charged at the *exit* (Sprint's exit TDP),
not at entry. On the SieTill lexicon (no shared prefixes) the tree is
exactly the linear search space, and transcripts must be identical to
the word-loop decoder — the regression test for the tree machinery.

The per-frame state is [B, num_nodes] — one dense vector per utterance,
scanned over time like the other decoders, with threshold pruning and
per-frame renormalization.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..lexicon import Lexicon
from ..tdp import TdpModel
from ..models import gmm as gmm_mod
from .decoder import BIG


@dataclass
class TreeTables:
    """Flattened prefix tree. Node 0 is the virtual root (non-emitting)."""

    state: np.ndarray        # int32 [N] acoustic state per node (0 for root)
    parent: np.ndarray       # int32 [N]
    grand: np.ndarray        # int32 [N]
    depth: np.ndarray        # int32 [N]
    tdp: np.ndarray          # f64 [N, 3] loop/forward/skip into each node
    loop_allowed: np.ndarray  # bool [N] (False at pure word-end leaves)
    end_word: np.ndarray     # int32 [N] word index ending here, −1 otherwise
    exit_penalty: np.ndarray  # f64 [N] word penalty charged at the word end
    num_nodes: int
    num_words: int
    end_node: Optional[np.ndarray] = None  # int32 [W] end node per word
                                           # (homophones share a node)

    @staticmethod
    def build(lexicon: Lexicon, tdp_model: TdpModel, word_penalty,
              ) -> "TreeTables":
        W = lexicon.num_words
        if np.isscalar(word_penalty):
            wp_vec = np.where(np.arange(W) == lexicon.silence_idx,
                              0.0, float(word_penalty))
        else:
            wp_vec = np.asarray(word_penalty, np.float64)

        # build the trie over state sequences
        children: List[Dict[int, int]] = [{}]
        parent = [0]
        state = [0]
        depth = [0]
        end_word = [-1]
        end_node = np.zeros(W, np.int32)
        for w in range(W):
            seq = lexicon.get_automaton_for_word(w).states
            node = 0
            for s in seq:
                nxt = children[node].get(int(s))
                if nxt is None:
                    nxt = len(parent)
                    children[node][int(s)] = nxt
                    children.append({})
                    parent.append(node)
                    state.append(int(s))
                    depth.append(depth[node] + 1)
                    end_word.append(-1)
                node = nxt
            end_node[w] = node
            if end_word[node] != -1:
                # homophone: keep the smaller word index (reference word-end
                # ties resolve to the smallest word)
                end_word[node] = min(end_word[node], w)
            else:
                end_word[node] = w

        N = len(parent)
        parent_a = np.asarray(parent, np.int32)
        state_a = np.asarray(state, np.int32)
        depth_a = np.asarray(depth, np.int32)
        end_a = np.asarray(end_word, np.int32)
        grand_a = parent_a[parent_a]

        tdp = tdp_model.table_for_states(state_a)  # [N, 3]
        tdp[0] = BIG                              # nothing enters the root
        has_children = np.zeros(N, bool)
        has_children[[i for i, c in enumerate(children) if c]] = True
        # pure word-end leaves never loop/expand (Recognizer.cpp:131: a
        # hypothesis at its word's last state only crosses word boundaries)
        loop_allowed = has_children | (end_a < 0)
        loop_allowed[0] = False

        exit_pen = np.zeros(N, np.float64)
        mask = end_a >= 0
        exit_pen[mask] = wp_vec[end_a[mask]]
        return TreeTables(state=state_a, parent=parent_a, grand=grand_a,
                          depth=depth_a, tdp=tdp, loop_allowed=loop_allowed,
                          end_word=end_a, exit_penalty=exit_pen,
                          num_nodes=N, num_words=W, end_node=end_node)


@partial(jax.jit, static_argnames=("prune",))
def _tree_scan(am: jnp.ndarray, feat_len: jnp.ndarray,
               state: jnp.ndarray, parent: jnp.ndarray, grand: jnp.ndarray,
               depth: jnp.ndarray, tdp: jnp.ndarray, loop_allowed: jnp.ndarray,
               end_word: jnp.ndarray, exit_penalty: jnp.ndarray,
               am_threshold: jnp.ndarray, prune: bool = True):
    """am [B, T, S]. Returns per-frame book (score, word, bkp) [T, B]."""
    B, T, S = am.shape
    dtype = am.dtype
    N = state.shape[0]
    big = jnp.asarray(BIG, dtype)
    tdp = tdp.astype(dtype)
    exit_penalty = exit_penalty.astype(dtype)

    hyp0 = jnp.full((B, N), big, dtype)
    bkp0 = jnp.zeros((B, N), jnp.int32)
    book0 = jnp.zeros((B,), dtype)

    root_mask = jnp.arange(N) == 0
    d1 = depth == 1
    d2 = depth == 2
    is_end = end_word >= 0

    def step(carry, inputs):
        hyp, bkp, book_prev = carry
        am_t, t = inputs

        # predecessor costs through the tree; the root carries the book
        hyp_root = jnp.where(root_mask[None, :], book_prev[:, None], hyp)
        loop = jnp.where(loop_allowed[None, :], hyp + tdp[None, :, 0], big)
        fwd = hyp_root[:, parent] + tdp[None, :, 1]
        fwd = jnp.where(d1[None, :],
                        book_prev[:, None] + tdp[None, :, 1], fwd)
        skip = hyp_root[:, grand] + tdp[None, :, 2]
        skip = jnp.where(d2[None, :],
                         book_prev[:, None] + tdp[None, :, 2], skip)
        skip = jnp.where(d1[None, :], big, skip)

        # larger jumps win ties (matching the word-loop decoder)
        new, nbkp = skip, jnp.where(
            d2[None, :], (t - 1).astype(jnp.int32), bkp[:, grand])
        for c, b in ((fwd, jnp.where(d1[None, :], (t - 1).astype(jnp.int32),
                                     bkp[:, parent])),
                     (loop, bkp)):
            take = c < new
            new = jnp.where(take, c, new)
            nbkp = jnp.where(take, b, nbkp)
        new = new + am_t[:, state]
        new = new.at[:, 0].set(big)
        new = jnp.minimum(new, big)

        best = new.min(axis=1, keepdims=True)
        best = jnp.where(best >= big * 0.5, 0.0, best)
        new = jnp.where(new >= big * 0.5, big, new - best)
        if prune:
            new = jnp.where(new > am_threshold, big, new)

        # word-end recombination: exit penalty charged here
        end_scores = jnp.where(is_end[None, :], new + exit_penalty[None, :], big)
        order = jnp.argmin(end_scores, axis=1)
        book_score = jnp.take_along_axis(end_scores, order[:, None], axis=1)[:, 0]
        book_word = end_word[order].astype(jnp.int32)
        book_bkp = jnp.take_along_axis(nbkp, order[:, None], axis=1)[:, 0]
        book_score = jnp.where(book_score >= big * 0.5, big, book_score)

        alive = (t <= feat_len)
        hyp_out = jnp.where(alive[:, None], new, hyp)
        bkp_out = jnp.where(alive[:, None], nbkp, bkp)
        book_out = jnp.where(alive, book_score, book_prev)
        return (hyp_out, bkp_out, book_out), (book_score, book_word, book_bkp)

    _, (scores, words, bkps) = jax.lax.scan(
        step, (hyp0, bkp0, book0),
        (jnp.moveaxis(am, 1, 0), jnp.arange(1, T + 1)))
    return scores, words, bkps


def decode_batch_tree(pack: gmm_mod.ScorePack, feats: np.ndarray,
                      feat_len: np.ndarray, tables: TreeTables,
                      am_threshold: float, silence_idx: int,
                      prune: bool = True, dtype=jnp.float32,
                      am=None) -> List[List[int]]:
    """Tree decode → word sequences (silence removed). `am` may be passed
    to reuse precomputed [B, T, S] acoustic scores (e.g. NN hybrid)."""
    B, T, dim = feats.shape
    if am is None:
        flat = jnp.asarray(feats.reshape(B * T, dim))
        am = gmm_mod.am_scores(pack, flat).reshape(B, T, pack.num_mixtures)
    am = am.astype(dtype)
    scores, words, bkps = _tree_scan(
        am, jnp.asarray(feat_len, jnp.int32),
        jnp.asarray(tables.state), jnp.asarray(tables.parent),
        jnp.asarray(tables.grand), jnp.asarray(tables.depth),
        jnp.asarray(tables.tdp), jnp.asarray(tables.loop_allowed),
        jnp.asarray(tables.end_word), jnp.asarray(tables.exit_penalty),
        jnp.asarray(am_threshold, dtype), prune=prune)
    words_np = np.asarray(words)
    bkps_np = np.asarray(bkps)
    out: List[List[int]] = []
    for b in range(B):
        t = int(feat_len[b])
        seq: List[int] = []
        while t > 0:
            w = int(words_np[t - 1, b])
            if w != silence_idx:
                seq.append(w)
            t = int(bkps_np[t - 1, b])
        seq.reverse()
        out.append(seq)
    return out
