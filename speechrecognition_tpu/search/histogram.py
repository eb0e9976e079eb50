"""Histogram pruning: cap the number of active hypotheses per frame.

JAX realization of the reference's score histogram
(rwth-asr-0.5/src/Search/Histogram.hh:26-77) and its use for acoustic /
word-end histogram pruning in the production decoder
(Search/WordConditionedTreeSearch.cc:1256-1287): after beam (threshold)
pruning, if more than ``limit`` hypotheses survive, the pruning threshold
is tightened to the score quantile of the ``limit``-th best hypothesis,
computed from a fixed-bin histogram rather than a sort.

Semantics are matched exactly:
  * bin(s) = trunc((s − lower)·scale) clamped to the last bin, with
    scale = (bins − 1)/(upper − lower)            (Histogram.hh:32-39)
  * quantile(n) walks bins until the cumulative count reaches n and
    returns bin_index/scale + lower               (Histogram.hh:62-74)
  * pruning keeps hypotheses with score <= threshold
    (WordConditionedTreeSearch.cc:634 ``prospect <= threshold``)

Everything is fixed-shape and branch-free (``where`` masks), so it jits
into the per-frame decode scan: the bincount is one scatter-add, the
quantile one cumsum + argmax. No data-dependent shapes, no host sync.
"""

from __future__ import annotations

import jax.numpy as jnp

DEFAULT_BINS = 101  # paramAcousticPruningBins default ("number of bins", WCTS.cc:1051-1055)


def histogram_quantile(scores: jnp.ndarray, valid: jnp.ndarray,
                       lower, upper, n, bins: int = DEFAULT_BINS):
    """Score of the ``n``-th best valid hypothesis, histogram-quantized.

    scores: [...] float; valid: [...] bool mask of live hypotheses with
    lower <= score (invalid entries are ignored). Returns the LOWER edge
    of the first bin whose cumulative count reaches ``n``
    (Histogram.hh:69: ``return position(b)`` after ``s >= n``), exactly as
    the reference does — so the kept count #(scores <= t) can fall short
    of ``n`` by up to that bin's population (everything in the boundary
    bin above its lower edge is cut).
    """
    scores = scores.reshape(-1)
    valid = valid.reshape(-1)
    scale = (bins - 1) / jnp.maximum(upper - lower, 1e-30)
    idx = jnp.clip(((scores - lower) * scale).astype(jnp.int32), 0, bins - 1)
    counts = jnp.zeros((bins,), jnp.int32).at[idx].add(valid.astype(jnp.int32))
    cum = jnp.cumsum(counts)
    hit = cum >= n
    # first bin reaching n; if never reached, b = bins (reference loop end)
    b = jnp.where(jnp.any(hit), jnp.argmax(hit), bins)
    return b.astype(scores.dtype) / scale + lower


def histogram_prune(scores: jnp.ndarray, valid: jnp.ndarray, limit,
                    lower, upper, bins: int = DEFAULT_BINS):
    """Tighten a beam threshold to keep at most ~``limit`` hypotheses.

    Mirrors the production sequence (WordConditionedTreeSearch.cc:1256-1264):
    the caller has already beam-pruned at ``upper = lower + beam``; when the
    surviving count exceeds ``limit`` (and the beam is non-degenerate), the
    threshold drops to the histogram quantile. Returns (keep_mask,
    threshold); keep is ``valid & (scores <= threshold)``.
    """
    count = valid.sum()
    q = histogram_quantile(scores, valid, lower, upper, limit, bins)
    thr = jnp.where((count > limit) & (lower < upper), q,
                    jnp.asarray(upper, scores.dtype))
    return valid & (scores <= thr), thr
