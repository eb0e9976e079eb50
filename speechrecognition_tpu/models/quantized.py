"""Int8 quantized batch scoring + density preselection.

Counterpart of the reference's SIMD batch feature scorers
(rwth-asr-0.5/src/Mm/BatchFeatureScorer.hh:199-333 —
`BatchIntFeatureScorer` / `BatchPreselectionIntFeatureScorer`,
registered as the `SIMD-diagonal-maximum` scorer the AN4 recognition
config actually uses, Mm/Module.cc:84) and of the density-preselection
clustering (Mm/DensityClustering.{hh,cc,tcc}).

Reference semantics kept exactly:
  * requires a GLOBALLY POOLED diagonal covariance
    (BatchFeatureScorer.cc:399 criticalError) and max-approx scoring;
  * preprocessing: mean' = mean · invsqrt(var) · scale, quantized to one
    byte with round-to-nearest and clipping (Mm/Utilities.hh:144-158);
    features quantized the same way per frame;
  * scale = span(u8) / (1.25 · 2·max|mean'|)   (quantizationScale,
    BatchFeatureScorer.cc:375-396);
  * integer distance d = Σ (qx − qm)², score = (d + c) / (2·scale²)
    with c = ⌊scale²·logNorm − 2·scale²·log w⌋ (init, :413-436), min
    over densities taken in INTEGER space exactly like the SSE kernel
    (fillScoreCacheTpl :489-531);
  * preselection: k-means (5 Lloyd iterations, deterministic init) over
    the QUANTIZED means, integer distances; per frame the `nSelected`
    closest of `nClusters` cluster centers are selected and only
    densities in selected clusters are scored — the rest read the
    backoff score (DensityClustering.tcc selectClusters; defaults
    clusters=256, select-clusters=32, backoff-score=40000,
    DensityClustering.cc:18-29).

The device mapping: the reference's u8 values carry a +128 offset that
cancels in the |qx − qm| difference, so int8 (offset-free) tables give
the SAME integer distances through an s8×s8→s32 integer matmul:

    d[N,J] = Σqx² [N,1] − 2·(qx · qmᵀ)[N,J] + Σqm² [1,J]

one int8 matmul per frame block. Cluster selection is a second (tiny)
integer matmul + top-k; unselected densities are masked to the backoff
AFTER the dense matmul — same scores as the reference's skip-loop, in
the form the hardware wants (dense compute + mask beats gather at these
codebook sizes; the win the reference gets from *skipping* we get from
int8 matmul throughput and halved memory traffic).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

INT_MAX = np.int32(2147483647)
#: sentinel for inactive/unselected densities: large enough to lose every
#: min, small enough that adding the max possible integer distance
#: (dim·255² ≈ 3e6) cannot overflow int32
INACTIVE_INT = np.int32(1 << 30)

#: reference defaults (DensityClustering.cc:18-29)
NUM_CLUSTERS = 256
SELECT_CLUSTERS = 32
CLUSTER_ITERATIONS = 5
BACKOFF_SCORE = 40000.0


def _quantize(x: np.ndarray) -> np.ndarray:
    """round-to-nearest + clip to int8 (Mm/Utilities.hh quantize<>,
    minus the u8 +128 offset which cancels in distances)."""
    return np.clip(np.round(x), -128, 127).astype(np.int8)


@dataclass
class QuantPack:
    """Device tables for the int8 max-approx scorer."""

    qmeans: jnp.ndarray        # int8 [J, dim]
    qmeans_sq: jnp.ndarray     # int32 [J]  Σ qm²
    consts: jnp.ndarray        # int32 [J]  ⌊scale²·logNorm − 2scale²·logw⌋
    inv_sqrt_var: jnp.ndarray  # f32 [dim]  scale · invsqrt(pooled var)
    scale2x: float             # 2·scale²  (reference scale_)
    active: jnp.ndarray        # bool [S, D] real (non-padding) densities
    num_mixtures: int
    density_cap: int
    dim: int
    #: preselection tables (None → AllDensitySelector, no preselection)
    qcenters: Optional[jnp.ndarray] = None      # int8 [C, dim]
    qcenters_sq: Optional[jnp.ndarray] = None   # int32 [C]
    cluster_of: Optional[jnp.ndarray] = None    # int32 [S·D] (padded → 0)
    n_selected: int = SELECT_CLUSTERS
    backoff: float = BACKOFF_SCORE


jax.tree_util.register_pytree_node(
    QuantPack,
    lambda p: ((p.qmeans, p.qmeans_sq, p.consts, p.inv_sqrt_var, p.active,
                p.qcenters, p.qcenters_sq, p.cluster_of),
               (p.scale2x, p.num_mixtures, p.density_cap, p.dim,
                p.n_selected, p.backoff)),
    lambda aux, ch: QuantPack(
        qmeans=ch[0], qmeans_sq=ch[1], consts=ch[2], inv_sqrt_var=ch[3],
        active=ch[4], qcenters=ch[5], qcenters_sq=ch[6], cluster_of=ch[7],
        scale2x=aux[0], num_mixtures=aux[1], density_cap=aux[2],
        dim=aux[3], n_selected=aux[4], backoff=aux[5]))


def _pooled_tables(model) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray, float]:
    """Extract (means [J,dim], logw [J], active [S,D], invsqrt pooled
    var [dim], logNorm) from a MixtureModel laid out like
    MixtureModel.pack (mixture-major, padded to density_cap)."""
    from .gmm import VarianceModel

    if model.var_model != VarianceModel.GLOBAL_POOLING:
        raise ValueError(
            "quantized scorer supports only globally pooled variance "
            "(the reference's BatchFeatureScorer.cc:399 contract)")
    if not model.max_approx:
        raise ValueError("quantized scorer is max-approx only "
                         "(BatchFeatureScorer.hh:283)")
    S = model.num_mixtures
    D = model.max_densities_per_mixture
    dim = model.dim
    var = np.asarray(model.vars[0], np.float64)     # global var_idx == 0
    isv = 1.0 / np.sqrt(var)
    # logNormalizationFactor = Σ log 2πσ² == 2 · the pack's half-norm
    log_norm = 2.0 * float(model.norm[0])
    means = np.zeros((S * D, dim), np.float64)
    logw = np.full(S * D, -1e30, np.float64)
    active = np.zeros((S, D), bool)
    for s in range(S):
        for d, (mi, vi) in enumerate(model.mixtures[s]):
            if vi != 0:
                raise ValueError("global pooling expects var index 0 "
                                 f"(mixture {s} density {d} has {vi})")
            mu = model.means[mi]
            lw = model.mean_weights_log[mi]
            if not (np.isfinite(mu).all() and np.isfinite(lw)):
                continue        # zero-count density (inactive, like pack())
            means[s * D + d] = mu
            logw[s * D + d] = lw
            active[s, d] = True
    return means, logw, active, isv, log_norm


def build_quant_pack(model, preselection: bool = False,
                     num_clusters: int = NUM_CLUSTERS,
                     n_selected: int = SELECT_CLUSTERS,
                     iterations: int = CLUSTER_ITERATIONS,
                     backoff: float = BACKOFF_SCORE,
                     seed: int = 1) -> QuantPack:
    """MixtureModel (global pooling, max-approx) → QuantPack.

    `seed` mirrors the reference's srand(1) deterministic cluster
    initialization (DensityClustering.tcc initializeClusters) — same
    algorithm, portable RNG instead of C rand()."""
    means, logw, active, isv, log_norm = _pooled_tables(model)
    S, D = active.shape
    dim = means.shape[1]

    # quantizationScale (BatchFeatureScorer.cc:375-396)
    divided = means * isv[None, :]
    real = active.reshape(-1)
    maxabs = float(np.abs(divided[real]).max()) if real.any() else 1.0
    scale = 255.0 / (1.25 * 2.0 * maxabs)
    scale2x = 2.0 * scale * scale

    qmeans = _quantize(divided * scale)
    qmeans[~real] = 0
    consts = np.full(logw.shape, np.int64(INACTIVE_INT), np.int64)
    consts[real] = np.floor(scale * scale * log_norm
                            - scale2x * logw[real]).astype(np.int64)
    consts = np.clip(consts, -2 ** 31, 2 ** 31 - 1).astype(np.int32)

    qcenters = qcenters_sq = cluster_of = None
    if preselection:
        C = min(num_clusters, int(real.sum()))
        centers, assign = _kmeans_int(qmeans[real].astype(np.int32),
                                      C, iterations, seed)
        cl = np.zeros(S * D, np.int32)
        cl[real] = assign
        qcenters = jnp.asarray(_quantize(centers))
        qcenters_sq = jnp.asarray(
            (centers.astype(np.int64) ** 2).sum(1).astype(np.int32))
        cluster_of = jnp.asarray(cl)

    qm = qmeans.astype(np.int32)
    return QuantPack(
        qmeans=jnp.asarray(qmeans),
        qmeans_sq=jnp.asarray((qm * qm).sum(1).astype(np.int32)),
        consts=jnp.asarray(consts),
        inv_sqrt_var=jnp.asarray(isv * scale, jnp.float32),
        scale2x=scale2x,
        active=jnp.asarray(active),
        num_mixtures=S, density_cap=D, dim=dim,
        qcenters=qcenters, qcenters_sq=qcenters_sq, cluster_of=cluster_of,
        n_selected=min(n_selected, num_clusters), backoff=backoff)


def _kmeans_int(points: np.ndarray, C: int, iterations: int, seed: int,
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd k-means over integer points (the reference clusters the
    QUANTIZED means with integer distances,
    BatchPreselectionIntFeatureScorer / DensityClustering<u8, u32>).
    Deterministic: distinct random points as initial centers."""
    n = points.shape[0]
    rng = np.random.RandomState(seed)
    init = rng.permutation(n)[:C]
    centers = points[init].astype(np.float64)
    assign = np.zeros(n, np.int32)
    for _ in range(iterations):
        d = ((points[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        assign = d.argmin(1).astype(np.int32)
        for c in range(C):
            sel = assign == c
            if sel.any():
                centers[c] = points[sel].mean(0)
    return np.round(centers), assign


def quantize_features(pack: QuantPack, feats: jnp.ndarray) -> jnp.ndarray:
    """f32 [N, dim] → int8 [N, dim] (setFeature: multiply by
    scale·invsqrt(var), round, clip)."""
    x = feats.astype(jnp.float32) * pack.inv_sqrt_var[None, :]
    return jnp.clip(jnp.round(x), -128, 127).astype(jnp.int8)


def quantized_distances(pack: QuantPack, qx: jnp.ndarray) -> jnp.ndarray:
    """int8 [N, dim] → int32 [N, J] exact integer distances
    Σ (qx − qm)² via one s8×s8→s32 matmul."""
    xi = qx.astype(jnp.int32)
    xx = (xi * xi).sum(axis=1, dtype=jnp.int32)                  # [N]
    cross = jax.lax.dot_general(
        qx, pack.qmeans.T, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)                        # [N, J]
    return xx[:, None] - 2 * cross + pack.qmeans_sq[None, :]


def _select_mask(pack: QuantPack, qx: jnp.ndarray) -> jnp.ndarray:
    """bool [N, J]: densities whose cluster is among the n_selected
    closest centers for each frame (selectClusters)."""
    xi = qx.astype(jnp.int32)
    xx = (xi * xi).sum(axis=1, dtype=jnp.int32)
    cross = jax.lax.dot_general(
        qx, pack.qcenters.T, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)                        # [N, C]
    cd = xx[:, None] - 2 * cross + pack.qcenters_sq[None, :]
    # n_selected closest: threshold at the k-th smallest distance;
    # ties beyond k admit extra clusters (a superset of the reference's
    # sort-based pick — only ADDS exactly-scored densities, never drops)
    kth = -jax.lax.top_k(-cd, pack.n_selected)[0][:, -1]         # [N]
    sel = cd <= kth[:, None]                                     # [N, C]
    return jnp.take_along_axis(
        sel, pack.cluster_of[None, :], axis=1)                   # [N, J]


def am_scores_q(pack: QuantPack, feats: jnp.ndarray) -> jnp.ndarray:
    """f32 [N, dim] → f32 [N, S] max-approx state scores.

    Integer min over densities exactly like the SSE loop, THEN the
    single float division by 2·scale² (fillScoreCacheTpl:529-531)."""
    qx = quantize_features(pack, feats)
    d = quantized_distances(pack, qx)
    total = d + pack.consts[None, :]
    if pack.qcenters is not None:
        sel = _select_mask(pack, qx)
        total = jnp.where(sel, total, INACTIVE_INT)
    N = feats.shape[0]
    best = total.reshape(N, pack.num_mixtures, pack.density_cap).min(-1)
    scores = best.astype(jnp.float32) / jnp.float32(pack.scale2x)
    if pack.qcenters is not None:
        # a state whose every density fell outside the selected clusters
        # reads the backoff score (DensityClustering backoffScore_)
        scores = jnp.where(best >= INACTIVE_INT,
                           jnp.float32(pack.backoff), scores)
    return scores


def am_scores_q_chunked(pack: QuantPack, feats: jnp.ndarray,
                        chunk: int = 1 << 15) -> jnp.ndarray:
    """Chunked wrapper mirroring gmm.am_scores' memory bound."""
    N = feats.shape[0]
    if N <= chunk:
        return am_scores_q(pack, feats)
    pad = (-N) % chunk
    fp = jnp.pad(feats, ((0, pad), (0, 0)))
    out = jax.lax.map(lambda x: am_scores_q(pack, x),
                      fp.reshape(-1, chunk, feats.shape[1]))
    return out.reshape(-1, pack.num_mixtures)[:N]
