"""Diagonal-covariance GMM acoustic model with EM training.

Design: the *bookkeeping* (density lists, split/eliminate, finalization)
lives on the host in float64 and mirrors the reference exactly
(src/sietill/Mixtures.cpp) — it touches at most a few thousand numbers.
The *compute* (per-frame density scoring and sufficient statistics over
millions of frames) runs on the device as one matmul:

    score[t, (s,d)] = ½·Σᵢ(xᵢ−μᵢ)²/σᵢ² + norm − log w
                    = [x², x, 1]ₜ · P[:, (s,d)]

with P packing the quadratic expansion, densities padded to a per-model
capacity D and inactive slots masked by a large constant. Sufficient
statistics come back as dense [S, D(, dim)] arrays via segment-sums.

Score semantics match Mixtures.cpp:590-744: score = norm + ½·Mahalanobis
− log w; mixture score is the min over densities clipped at 1e10
(max-approx, ::696-713) or −log Σ exp(−score) (sum, ::719-728).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..config import Configuration
from ..io import RawMixtureSet

MIN_SCORE_INIT = 1e10      # Mixtures.cpp:699
INACTIVE_SCORE = 5e17      # sentinel for padded density slots (f32-safe, < inf)
MIN_VARIANCE = 1e-4        # Mixtures.cpp:167 (var accumulator floor)
MEMBERSHIP_EPS = 1e-8      # Mixtures.cpp:336


class VarianceModel(enum.Enum):
    GLOBAL_POOLING = "global"
    MIXTURE_POOLING = "mixture"
    NO_POOLING = "none"

    @staticmethod
    def from_string(s: str) -> "VarianceModel":
        for v in VarianceModel:
            if v.value == s:
                return v
        raise ValueError(f"invalid pooling option: {s}")


@dataclass
class ScorePack:
    """Device-side packed scoring tables for one model snapshot: the
    quadratic expansion [x², x, 1] · P as one matmul. In float32 it loses
    ~1e-3 to cancellation (fine for training E-steps); decode paths that
    must reproduce the reference's double-precision decisions use float64
    or the double-float ScorePackDF.
    """

    P: jnp.ndarray            # f32/f64 [2·dim+1, S·D] quadratic-expansion matrix
    active: jnp.ndarray       # bool [S, D]
    num_mixtures: int
    density_cap: int
    dim: int
    max_approx: bool
    dtype: jnp.dtype

    def features_expanded(self, x: jnp.ndarray) -> jnp.ndarray:
        """[N, dim] → [N, 2·dim+1] = [x², x, 1]."""
        ones = jnp.ones((*x.shape[:-1], 1), dtype=x.dtype)
        return jnp.concatenate([x * x, x, ones], axis=-1)


@dataclass
class ScorePackDF:
    """Double-float (two-f32) scoring tables: the f32-only stand-in for
    the reference's float64 accumulation (Mixtures.cpp:590-628) — ~49
    effective mantissa bits with every device op in f32.

    Fields are DF pairs from ops/doublefloat.py; ``mu``/``iv`` are the raw
    means and inverse variances (NOT pre-halved: the reference multiplies
    by vars_inv_ and halves the final sum, density_score_sse
    Mixtures.cpp:645-690 — we keep the same operation order)."""

    mu: "object"              # DF [S·D, dim]
    iv: "object"              # DF [S·D, dim]
    norm: "object"            # DF [S·D]
    logw: "object"            # DF [S·D]
    active: jnp.ndarray       # bool [S, D]
    num_mixtures: int
    density_cap: int
    dim: int
    max_approx: bool


# pytree registrations so packs flow through jax.jit (arrays as leaves,
# the shape/config metadata as static aux data)
jax.tree_util.register_pytree_node(
    ScorePack,
    lambda p: ((p.P, p.active),
               (p.num_mixtures, p.density_cap, p.dim, p.max_approx,
                p.dtype)),
    lambda aux, ch: ScorePack(P=ch[0], active=ch[1], num_mixtures=aux[0],
                              density_cap=aux[1], dim=aux[2],
                              max_approx=aux[3], dtype=aux[4]))


jax.tree_util.register_pytree_node(
    ScorePackDF,
    lambda p: ((p.mu, p.iv, p.norm, p.logw, p.active),
               (p.num_mixtures, p.density_cap, p.dim, p.max_approx)),
    lambda aux, ch: ScorePackDF(mu=ch[0], iv=ch[1], norm=ch[2], logw=ch[3],
                                active=ch[4], num_mixtures=aux[0],
                                density_cap=aux[1], dim=aux[2],
                                max_approx=aux[3]))


class MixtureModel:
    """Host-side GMM state (flat f64 arrays, reference-identical indices)."""

    def __init__(self, dim: int, num_mixtures: int,
                 var_model: VarianceModel = VarianceModel.MIXTURE_POOLING,
                 max_approx: bool = True):
        self.dim = dim
        self.num_mixtures = num_mixtures
        self.var_model = var_model
        self.max_approx = max_approx

        # flat per-mean / per-var arrays (grow on split, never shrink)
        self.means = np.zeros((0, dim))
        self.mean_acc = np.zeros((0, dim))
        self.mean_weights = np.zeros(0)
        self.mean_weights_log = np.zeros(0)
        self.mean_weight_acc = np.zeros(0)
        self.mean_refs = np.zeros(0, dtype=np.int64)

        self.vars = np.zeros((0, dim))
        self.vars_inv = np.zeros((0, dim))
        self.var_acc = np.zeros((0, dim))
        self.var_weight_acc = np.zeros(0)
        self.var_refs = np.zeros(0, dtype=np.int64)
        self.norm = np.zeros(0)

        # mixtures_[m] = list of (mean_idx, var_idx)
        self.mixtures: List[List[Tuple[int, int]]] = [[] for _ in range(num_mixtures)]

        for m in range(num_mixtures):
            if var_model != VarianceModel.GLOBAL_POOLING:
                md = self._create_density(len(self.mean_refs), len(self.var_refs))
            else:
                md = self._create_density(len(self.mean_refs), 0)
            self.mixtures[m].append(md)

    # -- construction helpers ------------------------------------------------

    def _append_mean_slot(self) -> None:
        self.means = np.vstack([self.means, np.zeros((1, self.dim))])
        self.mean_acc = np.vstack([self.mean_acc, np.zeros((1, self.dim))])
        self.mean_weights = np.append(self.mean_weights, 0.0)
        self.mean_weights_log = np.append(self.mean_weights_log, 0.0)
        self.mean_weight_acc = np.append(self.mean_weight_acc, 0.0)
        self.mean_refs = np.append(self.mean_refs, 1)

    def _append_var_slot(self) -> None:
        self.vars = np.vstack([self.vars, np.zeros((1, self.dim))])
        self.vars_inv = np.vstack([self.vars_inv, np.zeros((1, self.dim))])
        self.var_acc = np.vstack([self.var_acc, np.full((1, self.dim), MIN_VARIANCE)])
        self.var_weight_acc = np.append(self.var_weight_acc, 0.0)
        self.var_refs = np.append(self.var_refs, 1)
        self.norm = np.append(self.norm, 0.0)

    def _create_density(self, mean_idx: int, var_idx: int) -> Tuple[int, int]:
        """Mirrors Mixtures.cpp:205-233 (reuses var slot when it exists)."""
        self._append_mean_slot()
        if var_idx >= len(self.var_refs):
            self._append_var_slot()
        return (mean_idx, var_idx)

    # -- EM bookkeeping ------------------------------------------------------

    def reset_accumulators(self) -> None:
        self.mean_acc[:] = 0.0
        self.mean_weight_acc[:] = 0.0
        self.var_acc[:] = MIN_VARIANCE
        self.var_weight_acc[:] = 0.0

    def _calculate_variance(self, var_idx: int, mean_vec: np.ndarray) -> None:
        """E[X²]−E[X]² + norm term (Mixtures.cpp:251-275). Degenerate
        inputs flow through as nan/inf, like the C++ double math."""
        with np.errstate(divide="ignore", invalid="ignore"):
            v = self.var_acc[var_idx] / self.var_weight_acc[var_idx]
            v = v - mean_vec * mean_vec
            self.vars[var_idx] = v
            self.vars_inv[var_idx] = 1.0 / v
            self.norm[var_idx] = (self.dim * math.log(2 * math.pi)
                                  + np.log(v).sum()) / 2.0

    def finalize(self) -> None:
        """M-step (Mixtures.cpp:374-461). Zero-count densities yield nan
        means and −inf log-weights exactly like the C++ double arithmetic;
        they are skipped by scoring (see pack()) and removed by the next
        eliminate() — do not raise."""
        total_observations = 0.0
        with np.errstate(divide="ignore", invalid="ignore"):
            for m in range(self.num_mixtures):
                total_mix = 0.0
                for (mean_idx, var_idx) in self.mixtures[m]:
                    total_mix += self.mean_weight_acc[mean_idx]
                    self.means[mean_idx] = self.mean_acc[mean_idx] / self.mean_weight_acc[mean_idx]
                    if self.var_model == VarianceModel.NO_POOLING:
                        self._calculate_variance(var_idx, self.means[mean_idx])
                for (mean_idx, _var_idx) in self.mixtures[m]:
                    self.mean_weights[mean_idx] = self.mean_weight_acc[mean_idx] / total_mix
                    self.mean_weights_log[mean_idx] = np.log(self.mean_weights[mean_idx])
                if self.var_model == VarianceModel.MIXTURE_POOLING \
                        and self.mixtures[m]:
                    # empty mixtures occur when eliminate() drops every
                    # density of an unobserved class (LVCSR state tying)
                    mixture_mean = np.zeros(self.dim)
                    for (mean_idx, _v) in self.mixtures[m]:
                        mixture_mean += self.mean_acc[mean_idx]
                    mixture_mean /= total_mix
                    self._calculate_variance(self.mixtures[m][0][1], mixture_mean)
                total_observations += total_mix

            if self.var_model == VarianceModel.GLOBAL_POOLING:
                global_mean = np.zeros(self.dim)
                for m in range(self.num_mixtures):
                    for (mean_idx, _v) in self.mixtures[m]:
                        global_mean += self.mean_acc[mean_idx]
                global_mean /= total_observations
                self._calculate_variance(0, global_mean)

    def sync_accumulators_to_parameters(self) -> None:
        """Rewrite the sufficient-statistic accumulators so finalize()
        reproduces the CURRENT parameters exactly.

        The .mix checkpoint stores ACCUMULATORS only and re-finalizes on
        load (Mixtures.cpp:748-830 / from_raw) — so any direct parameter
        update (EBW/MPE M-steps, adaptation) would silently revert on a
        save/load round trip unless the accumulators are re-derived:
        means·weights back into mean_acc, E[X²]-form variances back into
        var_acc, per-mixture mass preserved."""
        with np.errstate(divide="ignore", invalid="ignore"):
            for m in range(self.num_mixtures):
                total_mix = sum(self.mean_weight_acc[mi]
                                for (mi, _vi) in self.mixtures[m])
                if not np.isfinite(total_mix) or total_mix <= 0:
                    continue
                for (mi, vi) in self.mixtures[m]:
                    if not (np.all(np.isfinite(self.means[mi]))
                            and np.isfinite(self.mean_weights[mi])):
                        continue
                    self.mean_weight_acc[mi] = (self.mean_weights[mi]
                                                * total_mix)
                    self.mean_acc[mi] = (self.means[mi]
                                         * self.mean_weight_acc[mi])
                    if self.var_model == VarianceModel.NO_POOLING:
                        self.var_weight_acc[vi] = self.mean_weight_acc[mi]
                        self.var_acc[vi] = ((self.vars[vi]
                                             + self.means[mi] ** 2)
                                            * self.var_weight_acc[vi])
                if (self.var_model == VarianceModel.MIXTURE_POOLING
                        and self.mixtures[m]):
                    vi0 = self.mixtures[m][0][1]
                    mixture_mean = np.zeros(self.dim)
                    for (mi, _v) in self.mixtures[m]:
                        mixture_mean += self.mean_acc[mi]
                    mixture_mean /= total_mix
                    self.var_weight_acc[vi0] = total_mix
                    self.var_acc[vi0] = ((self.vars[vi0]
                                          + mixture_mean ** 2) * total_mix)
            if self.var_model == VarianceModel.GLOBAL_POOLING:
                total_obs = 0.0
                global_mean = np.zeros(self.dim)
                for m in range(self.num_mixtures):
                    for (mi, _v) in self.mixtures[m]:
                        if np.isfinite(self.mean_weight_acc[mi]):
                            total_obs += self.mean_weight_acc[mi]
                            global_mean += self.mean_acc[mi]
                if total_obs > 0:
                    global_mean /= total_obs
                    self.var_weight_acc[0] = total_obs
                    self.var_acc[0] = ((self.vars[0] + global_mean ** 2)
                                       * total_obs)

    def split(self, min_obs: float) -> None:
        """Split densities with enough mass, μ ± √σ² (Mixtures.cpp:465-543).
        Iterates densities in reverse, appends the new density at the end."""
        for m in range(self.num_mixtures):
            for di in range(len(self.mixtures[m]) - 1, -1, -1):
                mean_idx, var_idx = self.mixtures[m][di]
                if self.mean_weight_acc[mean_idx] >= min_obs:
                    if self.var_model == VarianceModel.NO_POOLING:
                        new_md = self._create_density(len(self.mean_refs), len(self.var_refs))
                    else:
                        new_md = self._create_density(len(self.mean_refs), var_idx)
                    self._update_split_densities((mean_idx, var_idx), new_md)
                    self.mixtures[m].append(new_md)

    def _update_split_densities(self, orig: Tuple[int, int], new: Tuple[int, int]) -> None:
        mo, vo = orig
        mn, vn = new
        self.mean_weights[mn] = self.mean_weights[mo]
        self.mean_weights_log[mn] = self.mean_weights_log[mo]
        self.mean_weight_acc[mn] = self.mean_weight_acc[mo]
        shift = np.sqrt(self.vars[vo])
        mean_plus = self.means[mo] + shift
        mean_minus = self.means[mo] - shift
        self.means[mo] = mean_plus
        self.means[mn] = mean_minus
        if self.var_model == VarianceModel.NO_POOLING:
            self.var_weight_acc[vn] = self.var_weight_acc[vo]
            self.var_acc[vn] = self.var_acc[vo]
            self.vars[vn] = self.vars[vo]
            self.vars_inv[vn] = self.vars_inv[vo]
            self.norm[vn] = self.norm[vo]

    def eliminate(self, min_obs: float) -> None:
        """Drop underpopulated densities (Mixtures.cpp:547-576)."""
        for m in range(self.num_mixtures):
            for di in range(len(self.mixtures[m]) - 1, -1, -1):
                mean_idx, var_idx = self.mixtures[m][di]
                if self.mean_weight_acc[mean_idx] < min_obs:
                    del self.mixtures[m][di]
                    self.mean_refs[mean_idx] = 0
                    if self.var_model == VarianceModel.NO_POOLING:
                        self.var_refs[var_idx] = 0

    def num_densities(self) -> int:
        return int(len(self.mean_refs) - np.count_nonzero(self.mean_refs == 0))

    @property
    def max_densities_per_mixture(self) -> int:
        return max(len(m) for m in self.mixtures)

    # -- serialization (reference .mix format) -------------------------------

    def to_raw(self) -> RawMixtureSet:
        """Compacted accumulator state, as Mixtures.cpp::write()."""
        mean_map = -np.ones(len(self.mean_refs), dtype=np.int64)
        mean_map[self.mean_refs > 0] = np.arange(int((self.mean_refs > 0).sum()))
        var_map = -np.ones(len(self.var_refs), dtype=np.int64)
        var_map[self.var_refs > 0] = np.arange(int((self.var_refs > 0).sum()))

        density_list = []
        mixtures_out: List[np.ndarray] = []
        for m in range(self.num_mixtures):
            ids = []
            for (mean_idx, var_idx) in self.mixtures[m]:
                ids.append(len(density_list))
                density_list.append((mean_map[mean_idx], var_map[var_idx]))
            mixtures_out.append(np.asarray(ids, dtype=np.int64))

        keep_m = self.mean_refs > 0
        keep_v = self.var_refs > 0
        return RawMixtureSet(
            dim=self.dim,
            mean_acc=self.mean_acc[keep_m].copy(),
            mean_weight=self.mean_weight_acc[keep_m].copy(),
            var_acc=self.var_acc[keep_v].copy(),
            var_weight=self.var_weight_acc[keep_v].copy(),
            densities=np.asarray(density_list, dtype=np.int64).reshape(-1, 2),
            mixtures=mixtures_out,
        )

    @staticmethod
    def from_raw(raw: RawMixtureSet, var_model: VarianceModel,
                 max_approx: bool) -> "MixtureModel":
        """Load + re-finalize, as Mixtures.cpp::read() (::748-830)."""
        model = MixtureModel.__new__(MixtureModel)
        model.dim = raw.dim
        model.num_mixtures = len(raw.mixtures)
        model.var_model = var_model
        model.max_approx = max_approx

        n_means = raw.mean_acc.shape[0]
        n_vars = raw.var_acc.shape[0]
        model.mean_acc = raw.mean_acc.copy()
        model.mean_weight_acc = raw.mean_weight.copy()
        model.means = np.zeros_like(model.mean_acc)
        model.mean_weights = np.zeros(n_means)
        model.mean_weights_log = np.zeros(n_means)
        model.mean_refs = np.zeros(n_means, dtype=np.int64)

        model.var_acc = raw.var_acc.copy()
        model.var_weight_acc = raw.var_weight.copy()
        model.vars = np.zeros_like(model.var_acc)
        model.vars_inv = np.zeros_like(model.var_acc)
        model.var_refs = np.zeros(n_vars, dtype=np.int64)
        model.norm = np.zeros(n_vars)

        model.mixtures = []
        for ids in raw.mixtures:
            lst = []
            for d in ids:
                mean_idx, var_idx = int(raw.densities[d, 0]), int(raw.densities[d, 1])
                model.mean_refs[mean_idx] += 1
                model.var_refs[var_idx] += 1
                lst.append((mean_idx, var_idx))
            model.mixtures.append(lst)
        model.finalize()
        return model

    # -- device packing ------------------------------------------------------

    def pack(self, dtype=jnp.float32,
             density_cap: Optional[int] = None) -> ScorePack:
        S = self.num_mixtures
        D = density_cap or self.max_densities_per_mixture
        dim = self.dim
        A = np.zeros((S, D, dim))
        B = np.zeros((S, D, dim))
        C = np.full((S, D), float(INACTIVE_SCORE))
        active = np.zeros((S, D), dtype=bool)
        for s in range(S):
            for d, (mean_idx, var_idx) in enumerate(self.mixtures[s]):
                iv = self.vars_inv[var_idx]
                mu = self.means[mean_idx]
                a = 0.5 * iv
                b = -mu * iv
                c = (0.5 * np.sum(mu * mu * iv) + self.norm[var_idx]
                     - self.mean_weights_log[mean_idx])
                # zero-count densities have nan means / −inf log-weights;
                # the reference's nan scores are skipped by every strict-<
                # comparison (Mixtures.cpp:706), equivalent to "inactive"
                if not (np.isfinite(a).all() and np.isfinite(b).all()
                        and np.isfinite(c)):
                    continue
                A[s, d] = a
                B[s, d] = b
                C[s, d] = c
                active[s, d] = True
        P = np.concatenate([A.reshape(S * D, dim).T,
                            B.reshape(S * D, dim).T,
                            C.reshape(1, S * D)], axis=0)
        return ScorePack(P=jnp.asarray(P, dtype=dtype),
                         active=jnp.asarray(active),
                         num_mixtures=S, density_cap=D, dim=dim,
                         max_approx=self.max_approx, dtype=dtype)

    # -- host application of device statistics -------------------------------

    def pack_df(self, density_cap: Optional[int] = None) -> "ScorePackDF":
        """Double-float (two-f32) scoring pack: exact f32-pair splits of the
        host float64 tables for the bit-parity decode path (see
        am_scores_df).

        ``density_cap``: pad density slots to a fixed capacity so device
        program shapes stay constant while EM splitting grows the model,
        and one compiled program serves every split (train/em.py)."""
        from ..ops import doublefloat as dfm

        S = self.num_mixtures
        D = density_cap or self.max_densities_per_mixture
        dim = self.dim
        mu = np.zeros((S * D, dim))
        iv = np.zeros((S * D, dim))
        norm = np.full(S * D, float(INACTIVE_SCORE))
        logw = np.zeros(S * D)
        active = np.zeros((S, D), bool)
        for s in range(S):
            for d, (mean_idx, var_idx) in enumerate(self.mixtures[s]):
                m_vec = self.means[mean_idx]
                iv_vec = self.vars_inv[var_idx]
                nrm = self.norm[var_idx]
                lw = self.mean_weights_log[mean_idx]
                if not (np.isfinite(m_vec).all() and np.isfinite(iv_vec).all()
                        and np.isfinite(nrm) and np.isfinite(lw)):
                    continue
                j = s * D + d
                mu[j] = m_vec
                iv[j] = iv_vec
                norm[j] = nrm
                logw[j] = lw
                active[s, d] = True
        return ScorePackDF(
            mu=dfm.from_f64(mu), iv=dfm.from_f64(iv),
            norm=dfm.from_f64(norm), logw=dfm.from_f64(logw),
            active=jnp.asarray(active), num_mixtures=S, density_cap=D,
            dim=dim, max_approx=self.max_approx)

    def apply_statistics(self, w: np.ndarray, xs: np.ndarray, x2s: np.ndarray) -> None:
        """Fold dense per-(mixture, density-slot) stats into the flat
        reference-indexed accumulators (handles shared var slots)."""
        self.reset_accumulators()
        for s in range(self.num_mixtures):
            for d, (mean_idx, var_idx) in enumerate(self.mixtures[s]):
                self.mean_weight_acc[mean_idx] += w[s, d]
                self.var_weight_acc[var_idx] += w[s, d]
                self.mean_acc[mean_idx] += xs[s, d]
                self.var_acc[var_idx] += x2s[s, d]


# -- device-side scoring and statistics --------------------------------------


def density_scores(pack: ScorePack, feats: jnp.ndarray) -> jnp.ndarray:
    """[N, dim] → [N, S, D] per-density scores (−log p, padded slots huge)."""
    X = pack.features_expanded(feats.astype(pack.dtype))
    # HIGHEST: the expansion already cancels to ~1e-3 in full f32, and a
    # TF32 product (10-bit mantissa) would lose far more
    scores = jnp.dot(X, pack.P, precision=jax.lax.Precision.HIGHEST)
    return scores.reshape(X.shape[0], pack.num_mixtures, pack.density_cap)


def mixture_scores_from_density(pack: ScorePack, scores_sd: jnp.ndarray) -> jnp.ndarray:
    """[.., S, D] → [.., S] mixture-level scores (min-clip or −logΣexp)."""
    if pack.max_approx:
        return jnp.minimum(scores_sd.min(axis=-1), MIN_SCORE_INIT)
    neg = jnp.where(pack.active, -scores_sd, -jnp.inf)
    return -jax.scipy.special.logsumexp(neg, axis=-1)


AM_CHUNK = 1 << 15  # frames per chunk: bounds the [chunk, S·D] intermediate


def am_scores(pack: ScorePack, feats: jnp.ndarray) -> jnp.ndarray:
    """[N, dim] → [N, S] state-level acoustic scores.

    Internally chunked over frames so the [chunk, S·D] per-density tensor
    never exceeds ~0.5 GB regardless of batch size (the density dimension
    is reduced immediately)."""
    N = feats.shape[0]
    if N <= AM_CHUNK:
        return mixture_scores_from_density(pack, density_scores(pack, feats))
    pad = (-N) % AM_CHUNK
    fp = jnp.pad(feats, ((0, pad), (0, 0)))
    chunks = fp.reshape(-1, AM_CHUNK, feats.shape[1])
    out = jax.lax.map(
        lambda x: mixture_scores_from_density(pack, density_scores(pack, x)),
        chunks)
    return out.reshape(-1, pack.num_mixtures)[:N]


AM_CHUNK_DF = 1 << 12  # df scoring holds several [chunk, S·D] f32 pairs


def _density_scores_df(packdf: ScorePackDF, x: jnp.ndarray):
    """x f32 [n, dim] → DF [n, S·D] density scores, reference op order:
    d = Σᵢ (x−μ)²·iv  (double in C++, DF here);  score = norm + d/2 − logw."""
    from ..ops import doublefloat as dfm

    n = x.shape[0]
    J = packdf.mu.hi.shape[0]
    x = x.astype(jnp.float32)
    acc = dfm.DF(jnp.zeros((n, J), jnp.float32), jnp.zeros((n, J), jnp.float32))
    for i in range(packdf.dim):
        mu_i = dfm.DF(packdf.mu.hi[None, :, i], packdf.mu.lo[None, :, i])
        iv_i = dfm.DF(packdf.iv.hi[None, :, i], packdf.iv.lo[None, :, i])
        diff = dfm.add_f(dfm.neg(mu_i), x[:, i, None])          # [n, J]
        acc = dfm.add(acc, dfm.mul(dfm.mul(diff, diff), iv_i))
    half = dfm.DF(acc.hi * 0.5, acc.lo * 0.5)                   # exact ×2⁻¹
    score = dfm.add(dfm.DF(packdf.norm.hi[None, :], packdf.norm.lo[None, :]),
                    half)
    score = dfm.add(score, dfm.neg(dfm.DF(packdf.logw.hi[None, :],
                                          packdf.logw.lo[None, :])))
    return score


@jax.jit
def _am_chunk_df(packdf: ScorePackDF, x: jnp.ndarray):
    from ..ops import doublefloat as dfm

    sc = _density_scores_df(packdf, x)
    S, D = packdf.num_mixtures, packdf.density_cap
    sc = dfm.DF(sc.hi.reshape(-1, S, D), sc.lo.reshape(-1, S, D))
    if not packdf.max_approx:
        raise NotImplementedError("df32 path covers max-approx scoring only")
    m = dfm.min_axis(sc, axis=-1)
    init = dfm.df(jnp.asarray(MIN_SCORE_INIT, jnp.float32))
    cap = dfm.DF(jnp.broadcast_to(init.hi, m.hi.shape),
                 jnp.broadcast_to(init.lo, m.lo.shape))
    return dfm.minimum(m, cap)


def am_scores_df(packdf: ScorePackDF, feats: jnp.ndarray):
    """[N, dim] f32 → DF [N, S] state-level scores in double-float.

    Chunked over frames like am_scores; a per-dim unrolled elementwise DF
    loop (a matmul unit cannot accumulate beyond f32)."""
    from ..ops import doublefloat as dfm

    N = feats.shape[0]
    if N <= AM_CHUNK_DF:
        return _am_chunk_df(packdf, feats)
    pad = (-N) % AM_CHUNK_DF
    fp = jnp.pad(feats, ((0, pad), (0, 0)))
    chunks = fp.reshape(-1, AM_CHUNK_DF, feats.shape[1])
    out = jax.lax.map(lambda x: _am_chunk_df(packdf, x), chunks)
    S = packdf.num_mixtures
    return dfm.DF(out.hi.reshape(-1, S)[:N], out.lo.reshape(-1, S)[:N])


def accumulate_chunk(pack: ScorePack, feats: jnp.ndarray, states: jnp.ndarray,
                     frame_mask: jnp.ndarray, first_pass: bool,
                     ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sufficient statistics for one chunk of aligned frames.

    feats [N, dim], states int32 [N] (aligned mixture per frame), frame_mask
    [N] (0 for padding). Returns (w [S,D], xs [S,D,dim], x2s [S,D,dim]) in
    float64. Membership: one-hot argmin for max-approx (Mixtures.cpp:296-305),
    normalized exp(−score) with the 1e-8 cutoff for sum (::307-336).
    """
    S, D = pack.num_mixtures, pack.density_cap
    N = feats.shape[0]
    if first_pass:
        gamma = jnp.zeros((N, D), pack.dtype).at[:, 0].set(1.0)
    else:
        sc = density_scores(pack, feats)                       # [N, S, D]
        sc_aligned = jnp.take_along_axis(
            sc, states[:, None, None].astype(jnp.int32), axis=1)[:, 0]  # [N, D]
        if pack.max_approx:
            best = jnp.argmin(sc_aligned, axis=-1)
            gamma = jax.nn.one_hot(best, D, dtype=pack.dtype)
        else:
            shifted = sc_aligned - sc_aligned.min(axis=-1, keepdims=True)
            p = jnp.exp(-shifted)
            p = p / p.sum(axis=-1, keepdims=True)
            gamma = jnp.where(p < MEMBERSHIP_EPS, 0.0, p)
    gamma = gamma * frame_mask[:, None].astype(pack.dtype)

    ids = states.astype(jnp.int32)
    # per-(s,d) sums via segment-sum over mixture ids, one segment per slot
    gamma64 = gamma.astype(jnp.float64)
    f64 = feats.astype(jnp.float64)
    w = jax.ops.segment_sum(gamma64, ids, num_segments=S)                 # [S, D]
    xs = jax.ops.segment_sum(gamma64[:, :, None] * f64[:, None, :], ids,
                             num_segments=S)                              # [S, D, dim]
    x2s = jax.ops.segment_sum(gamma64[:, :, None] * (f64 * f64)[:, None, :], ids,
                              num_segments=S)
    return w, xs, x2s


def aligned_density_scores_df(packdf: ScorePackDF, feats: jnp.ndarray,
                              states: jnp.ndarray):
    """Double-float twin of `aligned_density_scores`: [N, dim] × int32 [N]
    → DF [N, D] scores of the aligned mixture's densities, with exactly
    `_density_scores_df`'s operation order (so decisions match the decode
    path's reference-f64 parity argument)."""
    from ..ops import doublefloat as dfm

    S, D, dim = packdf.num_mixtures, packdf.density_cap, packdf.dim
    st = states.astype(jnp.int32)
    mu_hi = packdf.mu.hi.reshape(S, D, dim)[st]    # [N, D, dim]
    mu_lo = packdf.mu.lo.reshape(S, D, dim)[st]
    iv_hi = packdf.iv.hi.reshape(S, D, dim)[st]
    iv_lo = packdf.iv.lo.reshape(S, D, dim)[st]
    x = feats.astype(jnp.float32)
    N = x.shape[0]
    acc = dfm.DF(jnp.zeros((N, D), jnp.float32), jnp.zeros((N, D), jnp.float32))
    for i in range(dim):
        mu_i = dfm.DF(mu_hi[:, :, i], mu_lo[:, :, i])
        iv_i = dfm.DF(iv_hi[:, :, i], iv_lo[:, :, i])
        diff = dfm.add_f(dfm.neg(mu_i), x[:, i, None])
        acc = dfm.add(acc, dfm.mul(dfm.mul(diff, diff), iv_i))
    half = dfm.DF(acc.hi * 0.5, acc.lo * 0.5)
    score = dfm.add(dfm.DF(packdf.norm.hi.reshape(S, D)[st],
                           packdf.norm.lo.reshape(S, D)[st]), half)
    score = dfm.add(score, dfm.neg(dfm.DF(packdf.logw.hi.reshape(S, D)[st],
                                          packdf.logw.lo.reshape(S, D)[st])))
    return score


def aligned_density_scores(pack: ScorePack, feats: jnp.ndarray,
                           states: jnp.ndarray) -> jnp.ndarray:
    """Per-density scores of each frame's ALIGNED mixture only:
    [N, dim] × int32 [N] → [N, D].

    The E-step and AM-score passes under a fixed alignment never look at
    the other S−1 mixtures (Mixtures.cpp:296-305 scores only
    ``mixtures_[aligned]``), so instead of the full [N, S·D] matmul this
    gathers the aligned mixture's expansion columns ([51, N, D], HBM
    bandwidth) and contracts — ~S× less arithmetic. Same per-density
    reduction as the full path (matmul over the 2·dim+1 expansion)."""
    X = pack.features_expanded(feats.astype(pack.dtype))       # [N, K]
    K = X.shape[-1]
    P3 = pack.P.reshape(K, pack.num_mixtures, pack.density_cap)
    Pg = P3[:, states.astype(jnp.int32), :]                    # [K, N, D]
    # HIGHEST: same cancellation argument as density_scores
    return jnp.einsum("nk,knd->nd", X, Pg,
                      precision=jax.lax.Precision.HIGHEST)


# -- whole-corpus fused EM passes ---------------------------------------------
# One jitted dispatch per E-step / AM-score pass over device-resident
# feature chunks (the reference streams the flat corpus array once per
# pass too, Training.cpp:44-235 / Mixtures.cpp:278-372).


@partial(jax.jit, static_argnames=("first_pass", "aligned_gather"))
def em_accumulate_corpus(pack: ScorePack, feats_chunks: jnp.ndarray,
                         states_chunks: jnp.ndarray, mask_chunks: jnp.ndarray,
                         first_pass: bool, aligned_gather: bool = True):
    """feats_chunks f32 [K, C, dim]; states int32 [K, C]; mask f32 [K, C].
    Returns (w [S,D], xs [S,D,dim], x2s [S,D,dim]) in float64 — identical
    math to accumulate_chunk, scanned over chunks on device.
    ``aligned_gather`` scores only the aligned mixture's densities
    (aligned_density_scores) instead of the full [C, S·D] product.
    ``pack`` may be a ScorePackDF: membership decisions then run in
    double-float pairs (reference-f64 decisions, f32 device speed)."""
    is_df = isinstance(pack, ScorePackDF)
    S, D = pack.num_mixtures, pack.density_cap
    dim = feats_chunks.shape[-1]
    gdtype = jnp.float32 if is_df else pack.dtype

    def best_density(f, st):
        """Hard membership: the aligned mixture's winning density index
        per frame (max-approx, Mixtures.cpp:296-305) — int32 [C]."""
        if first_pass:
            return jnp.zeros(f.shape[0], jnp.int32)
        if is_df:
            from ..ops import doublefloat as dfm
            # full-table streaming scores + a [C, D] gather of the aligned
            # mixture's block: the mu/iv tables are tiny and stay in VMEM,
            # whereas gathering per-frame [C, D, dim] parameter slices
            # (aligned_density_scores_df) moves ~400MB of random-access
            # HBM traffic per chunk — bandwidth, not FLOPs, priced the
            # E-step. Same per-density op order, so decisions are
            # unchanged.
            sc_all = _density_scores_df(pack, f)              # DF [C, S·D]
            C = f.shape[0]
            idx = (st.astype(jnp.int32)[:, None] * D
                   + jnp.arange(D)[None, :])                  # [C, D]
            sc = dfm.DF(jnp.take_along_axis(sc_all.hi, idx, axis=1),
                        jnp.take_along_axis(sc_all.lo, idx, axis=1))
            m = dfm.min_axis(sc, axis=-1)
            eq = (sc.hi == m.hi[:, None]) & (sc.lo == m.lo[:, None])
            return jnp.argmax(eq, axis=-1).astype(jnp.int32)  # first minimum
        if aligned_gather:
            sc_aligned = aligned_density_scores(pack, f, st)
        else:
            sc = density_scores(pack, f)
            sc_aligned = jnp.take_along_axis(
                sc, st[:, None, None].astype(jnp.int32), axis=1)[:, 0]
        return jnp.argmin(sc_aligned, axis=-1).astype(jnp.int32)

    def soft_membership(f, st):
        if is_df:
            raise NotImplementedError(
                "df32 EM covers max-approx membership only")
        if aligned_gather:
            sc_aligned = aligned_density_scores(pack, f, st)
        else:
            sc = density_scores(pack, f)
            sc_aligned = jnp.take_along_axis(
                sc, st[:, None, None].astype(jnp.int32), axis=1)[:, 0]
        shifted = sc_aligned - sc_aligned.min(axis=-1, keepdims=True)
        p = jnp.exp(-shifted)
        p = p / p.sum(axis=-1, keepdims=True)
        return jnp.where(p < MEMBERSHIP_EPS, 0.0, p)

    hard = first_pass or pack.max_approx

    def body(carry, inp):
        w, xs, x2s = carry
        f, st, m = inp
        f64 = f.astype(jnp.float64)
        if hard:
            # one frame → exactly one (mixture, density) slot: scatter the
            # frame itself into flat slot ids — [C, dim] float64 adds, no
            # per-density product tensor (the gamma values are exactly 0/1,
            # so the products the reference computes are the features)
            slots = st.astype(jnp.int32) * D + best_density(f, st)
            m64 = m.astype(jnp.float64)
            cw = jax.ops.segment_sum(m64, slots, num_segments=S * D)
            cxs = jax.ops.segment_sum(f64 * m64[:, None], slots,
                                      num_segments=S * D)
            cx2s = jax.ops.segment_sum(f64 * f64 * m64[:, None], slots,
                                       num_segments=S * D)
            return (w + cw.reshape(S, D), xs + cxs.reshape(S, D, dim),
                    x2s + cx2s.reshape(S, D, dim)), None
        gamma = soft_membership(f, st) * m[:, None].astype(gdtype)
        ids = st.astype(jnp.int32)
        gamma64 = gamma.astype(jnp.float64)
        cw = jax.ops.segment_sum(gamma64, ids, num_segments=S)
        cxs = jax.ops.segment_sum(gamma64[:, :, None] * f64[:, None, :], ids,
                                  num_segments=S)
        cx2s = jax.ops.segment_sum(
            gamma64[:, :, None] * (f64 * f64)[:, None, :], ids,
            num_segments=S)
        return (w + cw, xs + cxs, x2s + cx2s), None

    init = (jnp.zeros((S, D), jnp.float64),
            jnp.zeros((S, D, dim), jnp.float64),
            jnp.zeros((S, D, dim), jnp.float64))
    (w, xs, x2s), _ = jax.lax.scan(
        body, init, (feats_chunks, states_chunks, mask_chunks))
    return w, xs, x2s


@partial(jax.jit, static_argnames=("first_pass", "aligned_gather"))
def em_score_and_accumulate_corpus(pack: ScorePack, feats_chunks: jnp.ndarray,
                                   states_chunks: jnp.ndarray,
                                   mask_chunks: jnp.ndarray,
                                   first_pass: bool = False,
                                   aligned_gather: bool = True):
    """Fused (em_am_score_corpus, em_accumulate_corpus) under ONE model:
    the EM estimate loop scores M_{k+1} (the trajectory line) and then
    immediately accumulates under the same M_{k+1} — one corpus pass
    and ONE per-frame scoring shared by both
    (instead of two passes each scoring every frame). Returns
    (score_total, w, xs, x2s), bit-identical to the two separate passes
    (same kernels on the same gathered score block)."""
    is_df = isinstance(pack, ScorePackDF)
    S, D = pack.num_mixtures, pack.density_cap
    dim = feats_chunks.shape[-1]

    def scored_block(f, st):
        """DF or plain [C, D] scores of the aligned mixture's densities,
        shared by the score sum and the membership argmin."""
        if is_df:
            if not pack.max_approx:
                raise NotImplementedError(
                    "df32 EM covers max-approx scoring only")
            from ..ops import doublefloat as dfm
            sc_all = _density_scores_df(pack, f)
            idx = (st.astype(jnp.int32)[:, None] * D
                   + jnp.arange(D)[None, :])
            return dfm.DF(jnp.take_along_axis(sc_all.hi, idx, axis=1),
                          jnp.take_along_axis(sc_all.lo, idx, axis=1))
        if aligned_gather:
            return aligned_density_scores(pack, f, st)
        sc = density_scores(pack, f)
        return jnp.take_along_axis(
            sc, st[:, None, None].astype(jnp.int32), axis=1)[:, 0]

    def body(carry, inp):
        total, w, xs, x2s = carry
        f, st, m = inp
        sc = scored_block(f, st)
        # frame score (Training.cpp:585-612 semantics, as em_am_score_corpus)
        if is_df:
            from ..ops import doublefloat as dfm
            mn = dfm.min_axis(sc, axis=-1)
            capped_hi = jnp.minimum(mn.hi, jnp.float32(MIN_SCORE_INIT))
            capped_lo = jnp.where(mn.hi < jnp.float32(MIN_SCORE_INIT),
                                  mn.lo, 0.0)
            fs64 = capped_hi.astype(jnp.float64) + capped_lo.astype(jnp.float64)
            total = total + (fs64 * m).sum()
            eq = (sc.hi == mn.hi[:, None]) & (sc.lo == mn.lo[:, None])
            best = jnp.argmax(eq, axis=-1).astype(jnp.int32)
        else:
            if pack.max_approx:
                fs = jnp.minimum(sc.min(axis=-1), MIN_SCORE_INIT)
            else:
                neg = jnp.where(pack.active[st.astype(jnp.int32)],
                                -sc, -jnp.inf)
                fs = -jax.scipy.special.logsumexp(neg, axis=-1)
            total = total + (fs.astype(jnp.float64) * m).sum()
            best = jnp.argmin(sc, axis=-1).astype(jnp.int32)
        # statistics (em_accumulate_corpus hard path; first_pass → slot 0)
        if first_pass:
            best = jnp.zeros_like(best)
        if not (first_pass or pack.max_approx):
            raise NotImplementedError(
                "fused pass covers max-approx membership only")
        f64 = f.astype(jnp.float64)
        slots = st.astype(jnp.int32) * D + best
        m64 = m.astype(jnp.float64)
        cw = jax.ops.segment_sum(m64, slots, num_segments=S * D)
        cxs = jax.ops.segment_sum(f64 * m64[:, None], slots,
                                  num_segments=S * D)
        cx2s = jax.ops.segment_sum(f64 * f64 * m64[:, None], slots,
                                   num_segments=S * D)
        return (total, w + cw.reshape(S, D), xs + cxs.reshape(S, D, dim),
                x2s + cx2s.reshape(S, D, dim)), None

    init = (jnp.zeros((), jnp.float64),
            jnp.zeros((S, D), jnp.float64),
            jnp.zeros((S, D, dim), jnp.float64),
            jnp.zeros((S, D, dim), jnp.float64))
    (total, w, xs, x2s), _ = jax.lax.scan(
        body, init, (feats_chunks, states_chunks, mask_chunks))
    return total, w, xs, x2s


@partial(jax.jit, static_argnames=("aligned_gather",))
def em_am_score_corpus(pack: ScorePack, feats_chunks: jnp.ndarray,
                       states_chunks: jnp.ndarray, mask_chunks: jnp.ndarray,
                       aligned_gather: bool = True):
    """Sum of per-frame mixture scores under the alignment
    (Training.cpp:585-612), one device dispatch for the whole corpus.
    ``pack`` may be a ScorePackDF (double-float per-frame scores, summed
    in f64 on the host side of the pair split)."""
    is_df = isinstance(pack, ScorePackDF)

    def body(total, inp):
        f, st, m = inp
        if is_df:
            if not pack.max_approx:
                raise NotImplementedError(
                    "df32 EM covers max-approx scoring only")
            from ..ops import doublefloat as dfm
            # full-table streaming + aligned-block gather (see
            # em_accumulate_corpus.best_density for the bandwidth note)
            D = pack.density_cap
            sc_all = _density_scores_df(pack, f)              # DF [C, S·D]
            idx = (st.astype(jnp.int32)[:, None] * D
                   + jnp.arange(D)[None, :])
            sc = dfm.DF(jnp.take_along_axis(sc_all.hi, idx, axis=1),
                        jnp.take_along_axis(sc_all.lo, idx, axis=1))
            mn = dfm.min_axis(sc, axis=-1)
            capped_hi = jnp.minimum(mn.hi, jnp.float32(MIN_SCORE_INIT))
            capped_lo = jnp.where(mn.hi < jnp.float32(MIN_SCORE_INIT),
                                  mn.lo, 0.0)
            fs64 = capped_hi.astype(jnp.float64) + capped_lo.astype(jnp.float64)
            return total + (fs64 * m).sum(), None
        if aligned_gather:
            sc_aligned = aligned_density_scores(pack, f, st)  # [C, D]
            if pack.max_approx:
                # padded slots carry the huge INACTIVE_SCORE constant in
                # their expansion column — no explicit mask needed
                fs = jnp.minimum(sc_aligned.min(axis=-1), MIN_SCORE_INIT)
            else:
                neg = jnp.where(pack.active[st.astype(jnp.int32)],
                                -sc_aligned, -jnp.inf)
                fs = -jax.scipy.special.logsumexp(neg, axis=-1)
        else:
            sc = mixture_scores_from_density(pack, density_scores(pack, f))
            fs = jnp.take_along_axis(sc, st[:, None].astype(jnp.int32),
                                     axis=1)[:, 0]
        return total + (fs.astype(jnp.float64) * m).sum(), None

    total, _ = jax.lax.scan(
        body, jnp.zeros((), jnp.float64),
        (feats_chunks, states_chunks, mask_chunks))
    return total


# -- state-sorted E-step passes ----------------------------------------------
# Frames grouped by their aligned mixture: each BLOCK scores against ONE
# mixture's [D, dim] parameters (VMEM-resident) — the reference's
# aligned-mixture-only scoring (Mixtures.cpp:296-305), ~S× less arithmetic
# than full-table scoring and none of the per-frame parameter-gather
# bandwidth. The trainer builds the sorted block index once per
# realignment and reuses it for every estimate pass under that alignment.

EM_BLOCK = 4096


def sorted_blocks(alignment: np.ndarray, num_mixtures: int,
                  block: int = EM_BLOCK):
    """Host-side grouping: frame indices sorted by aligned state, cut into
    per-state blocks of ``block`` rows (padded with -1). Returns
    (frame_idx int32 [NB, block], block_state int32 [NB], NB_used) with NB
    padded to the alignment-independent capacity ceil(N/block) + S so the
    device pass compiles once."""
    N = alignment.shape[0]
    order = np.argsort(alignment, kind="stable")
    counts = np.bincount(alignment, minlength=num_mixtures)
    nb_cap = -(-N // block) + num_mixtures
    frame_idx = np.full((nb_cap, block), -1, np.int64)
    block_state = np.zeros(nb_cap, np.int32)
    nb = 0
    pos = 0
    for s in range(num_mixtures):
        n_s = int(counts[s])
        for off in range(0, n_s, block):
            rows = order[pos + off: pos + min(off + block, n_s)]
            frame_idx[nb, : rows.shape[0]] = rows
            block_state[nb] = s
            nb += 1
        pos += n_s
    return frame_idx, block_state, nb


@partial(jax.jit, static_argnames=("first_pass",))
def em_pass_sorted(pack, frames: jnp.ndarray, mask: jnp.ndarray,
                   block_state: jnp.ndarray, first_pass: bool = False):
    """One fused AM-score + E-step pass over state-sorted frame blocks.

    frames f32 [NB, BLOCK, dim] (rows gathered in sorted order, padding
    rows arbitrary), mask f32 [NB, BLOCK], block_state int32 [NB].
    Returns (score_total f64, w [S,D], xs [S,D,dim], x2s [S,D,dim]) —
    the same statistics as em_accumulate_corpus/em_am_score_corpus
    (agreeing to ~1e-13 relative: the f64 accumulation of exact f32
    products still rounds, so the sorted-block order can differ from the
    chunked order in the last bits) and the same per-frame decisions
    (identical df op order per density).
    """
    is_df = isinstance(pack, ScorePackDF)
    S, D, dim = pack.num_mixtures, pack.density_cap, pack.dim
    if not (first_pass or pack.max_approx):
        raise NotImplementedError("sorted EM pass covers max-approx only")

    if is_df:
        from ..ops import doublefloat as dfm
        mu3 = dfm.DF(pack.mu.hi.reshape(S, D, dim),
                     pack.mu.lo.reshape(S, D, dim))
        iv3 = dfm.DF(pack.iv.hi.reshape(S, D, dim),
                     pack.iv.lo.reshape(S, D, dim))
        norm2 = dfm.DF(pack.norm.hi.reshape(S, D), pack.norm.lo.reshape(S, D))
        logw2 = dfm.DF(pack.logw.hi.reshape(S, D), pack.logw.lo.reshape(S, D))
    else:
        P3 = pack.P.reshape(-1, S, D)                  # [K, S, D]

    def body(carry, inp):
        total, w, xs, x2s = carry
        f, m, s = inp                                   # [BLOCK, dim], [BLOCK], ()
        if is_df:
            from ..ops import doublefloat as dfm
            x = f.astype(jnp.float32)
            acc = dfm.DF(jnp.zeros((f.shape[0], D), jnp.float32),
                         jnp.zeros((f.shape[0], D), jnp.float32))
            for i in range(dim):
                mu_i = dfm.DF(mu3.hi[s, :, i][None, :], mu3.lo[s, :, i][None, :])
                iv_i = dfm.DF(iv3.hi[s, :, i][None, :], iv3.lo[s, :, i][None, :])
                diff = dfm.add_f(dfm.neg(mu_i), x[:, i, None])
                acc = dfm.add(acc, dfm.mul(dfm.mul(diff, diff), iv_i))
            half = dfm.DF(acc.hi * 0.5, acc.lo * 0.5)
            sc = dfm.add(dfm.DF(norm2.hi[s][None, :], norm2.lo[s][None, :]),
                         half)
            sc = dfm.add(sc, dfm.neg(dfm.DF(logw2.hi[s][None, :],
                                            logw2.lo[s][None, :])))
            mn = dfm.min_axis(sc, axis=-1)
            eq = (sc.hi == mn.hi[:, None]) & (sc.lo == mn.lo[:, None])
            best = jnp.argmax(eq, axis=-1).astype(jnp.int32)
            capped_hi = jnp.minimum(mn.hi, jnp.float32(MIN_SCORE_INIT))
            capped_lo = jnp.where(mn.hi < jnp.float32(MIN_SCORE_INIT),
                                  mn.lo, 0.0)
            fs64 = (capped_hi.astype(jnp.float64)
                    + capped_lo.astype(jnp.float64))
        else:
            X = pack.features_expanded(f.astype(pack.dtype))  # [BLOCK, K]
            # HIGHEST: same cancellation argument as density_scores
            sc = jnp.dot(X, P3[:, s, :],
                         precision=jax.lax.Precision.HIGHEST)  # [BLOCK, D]
            best = jnp.argmin(sc, axis=-1).astype(jnp.int32)
            fs64 = jnp.minimum(sc.min(axis=-1),
                               MIN_SCORE_INIT).astype(jnp.float64)
        if first_pass:
            best = jnp.zeros_like(best)
        total = total + (fs64 * m).sum()
        f64 = f.astype(jnp.float64)
        m64 = m.astype(jnp.float64)
        cw = jax.ops.segment_sum(m64, best, num_segments=D)
        cxs = jax.ops.segment_sum(f64 * m64[:, None], best, num_segments=D)
        cx2s = jax.ops.segment_sum(f64 * f64 * m64[:, None], best,
                                   num_segments=D)
        return (total, w.at[s].add(cw), xs.at[s].add(cxs),
                x2s.at[s].add(cx2s)), None

    init = (jnp.zeros((), jnp.float64),
            jnp.zeros((S, D), jnp.float64),
            jnp.zeros((S, D, dim), jnp.float64),
            jnp.zeros((S, D, dim), jnp.float64))
    (total, w, xs, x2s), _ = jax.lax.scan(
        body, init, (frames, mask, block_state))
    return total, w, xs, x2s
