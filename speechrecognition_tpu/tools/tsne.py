"""t-SNE for NN-activation visualization, as a jitted gradient loop.

JAX counterpart of the reference's vendored van-der-Maaten t-SNE
(src/tSNE-plotting/tsne.py, applied to activations dumped by the
plot-activations action, SieTill.cpp:152-179): exact O(N²) t-SNE where
the pairwise affinities and gradients are dense matmul/elementwise ops,
scanned on the device; fine for the few thousand frames one visualizes.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import numpy as np

import jax
import jax.numpy as jnp


def _hbeta(D_row: np.ndarray, beta: float):
    P = np.exp(-D_row * beta)
    sumP = max(P.sum(), 1e-12)
    H = np.log(sumP) + beta * (D_row * P).sum() / sumP
    return H, P / sumP


def binary_search_perplexity(D: np.ndarray, perplexity: float = 30.0,
                             tol: float = 1e-5) -> np.ndarray:
    """Row-wise conditional affinities with the target perplexity
    (reference tsne.py x2p)."""
    n = D.shape[0]
    P = np.zeros((n, n))
    logU = np.log(perplexity)
    for i in range(n):
        idx = np.concatenate([np.arange(i), np.arange(i + 1, n)])
        beta, betamin, betamax = 1.0, -np.inf, np.inf
        Di = D[i, idx]
        H, thisP = _hbeta(Di, beta)
        for _ in range(50):
            if abs(H - logU) < tol:
                break
            if H > logU:
                betamin = beta
                beta = beta * 2 if betamax == np.inf else (beta + betamax) / 2
            else:
                betamax = beta
                beta = beta / 2 if betamin == -np.inf else (beta + betamin) / 2
            H, thisP = _hbeta(Di, beta)
        P[i, idx] = thisP
    return P


@partial(jax.jit, static_argnames=("n_iter",))
def _tsne_optimize(P: jnp.ndarray, Y0: jnp.ndarray, n_iter: int = 500,
                   ) -> jnp.ndarray:
    n = P.shape[0]

    def grad_step(carry, it):
        Y, dY, gains = carry
        sum_Y = jnp.sum(Y * Y, axis=1)
        num = 1.0 / (1.0 + sum_Y[:, None] + sum_Y[None, :]
                     - 2.0 * (Y @ Y.T))
        num = num * (1.0 - jnp.eye(n))
        Q = jnp.maximum(num / jnp.maximum(num.sum(), 1e-12), 1e-12)
        PQ = (P - Q) * num
        grad = 4.0 * ((jnp.diag(PQ.sum(axis=1)) - PQ) @ Y)
        momentum = jnp.where(it < 20, 0.5, 0.8)
        gains = jnp.where(jnp.sign(grad) != jnp.sign(dY),
                          gains + 0.2, gains * 0.8)
        gains = jnp.maximum(gains, 0.01)
        dY = momentum * dY - 50.0 * gains * grad
        Y = Y + dY
        Y = Y - Y.mean(axis=0, keepdims=True)
        return (Y, dY, gains), 0.0

    init = (Y0, jnp.zeros_like(Y0), jnp.ones_like(Y0))
    (Y, _, _), _ = jax.lax.scan(grad_step, init, jnp.arange(n_iter))
    return Y


def tsne(X: np.ndarray, perplexity: float = 30.0, n_iter: int = 500,
         seed: int = 0, early_exaggeration: float = 4.0) -> np.ndarray:
    """[N, D] → [N, 2] embedding."""
    X = np.asarray(X, np.float64)
    X = X - X.mean(axis=0)
    sq = (X * X).sum(axis=1)
    D = np.maximum(sq[:, None] + sq[None, :] - 2.0 * X @ X.T, 0.0)
    P = binary_search_perplexity(D, perplexity)
    P = (P + P.T) / max(P.sum(), 1e-12)
    rng = np.random.default_rng(seed)
    Y0 = jnp.asarray(rng.normal(0, 1e-4, (X.shape[0], 2)))
    Y = _tsne_optimize(jnp.asarray(P * early_exaggeration), Y0,
                       n_iter=n_iter // 2)
    Y = _tsne_optimize(jnp.asarray(P), Y, n_iter=n_iter - n_iter // 2)
    return np.asarray(Y)


def dump_activations(mlp, params: Dict, feats: np.ndarray,
                     layer_names, out_dir: str) -> None:
    """Forward a batch and write each named layer's activations as raw
    float32 (the plot-activations action, SieTill.cpp:152-179)."""
    import os
    os.makedirs(out_dir, exist_ok=True)
    acts = mlp.apply(params, jnp.asarray(feats))
    for name in layer_names:
        np.asarray(acts[name], np.float32).tofile(
            os.path.join(out_dir, f"{name}.activations"))


def plot_tsne(Y: np.ndarray, labels: np.ndarray, out_path: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 6))
    sc = ax.scatter(Y[:, 0], Y[:, 1], c=labels, s=4, cmap="tab20")
    fig.colorbar(sc, ax=ax, label="state")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
