"""Hybrid MLP acoustic scorer (the reference's NN stack, batched).

Replicates the semantics of src/sietill/{NetworkLayer,FeedForwardLayer,
OutputLayer,NeuralNetwork}.{hpp,cpp}: named layers built from the config's
"layers" array, topologically sorted by declared inputs, y=σ(Wx+b) layers
(sigmoid/tanh/relu/none) and a log-space-softmax output layer. The
reference runs one BLAS sgemm per timestep under OpenMP
(FeedForwardLayer.cpp:96-167); here the whole (T·B, D) batch is a single
matmul per layer.

Scoring (NeuralNetwork.cpp:184-199): score(t, s) = −log softmax(t, s)
+ κ·log prior(s), with the prior loaded from a text file of state
frequencies (::293-305).

The backward pass uses jax.grad, which computes exactly the reference's
hand-written gradients (CE+softmax error `p − y`, NeuralNetwork.cpp:266;
inner derivatives σ', FeedForwardLayer.cpp:254-279). The optional weight
decay replicates the reference quirk of adding the decay term once per
*timestep* (FeedForwardLayer.cpp:343-361: the decay is added inside the
time loop, so its effective strength scales with max_len).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..config import Configuration, ParameterFloat, ParameterString


@dataclass(frozen=True)
class LayerSpec:
    name: str
    num_outputs: int
    kind: str            # "feed-forward" | "output"
    nonlinearity: str    # "sigmoid" | "tanh" | "relu" | "" (none)
    inputs: Tuple[str, ...]
    weight_decay: str = ""
    weight_decay_factor: float = 0.0


def layer_specs_from_config(config: Configuration) -> List[LayerSpec]:
    specs = []
    for c in config.get_array("layers"):
        specs.append(LayerSpec(
            name=ParameterString("layer-name", "")(c),
            num_outputs=c.get_value("num-outputs"),
            kind=ParameterString("type", "feed-forward")(c),
            nonlinearity=ParameterString("nonlinearity", "")(c),
            inputs=tuple(c.get_string_array("input")),
            weight_decay=ParameterString("weight-decay", "")(c),
            weight_decay_factor=ParameterFloat("weight-decay-factor", 0.0)(c),
        ))
    return topo_sort(specs)


def topo_sort(specs: List[LayerSpec]) -> List[LayerSpec]:
    """Order layers so every input is produced first (NeuralNetwork.cpp:73-166)."""
    placed: List[LayerSpec] = []
    have = {"data"}
    remaining = list(specs)
    while remaining:
        progress = False
        for s in list(remaining):
            if all(i in have for i in s.inputs):
                placed.append(s)
                have.add(s.name)
                remaining.remove(s)
                progress = True
        if not progress:
            raise ValueError(f"layer graph has a cycle or missing input: "
                             f"{[s.name for s in remaining]}")
    return placed


def _nonlin(name: str, x: jnp.ndarray) -> jnp.ndarray:
    if name == "sigmoid":
        return 1.0 / (1.0 + jnp.exp(-x))
    if name == "tanh":
        return 2.0 / (1.0 + jnp.exp(-2.0 * x)) - 1.0
    if name == "relu":
        return jnp.maximum(x, 0.0)
    return x


@dataclass
class MLP:
    """Parameterized network; params is a {layer: {"W": [H,D], "b": [H]}} pytree."""

    specs: List[LayerSpec]
    input_dim: int

    def layer_input_dim(self, spec: LayerSpec) -> int:
        dim = 0
        for inp in spec.inputs:
            if inp == "data":
                dim += self.input_dim
            else:
                dim += next(s.num_outputs for s in self.specs if s.name == inp)
        return dim

    def init_params(self, rng: np.random.Generator, scale: float = 0.1) -> Dict:
        """Normal(0, 0.1) init (NNTraining.cpp:300-301)."""
        params = {}
        for s in self.specs:
            D = self.layer_input_dim(s)
            params[s.name] = {
                "W": jnp.asarray(rng.normal(0.0, scale, (s.num_outputs, D)),
                                 jnp.float32),
                "b": jnp.asarray(rng.normal(0.0, scale, (s.num_outputs,)),
                                 jnp.float32),
            }
        return params

    def apply(self, params: Dict, x: jnp.ndarray) -> Dict[str, jnp.ndarray]:
        """x: [..., input_dim] → dict of layer activations; output layer
        yields log-softmax (stable, OutputLayer.cpp:30-67)."""
        acts: Dict[str, jnp.ndarray] = {"data": x}
        log_probs = None
        for s in self.specs:
            inp = jnp.concatenate([acts[i] for i in s.inputs], axis=-1)
            # HIGHEST: f32 as in the reference MLP, never TF32
            z = jnp.dot(inp, params[s.name]["W"].T,
                        precision=jax.lax.Precision.HIGHEST) + params[s.name]["b"]
            if s.kind == "output":
                log_probs = jax.nn.log_softmax(z, axis=-1)
                acts[s.name] = jnp.exp(log_probs)
            else:
                acts[s.name] = _nonlin(s.nonlinearity, z)
        if log_probs is None:
            raise ValueError("network has no output layer")
        acts["__log_probs__"] = log_probs
        return acts

    def log_probs(self, params: Dict, x: jnp.ndarray) -> jnp.ndarray:
        return self.apply(params, x)["__log_probs__"]

    # -- loss ---------------------------------------------------------------

    def loss(self, params: Dict, x: jnp.ndarray, targets: jnp.ndarray,
             frame_mask: jnp.ndarray, max_len: Optional[int] = None) -> jnp.ndarray:
        """Masked cross-entropy, averaged over frames (NNTraining.cpp:432-455).
        targets: one-hot (or weighted) [T, B, C]; frame_mask [T, B]."""
        lp = self.log_probs(params, x)
        ce = -(targets * lp).sum(axis=-1) * frame_mask
        decay = 0.0
        if max_len is not None:
            for s in self.specs:
                if s.weight_decay == "l2" and s.weight_decay_factor:
                    W = params[s.name]["W"]
                    decay = decay + 0.5 * s.weight_decay_factor * max_len * (W * W).sum()
        return ce.sum() / frame_mask.sum() + decay

    # -- gradient check (NetworkLayer.cpp:36-112) ---------------------------

    def gradient_check(self, params: Dict, x: jnp.ndarray, targets: jnp.ndarray,
                       frame_mask: jnp.ndarray, eps: float = 1e-4,
                       tolerance: float = 1e-2, samples: int = 50,
                       rng: Optional[np.random.Generator] = None) -> float:
        """Central finite differences on a random parameter subset vs
        jax.grad; returns the max relative deviation. Runs in float64 so the
        finite differences are meaningful (f32 FD noise alone is ~1e-3)."""
        rng = rng or np.random.default_rng(0)
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), params)
        x = x.astype(jnp.float64)
        targets = targets.astype(jnp.float64)
        frame_mask = frame_mask.astype(jnp.float64)
        loss_fn = lambda p: self.loss(p, x, targets, frame_mask)
        g = jax.grad(loss_fn)(params)
        flat, tree = jax.tree_util.tree_flatten(params)
        gflat, _ = jax.tree_util.tree_flatten(g)
        worst = 0.0
        for _ in range(samples):
            li = rng.integers(len(flat))
            arr = np.asarray(flat[li])
            idx = tuple(rng.integers(d) for d in arr.shape)
            orig = arr[idx]
            arr_p = arr.copy(); arr_p[idx] = orig + eps
            arr_m = arr.copy(); arr_m[idx] = orig - eps
            fp = float(loss_fn(jax.tree_util.tree_unflatten(
                tree, flat[:li] + [jnp.asarray(arr_p)] + flat[li+1:])))
            fm = float(loss_fn(jax.tree_util.tree_unflatten(
                tree, flat[:li] + [jnp.asarray(arr_m)] + flat[li+1:])))
            fd = (fp - fm) / (2 * eps)
            an = float(np.asarray(gflat[li])[idx])
            denom = max(abs(fd), abs(an), 1e-8)
            worst = max(worst, abs(fd - an) / denom)
        if worst > tolerance:
            raise AssertionError(f"gradient check failed: {worst} > {tolerance}")
        return worst

    # -- reference-format serialization (raw float32 per layer) -------------

    def save(self, params: Dict, folder: str) -> None:
        import os
        os.makedirs(folder, exist_ok=True)
        for s in self.specs:
            W = np.asarray(params[s.name]["W"], np.float32)
            b = np.asarray(params[s.name]["b"], np.float32)
            with open(folder + s.name, "wb") as f:
                W.tofile(f)
                b.tofile(f)

    def load(self, folder: str) -> Dict:
        params = {}
        for s in self.specs:
            D = self.layer_input_dim(s)
            raw = np.fromfile(folder + s.name, dtype=np.float32)
            if raw.size != s.num_outputs * D + s.num_outputs:
                raise ValueError(f"bad parameter file for layer {s.name}")
            params[s.name] = {
                "W": jnp.asarray(raw[: s.num_outputs * D].reshape(s.num_outputs, D)),
                "b": jnp.asarray(raw[s.num_outputs * D:]),
            }
        return params


# -- updaters (NNTraining.cpp:211-260) ---------------------------------------


class SGDUpdater:
    def __init__(self, learning_rate: float = 0.001):
        self.learning_rate = learning_rate

    def init_state(self, params: Dict) -> Dict:
        return {}

    def update(self, params: Dict, grads: Dict, state: Dict) -> Tuple[Dict, Dict]:
        new = jax.tree_util.tree_map(
            lambda p, g: p - self.learning_rate * g, params, grads)
        return new, state


class AdaDeltaUpdater:
    """AdaDelta with RMS accumulators (NNTraining.cpp:230-260;
    momentum 0.9, stability 1e-8, no learning-rate scaling)."""

    def __init__(self, momentum: float = 0.90, stability: float = 1e-8,
                 learning_rate: float = 0.001):
        self.momentum = momentum
        self.stability = stability
        self.learning_rate = learning_rate  # unused by the update, kept for parity

    def init_state(self, params: Dict) -> Dict:
        z = jax.tree_util.tree_map(jnp.zeros_like, params)
        return {"grad_rms": z, "update_rms": jax.tree_util.tree_map(jnp.zeros_like, params)}

    def update(self, params: Dict, grads: Dict, state: Dict) -> Tuple[Dict, Dict]:
        m, eps = self.momentum, self.stability

        def upd(p, g, grms, urms):
            grms_new = m * grms + (1 - m) * g * g
            step = jnp.sqrt(urms + eps) / jnp.sqrt(grms_new + eps) * -g
            urms_new = m * urms + (1 - m) * step * step
            return p + step, grms_new, urms_new

        out = jax.tree_util.tree_map(upd, params, grads,
                                     state["grad_rms"], state["update_rms"])
        new_params = jax.tree_util.tree_map(lambda t: t[0], out,
                                            is_leaf=lambda t: isinstance(t, tuple))
        grad_rms = jax.tree_util.tree_map(lambda t: t[1], out,
                                          is_leaf=lambda t: isinstance(t, tuple))
        update_rms = jax.tree_util.tree_map(lambda t: t[2], out,
                                            is_leaf=lambda t: isinstance(t, tuple))
        return new_params, {"grad_rms": grad_rms, "update_rms": update_rms}


# -- scorer for the decoder ---------------------------------------------------


@dataclass
class NNScorer:
    """FeatureScorer-compatible: am[t, s] = −log p(s|x_t) + κ·log prior(s)."""

    mlp: MLP
    params: Dict
    log_prior: jnp.ndarray   # [num_classes], already scaled by prior_scale
    context_frames: int

    @staticmethod
    def load_prior(path: str, num_classes: int, prior_scale: float) -> jnp.ndarray:
        vals = np.loadtxt(path).reshape(-1)[:num_classes]
        return jnp.asarray(prior_scale * np.log(vals), jnp.float32)

    def am_batch(self, feats: np.ndarray, base_dim: int) -> jnp.ndarray:
        """feats f32 [B, T, base_dim] → scores [B, T, C]."""
        x = jnp.asarray(feats)
        windows = build_context_windows(x, self.context_frames)
        lp = self.mlp.log_probs(self.params, windows)
        return -lp + self.log_prior[None, None, :]


def build_context_windows(x: jnp.ndarray, context_frames: int) -> jnp.ndarray:
    """[B, T, D] → [B, T, (2k+1)·D] with *zero* padding outside the sequence
    (the reference leaves out-of-range context at 0, NNTraining.cpp:123-127)."""
    if context_frames == 0:
        return x
    k = context_frames
    B, T, D = x.shape
    padded = jnp.pad(x, ((0, 0), (k, k), (0, 0)))
    parts = [padded[:, d: d + T, :] for d in range(2 * k + 1)]
    return jnp.concatenate(parts, axis=-1)
