"""plot-activations CLI action: forward the first minibatch through a
saved MLP and dump per-layer activation files (+ optional t-SNE plot),
mirroring the reference action (SieTill.cpp:152-179)."""

import json

import numpy as np

from speechrecognition_tpu import cli
from speechrecognition_tpu.config import Configuration
from speechrecognition_tpu.models.nn import MLP, layer_specs_from_config


LAYERS = [
    {"layer-name": "hidden-layer1", "num-outputs": 20,
     "type": "feed-forward", "nonlinearity": "sigmoid", "input": ["data"]},
    {"layer-name": "output-layer", "num-outputs": 106,
     "type": "output", "input": ["hidden-layer1"]},
]


def test_plot_activations_action(tmp_path, fixtures_dir):
    model_dir = str(tmp_path / "models") + "/"
    acts_dir = str(tmp_path / "activations")
    cfg = {
        "corpus": str(fixtures_dir / "demo_corpus.json"),
        "feature-path": str(fixtures_dir / "demo_features") + "/",
        "normalization-path": str(fixtures_dir / "normalization-demo.bin"),
        "target-file": str(fixtures_dir / "demo_alignments"
                           / "alignment-2-0.dump"),
        "context-frames": 1,
        "batch-size": 4,
        "layers": LAYERS,
        "model-path": model_dir,
        "activations-path": acts_dir,
    }
    # save a deterministic MLP in the reference raw-float32 layout
    mlp = MLP(layer_specs_from_config(Configuration(cfg)),
              input_dim=25 * 3)
    params = mlp.init_params(np.random.default_rng(0))
    mlp.save(params, model_dir)

    cfg_path = tmp_path / "plot.config"
    cfg_path.write_text(json.dumps(cfg))
    assert cli.main([str(cfg_path), "plot-activations"]) == 0

    labels = np.fromfile(f"{acts_dir}/labels.bin", np.int32)
    assert labels.size > 0
    for name, width in (("hidden-layer1", 20), ("output-layer", 106)):
        acts = np.fromfile(f"{acts_dir}/{name}.activations", np.float32)
        assert acts.size == labels.size * width
        assert np.isfinite(acts).all()
    # the output layer is a softmax: rows sum to 1
    out = np.fromfile(f"{acts_dir}/output-layer.activations",
                      np.float32).reshape(-1, 106)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-4)
