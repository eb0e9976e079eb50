"""Plot/stats tooling + CLI smoke tests."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest


def test_am_score_parsing_and_plot(fixtures_dir, tmp_path):
    from speechrecognition_tpu.tools.plots import plot_am_scores, read_am_scores
    rows = read_am_scores(str(fixtures_dir / "am_scores.data"))
    assert rows[0] == (-1, 0, 0, 32.9885)
    assert len(rows) == 10
    out = tmp_path / "am.png"
    plot_am_scores(str(fixtures_dir / "am_scores.data"), str(out))
    assert out.stat().st_size > 1000


def test_energy_plot_and_pgm(tmp_path):
    from speechrecognition_tpu.tools.plots import (dump_log_spectrum_pgm,
                                                   plot_energy_segmentation)
    rng = np.random.default_rng(0)
    energy = rng.normal(-2, 1, 300).astype(np.float32)
    out = tmp_path / "e.png"
    plot_energy_segmentation(energy, 40, 260, str(out))
    assert out.stat().st_size > 1000
    spec = rng.random((100, 257)) + 1e-6
    pgm = tmp_path / "s.pgm"
    dump_log_spectrum_pgm(spec, str(pgm))
    with open(pgm, "rb") as f:
        assert f.read(2) == b"P5"


def test_prior_plot(tmp_path):
    from speechrecognition_tpu.tools.plots import plot_state_priors
    p1 = np.random.default_rng(0).random(106)
    p1 /= p1.sum()
    out = tmp_path / "p.png"
    plot_state_priors({"alignment": p1, "uniform": np.full(106, 1 / 106)}, str(out))
    assert out.exists()


def test_nn_stats_roundtrip(tmp_path):
    from speechrecognition_tpu.tools.plots import plot_nn_training, read_nn_stats
    path = tmp_path / "nn.data"
    with open(path, "w") as f:
        f.write("Train frame error rate # Cv frame error rate # Time (s)\n")
        f.write("0.5 # 0.6 # 12.0\n0.4 # 0.55 # 11.0\n")
    train, cv, times = read_nn_stats(str(path))
    np.testing.assert_allclose(train, [0.5, 0.4])
    np.testing.assert_allclose(cv, [0.6, 0.55])
    plot_nn_training(str(path), str(tmp_path / "nn.png"))
    assert (tmp_path / "nn.png").exists()


def test_cli_recognize_smoke(fixtures_dir, tmp_path):
    """Drive the CLI end-to-end on the demo fixtures (recognize action)."""
    config = {
        "action": "recognize",
        "pooling": "mixture", "max-approx": True,
        "corpus": str(fixtures_dir / "demo_corpus.json"),
        "feature-path": str(fixtures_dir / "demo_features") + "/",
        "normalization-path": str(fixtures_dir / "normalization-demo.bin"),
        "tdp-loop": 3.0, "tdp-forward": 0.0, "tdp-skip": 30.0,
        "load-mixtures-from": str(fixtures_dir / "iter-2.mix"),
        "feature-scorer": "gmm",
        "am-threshold": 200.0, "word-penalty": 80.0, "pruned-search": True,
    }
    cfg_path = tmp_path / "rec.json"
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; from speechrecognition_tpu.cli import main;"
         f"sys.exit(main(['{cfg_path}']))"],
        capture_output=True, text=True, env=env,
        cwd=str(fixtures_dir.parents[1]), timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "WER: 19.587629%" in proc.stderr
    assert "SER: 20.000000%" in proc.stderr


def test_tsne_separates_clusters():
    """t-SNE on two well-separated Gaussian blobs must keep them apart."""
    from speechrecognition_tpu.tools.tsne import tsne
    rng = np.random.default_rng(0)
    a = rng.normal(0, 0.3, (60, 10))
    b = rng.normal(4, 0.3, (60, 10))
    Y = tsne(np.vstack([a, b]), perplexity=15.0, n_iter=400)
    ca, cb = Y[:60].mean(axis=0), Y[60:].mean(axis=0)
    labels = np.array([0] * 60 + [1] * 60)
    assign = (np.linalg.norm(Y - ca, axis=1)
              > np.linalg.norm(Y - cb, axis=1)).astype(int)
    assert (assign == labels).mean() >= 0.95


def test_dump_activations(tmp_path):
    from speechrecognition_tpu.config import Configuration
    from speechrecognition_tpu.models.nn import MLP, layer_specs_from_config
    from speechrecognition_tpu.tools.tsne import dump_activations
    cfg = Configuration({"layers": [
        {"layer-name": "h1", "num-outputs": 8, "type": "feed-forward",
         "nonlinearity": "sigmoid", "input": ["data"]},
        {"layer-name": "out", "num-outputs": 5, "type": "output", "input": ["h1"]},
    ]})
    mlp = MLP(layer_specs_from_config(cfg), input_dim=6)
    params = mlp.init_params(np.random.default_rng(0))
    feats = np.random.default_rng(1).normal(0, 1, (20, 6)).astype(np.float32)
    dump_activations(mlp, params, feats, ["h1", "out"], str(tmp_path))
    h1 = np.fromfile(tmp_path / "h1.activations", dtype=np.float32)
    assert h1.size == 20 * 8
