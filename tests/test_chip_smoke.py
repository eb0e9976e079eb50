"""chip_smoke.py: its phases on the CPU device, its refusal to run without a
GPU, the compile-cache rule, and the GPU runs themselves (marked `gpu`)."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def test_df32_exact_phase_on_cpu():
    info = chip_smoke.df32_exact()
    assert info["pairs"] == 1 << 20
    assert info["mismatches"] == {"two_sum": 0, "fast_two_sum": 0,
                                  "split": 0, "two_prod": 0}
    assert max(info["max_rel_err_log2"].values()) <= -44


def test_df32_exact_catches_a_contracted_split(monkeypatch):
    """An FMA-contracted Dekker split (t - a computed exactly as
    fma(a, 4097, -a)) must be reported, not passed."""
    from speechrecognition_tpu.ops import doublefloat as dfm

    def contracted_split(a):
        t = a * dfm._SPLIT
        hi = t - (a * 4096.0)          # exact a*4097 - a == 4096*a
        return hi, a - hi

    monkeypatch.setattr(dfm, "split", contracted_split)
    with pytest.raises(chip_smoke.PhaseFailed, match="split"):
        chip_smoke.df32_exact(n=1 << 12)


def test_golden_demo_phase_on_cpu():
    info = chip_smoke.golden_demo()
    assert info == {"utterances": 35, "wer": 19.587629, "ser": 20.0,
                    "sid": [4, 14, 1]}


def test_replicate_keeps_utterances():
    lex = chip_smoke._lexicon()
    demo = chip_smoke._demo_corpus(lex)
    rep = chip_smoke._replicate(demo, 80)
    assert rep.num_segments == 80
    for s in (0, 34, 35, 79):
        np.testing.assert_array_equal(rep.feature_sequence(s),
                                      demo.feature_sequence(s % 35))
        assert rep.orths[s] == demo.orths[s % 35]


def test_main_refuses_a_cpu_only_run(capsys):
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_prints_no_result(tmp_path):
    """Run from a directory that holds chip_smoke.py and nothing else of
    the repository, the script exits non-zero and prints no result (here
    for want of a GPU; on a GPU host for want of the package)."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("env_set", [True, False], ids=["env-set", "env-unset"])
def test_compile_cache_dir(env_set, tmp_path, monkeypatch):
    from speechrecognition_tpu import compile_cache

    before = jax.config.jax_compilation_cache_dir
    before_min = jax.config.jax_persistent_cache_min_compile_time_secs
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = compile_cache.enable_compile_cache()
        if env_set:
            # JAX reads the variable itself; nothing in code overrides it
            assert got == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            assert got == compile_cache.REPO_CACHE_DIR
            assert got == str(REPO / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 1.0
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          before_min)


def test_score_pack_has_no_method_and_flattens(fixtures_dir):
    import jax.numpy as jnp
    from speechrecognition_tpu.io import read_mixture_set
    from speechrecognition_tpu.models.gmm import (MixtureModel, ScorePack,
                                                  VarianceModel, am_scores)

    model = MixtureModel.from_raw(
        read_mixture_set(str(fixtures_dir / "iter-2.mix"), 25),
        VarianceModel.MIXTURE_POOLING, max_approx=True)
    pack = model.pack(dtype=jnp.float32)
    assert not hasattr(pack, "method")
    leaves, treedef = jax.tree_util.tree_flatten(pack)
    assert len(leaves) == 2
    assert leaves[0].shape == (2 * 25 + 1,
                               pack.num_mixtures * pack.density_cap)
    again = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(again, ScorePack)
    assert (again.num_mixtures, again.density_cap, again.dim) == \
        (pack.num_mixtures, pack.density_cap, pack.dim)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(16, 25)),
                    jnp.float32)
    np.testing.assert_array_equal(np.asarray(jax.jit(am_scores)(pack, x)),
                                  np.asarray(am_scores(again, x)))


# -- on the card -----------------------------------------------------------------


def _gpu_count() -> int:
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return 0
    return out.stdout.count("GPU ") if out.returncode == 0 else 0


def _run_on_gpu(*args):
    # this test process stays on the CPU; the child owns the card and
    # keeps the CPU backend for its reference runs
    env = dict(os.environ, JAX_PLATFORMS="cuda,cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py", *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()


@pytest.mark.gpu
def test_chip_smoke_on_one_gpu():
    if _gpu_count() < 1:
        pytest.skip("needs an NVIDIA GPU; nvidia-smi finds none")
    lines = _run_on_gpu()
    last = json.loads(lines[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
    for phase in chip_smoke.PHASES:
        assert any(line.startswith(f"phase {phase.__name__}:")
                   and " pass " in line for line in lines), phase.__name__


@pytest.mark.gpu
def test_chip_smoke_multi_on_four_gpus():
    if _gpu_count() < 4:
        pytest.skip("needs 4 NVIDIA GPUs; nvidia-smi finds fewer")
    lines = _run_on_gpu("--multi")
    last = json.loads(lines[-1])
    assert last["ok"] is True and last["device"]["count"] == 4
    assert any(line.startswith("phase multi:") and " pass " in line
               for line in lines)
