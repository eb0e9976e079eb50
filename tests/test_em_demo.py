"""End-to-end EM training parity on the demo corpus vs oracle fixtures."""

import json
import pathlib

import numpy as np
import pytest

from speechrecognition_tpu.io import read_alignment, read_mixture_set
from speechrecognition_tpu.models.gmm import MixtureModel, VarianceModel
from speechrecognition_tpu.tdp import TdpModel
from speechrecognition_tpu.train.em import Trainer, TrainerConfig

# oracle training config: tdp 20/0/20, pruning 120, 2 splits, 3 estimates
with open(pathlib.Path(__file__).parent / "fixtures"
          / "em_demo_am_scores.json") as _f:
    _ORACLE = json.load(_f)
TDP = _ORACLE["tdp"]
ORACLE_AM_SCORES = {(int(i), int(j), int(k)): s
                    for i, j, k, s in _ORACLE["trajectory"]}


@pytest.fixture(scope="module")
def trained(lexicon, demo_corpus, tmp_path_factory):
    import jax.numpy as jnp
    out = tmp_path_factory.mktemp("em")
    model = MixtureModel(dim=25, num_mixtures=lexicon.num_states,
                         var_model=VarianceModel.MIXTURE_POOLING, max_approx=True)
    tdp = TdpModel(silence_state=lexicon.silence_state, **TDP)
    cfg = TrainerConfig(min_obs=1, num_splits=2, num_aligns=1, num_estimates=3,
                        pruning_threshold=120.0,
                        mixture_path=str(out) + "/iter-",
                        alignment_path=str(out) + "/alignment-")
    trainer = Trainer(cfg, lexicon, model, tdp, max_approx=True,
                      dtype=jnp.float64, log=lambda *a: None)
    alignment = trainer.train(demo_corpus)
    return trainer, alignment, out


def test_am_score_trajectory(trained):
    trainer, _, _ = trained
    got = {}
    for line in trainer.stats_lines:
        i, j, k, s = line.split()
        got[(int(i), int(j), int(k))] = float(s)
    assert set(got) == set(ORACLE_AM_SCORES)
    for key, ref in ORACLE_AM_SCORES.items():
        # the oracle prints %g (6 significant digits) → tolerance 1e-4
        assert abs(got[key] - ref) < 1e-4, (key, got[key], ref)


def test_final_alignment_matches_oracle(trained, fixtures_dir):
    _, alignment, out = trained
    ref_states, _, _ = read_alignment(
        str(fixtures_dir / "demo_alignments" / "alignment-2-0.dump"))
    mine, _, _ = read_alignment(str(out / "alignment-2-0.dump"))
    assert mine.shape == ref_states.shape
    np.testing.assert_array_equal(mine, ref_states)


def test_mix_accumulators_close(trained, fixtures_dir):
    _, _, out = trained
    for name in ("iter-lin.mix", "iter-2.mix"):
        ref = read_mixture_set(str(fixtures_dir / name), 25)
        mine = read_mixture_set(str(out / name), 25)
        assert [len(m) for m in mine.mixtures] == [len(m) for m in ref.mixtures]
        np.testing.assert_array_equal(mine.mean_weight, ref.mean_weight)
        np.testing.assert_allclose(mine.mean_acc, ref.mean_acc,
                                   rtol=1e-9, atol=1e-7)


def test_lin_mix_exact(trained, fixtures_dir):
    """The linear-segmentation pass is deterministic (no pruning, no model):
    its accumulator counts must match the oracle exactly."""
    _, _, out = trained
    ref = read_mixture_set(str(fixtures_dir / "iter-lin.mix"), 25)
    mine = read_mixture_set(str(out / "iter-lin.mix"), 25)
    np.testing.assert_array_equal(mine.mean_weight, ref.mean_weight)
    np.testing.assert_allclose(mine.mean_acc, ref.mean_acc, rtol=1e-12, atol=1e-9)
