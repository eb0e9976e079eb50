"""Int8 quantized batch scorer + density preselection
(models/quantized.py vs Mm/BatchFeatureScorer.hh:199-333 +
Mm/DensityClustering.*): integer-path exactness, reference formula
checks, score fidelity vs the exact scorer on the committed AN4
global-pooling model, preselection semantics."""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from speechrecognition_tpu.io import read_mixture_set
from speechrecognition_tpu.models.gmm import (MixtureModel, VarianceModel,
                                              am_scores)
from speechrecognition_tpu.models.quantized import (
    BACKOFF_SCORE, INACTIVE_INT, QuantPack, am_scores_q, build_quant_pack,
    quantize_features, quantized_distances)

AN4_MIX = "bench/an4/am.mix"
AN4_DIM = 45


@pytest.fixture(scope="module")
def an4_model():
    raw = read_mixture_set(AN4_MIX, AN4_DIM)
    return MixtureModel.from_raw(raw, VarianceModel.GLOBAL_POOLING,
                                 max_approx=True)


@pytest.fixture(scope="module")
def qpack(an4_model):
    return build_quant_pack(an4_model)


@pytest.fixture(scope="module")
def sample_features(an4_model):
    """Features near the model's own means (realistic score range)."""
    rng = np.random.RandomState(0)
    mi = rng.randint(0, an4_model.means.shape[0], 64)
    x = (an4_model.means[mi]
         + rng.randn(64, AN4_DIM) * np.sqrt(an4_model.vars[0]) * 0.5)
    return np.nan_to_num(x).astype(np.float32)


def test_rejects_non_pooled_model(fixtures_dir):
    raw = read_mixture_set(str(fixtures_dir / "iter-2.mix"), 25)
    model = MixtureModel.from_raw(raw, VarianceModel.MIXTURE_POOLING,
                                  max_approx=True)
    with pytest.raises(ValueError, match="globally pooled"):
        build_quant_pack(model)


def test_quantization_scale_formula(an4_model, qpack):
    """scale = 255 / (1.25 · 2·max|mean·invsqrt(var)|)
    (BatchFeatureScorer.cc:375-396)."""
    isv = 1.0 / np.sqrt(an4_model.vars[0])
    divided = an4_model.means * isv[None, :]
    maxabs = np.nanmax(np.abs(divided))
    scale = 255.0 / (1.25 * 2.0 * maxabs)
    assert qpack.scale2x == pytest.approx(2.0 * scale * scale, rel=1e-12)


def test_constants_formula(an4_model, qpack):
    """c = ⌊scale²·logNorm − 2scale²·logw⌋ (init, :413-436)."""
    scale_sq = qpack.scale2x / 2.0
    log_norm = 2.0 * float(an4_model.norm[0])
    s = next(i for i, mix in enumerate(an4_model.mixtures)
             if mix and np.isfinite(
                 an4_model.mean_weights_log[mix[0][0]]))
    d = 0
    mi, _vi = an4_model.mixtures[s][d]
    want = math.floor(scale_sq * log_norm
                      - qpack.scale2x * an4_model.mean_weights_log[mi])
    got = int(np.asarray(qpack.consts)[s * qpack.density_cap + d])
    assert got == want


def test_integer_distances_bit_exact(qpack, sample_features):
    """The s8×s8→s32 matmul expansion equals the reference's
    Σ (qx − qm)² integer distance exactly."""
    qx = np.asarray(quantize_features(qpack, jnp.asarray(sample_features)))
    d_dev = np.asarray(quantized_distances(qpack, jnp.asarray(qx)))
    qm = np.asarray(qpack.qmeans).astype(np.int64)
    qx64 = qx.astype(np.int64)
    d_np = ((qx64[:, None, :] - qm[None, :64, :]) ** 2).sum(-1)
    assert np.array_equal(d_np, d_dev[:, :64])


def test_quantized_scores_close_to_exact(an4_model, qpack, sample_features):
    """Score fidelity: bounded absolute error on active states and the
    same argmin state on every frame (the max-approx decision)."""
    sq = np.asarray(am_scores_q(qpack, jnp.asarray(sample_features)))
    pack = an4_model.pack(dtype=jnp.float64)
    se = np.asarray(am_scores(pack, jnp.asarray(sample_features,
                                                jnp.float64)))
    live = se < 1e9                    # states with any active density
    err = np.abs(sq - se)[live]
    assert err.max() < 2.0             # observed ≈0.3; bound generously
    assert np.array_equal(sq.argmin(1), se.argmin(1))


def test_preselection_semantics(an4_model, qpack, sample_features):
    x = jnp.asarray(sample_features)
    sq = np.asarray(am_scores_q(qpack, x))
    qp_pre = build_quant_pack(an4_model, preselection=True)
    sp = np.asarray(am_scores_q(qp_pre, x))
    # the min runs over the SELECTED densities only: scores can only go
    # up (fewer candidates), never down; states with nothing selected
    # read the backoff
    is_backoff = sp == np.float32(BACKOFF_SCORE)
    assert 0.0 < is_backoff.mean() < 1.0
    assert np.all(sp[~is_backoff] >= sq[~is_backoff] - 1e-4)
    # the winning (argmin) state's score is preserved exactly — its
    # best density's cluster is selected for in-distribution frames
    # (the clustering's whole point)
    rows = np.arange(sp.shape[0])
    assert np.array_equal(sp.argmin(1), sq.argmin(1))
    assert np.array_equal(sp[rows, sp.argmin(1)], sq[rows, sq.argmin(1)])


def test_preselection_select_all_is_identity(an4_model, sample_features):
    """select-clusters == clusters ⇒ no preselection
    (paramSelectClusters doc, DensityClustering.cc:20-24), up to
    empty states mapping to the backoff."""
    x = jnp.asarray(sample_features)
    qp = build_quant_pack(an4_model)
    qp_all = build_quant_pack(an4_model, preselection=True, n_selected=256)
    sq = np.asarray(am_scores_q(qp, x))
    sa = np.asarray(am_scores_q(qp_all, x))
    nonempty = sq < float(INACTIVE_INT) / qp.scale2x * 0.5
    assert np.array_equal(sq[nonempty], sa[nonempty])
    assert np.all(sa[~nonempty] == np.float32(BACKOFF_SCORE))


def test_wcts_decode_with_quantized_am(an4_model, sample_features):
    """The quantized scores drop into the WCTS decode exactly like the
    float scorer's [B, T, S] tensor (the `SIMD-diagonal-maximum`
    production wiring, Mm/Module.cc:84): identical shapes/dtype."""
    from speechrecognition_tpu.models.quantized import am_scores_q_chunked

    qp = build_quant_pack(an4_model, preselection=True)
    am = am_scores_q_chunked(qp, jnp.asarray(sample_features))
    assert am.shape == (64, an4_model.num_mixtures)
    assert am.dtype == jnp.float32
    assert bool(jnp.isfinite(am).all())
