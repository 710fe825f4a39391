"""PyTorch port of the serving Predictor against the JAX Predictor on CPU.

Both serve the same Flax parameters (the port converts them on load) and the
same numpy requests. Outputs agree at float32 to 1e-5 relative / 1e-6
absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from healnet_tpu.models.healnet import HealNetModule as JaxHealNet
from healnet_tpu.serving import Predictor as JaxPredictor
from healnet_tpu.train.losses import hazards_survival_risk as jax_hsr
from healnet_tpu_torch.models.healnet import HealNetModule as TorchHealNet
from healnet_tpu_torch.serving import Predictor
from healnet_tpu_torch.train.losses import hazards_survival_risk
from healnet_tpu_torch.utils.train_utils import accepts_kv_masks

RTOL, ATOL = 1e-5, 1e-6
CFG = dict(
    n_modalities=2, channel_dims=(12, 6), num_spatial_axes=(1, 1), out_dims=4,
    depth=2, num_freq_bands=2, max_freq=2.0, l_c=5, l_d=8, x_heads=1, l_heads=2,
    cross_dim_head=6, latent_dim_head=4, self_per_cross_attn=0,
)
KEYS = ("logits", "hazards", "survival", "risk")


@pytest.fixture(scope="module")
def predictors():
    jmod = JaxHealNet(**CFG, projection_impl="xla")
    example = (jnp.zeros((2, 1, 12)), jnp.zeros((2, 16, 6)))
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(1), example)["params"]
    )
    kw = dict(batch_size=4, bucket_boundaries=[8, 16])
    jpred = JaxPredictor(jmod, params, **kw)
    tpred = Predictor(TorchHealNet(**CFG, device="cpu"), params, device="cpu", **kw)
    return jpred, tpred


def _assert_same(got, ref):
    assert set(got) == set(ref)
    for k in KEYS:
        assert got[k].dtype == np.float32 and got[k].shape == np.asarray(ref[k]).shape, k
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=RTOL, atol=ATOL, err_msg=k)


def _request(rng, n, tokens=16):
    return [
        rng.normal(size=(n, 1, 12)).astype(np.float32),
        rng.normal(size=(n, tokens, 6)).astype(np.float32),
    ]


def test_call_pads_last_micro_batch(rng, predictors):
    jpred, tpred = predictors
    req = _request(rng, 5)  # 5 = one full micro-batch of 4 + one padded
    _assert_same(tpred(req), jpred(req))


def test_call_missing_modality_and_masks(rng, predictors):
    jpred, tpred = predictors
    req = _request(rng, 3)
    _assert_same(tpred([None, req[1]]), jpred([None, req[1]]))
    mask = rng.uniform(size=(3, 16)) > 0.3
    _assert_same(tpred(req, kv_masks=[None, mask]), jpred(req, kv_masks=[None, mask]))


def test_empty_request(predictors):
    jpred, tpred = predictors
    got = tpred([np.zeros((0, 1, 12), np.float32), np.zeros((0, 16, 6), np.float32)])
    ref = jpred([np.zeros((0, 1, 12), np.float32), np.zeros((0, 16, 6), np.float32)])
    for k in KEYS:
        assert got[k].shape == ref[k].shape == ((0, 4) if k != "risk" else (0,))


def test_predict_ragged_two_buckets(rng, predictors):
    jpred, tpred = predictors
    omic = rng.normal(size=(5, 1, 12)).astype(np.float32)
    bags = [rng.normal(size=(n, 6)).astype(np.float32) for n in (5, 12, 8, 3, 16)]
    bags[3] = None  # a sample without its bag
    _assert_same(tpred.predict_ragged([omic, bags]), jpred.predict_ragged([omic, bags]))
    assert tpred._bucket_width(9) == 16 and tpred._bucket_width(40) == 16


def test_warmup(predictors):
    _, tpred = predictors
    out = tpred.warmup([(1, 12), (16, 6)])
    assert out["programs"] >= 3 and out["seconds"] >= 0.0


def test_survival_head_and_kv_mask_gate(rng):
    logits = rng.normal(size=(6, 4)).astype(np.float32)
    for got, ref in zip(hazards_survival_risk(torch.from_numpy(logits)),
                        jax_hsr(jnp.asarray(logits))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert accepts_kv_masks(TorchHealNet(**CFG, device="cpu"))
    assert not accepts_kv_masks(torch.nn.Linear(2, 2))


def test_predictor_needs_a_gpu_or_cpu_request():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(TorchHealNet(**CFG, device="cpu"))
