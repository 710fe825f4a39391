"""PyTorch port of HealNetModule against the JAX package on CPU.

The same Flax parameters, converted by ``compat.flax_params``, and the same
numpy inputs go through both models. Logits agree at float32 to 1e-5
relative / 1e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from healnet_tpu.models.healnet import HealNetModule as JaxHealNet
from healnet_tpu.models.layers import PreNormAttention as JaxPreNormAttention
from healnet_tpu_torch.compat.flax_params import flax_from_state_dict, state_dict_from_flax
from healnet_tpu_torch.models.healnet import HealNetModule as TorchHealNet
from healnet_tpu_torch.models.layers import Attention, PreNormAttention

RTOL, ATOL = 1e-5, 1e-6

BASE = dict(
    n_modalities=2, channel_dims=(12, 10), num_spatial_axes=(1, 2), out_dims=4,
    depth=2, num_freq_bands=2, max_freq=2.0, l_c=5, l_d=8, x_heads=2, l_heads=2,
    cross_dim_head=6, latent_dim_head=4,
)


def _inputs(rng, b=3, n=2):
    x = [
        rng.normal(size=(b, 1, 12)).astype(np.float32),
        rng.normal(size=(b, 4, 5, 10)).astype(np.float32),
    ]
    if n == 3:  # a third bag, as bench.py's trimodal row adds one
        x.append(rng.normal(size=(b, 16, 7)).astype(np.float32))
    return x


def _pair(rng, torch_kw=None, **kw):
    cfg = {**BASE, **kw}
    jmod = JaxHealNet(**cfg, projection_impl="xla")
    x = _inputs(rng, n=cfg["n_modalities"])
    params = jmod.init(jax.random.PRNGKey(0), tuple(map(jnp.asarray, x)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tmod = TorchHealNet(**cfg, **(torch_kw or {}), device="cpu").eval()
    tmod.load_state_dict(state_dict_from_flax(params))
    return jmod, params, tmod, x


def _run_both(jmod, params, tmod, x, presence=None, kv_masks=None):
    ref = jmod.apply(
        {"params": params}, tuple(map(jnp.asarray, x)),
        presence=None if presence is None else jnp.asarray(presence),
        kv_masks=None if kv_masks is None else tuple(
            None if m is None else jnp.asarray(m) for m in kv_masks),
    )
    with torch.no_grad():
        got = tmod(
            [torch.from_numpy(a) for a in x],
            presence=None if presence is None else torch.from_numpy(presence),
            kv_masks=None if kv_masks is None else [
                None if m is None else torch.from_numpy(m) for m in kv_masks],
        )
    return got, ref


@pytest.mark.parametrize(
    "kw",
    [
        dict(self_per_cross_attn=0, snn=True),
        dict(self_per_cross_attn=1, snn=True),
        dict(self_per_cross_attn=0, snn=False),
        dict(self_per_cross_attn=1, snn=False, depth=3, weight_tie_layers=True),
        dict(self_per_cross_attn=0, snn=True, x_heads=1, n_modalities=3,
             channel_dims=(12, 10, 7), num_spatial_axes=(1, 2, 1)),
    ],
    ids=["d2_s0_snn", "d2_s1_snn", "d2_s0_gelu", "d3_tied_s1_gelu", "trimodal_s0_snn"],
)
def test_logits_match_jax(rng, kw):
    jmod, params, tmod, x = _pair(rng, **kw)
    got, ref = _run_both(jmod, params, tmod, x)
    assert tuple(got.shape) == (3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_weight_tying_shares_modules(rng):
    _, params, tmod, _ = _pair(rng, depth=3, weight_tie_layers=True, self_per_cross_attn=1)
    assert "layer1_cross_ff_shared" in params and "layer2_cross_attn_m0" not in params
    assert tmod.groups[1]["cross_ffs"] == ["layer1_cross_ff_shared"] * 2
    assert set(tmod.state_dict()) == set(state_dict_from_flax(params))


def test_missing_modality_and_kv_masks(rng):
    jmod, params, tmod, x = _pair(rng, self_per_cross_attn=1)
    presence = np.array([[1, 1], [1, 0], [0, 1]], np.float32)
    mask = rng.uniform(size=(3, 20)) > 0.4
    mask[2] = False  # a sample whose whole bag is masked
    got, ref = _run_both(jmod, params, tmod, x, presence=presence, kv_masks=[None, mask])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    no_mask, _ = _run_both(jmod, params, tmod, x, presence=presence)
    assert float((got - no_mask).abs().max()) > 1e-4


def test_kernel_impls_take_plain_version_on_cpu(rng):
    jmod, params, tmod, x = _pair(
        rng, torch_kw=dict(attention_impl="flash", projection_impl="pallas"))
    mask = rng.uniform(size=(3, 20)) > 0.3
    got, ref = _run_both(jmod, params, tmod, x, kv_masks=[None, mask])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_return_embeddings(rng):
    jmod, params, tmod, x = _pair(rng)
    ref = jmod.apply({"params": params}, tuple(map(jnp.asarray, x)), return_embeddings=True)
    with torch.no_grad():
        got = tmod([torch.from_numpy(a) for a in x], return_embeddings=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_flax_state_dict_round_trip_exact(rng):
    _, params, tmod, _ = _pair(rng, self_per_cross_attn=1)
    sd = state_dict_from_flax(params)
    back = flax_from_state_dict(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert np.array_equal(flat_b[path], leaf), path
    # and the port's own state_dict converts back to the same tree
    again = flax_from_state_dict(tmod.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(again):
        assert np.array_equal(leaf, dict(flat_a)[path]), path


def test_seeded_init_is_deterministic():
    a = TorchHealNet(**BASE, device="cpu", generator=torch.Generator().manual_seed(3))
    b = TorchHealNet(**BASE, device="cpu", generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.state_dict()["layer0_cross_attn_m0.fn.to_q.weight"]
    assert float(w.abs().max()) <= 8**-0.5  # U(+-1/sqrt(fan_in)), fan_in = l_d


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prenorm_attention_raw_context(rng, impl):
    """PreNormAttention normalizing a raw context itself (the path the model
    does not take: it passes the merged, folded KV instead)."""
    x = rng.normal(size=(3, 5, 8)).astype(np.float32)
    ctx = rng.normal(size=(3, 20, 10)).astype(np.float32)
    mask = rng.uniform(size=(3, 20)) > 0.3
    jmod = JaxPreNormAttention(query_dim=8, context_dim=10, heads=2, dim_head=6)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x), context=jnp.asarray(ctx))["params"])
    for scope in ("norm", "norm_context"):  # non-trivial affines
        params[scope] = {k: rng.normal(size=v.shape).astype(np.float32)
                         for k, v in params[scope].items()}
    ref, _ = jmod.apply({"params": params}, jnp.asarray(x), context=jnp.asarray(ctx),
                        kv_mask=jnp.asarray(mask))
    tmod = PreNormAttention(8, 10, heads=2, dim_head=6, attention_impl=impl)
    tmod.load_state_dict(state_dict_from_flax(params))
    with torch.no_grad():
        got, _ = tmod(torch.from_numpy(x), context=torch.from_numpy(ctx),
                      kv_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_auto_attention_rule():
    attn = Attention(126, 2048, heads=1, dim_head=63, attention_impl="auto")
    assert not attn._should_use_flash(0.0, 8, 17, 65536, on_card=True)
    assert attn._should_use_flash(0.0, 8, 126, 65536, on_card=True)
    assert not attn._should_use_flash(0.0, 8, 126, 4096, on_card=True)
    assert attn._should_use_flash(0.083, 64, 512, 65536, on_card=True)
    assert not attn._should_use_flash(0.0, 64, 512, 65536, on_card=False)
    # JAX's rule with dropout on: flash only when the weights exceed 2 GiB
    assert not attn._should_use_flash(0.083, 8, 126, 65536, on_card=True)
    assert not attn._should_use_flash(0.3, 8, 512, 65536, on_card=True)  # 1 GiB of weights
    assert attn._should_use_flash(0.3, 17, 512, 65536, on_card=True)  # 2.1 GiB


def test_attention_passes_its_dropout_rate_to_the_rule(monkeypatch):
    seen = []
    monkeypatch.setattr(Attention, "_should_use_flash",
                        lambda self, rate, *a: seen.append(rate) or False)
    attn = Attention(8, 10, heads=2, dim_head=6, dropout=0.25, attention_impl="auto")
    x, kv = torch.randn(2, 5, 8), torch.randn(2, 7, 24)
    attn.train()(x, kv=kv, dropout_seed=3)
    attn.eval()(x, kv=kv)
    assert seen == [0.25, 0.0]
    with pytest.raises(ValueError, match="dropout_seed"):
        attn.train()(x, kv=kv)


def test_model_entry_point_needs_a_gpu_or_cpu_request():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchHealNet(**BASE)
