"""The port's reference-compatible ``HealNet`` wrapper, attention capture,
rematerialisation and the reference weight layout, against the JAX package
on the CPU.

The wrapper's own cases mirror ``tests/test_healnet.py``. Against JAX's
``HealNet`` (the same Flax weights, converted by ``compat.flax_params``):
logits and captured weights agree at float32 to 1e-5 relative / 1e-6
absolute. Gradients of the remat path: 1e-4 relative / 1e-6 absolute (sums
in another order, as ``tests/test_torch_port_train.py`` holds the step).
The converter round trip is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from healnet_tpu.compat.torch_import import params_from_torch_state_dict
from healnet_tpu.models.healnet import HealNet as JaxHealNet
from healnet_tpu.models.healnet import HealNetModule as JaxModule
from healnet_tpu.models.healnet import attention_module_order as jax_module_order
from healnet_tpu_torch import HealNet
from healnet_tpu_torch.compat.flax_params import flax_from_state_dict, state_dict_from_flax
from healnet_tpu_torch.compat.torch_import import (
    reference_from_state_dict,
    state_dict_from_reference,
)
from healnet_tpu_torch.models.healnet import HealNetModule, attention_module_order

RTOL, ATOL = 1e-5, 1e-6
B = 4
T_C, T_D = 1, 37
I_H, I_W, I_C = 6, 6, 5
SMALL_HP = dict(l_c=8, l_d=16, x_heads=2, l_heads=2, cross_dim_head=8, latent_dim_head=8,
                depth=2)
# bench.py's rows at depth 2 with channels and tokens cut down (as
# tests/test_torch_port_train.py), and a tied row with self-attention
ROWS = {
    "brca": dict(l_c=17, l_d=126, x_heads=1, cross_dim_head=63, l_heads=8,
                 latent_dim_head=20, self_per_cross_attn=0),
    "kirp": dict(l_c=17, l_d=62, x_heads=1, cross_dim_head=27, l_heads=8,
                 latent_dim_head=113, self_per_cross_attn=0),
    "trimodal": dict(l_c=17, l_d=126, x_heads=1, cross_dim_head=63, l_heads=8,
                     latent_dim_head=20, self_per_cross_attn=0, n_modalities=3,
                     channel_dims=(40, 32, 24), num_spatial_axes=(1, 1, 1)),
    "tied_self": dict(depth=3, l_c=9, l_d=16, x_heads=2, cross_dim_head=6, l_heads=2,
                      latent_dim_head=4, self_per_cross_attn=1, weight_tie_layers=True,
                      snn=False),
}
ROW_COMMON = dict(n_modalities=2, channel_dims=(40, 32), num_spatial_axes=(1, 1), out_dims=4,
                  depth=2, num_freq_bands=2, max_freq=2.0)


def _bimodal(**kw):
    return HealNet(n_modalities=2, channel_dims=[T_D, I_C], num_spatial_axes=[1, 2],
                   out_dims=4, device="cpu", **{**SMALL_HP, **kw})


def _tab_img(rng, b=B):
    return (rng.normal(size=(b, T_C, T_D)).astype(np.float32),
            rng.normal(size=(b, I_H, I_W, I_C)).astype(np.float32))


def _row_inputs(rng, n, b=B):
    x = [rng.normal(size=(b, 1, 40)).astype(np.float32),
         rng.normal(size=(b, 24, 32)).astype(np.float32)]
    if n == 3:
        x.append(rng.normal(size=(b, 16, 24)).astype(np.float32))
    return x


# ------------------------------------------------------- the wrapper's cases


def test_healnet_unimodal(rng):
    m = HealNet(n_modalities=1, channel_dims=[T_D], num_spatial_axes=[1], out_dims=5,
                device="cpu", **SMALL_HP)
    assert m([_tab_img(rng)[0]]).shape == (B, 5)


def test_healnet_bimodal(rng):
    assert _bimodal()(list(_tab_img(rng))).shape == (B, 4)


def test_healnet_trimodal_3d(rng):
    m = HealNet(n_modalities=3, channel_dims=[64, 3, 3], num_spatial_axes=[1, 2, 3],
                out_dims=4, device="cpu", **SMALL_HP)
    x = [rng.normal(size=(2, T_C, 64)), rng.normal(size=(2, 8, 8, 3)),
         rng.normal(size=(2, 4, 6, 6, 3))]
    assert m([a.astype(np.float32) for a in x]).shape == (2, 4)


def test_healnet_misaligned_args_raise():
    with pytest.raises(ValueError, match="same length"):
        HealNet(n_modalities=1, channel_dims=[T_D, I_C], num_spatial_axes=[1, 1], out_dims=4,
                device="cpu")
    with pytest.raises(ValueError, match="number of modalities"):
        HealNet(n_modalities=1, channel_dims=[T_D, I_C], num_spatial_axes=[1, 2], out_dims=4,
                device="cpu")


def test_missing_modality_forward(rng):
    m = _bimodal()
    tab, img = _tab_img(rng)
    full, missing = m([tab, img]), m([tab, None])
    assert missing.shape == (B, 4) and torch.isfinite(missing).all()
    assert not torch.allclose(full, missing)  # the missing update was gated off
    with pytest.raises(ValueError, match="at least one"):
        m([None, None])


def test_return_embeddings(rng):
    emb = _bimodal()(list(_tab_img(rng)), return_embeddings=True)
    assert emb.shape == (B, SMALL_HP["l_c"], SMALL_HP["l_d"])


def test_attention_weights_exposed(rng):
    m = _bimodal(self_per_cross_attn=1)
    m(list(_tab_img(rng)))
    weights = m.get_attention_weights()
    assert len(weights) == 6  # 2 layers x (2 cross + 1 self), no tying
    assert weights[0].shape == (B * 2, 8, T_C)
    assert weights[1].shape == (B * 2, 8, I_H * I_W)
    assert weights[2].shape == (B * 2, 8, 8)
    np.testing.assert_allclose(weights[1].sum(-1), 1.0, rtol=1e-5)
    assert _bimodal(store_attention="off")(list(_tab_img(rng))) is not None
    off = _bimodal(store_attention=False)
    off(list(_tab_img(rng)))
    assert off.get_attention_weights() == []


def test_per_sample_presence(rng):
    module = HealNetModule(n_modalities=2, channel_dims=(T_D, I_C), num_spatial_axes=(1, 2),
                           out_dims=4, device="cpu", **SMALL_HP).eval()
    tab, img = (torch.from_numpy(a) for a in _tab_img(rng))
    presence = torch.ones(B, 2)
    presence[0, 1] = 0.0
    with torch.no_grad():
        masked = module((tab, img), presence=presence)
        full = module((tab, img))
        img0 = img.clone()
        img0[0] = 0.0
        masked2 = module((tab, img0), presence=presence)
    assert not torch.allclose(masked[0], full[0])
    torch.testing.assert_close(masked[1:], full[1:], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(masked[0], masked2[0], rtol=1e-6, atol=1e-6)


def test_wrapper_save_load_roundtrip(tmp_path, rng):
    tab, img = _tab_img(rng)
    m = _bimodal()
    logits = m([tab, img])
    m.save(tmp_path / "wrapper_ckpt")
    m2 = _bimodal(seed=99)
    assert not torch.equal(m2([tab, img]), logits)
    m2.load(tmp_path / "wrapper_ckpt")
    assert torch.equal(m2([tab, img]), logits)
    assert m2.count_parameters() == sum(p.numel() for p in m.module.parameters())


def test_single_mask_matching_no_modality_raises(rng):
    m = _bimodal()
    tab, img = _tab_img(rng)
    with pytest.raises(ValueError, match="no modality"):
        m([tab, img], mask=np.ones((B, 7), bool))
    # a single mask of the bag's width applies to the bag (only it matches)
    mask = rng.uniform(size=(B, I_H * I_W)) > 0.5
    got = m([tab, img], mask=mask)
    as_list = m([tab, img], mask=[None, mask])
    assert torch.equal(got, as_list)
    assert not torch.allclose(got, m([tab, img]))


def test_lazy_capture_replays_the_training_pass(rng):
    """train=True draws dropout; the lazy capture replays that pass (same
    draws) and equals an eager capture of it, not an evaluation pass."""
    kw = dict(self_per_cross_attn=1, attn_dropout=0.3, ff_dropout=0.4, seed=7)
    x = list(_tab_img(rng))
    lazy, eager = _bimodal(**kw), _bimodal(store_attention="eager", **kw)
    out_lazy, out_eager = lazy(x, train=True), eager(x, train=True)
    assert torch.equal(out_lazy, out_eager)
    for a, b in zip(lazy.get_attention_weights(), eager.get_attention_weights()):
        np.testing.assert_array_equal(a, b)
    after = lazy(x, train=True)  # the generators moved on: other draws
    assert not torch.equal(after, out_lazy)
    lazy(x)
    evaluation = lazy.get_attention_weights()
    trained = eager.get_attention_weights()
    assert not all(np.array_equal(a, b) for a, b in zip(evaluation, trained))
    # the streaming capture replays the same (last) pass as the lazy one
    for w, st in zip(lazy.get_attention_weights(), lazy.get_attention_stats()):
        wb = np.asarray(w, np.float64).reshape(B, -1, *w.shape[1:])
        np.testing.assert_allclose(st["col_mean"], wb.mean(axis=(1, 2)), rtol=0, atol=1e-6)


def test_wrapper_needs_a_gpu_or_cpu_request():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HealNet(n_modalities=1, channel_dims=[T_D], num_spatial_axes=[1], out_dims=4)


# ------------------------------------------------------ against JAX's HealNet


def _jax_and_port_wrappers(rng, row):
    cfg = {**ROW_COMMON, **ROWS[row]}
    x = _row_inputs(rng, cfg["n_modalities"])
    jm = JaxHealNet(**cfg, store_attention="eager", projection_impl="xla")
    jm(x)
    tm = HealNet(**cfg, store_attention="eager", device="cpu")
    tm.module.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                          jm.params)))
    return cfg, x, jm, tm


@pytest.mark.parametrize("missing", [None, 0, 1], ids=["all", "no_omic", "no_wsi"])
@pytest.mark.parametrize("row", list(ROWS))
def test_wrapper_logits_and_weights_match_jax(rng, row, missing):
    cfg, x, jm, tm = _jax_and_port_wrappers(rng, row)
    if missing is not None:
        x[missing] = None
    ref = np.asarray(jm(x))
    ref_w = jm.get_attention_weights()
    got = tm(x)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    got_w = tm.get_attention_weights()
    assert len(got_w) == len(ref_w) > 0
    for a, r in zip(got_w, ref_w):
        assert a.shape == r.shape
        np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL)


def test_wrapper_masks_match_jax(rng):
    cfg, x, jm, tm = _jax_and_port_wrappers(rng, "brca")
    mask = rng.uniform(size=(B, 24)) > 0.4
    mask[2] = False  # a sample whose whole bag is masked
    np.testing.assert_allclose(tm(x, mask=mask).numpy(), np.asarray(jm(x, mask=mask)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm(x, mask=[None, mask]).numpy(),
                               np.asarray(jm(x, mask=[None, mask])), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("depth,n_mod,n_self", [(1, 1, 0), (2, 2, 1), (3, 2, 1), (4, 3, 2)])
def test_attention_module_order_matches_jax(depth, n_mod, n_self, tied):
    assert attention_module_order(depth, n_mod, n_self, tied) == \
        jax_module_order(depth, n_mod, n_self, tied)


# ------------------------------------------------------------------- remat


def _remat_pair(rng, row, **kw):
    cfg = {**ROW_COMMON, **ROWS[row], **kw}
    x = _row_inputs(rng, cfg["n_modalities"])
    jmod = JaxModule(**{k: v for k, v in cfg.items() if k not in ("attn_dropout", "ff_dropout")},
                     projection_impl="xla")
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(0), tuple(map(jnp.asarray, x)))["params"])
    state = state_dict_from_flax(params)
    mods = []
    for remat in (False, True):
        m = HealNetModule(**cfg, remat=remat, device="cpu")
        m.load_state_dict(state)
        mods.append(m.train())
    return cfg, x, params, mods


def _grads(module, x, weight, presence, masks, seed=None):
    module.zero_grad(set_to_none=True)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    logits = module([torch.from_numpy(a) for a in x], presence=presence, kv_masks=masks,
                    generator=gen)
    torch.sum(logits * weight).backward()
    return {n: p.grad.clone() for n, p in module.named_parameters()}, logits.detach()


@pytest.mark.parametrize("masked", [False, True], ids=["presence", "presence_and_mask"])
@pytest.mark.parametrize("row", ["brca", "trimodal", "tied_self"])
def test_remat_gradients_match_plain_path_and_jax(rng, row, masked):
    """The remat path's logits and gradients against the port's plain path
    and JAX's gradients. Unmasked, against JAX's remat path. With a KV mask
    JAX's own remat gradients move from its plain ones (by up to 2.6e-3 at
    the trimodal row, where the two forwards agree to 4e-7), so there the
    reference is JAX's plain path."""
    cfg, x, params, (plain, remat) = _remat_pair(rng, row)
    n = cfg["n_modalities"]
    weight = torch.from_numpy(rng.normal(size=(B, 4)).astype(np.float32))
    presence = np.ones((B, n), np.float32)
    presence[1, 1] = 0.0
    masks = None
    if masked:
        masks = [None, torch.from_numpy(rng.uniform(size=(B, 24)) > 0.3)] + [None] * (n - 2)
    g_plain, out_plain = _grads(plain, x, weight, torch.from_numpy(presence), masks)
    g_remat, out_remat = _grads(remat, x, weight, torch.from_numpy(presence), masks)
    torch.testing.assert_close(out_remat, out_plain, rtol=RTOL, atol=ATOL)

    jmod = JaxModule(**cfg, projection_impl="xla", remat=not masked)

    def jloss(p):
        logits = jmod.apply({"params": p}, tuple(map(jnp.asarray, x)),
                            presence=jnp.asarray(presence),
                            kv_masks=None if masks is None else tuple(
                                None if m is None else jnp.asarray(m.numpy()) for m in masks))
        return jnp.sum(logits * jnp.asarray(weight.numpy()))

    ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(params)))
    assert set(g_remat) == set(ref)
    for name, want in ref.items():
        np.testing.assert_allclose(g_remat[name].numpy(), want.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(g_remat[name].numpy(), g_plain[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_remat_gradients_with_dropout_match_plain_path(rng):
    """Attention and FF dropout on, one generator seed: the remat path
    draws the FF masks before each checkpointed block and the hash seeds up
    front, so it draws what the plain path draws, and its recomputation
    reuses them."""
    cfg, x, _, (plain, remat) = _remat_pair(rng, "tied_self", attn_dropout=0.3, ff_dropout=0.4)
    weight = torch.from_numpy(rng.normal(size=(B, 4)).astype(np.float32))
    g_plain, out_plain = _grads(plain, x, weight, None, None, seed=5)
    g_remat, out_remat = _grads(remat, x, weight, None, None, seed=5)
    torch.testing.assert_close(out_remat, out_plain, rtol=RTOL, atol=ATOL)
    for name in g_plain:
        np.testing.assert_allclose(g_remat[name].numpy(), g_plain[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    _, other = _grads(remat, x, weight, None, None, seed=6)
    assert not torch.allclose(other, out_remat)  # another seed, other masks


# --------------------------------------------------------------- converter


@pytest.mark.parametrize("row", list(ROWS))
def test_reference_layout_round_trip(rng, row):
    """A synthetic reference state_dict made from the port's weights: the
    round trip is exact, and the JAX package's importer reads it into the
    same Flax tree as the port's weights."""
    cfg = {**ROW_COMMON, **ROWS[row]}
    module = HealNetModule(**cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    state = module.state_dict()
    ref = reference_from_state_dict(state, module)
    assert "latents" in ref and "to_logits.2.weight" in ref
    assert f"layers.{cfg['depth'] - 1}.1.fn.net.2.bias" in ref
    back = state_dict_from_reference(ref, module)
    assert set(back) == set(state)
    for name, value in state.items():
        assert torch.equal(back[name], value), name
    jmod = JaxModule(**cfg)
    want = flax_from_state_dict(state)
    got = params_from_torch_state_dict({k: v.numpy() for k, v in ref.items()}, jmod)

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    got_leaves, want_leaves = dict(leaves(got)), dict(leaves(want))
    assert set(got_leaves) == set(want_leaves)
    for path, value in want_leaves.items():
        np.testing.assert_array_equal(got_leaves[path], value, err_msg="/".join(path))


def test_load_torch_state_dict_matches_jax(rng):
    cfg, x, jm, tm = _jax_and_port_wrappers(rng, "tied_self")
    other = HealNetModule(**cfg, device="cpu", generator=torch.Generator().manual_seed(11))
    ref_sd = reference_from_state_dict(other.state_dict(), other)
    jm.load_torch_state_dict({k: v.numpy() for k, v in ref_sd.items()})
    tm.load_torch_state_dict(ref_sd)
    np.testing.assert_allclose(tm(x).numpy(), np.asarray(jm(x)), rtol=RTOL, atol=ATOL)
