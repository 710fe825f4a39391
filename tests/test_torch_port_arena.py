"""Int8 contexts and the feature arena of the PyTorch port against the JAX
package on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and its
port: the quantizers, the quantized merged projection and its gradients, the
cotangent pass with the per-token scale and the batch-sum, the bag gather,
HealNetModule with a quantized slide, and the arena paths of the trainer and
the Predictor. Tolerances are stated with each test; the quantizers and the
gather are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from healnet_tpu.models.healnet import HealNetModule as JaxHealNet
from healnet_tpu.ops.fused_project import _pallas_bwd_call as jproject_bwd_call
from healnet_tpu.ops.fused_project import fused_kv_project as jproject
from healnet_tpu.ops.quantize import QuantizedContext as JaxQC
from healnet_tpu.ops.quantize import quantize_context as jquantize
from healnet_tpu.ops.quantize import quantize_context_host as jquantize_host
from healnet_tpu.parallel.arena import gather_bag as jgather_bag
from healnet_tpu.serving import Predictor as JaxPredictor
from healnet_tpu.train.loop import SurvivalTrainer as JaxTrainer
from healnet_tpu.train.loop import iterate_batches as jax_iterate_batches
from healnet_tpu_torch.compat.flax_params import state_dict_from_flax
from healnet_tpu_torch.models.healnet import HealNetModule as TorchHealNet
from healnet_tpu_torch.ops import QuantizedContext, quantize_context, quantize_context_host
from healnet_tpu_torch.ops.fused_project import (
    FusedProjectFunction,
    fused_kv_project,
    fused_project_bwd_kernel,
    fused_project_kernel,
    project_bwd_plain,
)
from healnet_tpu_torch.parallel import gather_bag, place_arena
from healnet_tpu_torch.serving import Predictor
from healnet_tpu_torch.train.loop import SurvivalTrainer, iterate_batches

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _close(port, ref, rtol, atol):
    np.testing.assert_allclose(
        port.detach().float().numpy(), np.asarray(ref, np.float32), rtol=rtol, atol=atol
    )


# -------------------------------------------------------------- quantizers


def _with_ties(rng):
    x = rng.normal(size=(2, 6, 40)).astype(np.float32) * 3
    x[0, 1] = 0.0  # a zero row: scale 0, values 0
    x[1, 4] = 0.0
    # absmax 127 gives scale 1 exactly, so these values sit on .5 ties
    x[0, 2, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 126.5]
    return x


@pytest.mark.parametrize("which", ["tensor_f32", "tensor_bf16", "host"])
def test_quantizers_bit_equal_to_jax(rng, which):
    x = _with_ties(rng)
    if which == "tensor_bf16":
        ref = jquantize(jnp.asarray(x, jnp.bfloat16))
        got = quantize_context(torch.from_numpy(x).bfloat16())
    elif which == "tensor_f32":
        ref = jquantize(jnp.asarray(x))
        got = quantize_context(torch.from_numpy(x))
    else:
        ref = JaxQC(*jquantize_host(x))
        got = QuantizedContext(*map(torch.from_numpy, quantize_context_host(x)))
    q, s = got.data.numpy(), got.scale.numpy()
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, np.asarray(ref.data))
    np.testing.assert_array_equal(s, np.asarray(ref.scale))
    assert s[0, 1] == 0.0 and not q[0, 1].any() and not q[1, 4].any()
    if which != "tensor_bf16":  # round half to even
        assert q[0, 2, :6].tolist() == [127, 2, -4, 0, 0, 126]
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(ref.dequantize()))
    assert got.shape == x.shape and got.ndim == 3 and got.device == torch.device("cpu")
    moved = got.to("cpu")
    assert torch.equal(moved.data, got.data) and torch.equal(moved.scale, got.scale)


# -------------------------------------------------- quantized projection


def _qproj_inputs(rng, b=2, t=256, c=96, e=10, f=70):
    dat = rng.normal(size=(b, t, c)).astype(np.float32) * 2
    dat[0, 3] = 0.0  # a zero row quantizes to scale 0
    q, s = jquantize_host(dat)
    enc = rng.normal(size=(t, e)).astype(np.float32) if e else None
    w = (rng.normal(size=(c + e, f)) * 0.05).astype(np.float32)
    bias = (rng.normal(size=(f,)) * 0.1).astype(np.float32)
    return q, s, enc, w, bias


def _jnp(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("enc_on", [True, False], ids=["enc", "no_enc"])
def test_quantized_projection_vs_jax(rng, out, enc_on):
    """The plain quantized projection against JAX's XLA path and its Pallas
    kernel (interpret mode). f32: the same formula, sums in another order,
    1e-5. bf16: both round at the same places, within two bf16 ulps of
    outputs of magnitude ~1-4 (2e-2)."""
    q, s, enc, w, bias = _qproj_inputs(rng, e=10 if enc_on else 0)
    jd, td = DTYPES[out]
    jqc = JaxQC(jnp.asarray(q), jnp.asarray(s))
    jargs = (jqc, _jnp(enc), jnp.asarray(w), jnp.asarray(bias))
    refs = {
        "xla": jproject(*jargs, impl="xla", out_dtype=jd),
        "pallas": jproject(*jargs, impl="pallas", interpret=True, tile=128, out_dtype=jd),
    }
    tqc = QuantizedContext(torch.from_numpy(q), torch.from_numpy(s))
    got = fused_kv_project(tqc, _t(enc), torch.from_numpy(w), torch.from_numpy(bias),
                           out_dtype=td)
    assert got.dtype == td
    tol = 1e-5 if out == "f32" else 2e-2
    for name, ref in refs.items():
        assert tuple(got.shape) == ref.shape, name
        _close(got, ref, rtol=tol, atol=tol)
    if out == "f32":  # a quantized context defaults to float32 output
        default = fused_kv_project(tqc, _t(enc), torch.from_numpy(w), torch.from_numpy(bias))
        assert default.dtype == torch.float32 and torch.equal(default, got)


@pytest.mark.parametrize("path", ["plain_autograd", "function"])
def test_quantized_projection_grads_vs_jax(rng, path):
    """d/d(w, bias, scale) of sum(sin(kv)): the CPU path's autograd and
    FusedProjectFunction's backward formulas against ``jax.grad`` through
    JAX's Pallas custom VJP and through XLA autodiff. f32; the weight and
    scale gradients are sums of 256 rows or 96 channels of products in
    another order, so 1e-4 relative to the largest entry."""
    q, s, enc, w, bias = _qproj_inputs(rng, t=128)
    jenc = jnp.asarray(enc)

    def jgrads(impl):
        def loss(w_, b_, s_):
            out = jproject(JaxQC(jnp.asarray(q), s_), jenc, w_, b_, impl=impl,
                           out_dtype=jnp.float32, interpret=True, tile=128)
            return jnp.sum(jnp.sin(out))

        return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(w), jnp.asarray(bias),
                                                 jnp.asarray(s))

    tw, tb, ts = (torch.from_numpy(a).requires_grad_() for a in (w, bias, s))
    tq, tenc = torch.from_numpy(q), torch.from_numpy(enc)
    if path == "function":
        out = FusedProjectFunction.apply(tq, tenc, tw, tb, 1e-5, ts, torch.float32)
    else:
        out = fused_kv_project(QuantizedContext(tq, ts), tenc, tw, tb)
    torch.sum(torch.sin(out)).backward()
    for impl in ("pallas", "xla"):
        for name, x, want in zip(("w", "bias", "scale"), (tw, tb, ts), jgrads(impl)):
            top = float(np.abs(np.asarray(want)).max())
            _close(x.grad, want, rtol=1e-4, atol=1e-4 * top)


@pytest.mark.parametrize("dtype,with_bsum", [("f32", True), ("f32", False), ("bf16", False)])
def test_project_bwd_plain_scale_vs_jax_kernel(rng, dtype, with_bsum):
    """The cotangent pass with an int8 context's scale (and the batch-sum)
    against the JAX backward kernel in interpret mode, called directly.
    d_raw rounds (scale * inv) * g once in both: equal in f32 up to the
    rsqrt's last bit, one bf16 ulp apart at most in bf16. dsum2: sums of 512
    terms in another order. bsum at f32, where rounding each term to g's
    dtype changes nothing: sums of 2 terms of magnitude ~1 whose inv may
    differ in its last bits (the two rsqrt), so 1e-6."""
    jd, td = DTYPES[dtype]
    b, t, f, d_total = 2, 256, 252, 261
    g = rng.normal(size=(b, t, f)).astype(np.float32)
    x = rng.normal(size=(b, t, d_total)).astype(np.float32) * 1.5 + 0.3
    s1, s2 = x.sum(-1), (x * x).sum(-1)
    scale = rng.uniform(0.005, 0.05, size=(b, t)).astype(np.float32)
    jg = jnp.pad(jnp.asarray(g, jd), ((0, 0), (0, 0), (0, 4)))  # F padded to 256 lanes
    ref = jproject_bwd_call(jg, jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(scale), d_total,
                            1e-5, 128, True, with_bsum, jd)
    got = project_bwd_plain(torch.from_numpy(g).to(td), torch.from_numpy(s1),
                            torch.from_numpy(s2), d_total, 1e-5, scale=torch.from_numpy(scale),
                            with_bsum=with_bsum)
    assert len(got) == len(ref) == (3 if with_bsum else 2)
    assert got[0].dtype == td
    tol = (1e-6, 1e-7) if dtype == "f32" else (8e-3, 1e-7)
    _close(got[0], np.asarray(ref[0][..., :f], np.float32), rtol=tol[0], atol=tol[1])
    _close(got[1], np.asarray(ref[1][:, :f]), rtol=1e-5, atol=1e-4)
    if with_bsum:
        assert got[2].shape == (t, f) and got[2].dtype == torch.float32
        _close(got[2], np.asarray(ref[2][:, :f]), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ arena


def _pack(bags, pad):
    """Bags back to back, then ``pad`` zero rows (``etl/tcga.py``'s arena
    layout): (arena, offsets, lengths)."""
    lengths = np.array([len(x) for x in bags], np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int32)
    arena = np.concatenate(list(bags) + [np.zeros((pad, bags[0].shape[1]), np.float32)])
    return arena, offsets, lengths


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_gather_bag_bit_equal_to_jax(rng, kind):
    bags = [rng.normal(size=(n, 12)).astype(np.float32) for n in (9, 16, 4, 11)]
    arena, offsets, lengths = _pack(bags, pad=16)
    width = 16
    # the last window starts past rows - width and is clamped, as
    # jax.lax.dynamic_slice clamps it
    offsets = np.append(offsets, arena.shape[0] - 3).astype(np.int32)
    lengths = np.append(lengths, 3).astype(np.int32)
    mask = np.arange(width)[None, :] < lengths[:, None]
    if kind == "int8":
        q, s = quantize_context_host(arena)
        jarena, tarena = JaxQC(jnp.asarray(q), jnp.asarray(s)), place_arena(
            QuantizedContext(q, s), "cpu")
    else:
        jarena, tarena = jnp.asarray(arena), place_arena(arena.astype(np.float64), "cpu")
        assert tarena.dtype == torch.float32
    ref = jgather_bag(jarena, jnp.asarray(offsets), jnp.asarray(mask))
    got = gather_bag(tarena, torch.from_numpy(offsets), torch.from_numpy(mask))
    if kind == "int8":
        assert got.data.dtype == torch.int8
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(got[-1, :3].numpy(), arena[-16:-13])


# ------------------------------------------------------------------ model

MODEL = dict(n_modalities=2, channel_dims=(24, 32), num_spatial_axes=(1, 1), out_dims=4,
             depth=2, l_c=6, l_d=16, x_heads=1, l_heads=2, cross_dim_head=8,
             latent_dim_head=8, self_per_cross_attn=0, max_freq=2.0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_model_quantized_slide_vs_jax(rng, dtype):
    """HealNetModule logits with an int8 slide against the JAX module (XLA
    and Pallas-interpret projections), same Flax weights. f32: 1e-5 / 1e-6.
    bf16: compute in bf16 on both sides, rounded at the same places but
    summed in other orders through two fusion layers: 3e-2."""
    jd, td = DTYPES[dtype]
    tab = rng.normal(size=(3, 1, 24)).astype(np.float32)
    wsi = rng.normal(size=(3, 40, 32)).astype(np.float32)
    wsi[1, 30:] = 0.0  # zero (padding) rows
    q, s = quantize_context_host(wsi)
    params = JaxHealNet(**MODEL).init(jax.random.PRNGKey(0), [tab, wsi])["params"]
    tmod = TorchHealNet(**MODEL, dtype=None if dtype == "f32" else td, device="cpu").eval()
    tmod.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    got = tmod([torch.from_numpy(tab), QuantizedContext(torch.from_numpy(q), torch.from_numpy(s))])
    assert got.dtype == td
    for impl in ("xla", "pallas"):
        jmod = JaxHealNet(**MODEL, projection_impl=impl, dtype=None if dtype == "f32" else jd)
        ref = jmod.apply({"params": params}, [jnp.asarray(tab), JaxQC(jnp.asarray(q),
                                                                     jnp.asarray(s))])
        tol = (1e-5, 1e-6) if dtype == "f32" else (3e-2, 3e-2)
        _close(got, ref, rtol=tol[0], atol=tol[1])


# ---------------------------------------------------------------- trainer

BRCA = dict(n_modalities=2, channel_dims=(40, 32), num_spatial_axes=(1, 1), out_dims=4,
            num_freq_bands=2, max_freq=2.0, depth=2, l_c=17, l_d=126, x_heads=1,
            cross_dim_head=63, l_heads=8, latent_dim_head=20, self_per_cross_attn=0)
WIDTH = 24


def _arena_data(rng, n=12):
    """Arena-indexed survival data: omic vectors, bags of 5-24 patches
    packed into an arena with WIDTH zero rows, and labels."""
    lengths = rng.integers(5, WIDTH + 1, size=n)
    bags = [rng.normal(size=(int(ln), 32)).astype(np.float32) for ln in lengths]
    arena, offsets, lengths = _pack(bags, pad=WIDTH)
    data = {
        "tensors": (rng.normal(size=(n, 1, 40)).astype(np.float32),),
        "kv_masks": (None, np.arange(WIDTH)[None, :] < lengths[:, None]),
        "patch_offsets": offsets.astype(np.int64),
        "patch_lengths": lengths.astype(np.int64),
        "y_disc": rng.integers(0, 4, size=n),
        "censorship": rng.integers(0, 2, size=n).astype(np.float32),
        "event_time": rng.uniform(1, 100, size=n).astype(np.float32),
    }
    return data, arena


def test_iterate_batches_carries_arena_keys(rng):
    data, _ = _arena_data(rng, n=7)
    for shuffle in (False, True):
        ref = list(jax_iterate_batches(data, 3, shuffle, np.random.default_rng(5)))
        got = list(iterate_batches(data, 3, shuffle, np.random.default_rng(5)))
        assert len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            assert set(g) == set(r)
            for key in ("patch_offsets", "patch_lengths", "sample_mask", "y_disc"):
                np.testing.assert_array_equal(g[key], r[key])
                assert g[key].dtype == r[key].dtype
            assert g["patch_offsets"].dtype == np.int32
            np.testing.assert_array_equal(g["kv_masks"][1], r["kv_masks"][1])


@pytest.mark.parametrize("quant", [False, True], ids=["plain_arena", "int8_arena"])
def test_three_step_arena_trajectory_matches_jax_trainer(rng, quant):
    """Three train steps from a feature arena (bags gathered on the device,
    int8 values and scales quantized on the host for ``arena_quant``)
    against the JAX trainer's compiled step given its device arena; same
    weights, dropout off, NLL/16 + L1, class weights, a padded batch row.
    Tolerance: max_lr 1e-3 and the L1 term keep Adam's updates well
    defined, as in ``test_three_step_trajectory_matches_jax_trainer``, and
    the parameters agree to 1e-6 relative. Where an element's gradient
    nearly cancels its L1 term, it sits at float32 noise, and Adam's step
    ``lr * g / (|g| + 1e-8)`` scales that noise by up to lr / 1e-8, so such
    an element may move by a few hundredths of a step: the absolute
    tolerance is 5% of the first steps' size (max_lr / 25), 2e-6, while a
    wrong gradient moves whole steps.
    """
    data, arena = _arena_data(rng, n=11)
    lengths = data["patch_lengths"]
    example = [data["tensors"][0][:2], np.zeros((2, WIDTH, 32), np.float32)]
    jmod = JaxHealNet(**BRCA, projection_impl="xla")
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(0), tuple(map(jnp.asarray, example)))["params"])
    tmod = TorchHealNet(**BRCA, device="cpu")
    tmod.load_state_dict(state_dict_from_flax(params))
    kw = dict(l1=1e-4, max_lr=1e-3, gc_compat=16, class_weights=np.array([1, 2, 1, 3], np.float32),
              feature_arena=(arena, data["patch_offsets"], lengths), arena_quant=quant)
    jtr = JaxTrainer(jmod, **kw)
    jtr._build_steps()
    jarena = jtr._device_arena()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jtr._opt.init(jparams)
    ttr = SurvivalTrainer(tmod, **kw, device="cpu")
    assert ttr.arena_quant is quant
    batches = list(iterate_batches(data, 4))  # 4 + 4 + 3 and a padded row
    for step, batch in enumerate(batches):
        jb = jax.tree_util.tree_map(jnp.asarray, batch)
        jparams, jstate, jloss, jrisk, jstats = jtr._train_step(
            jparams, jstate, jb, jax.random.PRNGKey(step), jarena, jtr.class_weights,
            jnp.float32(50.0))
        tloss, trisk, tstats = ttr.train_step(batch, horizon=50)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
        np.testing.assert_allclose(trisk.numpy(), np.asarray(jrisk), rtol=1e-5, atol=1e-6)
        for k in jstats:
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), rtol=1e-4, err_msg=k)
        ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
        for name, p in tmod.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=1e-6,
                                       atol=2e-6, err_msg=f"step {step + 1} {name}")
    device_arena = ttr._device_arena()
    assert isinstance(device_arena, QuantizedContext) is quant
    loss, risk, logits = ttr.eval_step(batches[0])
    jl, jr, jlg = jtr._eval_step(jparams, jax.tree_util.tree_map(jnp.asarray, batches[0]),
                                 jarena, jtr.class_weights)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlg), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)


def test_trainer_takes_a_device_arena_and_splits_offsets(rng):
    """``arena_device`` is used as given; ``accum_steps`` splits the offsets
    with the batch, never the arena, and averages the micro-batch
    gradients (no dropout), so one and two micro-batches agree."""
    data, arena = _arena_data(rng, n=4)
    q, s = quantize_context_host(arena)
    device_arena = place_arena(QuantizedContext(q, s), "cpu")
    batch = next(iterate_batches(data, 4))
    trainers = []
    for a in (1, 2):
        module = TorchHealNet(**BRCA, device="cpu", generator=torch.Generator().manual_seed(0))
        trainers.append(SurvivalTrainer(module, l1=1e-5, accum_steps=a, device="cpu",
                                        arena_device=device_arena))
    out = [t.train_step(batch, horizon=10) for t in trainers]
    assert trainers[0]._device_arena() is device_arena
    np.testing.assert_allclose(float(out[0][0]), float(out[1][0]), rtol=1e-6)
    for (name, a), (_, b) in zip(trainers[0].module.named_parameters(),
                                 trainers[1].module.named_parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-7, msg=name)


# ---------------------------------------------------------------- serving

SERVE = dict(n_modalities=2, channel_dims=(12, 6), num_spatial_axes=(1, 1), out_dims=4,
             depth=2, num_freq_bands=2, max_freq=2.0, l_c=5, l_d=8, x_heads=1, l_heads=2,
             cross_dim_head=6, latent_dim_head=4, self_per_cross_attn=0)


@pytest.mark.parametrize("quant", [False, True], ids=["plain_arena", "int8_arena"])
def test_predict_from_arena_matches_jax(rng, quant):
    """``predict_from_arena`` against the JAX Predictor's over the same
    arena: two bucket widths, a padded micro-batch, an overlong bag cut to
    the last bucket, a sample without its omic modality. f32: 1e-5 / 1e-6."""
    jmod = JaxHealNet(**SERVE, projection_impl="xla")
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(1), (jnp.zeros((2, 1, 12)), jnp.zeros((2, 16, 6))))["params"])
    bags = [rng.normal(size=(n, 6)).astype(np.float32) for n in (5, 12, 8, 3, 16, 20, 1)]
    arena, offsets, lengths = _pack(bags, pad=16)
    host = QuantizedContext(*quantize_context_host(arena)) if quant else arena
    jarena = JaxQC(host.data, host.scale) if quant else arena
    kw = dict(batch_size=4, bucket_boundaries=[8, 16])
    jpred = JaxPredictor(jmod, params, **kw, feature_arena=jarena)
    tpred = Predictor(TorchHealNet(**SERVE, device="cpu"), params, device="cpu", **kw,
                      feature_arena=host)
    omic = rng.normal(size=(len(bags), 1, 12)).astype(np.float32)
    presence = np.ones((len(bags), 2), np.float32)
    presence[2, 0] = 0.0
    got = tpred.predict_from_arena([omic], offsets, lengths, presence=presence)
    ref = jpred.predict_from_arena([omic], offsets, lengths, presence=presence)
    for k in ("logits", "hazards", "survival", "risk"):
        assert got[k].dtype == np.float32 and got[k].shape == np.asarray(ref[k]).shape, k
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    missing = tpred.predict_from_arena([None], offsets, lengths)
    np.testing.assert_allclose(missing["logits"],
                               np.asarray(jpred.predict_from_arena([None], offsets,
                                                                   lengths)["logits"]),
                               rtol=1e-5, atol=1e-6)
    warm = tpred.warmup([(1, 12), (16, 6)])
    assert warm["programs"] >= 3
    with pytest.raises(ValueError, match="feature_arena"):
        Predictor(TorchHealNet(**SERVE, device="cpu"), params,
                  device="cpu").predict_from_arena([omic], offsets, lengths)


def test_int8_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 2, 8, dtype=torch.int8)
    with pytest.raises(ValueError):
        fused_project_kernel(q, torch.zeros(8, 4), torch.zeros(2, 4), torch.zeros(2, 2),
                             torch.zeros(2, 4), 8, 1e-5, scale=torch.zeros(1, 2))
    with pytest.raises(ValueError):
        fused_project_bwd_kernel(torch.zeros(1, 2, 4), torch.zeros(1, 2), torch.zeros(1, 2), 8,
                                 scale=torch.zeros(1, 2), with_bsum=True)
