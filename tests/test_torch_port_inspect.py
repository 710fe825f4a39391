"""The port's streaming attention inspection, temperature softmax and the
attention mask family, against the JAX package on the CPU.

``streaming_attention_stats`` against JAX's at chunks that divide the keys
and chunks that do not, with a mask, a fully masked row and dropout: the
output within 1e-5, ``colsum`` within 1e-6, ``psum`` / ``psumsq`` within 1e-5
relative; with dropout the streaming output equals the dense output of the
same pass within 1e-6 (absolute and relative), its dropped entries bit for
bit. ``HealNet.get_attention_stats`` against JAX's (same
Flax weights through ``compat.flax_params``): the same modules in the same
order with the same ``kind``, ``index`` and ``tokens``, ``col_mean`` within
1e-6, ``mean`` / ``std`` within 1e-5 relative; and against the port's own
dense weights. The ``"threefry"`` mask family by its keep rate and its
independence from the hash mask (the two RNGs cannot give the same bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from healnet_tpu.models.healnet import HealNet as JaxHealNet
from healnet_tpu.ops.activations import temperature_softmax as jax_temperature_softmax
from healnet_tpu.ops.attention import streaming_attention_stats as jax_streaming
from healnet_tpu.ops.hash_dropout import mask_family as jax_mask_family
from healnet_tpu.ops.hash_dropout import seed_from_rng
from healnet_tpu_torch import HealNet, HealNetModule
from healnet_tpu_torch.compat.flax_params import state_dict_from_flax
from healnet_tpu_torch.ops import streaming_attention_stats, temperature_softmax
from healnet_tpu_torch.ops.attention import multihead_attention
from healnet_tpu_torch.ops.hash_dropout import dense_keep_mask, mask_family

OUT_ATOL, COL_ATOL, STAT_RTOL, DROP_ATOL = 1e-5, 1e-6, 1e-5, 1e-6


def _qkv(rng, b=2, h=3, lq=5, lkv=300, d=8):
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((b, h, lq, d), (b, h, lkv, d), (b, h, lkv, d)))


def _jax_seed(key) -> int:
    return int(np.asarray(seed_from_rng(key)).view(np.uint32)[0, 0])


def _pair(q, k, v, mask=None, chunk=2048, rate=0.0, key=None, scale=0.35):
    jkw = dict(dropout_rng=key, dropout_rate=rate) if rate else {}
    tkw = dict(dropout_seed=_jax_seed(key), dropout_rate=rate) if rate else {}
    want = jax_streaming(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
                         kv_mask=None if mask is None else jnp.asarray(mask), chunk=chunk, **jkw)
    got = streaming_attention_stats(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                    scale=scale, chunk=chunk,
                                    kv_mask=None if mask is None else torch.tensor(mask), **tkw)
    return want, got


def _stats_agree(want, got):
    (jo, js), (to, ts) = want, got
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(ts["colsum"].numpy(), np.asarray(js["colsum"]), rtol=0,
                               atol=COL_ATOL)
    for key in ("psum", "psumsq"):
        np.testing.assert_allclose(float(ts[key]), float(js[key]), rtol=STAT_RTOL)
    assert float(ts["count"]) == float(js["count"])
    assert ts["colsum"].dtype == torch.float32 and ts["psum"].dim() == 0


@pytest.mark.parametrize("chunk", [64, 100, 128, 300, 1024])
def test_streaming_matches_jax(rng, chunk):
    _stats_agree(*_pair(*_qkv(rng), chunk=chunk))


@pytest.mark.parametrize("chunk", [32, 40, 97])
def test_streaming_masked_and_fully_masked_rows_match_jax(rng, chunk):
    q, k, v = _qkv(rng, b=3, lkv=97)
    mask = np.ones((3, 97), bool)
    mask[0, 40:] = False
    mask[2, :] = False  # a fully masked sample: zero output, nothing in the stats
    want, got = _pair(q, k, v, mask=mask, chunk=chunk, scale=0.3)
    _stats_agree(want, got)
    assert torch.all(got[1]["colsum"][2] == 0) and torch.all(got[0][2] == 0)
    dense, w = multihead_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), scale=0.3,
                                   kv_mask=torch.tensor(mask), return_weights=True)
    np.testing.assert_allclose(got[0].numpy(), dense.numpy(), rtol=DROP_ATOL, atol=DROP_ATOL)
    np.testing.assert_allclose(got[1]["colsum"].numpy(), w.double().sum((1, 2)).numpy(),
                               rtol=0, atol=COL_ATOL)


@pytest.mark.parametrize("chunk", [64, 150, 47])
@pytest.mark.parametrize("masked", [False, True])
def test_streaming_dropout_matches_jax_and_the_dense_pass(rng, chunk, masked):
    """The output through hash dropout at absolute KV coordinates: JAX's
    within 1e-5, the port's dense pass with the same seed within 1e-6; the
    statistics from the probabilities before dropout."""
    q, k, v = _qkv(rng, lkv=150)
    mask = None
    if masked:
        mask = rng.uniform(size=(2, 150)) > 0.3
        mask[1] = False
    key = jax.random.PRNGKey(5)
    want, got = _pair(q, k, v, mask=mask, chunk=chunk, rate=0.3, key=key, scale=0.4)
    _stats_agree(want, got)
    tmask = None if mask is None else torch.tensor(mask)
    dense, w = multihead_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), scale=0.4,
                                   kv_mask=tmask, dropout_rate=0.3, dropout_seed=_jax_seed(key),
                                   return_weights=True)
    # f32 values of order 1 summed in another order: a few ulps apart
    np.testing.assert_allclose(got[0].numpy(), dense.numpy(), rtol=DROP_ATOL, atol=DROP_ATOL)
    np.testing.assert_allclose(got[1]["colsum"].numpy(), w.double().sum((1, 2)).numpy(),
                               rtol=0, atol=COL_ATOL)
    # the dropped entries themselves, bit for bit: with identity values the
    # output is the dropped map
    eye = torch.eye(150).expand(2, 3, 150, 150)
    kw = dict(scale=0.4, kv_mask=tmask, dropout_rate=0.3, dropout_seed=_jax_seed(key))
    s_map, _ = streaming_attention_stats(torch.tensor(q), torch.tensor(k), eye, chunk=chunk, **kw)
    d_map, _ = multihead_attention(torch.tensor(q), torch.tensor(k), eye, **kw)
    assert torch.equal(s_map == 0, d_map == 0)
    undropped, _ = streaming_attention_stats(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                             scale=0.4, kv_mask=tmask, chunk=chunk)
    assert not torch.allclose(undropped, got[0])


def test_streaming_never_holds_the_whole_map():
    """No operation of the streaming capture makes a (b, h, lq, lkv)
    tensor; its chunked intermediates are (b, h, lq, chunk)."""
    b, h, lq, lkv, d, chunk = 1, 2, 16, 4096, 8, 512
    shapes = set()

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    shapes.add(tuple(t.shape))
            return out

    q, k, v = torch.zeros(b, h, lq, d), torch.zeros(b, h, lkv, d), torch.zeros(b, h, lkv, d)
    with Shapes():
        streaming_attention_stats(q, k, v, scale=0.2, chunk=chunk, dropout_rate=0.2,
                                  dropout_seed=3)
    assert (b, h, lq, lkv) not in shapes
    assert (b, h, lq, chunk) in shapes


# ---------------------------------------------------------------- the model


MODEL = dict(n_modalities=2, channel_dims=[24, 10], num_spatial_axes=[1, 1], out_dims=4,
             l_d=16, x_heads=2, l_heads=3, cross_dim_head=8, latent_dim_head=6)


def _models(depth, l_c, self_per_cross_attn, stats_chunk, **kw):
    cfg = dict(MODEL, depth=depth, l_c=l_c, self_per_cross_attn=self_per_cross_attn,
               stats_chunk=stats_chunk, **kw)
    jm = JaxHealNet(**cfg, projection_impl="xla")
    tm = HealNet(**cfg, device="cpu")
    return jm, tm


def _load(jm, tm):
    tm.module.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jm.params)))


def _stats_lists_agree(got, want):
    assert [(s["kind"], s["index"], s["tokens"]) for s in got] == \
        [(s["kind"], s["index"], s["tokens"]) for s in want]
    assert len(got) > 0
    for g, w in zip(got, want):
        assert g["col_mean"].dtype == np.float64 and g["col_mean"].shape == w["col_mean"].shape
        np.testing.assert_allclose(g["col_mean"], w["col_mean"], rtol=0, atol=COL_ATOL)
        np.testing.assert_allclose(g["mean"], w["mean"], rtol=STAT_RTOL)
        np.testing.assert_allclose(g["std"], w["std"], rtol=STAT_RTOL)


@pytest.mark.parametrize("missing", [None, 0, 1], ids=["both", "no_omic", "no_wsi"])
@pytest.mark.parametrize("depth,l_c,n_self,chunk", [(1, 6, 0, 16), (2, 8, 1, 32),
                                                     (2, 4, 2, 50)])
def test_get_attention_stats_matches_jax(rng, depth, l_c, n_self, chunk, missing):
    """As tests/test_streaming_stats.py: a missing modality and a masked bag."""
    jm, tm = _models(depth, l_c, n_self, chunk)
    tab = rng.normal(size=(2, 7, 24)).astype(np.float32)
    img = rng.normal(size=(2, 50, 10)).astype(np.float32)
    mask = [None, np.arange(50)[None, :] < np.array([[33], [50]])]
    x = [tab, img]
    if missing is not None:
        x[missing] = None
        if missing == 1:
            mask = None
    jm(x, mask=mask)
    _load(jm, tm)
    np.testing.assert_allclose(tm(x, mask=mask).numpy(), np.asarray(jm(x, mask=mask)),
                               rtol=1e-5, atol=1e-6)
    _stats_lists_agree(tm.get_attention_stats(), jm.get_attention_stats())


def test_stats_are_the_reductions_of_the_dense_weights(rng):
    _, tm = _models(2, 6, 1, 32)
    tab = rng.normal(size=(2, 7, 24)).astype(np.float32)
    img = rng.normal(size=(2, 90, 10)).astype(np.float32)
    tm([tab, img])
    dense = tm.get_attention_weights()
    stats = tm.get_attention_stats()
    assert len(dense) == len(stats)
    for w, s in zip(dense, stats):
        w = np.asarray(w, np.float64)  # (b * h, lq, tokens)
        assert s["tokens"] == w.shape[-1]
        wb = w.reshape(2, -1, w.shape[1], w.shape[2])
        np.testing.assert_allclose(s["col_mean"], wb.mean(axis=(1, 2)), rtol=0, atol=COL_ATOL)
        np.testing.assert_allclose(s["std"], w.std(), rtol=STAT_RTOL)
        np.testing.assert_allclose(s["mean"], w.mean(), rtol=STAT_RTOL)


def test_stats_replay_the_training_pass(rng):
    """After train=True the stats replay that pass's dropout draws: they are
    the reductions of its pre-dropout weights, the generators are left
    where they were, and an evaluation pass gives other stats."""
    _, tm = _models(2, 6, 1, 16, attn_dropout=0.3, ff_dropout=0.4, seed=7)
    x = [rng.normal(size=(2, 7, 24)).astype(np.float32),
         rng.normal(size=(2, 40, 10)).astype(np.float32)]
    tm(x, train=True)
    states = (tm._generator.get_state(), tm._seed_generator.get_state())
    stats = tm.get_attention_stats()
    assert torch.equal(tm._generator.get_state(), states[0])
    assert torch.equal(tm._seed_generator.get_state(), states[1])
    dense = tm.get_attention_weights()
    for w, s in zip(dense, stats):
        wb = np.asarray(w, np.float64).reshape(2, -1, w.shape[1], w.shape[2])
        np.testing.assert_allclose(s["col_mean"], wb.mean(axis=(1, 2)), rtol=0, atol=COL_ATOL)
    tm(x)
    evaluation = tm.get_attention_stats()
    assert not all(np.allclose(a["col_mean"], b["col_mean"]) for a, b in zip(evaluation, stats))


def test_module_stats_pass_outputs_the_dense_pass(rng):
    """``store_attention="stats"`` in training, with the same seeds and
    feed-forward generator: logits within 1e-6 of the dense capture's."""
    module = HealNetModule(**{k: v for k, v in MODEL.items()}, depth=2, l_c=6,
                           self_per_cross_attn=1, attn_dropout=0.3, ff_dropout=0.2,
                           stats_chunk=16, device="cpu").train()
    x = (torch.randn(2, 7, 24), torch.randn(2, 40, 10))
    masks = (None, torch.arange(40)[None, :] < torch.tensor([[25], [40]]))
    seeds = torch.randint(0, 2**32, (module.attention_calls(),), dtype=torch.int64)
    out = {}
    with torch.no_grad():
        for mode in (True, "stats"):
            gen = torch.Generator().manual_seed(3)
            out[mode] = module(x, kv_masks=masks, generator=gen, seeds=seeds,
                               store_attention=mode)
    np.testing.assert_allclose(out["stats"][0].numpy(), out[True][0].numpy(),
                               rtol=DROP_ATOL, atol=DROP_ATOL)
    assert set(out["stats"][1]) == set(out[True][1])
    for tag, entries in out["stats"][1].items():
        for s, w in zip(entries, out[True][1][tag]):
            np.testing.assert_allclose(s["colsum"].numpy(), w.double().sum((1, 2)).numpy(),
                                       rtol=0, atol=COL_ATOL)


def test_stats_off_or_before_a_pass_are_empty():
    _, tm = _models(1, 4, 0, 16)
    assert tm.get_attention_stats() == []
    off = HealNet(**dict(MODEL, depth=1, l_c=4, self_per_cross_attn=0), store_attention="off",
                  device="cpu")
    off([np.zeros((1, 2, 24), np.float32), np.zeros((1, 3, 10), np.float32)])
    assert off.get_attention_stats() == []


# ------------------------------------------------- softmax and mask family


@pytest.mark.parametrize("temperature,axis", [(1.0, -1), (0.5, -1), (0.25, 0), (2.0, 1)])
def test_temperature_softmax_matches_jax(rng, temperature, axis):
    x = rng.normal(size=(3, 5, 7)).astype(np.float32) * 4
    got = temperature_softmax(torch.tensor(x), temperature, axis=axis)
    want = jax_temperature_softmax(jnp.asarray(x), temperature, axis=axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.fixture
def threefry():
    assert mask_family() == jax_mask_family() == "hash"  # the default
    mask_family("threefry")
    yield
    mask_family("hash")


def test_mask_family_get_set():
    assert mask_family() == "hash"
    with pytest.raises(ValueError):
        mask_family("philox")
    assert mask_family() == "hash"


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.6])
def test_threefry_keep_rate_and_independence(rng, threefry, rate):
    """The Bernoulli mask keeps 1 - rate of the entries, is drawn from the
    call's generator (the same generator state gives the same mask, the
    global RNG is untouched), and is independent of the hash mask."""
    q, k, v = (torch.tensor(a) for a in _qkv(rng, b=4, h=2, lq=16, lkv=512))
    eye = torch.eye(512).expand(4, 2, 512, 512)  # the output is the dropped map
    seed = 1234

    def keep_of(gen):
        out, _ = multihead_attention(q, k, eye, scale=0.3, dropout_rate=rate,
                                     dropout_seed=seed, generator=gen)
        return out.reshape(4, 16, 2, 512).transpose(1, 2) > 0

    before = torch.random.get_rng_state()
    keep = keep_of(torch.Generator().manual_seed(9))
    again = keep_of(torch.Generator().manual_seed(9))
    other = keep_of(torch.Generator().manual_seed(10))
    assert torch.equal(torch.random.get_rng_state(), before)
    assert torch.equal(keep, again) and not torch.equal(keep, other)
    n = keep.numel()
    rate_seen = 1.0 - keep.float().mean().item()
    assert abs(rate_seen - rate) < 4 * np.sqrt(rate * (1 - rate) / n)
    hashed = dense_keep_mask(seed, 8, 16, 512, rate).reshape(4, 2, 16, 512)
    both = (keep & hashed).float().mean().item()
    expect = (1 - rate) ** 2
    assert abs(both - expect) < 4 * np.sqrt(expect * (1 - expect) / n)
    with pytest.raises(ValueError, match="generator"):
        multihead_attention(q, k, v, scale=0.3, dropout_rate=rate, dropout_seed=seed)


def test_threefry_in_the_model_and_the_hash_default(rng, threefry):
    """Under threefry a training pass draws its attention masks from the
    forward's generator; remat refuses it; back on "hash" the pass equals
    JAX's hash family (the default)."""
    module = HealNetModule(**MODEL, depth=1, l_c=4, self_per_cross_attn=1, attn_dropout=0.4,
                           device="cpu").train()
    x = (torch.randn(2, 7, 24), torch.randn(2, 30, 10))
    seeds = torch.arange(module.attention_calls(), dtype=torch.int64)
    run = lambda s: module(x, generator=torch.Generator().manual_seed(s), seeds=seeds)
    with torch.no_grad():
        a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    mask_family("hash")
    with torch.no_grad():
        h1, h2 = run(1), run(2)
    assert torch.equal(h1, h2)  # the hash masks depend on the seeds only
    mask_family("threefry")
    remat = HealNetModule(**MODEL, depth=1, l_c=4, self_per_cross_attn=0, attn_dropout=0.4,
                          remat=True, device="cpu").train()
    with pytest.raises(ValueError, match="remat"):
        remat(x, generator=torch.Generator(), seeds=torch.arange(remat.attention_calls()))
