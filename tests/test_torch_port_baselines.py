"""The port's baselines (``healnet_tpu_torch.models.baselines``), their
trainers and their pipeline folds, against the JAX package on the CPU.

The same numpy inputs go through both packages, the JAX weights carried
into the port by ``compat.flax_params``, at small sizes (bags of 16-40
patches 32 wide, omic vectors of 40, MultiModN widths of 16, 10 Sinkhorn
iterations where a case sets them). Tolerances:

- deterministic forwards (eval mode, no dropout): every output within
  1e-5 of the largest magnitude of JAX's; MMPrognosis with its batch
  statistics within 5e-4: its second norm centres the highway's output,
  whose spread over the batch is a small part of its size, and each
  package's float32 logits lie ~1e-4 from float64 there (without the
  norms they agree to 3e-7);
- gradients of a fixed random projection of the outputs: every
  parameter's gradient within 1e-5 of the largest gradient of the case
  (the GRU's too: a 20-step recurrence at these widths stays there); the
  Sinkhorn plan's gradient by its cost within 1e-4 of the largest, since
  10 log-sum-exp iterations each add float32 rounding to the duals;
- dropout, whose RNGs differ, by its statistics: the keep rate within 4
  standard deviations, AlphaDropout's mean within 0.01 and variance within
  0.02 of a SELU-normal input's, the attention mask one (q, k) draw shared
  by every batch row and head;
- trainers (dropout-free MultiModN): losses 1e-5 relative, parameters
  1e-6 relative / 1e-7 absolute after each step, as
  ``tests/test_torch_port_train.py`` holds HealNet's steps.
"""

import math
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from healnet_tpu.models import baselines as jb
from healnet_tpu.models.baselines.multimodn import MultiModNHistory as JaxHistory
from healnet_tpu.train import MultiModNTrainer as JaxMultiModNTrainer
from healnet_tpu.train.loop import SurvivalTrainer as JaxTrainer
from healnet_tpu.train.pipeline import Pipeline as JaxPipeline
from healnet_tpu_torch.compat.flax_params import flax_from_state_dict, state_dict_from_flax
from healnet_tpu_torch.models import baselines as tb
from healnet_tpu_torch.models.baselines.common import MultiHeadDotProductAttention, dropout
from healnet_tpu_torch.train import MultiModNTrainer, SurvivalTrainer
from healnet_tpu_torch.train.pipeline import Pipeline
from healnet_tpu_torch.utils import Config

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_port_pipeline import cohort, write_config  # noqa: E402,F401

B, OMIC, WSI, PATCHES = 3, 40, 32, 20
CPU = dict(device="cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _init(model, *args, **kw):
    """Flax weights for ``model`` on these inputs: the tree of its
    ``init`` (by ``jax.eval_shape``; a traced init would cost seconds of
    compilation a model) filled from a numpy seed, kernels N(0, 1/fan_in),
    scales 1 + N(0, 0.01), every other leaf (biases, the state) N(0,
    0.01), so that every leaf's mapping shows."""
    tree = jax.eval_shape(lambda *a: model.init(jax.random.PRNGKey(0), *a, **kw), *args)
    rng = np.random.default_rng(7)

    def draw(path, leaf):
        keys = [getattr(k, "key", k) for k in path]
        x = rng.normal(size=leaf.shape).astype(np.float32)
        if keys[-1] == "kernel":
            fan_in = leaf.shape[0] if keys[-2] in ("query", "key", "value") \
                else math.prod(leaf.shape[:-1])
            return x / np.float32(math.sqrt(fan_in))
        return x * np.float32(0.1) + np.float32(keys[-1] == "scale")

    return jax.tree_util.tree_map_with_path(draw, tree["params"])


def _carried(module, params):
    """``module`` with the JAX weights (every name and shape must match),
    in eval mode."""
    module.load_state_dict(state_dict_from_flax(params))
    return module.eval()


def _flat(out):
    """The float arrays of a (nested) output, in a fixed order."""
    if out is None:
        return []
    if isinstance(out, dict):
        return [a for k in sorted(out) for a in _flat(out[k])]
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _flat(o)]
    return [out]


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{what}: max |diff| {err:.3g} > {tol} x {scale:.3g}"


class Case(SimpleNamespace):
    """A JAX function of its params, the params, the port module carrying
    them, and the port's call; both calls give the same output structure."""


def _inputs(rng, b=B, patches=PATCHES, tokens=False):
    omic = rng.normal(size=(b, 1, OMIC)).astype(np.float32)
    bag = rng.normal(size=(b, patches, WSI)).astype(np.float32)
    return omic, (bag if tokens else bag.transpose(0, 2, 1).copy())


def _model_case(jmodel, port_cls, port_kw, tensors, call_kw=None, port_call_kw=None):
    """A model called as ``model(tensors, **kw)`` in both packages."""
    call_kw = call_kw or {}
    params = _init(jmodel, [jnp.asarray(t) for t in tensors])
    shapes = [t.shape[1:] for t in tensors]
    module = _carried(port_cls(**port_kw, input_shapes=shapes, **CPU), params)
    jt = [jnp.asarray(t) for t in tensors]
    pt = [_t(t) for t in tensors]
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in call_kw.items()}
    pkw = {k: _t(v) if isinstance(v, np.ndarray) else v
           for k, v in {**call_kw, **(port_call_kw or {})}.items()}
    return Case(jax=lambda p: jmodel.apply({"params": p}, jt, **jkw), params=params,
                module=module, port=lambda: module(pt, **pkw))


def _block_case(jmodel, port_module, args, **kw):
    """A block called as ``block(*args)`` in both packages."""
    params = _init(jmodel, *[jnp.asarray(a) for a in args], **kw)
    module = _carried(port_module, params)
    return Case(jax=lambda p: jmodel.apply({"params": p}, *[jnp.asarray(a) for a in args], **kw),
                params=params, module=module, port=lambda: module(*[_t(a) for a in args]))


def _multimodn(rng, **kw):
    state = 16
    jmodel = jb.MultiModNModule(
        state_size=state,
        encoders=[jb.MLPEncoder(state, (16,)), jb.PatchEncoder(state, (16, 8))],
        decoders=[jb.ClassDecoder(4), jb.MLPDecoder((8,), n_classes=4)], **kw)
    omic = rng.normal(size=(B, OMIC)).astype(np.float32)
    bag = rng.normal(size=(B, PATCHES, WSI)).astype(np.float32)
    port = tb.MultiModNModule(
        state_size=state,
        encoders=[tb.MLPEncoder(state, (16,), input_shape=(OMIC,)),
                  tb.PatchEncoder(state, (16, 8), input_shape=(PATCHES, WSI))],
        decoders=[tb.ClassDecoder(4, state_size=state),
                  tb.MLPDecoder((8,), n_classes=4, state_size=state)], **kw, **CPU)
    targets = np.eye(4, dtype=np.float32)[[0, 3, 1]]
    return jmodel, port, [omic, bag], targets


def _multimodn_case(rng, stages=False, with_targets=True, **kw):
    jmodel, port, tensors, targets = _multimodn(rng, **kw)
    params = _init(jmodel, [jnp.asarray(t) for t in tensors], jnp.asarray(targets))
    module = _carried(port, params)
    if not with_targets:  # inference: the last decoder's outputs alone
        return Case(jax=lambda p: jmodel.apply({"params": p}, [jnp.asarray(t) for t in tensors]),
                    params=params, module=module, port=lambda: module([_t(t) for t in tensors]))
    call = dict(return_stages=stages)
    if stages:
        call.update(presence=np.array([[1, 1], [1, 0], [0, 1]], np.float32),
                    sample_weights=np.array([1, 1, 0], np.float32))
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in call.items()}
    pkw = {k: _t(v) if isinstance(v, np.ndarray) else v for k, v in call.items()}
    return Case(
        jax=lambda p: jmodel.apply({"params": p}, [jnp.asarray(t) for t in tensors],
                                   jnp.asarray(targets), **jkw),
        params=params, module=module,
        port=lambda: module([_t(t) for t in tensors], _t(targets), **pkw))


def _case(name, rng):
    omic, wsi = _inputs(rng)
    tok_omic, tokens = _inputs(rng, tokens=True)
    x = rng.normal(size=(B, 7, 24)).astype(np.float32)
    state = rng.normal(size=(B, 16)).astype(np.float32)
    if name == "snn_block":
        return _block_case(jb.SNNBlock(16), tb.SNNBlock(16, in_features=24), [x[:, 0]])
    if name == "snn_block_max_init":
        return _block_case(jb.SNNBlock(16, max_init=True),
                           tb.SNNBlock(16, max_init=True, in_features=24), [x[:, 0]])
    if name == "attn_net_gated":
        return _block_case(jb.AttnNetGated(hidden=16, n_classes=2, dropout=0.25),
                           tb.AttnNetGated(hidden=16, n_classes=2, dropout=0.25,
                                           in_features=24), [x])
    if name in ("bilinear_gated", "bilinear_ungated_skip"):
        kw = dict(dim1=16, dim2=24, scale_dim1=2, scale_dim2=4, mmhid=12)
        if name == "bilinear_ungated_skip":
            kw.update(gate1=False, gate2=False, skip=True)
        return _block_case(jb.BilinearFusion(**kw), tb.BilinearFusion(**kw),
                           [x[:, 0, :16], x[:, 1]])
    if name == "transformer":
        kw = dict(num_layers=2, d_model=24, nhead=4, dim_feedforward=20, dropout=0.25)
        return _block_case(jb.TransformerEncoder(**kw), tb.TransformerEncoder(**kw), [x])
    if name == "highway":
        return _block_case(jb.Highway(size=24, num_layers=3), tb.Highway(size=24, num_layers=3),
                           [x[:, 0]])
    if name == "fcnn":
        return _model_case(jb.FCNN([32, 16], 4), tb.FCNN, dict(hidden_sizes=[32, 16],
                                                                output_size=4), [omic])
    if name == "regularized_fcnn":
        return _model_case(jb.RegularizedFCNN(4), tb.RegularizedFCNN, dict(output_dim=4), [omic])
    if name == "mcat_concat":
        return _model_case(jb.MCAT(4), tb.MCAT, {}, [omic, wsi])
    if name == "mcat_bilinear":
        return _model_case(jb.MCAT(4, fusion="bilinear"), tb.MCAT, dict(fusion="bilinear"),
                           [omic, wsi])
    if name == "mcat_tokens_attention":
        return _model_case(jb.MCAT(4, tokens_layout=True), tb.MCAT, dict(tokens_layout=True),
                           [tok_omic, tokens], dict(return_attention=True))
    if name == "mcat_signatures":
        sigs = [rng.normal(size=(B, w)).astype(np.float32) for w in (30, 17, 25)]
        jmodel = jb.MCAT(4)
        params = _init(jmodel, [[jnp.asarray(s) for s in sigs], jnp.asarray(wsi)])
        module = _carried(tb.MCAT(4, input_shapes=[[s.shape[1:] for s in sigs], wsi.shape[1:]],
                                  **CPU), params)
        return Case(
            jax=lambda p: jmodel.apply({"params": p}, [[jnp.asarray(s) for s in sigs],
                                                       jnp.asarray(wsi)], return_attention=True),
            params=params, module=module,
            port=lambda: module([[_t(s) for s in sigs], _t(wsi)], return_attention=True))
    if name == "mil":
        return _model_case(jb.MILAttentionNet(4), tb.MILAttentionNet, {}, [wsi])
    if name == "mil_tokens":
        return _model_case(jb.MILAttentionNet(4, tokens_layout=True), tb.MILAttentionNet,
                           dict(tokens_layout=True), [tokens])
    if name == "snn":
        return _model_case(jb.SNN(4), tb.SNN, {}, [omic])
    if name == "motcat":
        return _model_case(jb.MOTCAT(4, ot_iters=10), tb.MOTCAT, dict(ot_iters=10), [omic, wsi])
    if name == "motcat_unbalanced_attention":
        return _model_case(jb.MOTCAT(4, ot_iters=10, ot_tau=0.5, tokens_layout=True), tb.MOTCAT,
                           dict(ot_iters=10, ot_tau=0.5, tokens_layout=True),
                           [tok_omic, tokens], dict(return_attention=True))
    if name == "mm_prognosis":
        return _model_case(jb.MMPrognosis(4), tb.MMPrognosis, {}, [omic, wsi])
    if name == "mm_prognosis_b1":
        return _model_case(jb.MMPrognosis(4), tb.MMPrognosis, {}, [omic[:1], wsi[:1]])
    if name == "mm_prognosis_presence_tokens":
        bag = rng.normal(size=(B, 33, WSI)).astype(np.float32)  # SAME pads 1 and 2
        return _model_case(jb.MMPrognosis(4, tokens_layout=True), tb.MMPrognosis,
                           dict(tokens_layout=True), [tok_omic, bag],
                           dict(presence=np.array([[1, 1], [1, 0], [0, 1]], np.float32)))
    if name == "mm_prognosis_no_batch_norm":
        return _model_case(jb.MMPrognosis(4, batch_norm=False), tb.MMPrognosis,
                           dict(batch_norm=False), [omic, wsi])
    if name == "mlp_encoder":
        return _block_case(jb.MLPEncoder(16, (20, 12)),
                           tb.MLPEncoder(16, (20, 12), input_shape=(1, OMIC)), [state, omic])
    if name == "patch_encoder":
        return _block_case(jb.PatchEncoder(16, (16, 8)),
                           tb.PatchEncoder(16, (16, 8), input_shape=(PATCHES, WSI)),
                           [state, tokens])
    if name == "resnet_encoder":
        img = rng.normal(size=(2, 19, 22, 3)).astype(np.float32)
        return _block_case(jb.ResNetEncoder(16, (4, 8)),
                           tb.ResNetEncoder(16, (4, 8), input_shape=img.shape[1:]),
                           [state[:2], img])
    if name == "class_decoder":
        return _block_case(jb.ClassDecoder(4), tb.ClassDecoder(4, state_size=16), [state])
    if name == "mlp_decoder":
        return _block_case(jb.MLPDecoder((8, 6), n_classes=3),
                           tb.MLPDecoder((8, 6), n_classes=3, state_size=16), [state])
    if name == "logistic_decoder":
        return _block_case(jb.LogisticDecoder(), tb.LogisticDecoder(state_size=16), [state])
    if name == "multimodn_logits":
        return _multimodn_case(rng, with_targets=False)
    if name == "multimodn_loss":
        return _multimodn_case(rng, state_change_penalty=0.3)
    if name == "multimodn_stages":
        return _multimodn_case(rng, stages=True, err_penalty=0.7, state_change_penalty=0.3)
    raise KeyError(name)


# forwards alone; the cases of GRADIENTS check their forward there
FORWARD = ["snn_block", "bilinear_ungated_skip", "highway", "mcat_tokens_attention",
           "mil_tokens", "motcat_unbalanced_attention", "mm_prognosis_presence_tokens",
           "mm_prognosis_no_batch_norm", "class_decoder", "logistic_decoder",
           "multimodn_logits"]
GRADIENTS = ["snn_block_max_init", "attn_net_gated", "bilinear_gated", "transformer",
             "fcnn", "regularized_fcnn", "mcat_concat", "mcat_bilinear", "mcat_signatures",
             "mil", "snn", "motcat", "mm_prognosis", "mm_prognosis_b1", "mlp_encoder",
             "patch_encoder", "resnet_encoder", "mlp_decoder", "multimodn_loss",
             "multimodn_stages"]


# the batch-statistics cases (see the module docstring)
BATCH_NORM_TOL = {"mm_prognosis": 5e-4, "mm_prognosis_presence_tokens": 5e-4}


@pytest.mark.parametrize("name", FORWARD)
def test_forward_matches_jax(rng, name):
    case = _case(name, rng)
    with torch.no_grad():
        got = _flat(case.port())
    want = _flat(jax.jit(case.jax)(case.params))
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy(), w, BATCH_NORM_TOL.get(name, 1e-5), f"{name} output {i}")


@pytest.mark.parametrize("name", GRADIENTS)
def test_gradients_match_jax(rng, name):
    """The outputs, and the gradient of sum(w_i * output_i) (w fixed
    random) by every parameter."""
    case = _case(name, rng)
    weights = [rng.normal(size=o.shape).astype(np.float32)
               for o in _flat(jax.eval_shape(case.jax, case.params))]

    def jloss(p):
        outs = _flat(case.jax(p))
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights)), outs

    grads, outs = jax.jit(jax.grad(jloss, has_aux=True))(case.params)
    want = state_dict_from_flax(grads)
    port_outs = _flat(case.port())
    for i, (g, w) in enumerate(zip(port_outs, outs)):
        _close(g.detach().numpy(), w, BATCH_NORM_TOL.get(name, 1e-5), f"{name} output {i}")
    sum(torch.sum(o * _t(w)) for o, w in zip(port_outs, weights)).backward()
    got = {n: torch.zeros_like(p) if p.grad is None else p.grad
           for n, p in case.module.named_parameters()}
    assert set(got) == set(want)
    scale = max(float(g.abs().max()) for g in want.values())
    assert scale > 0
    for n, g in want.items():
        err = float((got[n] - g).abs().max())
        tol = BATCH_NORM_TOL.get(name, 1e-5)
        assert err <= tol * scale, f"{name} {n}: {err:.3g} > {tol} x {scale:.3g}"


# ------------------------------------------------------------------ Sinkhorn

@pytest.mark.parametrize("tau", [None, 0.5], ids=["balanced", "unbalanced"])
def test_sinkhorn_matches_jax(rng, tau):
    """The plan (1e-5 of its largest entry) and its gradient by the cost
    (1e-4 of the largest)."""
    cost = rng.uniform(size=(2, 5, 9)).astype(np.float32)
    w = rng.normal(size=cost.shape).astype(np.float32)
    kw = dict(reg=0.1, n_iters=10, unbalanced_tau=tau)
    want, vjp = jax.vjp(lambda c: jb.sinkhorn_log(c, **kw), jnp.asarray(cost))
    c = _t(cost).requires_grad_(True)
    got = tb.sinkhorn_log(c, **kw)
    _close(got.detach().numpy(), want, 1e-5, "plan")
    (got * _t(w)).sum().backward()
    _close(c.grad.numpy(), vjp(jnp.asarray(w))[0], 1e-4, "d cost")


def test_sinkhorn_marginals():
    cost = torch.from_numpy(np.random.default_rng(1).uniform(size=(2, 5, 9)).astype(np.float32))
    plan = tb.sinkhorn_log(cost, reg=0.05, n_iters=200)
    np.testing.assert_allclose(plan.sum(-1).numpy(), 1 / 5, atol=1e-3)
    np.testing.assert_allclose(plan.sum(-2).numpy(), 1 / 9, atol=1e-3)


def test_ot_attention_matches_jax(rng):
    q = rng.normal(size=(2, 3, 8)).astype(np.float32)
    k = rng.normal(size=(2, 11, 8)).astype(np.float32)
    model = jb.OTAttention(n_iters=10)
    want = model.apply({}, jnp.asarray(q), jnp.asarray(k))
    got = tb.OTAttention(n_iters=10)(_t(q), _t(k))
    for g, w, what in zip(got, want, ("plan", "cost")):
        _close(g.numpy(), w, 1e-5, what)


def test_regularizers_match_jax(rng):
    case = _case("regularized_fcnn", rng)
    jmodel = jb.RegularizedFCNN(4)
    params = jax.tree_util.tree_map(jnp.asarray, case.params)
    for fn in ("l1_regularization", "l2_regularization"):
        want = float(getattr(jmodel, fn)(params))
        with torch.no_grad():
            np.testing.assert_allclose(float(getattr(case.module, fn)()), want, rtol=1e-5)
            sd = case.module.state_dict()
            np.testing.assert_allclose(float(getattr(case.module, fn)(sd)), want, rtol=1e-5)


def test_alpha_dropout_eval_is_identity(rng):
    x = rng.normal(size=(4, 9)).astype(np.float32)
    want = jb.AlphaDropout(0.25).apply({}, jnp.asarray(x), deterministic=True)
    got = tb.AlphaDropout(0.25).eval()(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ dropout

def test_dropout_keep_rate_and_scale():
    x = torch.ones(200_000)
    out = dropout(x, 0.3, torch.Generator().manual_seed(0), training=True)
    kept = out != 0
    rate, sigma = kept.float().mean().item(), math.sqrt(0.7 * 0.3 / x.numel())
    assert abs(rate - 0.7) < 4 * sigma
    np.testing.assert_allclose(out[kept].numpy(), 1 / 0.7, rtol=1e-6)
    assert torch.equal(dropout(x, 0.3, None, training=False), x)
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.3, None, training=True)


def test_alpha_dropout_keeps_selu_normal_statistics():
    """SELU's fixed point is mean 0, variance 1; AlphaDropout keeps it (so
    does JAX's, drawn from its own RNG)."""
    x = torch.randn(400_000, generator=torch.Generator().manual_seed(1))
    layer = tb.AlphaDropout(0.25).train()
    out = layer(x, torch.Generator().manual_seed(2))
    ref = jb.AlphaDropout(0.25).apply({}, jnp.asarray(x.numpy()), deterministic=False,
                                      rngs={"dropout": jax.random.PRNGKey(2)})
    for y in (out.numpy(), np.asarray(ref)):
        assert abs(float(y.mean())) < 0.01 and abs(float(y.var()) - 1.0) < 0.02
    # a dropped unit leaves as a * alpha' + b, the same value for all
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = (0.75 + alpha_p**2 * 0.75 * 0.25) ** -0.5
    dropped = torch.isclose(out, torch.tensor(a * alpha_p - a * alpha_p * 0.25)).float().mean()
    dropped = dropped.item()
    assert abs(dropped - 0.25) < 4 * math.sqrt(0.25 * 0.75 / x.numel())


def test_attention_dropout_mask_shared_across_batch_and_heads(rng):
    """One (q, k) keep mask for every batch row and head, as Flax's
    ``broadcast_dropout``: the output equals the attention recomputed with
    the mask the generator drew, broadcast."""
    mha = MultiHeadDotProductAttention(4, 16, 0.4, in_features=16).train()
    mha.query.reset_parameters(torch.Generator().manual_seed(0))
    for m in (mha.key, mha.value, mha.out):
        m.reset_parameters(torch.Generator().manual_seed(1))
    x = _t(rng.normal(size=(3, 6, 16)).astype(np.float32))
    gen = torch.Generator().manual_seed(3)
    twin = torch.Generator().set_state(gen.get_state())
    got = mha(x, gen)
    keep = torch.rand((6, 6), generator=twin) < 0.6
    with torch.no_grad():
        q, k, v = mha.query(x), mha.key(x), mha.value(x)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q / 2.0, k), dim=-1)
        want = mha.out(torch.einsum("bhqk,bkhd->bqhd", w * keep / 0.6, v))
    _close(got.detach().numpy(), want.numpy(), 1e-6, "masked attention")
    rates = []
    for seed in range(40):
        probe = torch.Generator().manual_seed(seed)
        rates.append((torch.rand((6, 6), generator=probe) < 0.6).float().mean().item())
    assert abs(np.mean(rates) - 0.6) < 4 * math.sqrt(0.24 / (40 * 36))


def test_dropout_draws_from_the_generator(rng):
    omic, wsi = _inputs(rng)
    model = tb.MCAT(4, input_shapes=[omic.shape[1:], wsi.shape[1:]], **CPU,
                    generator=torch.Generator().manual_seed(0)).train()
    t = [_t(omic), _t(wsi)]
    a = model(t, generator=torch.Generator().manual_seed(5))
    b = model(t, generator=torch.Generator().manual_seed(5))
    c = model(t, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        model(t)


# ------------------------------------------------------- presence and layout

@pytest.mark.parametrize("cls", ["MCAT", "MOTCAT", "SNN", "MILAttentionNet", "MMPrognosis"])
def test_presence_zero_imputes_the_absent_modality(rng, cls):
    """An absent modality changes the output, and equals feeding zeros for
    it (MMPrognosis: leaving it out of the fused mean)."""
    omic, wsi = _inputs(rng, b=4)
    tensors = {"SNN": [omic], "MILAttentionNet": [wsi]}.get(cls, [omic, wsi])
    n = len(tensors)
    model = getattr(tb, cls)(input_shapes=[t.shape[1:] for t in tensors], **CPU,
                             generator=torch.Generator().manual_seed(0)).eval()
    full = torch.ones(4, n)
    drop = full.clone()
    drop[:, -1] = 0.0
    t = [_t(x) for x in tensors]
    with torch.no_grad():
        out_full, out_drop = model(t, presence=full), model(t, presence=drop)
        assert not torch.allclose(out_full, out_drop)
        if cls != "MMPrognosis":
            zeroed = t[:-1] + [torch.zeros_like(t[-1])]
            torch.testing.assert_close(model(zeroed, presence=full), out_drop)


@pytest.mark.parametrize("cls", ["MCAT", "MOTCAT", "MILAttentionNet", "MMPrognosis"])
def test_tokens_layout_equals_channels_layout(rng, cls):
    """``tokens_layout=True`` on (b, patches, dim) is the channels-layout
    model on the transposed bag: the same weights, the same logits."""
    omic, tokens = _inputs(rng, tokens=True)
    channels = tokens.transpose(0, 2, 1).copy()
    with_omic = cls != "MILAttentionNet"
    t_ch = [omic, channels] if with_omic else [channels]
    t_tok = [omic, tokens] if with_omic else [tokens]
    model_cls = getattr(tb, cls)
    ch = model_cls(input_shapes=[t.shape[1:] for t in t_ch], **CPU,
                   generator=torch.Generator().manual_seed(0)).eval()
    tok = model_cls(tokens_layout=True, input_shapes=[t.shape[1:] for t in t_tok], **CPU).eval()
    tok.load_state_dict(ch.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(tok([_t(x) for x in t_tok]), ch([_t(x) for x in t_ch]),
                                   rtol=1e-5, atol=1e-6)


def test_multimodn_presence_keeps_the_state(rng):
    """An absent modality (presence 0) leaves the state as it was: no
    state change, the decoders' outputs those of the stage before."""
    _, port, tensors, targets = _multimodn(rng)
    t = [_t(x) for x in tensors]
    presence = torch.tensor([[1.0, 0.0]] * B)
    with torch.no_grad():
        stages, changes, loss = port.eval()(t, _t(targets), presence=presence,
                                            return_stages=True)
    assert len(stages) == 3 and float(changes[1]) == 0.0 and loss is not None
    torch.testing.assert_close(stages[2][0], stages[1][0])


# --------------------------------------------------------- weights and names

def _pipeline_widths_models():
    """(model, sources) pairs of both factories at full width: omic 1 x
    2000, bags of 4096 x 2048 from the arena, 4 bins."""
    return [("fcnn", ["omic", "slides"]), ("mcat", ["omic", "slides"]), ("mcat", ["omic"]),
            ("mcat", ["slides"]), ("mm_prognosis", ["omic", "slides"]),
            ("motcat", ["omic", "slides"]), ("multimodn", ["omic", "slides"])]


@pytest.mark.parametrize("model,sources", _pipeline_widths_models(),
                         ids=lambda v: v if isinstance(v, str) else "+".join(v))
def test_param_shapes_match_jax_at_pipeline_widths(model, sources):
    """Every parameter's name and shape, the port's factory against JAX's
    (``jax.eval_shape``: nothing is allocated on the JAX side)."""
    b, bag, omic_w, dim = 8, 4096, 2000, 2048
    ns = SimpleNamespace(config={"model": model, "patch_attention": True}, sources=sources,
                         output_dims=4, device=torch.device("cpu"))
    omic = np.zeros((b, 1, omic_w), np.float32)
    batch = {"tensors": (omic,) if "omic" in sources else (),
             "kv_masks": (None, np.ones((b, bag), bool)), "arena_dim": dim}
    port = Pipeline._make_baseline(ns, batch, torch.Generator().manual_seed(0))
    jmodel = JaxPipeline.make_model(ns, {"tensors": batch["tensors"], "arena_dim": dim})
    spec = [jax.ShapeDtypeStruct(t.shape, jnp.float32) for t in batch["tensors"]]
    if "slides" in sources:
        spec.append(jax.ShapeDtypeStruct((b, bag, dim), jnp.float32))
    extra = (jax.ShapeDtypeStruct((b, 4), jnp.float32),) if model == "multimodn" else ()
    want = jax.eval_shape(lambda *a: jmodel.init(jax.random.PRNGKey(0), list(a[:len(spec)]),
                                                 *a[len(spec):]), *spec, *extra)["params"]
    want = {jax.tree_util.keystr(p): tuple(l.shape)
            for p, l in jax.tree_util.tree_leaves_with_path(want)}
    got = {jax.tree_util.keystr(p): tuple(np.shape(l)) for p, l in
           jax.tree_util.tree_leaves_with_path(flax_from_state_dict(port.state_dict()))}
    assert got == want
    assert type(port).__name__ == type(jmodel).__name__


ROUND_TRIP = ["snn_block", "attn_net_gated", "bilinear_gated", "transformer", "highway",
              "fcnn", "regularized_fcnn", "mcat_concat", "mcat_bilinear", "mcat_signatures",
              "mil", "snn", "motcat", "mm_prognosis", "mm_prognosis_no_batch_norm",
              "mlp_encoder", "patch_encoder", "resnet_encoder", "class_decoder", "mlp_decoder",
              "multimodn_loss"]


@pytest.mark.parametrize("name", ROUND_TRIP)
def test_flax_round_trip_is_exact(rng, name):
    """Flax tree -> state dict -> Flax tree gives every leaf back bit for
    bit, and the port's own state dict survives the reverse trip."""
    case = _case(name, rng)
    tree = case.params
    back = flax_from_state_dict(state_dict_from_flax(tree))
    flat = dict(jax.tree_util.tree_leaves_with_path(tree))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(map(jax.tree_util.keystr, flat)) == set(map(jax.tree_util.keystr, flat_back))
    by_key = {jax.tree_util.keystr(k): v for k, v in flat_back.items()}
    for k, v in flat.items():
        w = by_key[jax.tree_util.keystr(k)]
        assert w.dtype == np.float32 and w.shape == v.shape
        np.testing.assert_array_equal(w, v)
    sd = case.module.state_dict()
    again = state_dict_from_flax(flax_from_state_dict(sd))
    assert set(again) == set(sd)
    for k, v in sd.items():
        assert torch.equal(again[k], v), k


# ------------------------------------------------------------------ trainers

def _survival_batch(rng, tensors, pad=0):
    b = tensors[0].shape[0]
    mask = np.ones(b, np.float32)
    mask[b - pad:] = 0.0
    return {"tensors": tuple(tensors), "y_disc": rng.integers(0, 4, size=b).astype(np.int32),
            "censorship": np.array([0, 1, 0, 1][:b], np.float32),
            "event_time": rng.uniform(1, 100, size=b).astype(np.float32), "sample_mask": mask}


def test_survival_trainer_aux_loss_matches_jax(rng):
    """Three steps of MultiModN (no dropout) through both trainers with
    ``aux_loss``: the survival loss, the risks and the weights after each
    step; the evaluation loss is the survival loss plus the module's."""
    jmodel, port, tensors, targets = _multimodn(rng, state_change_penalty=0.2)
    params = _init(jmodel, [jnp.asarray(t) for t in tensors], jnp.asarray(targets))
    port.load_state_dict(state_dict_from_flax(params))
    kw = dict(l1=1e-4, max_lr=1e-3, gc_compat=16, aux_loss=True, n_bins=4,
              class_weights=np.array([1, 2, 1, 3], np.float32))
    jtr = JaxTrainer(jmodel, **kw)
    jtr._build_steps()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jtr._opt.init(jparams)
    ttr = SurvivalTrainer(port, **kw, device="cpu")
    batches = [_survival_batch(rng, [rng.normal(size=t.shape).astype(np.float32)
                                     for t in tensors], pad=p) for p in (0, 1, 0)]
    for step, batch in enumerate(batches):
        jparams, jstate, jloss, jrisk, _ = jtr._train_step(
            jparams, jstate, jax.tree_util.tree_map(jnp.asarray, batch), jax.random.PRNGKey(0),
            None, jtr.class_weights, jnp.float32(50.0))
        tloss, trisk, _ = ttr.train_step(batch, horizon=50)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(trisk.numpy(), np.asarray(jrisk), rtol=1e-5, atol=1e-6)
        ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
        for name, p in port.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {step + 1} {name}")
    loss, _, logits = ttr.eval_step(batches[0])
    jl, _, jlg = jtr._eval_step(jparams, jax.tree_util.tree_map(jnp.asarray, batches[0]),
                                None, jtr.class_weights)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlg), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    surv, _ = ttr._surv_loss(logits, ttr._place(batches[0]))
    assert float(loss) > float(surv)  # the module's own loss is added


def test_fused_aux_loss_fit_matches_jax_fused_epochs(rng):
    """MultiModN (no dropout) from a feature arena, fused epochs, both
    trainers from the same weights: each epoch's losses and c-indices."""
    width, n = 12, 16
    lengths = rng.integers(3, width + 1, size=n).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int32)
    arena = np.concatenate([rng.normal(size=(int(lengths.sum()), WSI)),
                            np.zeros((width, WSI))]).astype(np.float32)
    data = {"tensors": (rng.normal(size=(n, 1, OMIC)).astype(np.float32),),
            "kv_masks": (None, np.arange(width)[None, :] < lengths[:, None]),
            "patch_offsets": offsets, "patch_lengths": lengths,
            "y_disc": rng.integers(0, 4, size=n),
            "censorship": (rng.uniform(size=n) < 0.4).astype(np.float32),
            "event_time": rng.uniform(1, 100, size=n).astype(np.float32)}
    state = 16
    jmodel = jb.MultiModNModule(state_size=state, encoders=[
        jb.MLPEncoder(state, (16,)), jb.PatchEncoder(state, (8,))], decoders=[jb.ClassDecoder(4)])
    params = _init(jmodel, [jnp.zeros((2, 1, OMIC)), jnp.zeros((2, width, WSI))],
                   jnp.zeros((2, 4)))
    port = tb.MultiModNModule(state_size=state, encoders=[
        tb.MLPEncoder(state, (16,), input_shape=(1, OMIC)),
        tb.PatchEncoder(state, (8,), input_shape=(width, WSI))],
        decoders=[tb.ClassDecoder(4, state_size=state)], **CPU)
    port.load_state_dict(state_dict_from_flax(params))
    kw = dict(batch_size=4, epochs=2, l1=1e-4, max_lr=1e-3, seed=5, early_stopping=False,
              aux_loss=True, n_bins=4, fused_epochs=True, prefetch=0,
              feature_arena=(arena, offsets, lengths))
    jtr = JaxTrainer(jmodel, **kw)
    jtr.params = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jtr.fit(data, data, verbose=False)
    ttr = SurvivalTrainer(port, **kw, device="cpu")
    assert ttr.fused_epochs
    got = ttr.fit(data, data, verbose=False)
    assert len(got["history"]) == len(ref["history"]) == 2
    for g, r in zip(got["history"], ref["history"]):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(g[key], r[key], rtol=1e-5, err_msg=key)
        for key in ("train_c_index", "val_c_index"):
            np.testing.assert_allclose(g[key], r[key], rtol=0, atol=1e-5, err_msg=key)


def test_multimodn_trainer_matches_jax(rng, tmp_path):
    """MultiModN's own protocol, two epochs from the same weights: the
    (stage x decoder) loss and accuracy matrices, confusion counts, binary
    rates and state changes of train and validation, the predictions, and
    the history's CSV against JAX's (pandas) CSV."""
    n = 20
    tab = rng.normal(size=(n, 6)).astype(np.float32)
    bag = rng.normal(size=(n, 5, 4)).astype(np.float32)
    y = (tab[:, 0] + 0.3 * bag[:, 0, 0] > 0).astype(np.int32)
    data = {"tensors": (tab, bag), "y_disc": y, "censorship": np.zeros(n, np.float32),
            "event_time": np.ones(n, np.float32)}
    kw = dict(err_penalty=1.0, state_change_penalty=0.5)
    jmodel = jb.MultiModNModule(16, (jb.MLPEncoder(16, (8,)), jb.PatchEncoder(16, (8,))),
                                (jb.ClassDecoder(2), jb.MLPDecoder((4,), n_classes=2)), **kw)
    params = _init(jmodel, [jnp.asarray(tab[:2]), jnp.asarray(bag[:2])], jnp.zeros((2, 2)))
    port = tb.MultiModNModule(16, (tb.MLPEncoder(16, (8,), input_shape=(6,)),
                                   tb.PatchEncoder(16, (8,), input_shape=(5, 4))),
                              (tb.ClassDecoder(2, state_size=16),
                               tb.MLPDecoder((4,), n_classes=2, state_size=16)), **kw, **CPU)
    port.load_state_dict(state_dict_from_flax(params))
    jtr = JaxMultiModNTrainer(jmodel, n_classes=2, lr=5e-3, batch_size=8)
    jtr.params = jax.tree_util.tree_map(jnp.asarray, params)
    ttr = MultiModNTrainer(port, n_classes=2, lr=5e-3, batch_size=8, device="cpu")
    jh, th = JaxHistory(), tb.MultiModNHistory()
    want, got = jtr.fit(data, data, epochs=2, history=jh), ttr.fit(data, data, epochs=2,
                                                                   history=th)
    for w_split, g_split in zip(want, got):
        assert set(g_split) == set(w_split)
        for key, w in w_split.items():
            assert g_split[key].shape == np.shape(w), key
            np.testing.assert_allclose(g_split[key], w, rtol=1e-5, atol=1e-6, err_msg=key)
    assert want[1]["loss"].shape == (3, 2)
    np.testing.assert_array_equal(ttr.predict(data), jtr.predict(data))
    jh.save_csv(tmp_path / "jax.csv")
    th.save_csv(tmp_path / "port.csv")
    jl = (tmp_path / "jax.csv").read_text().splitlines()
    tl = (tmp_path / "port.csv").read_text().splitlines()
    assert tl[0] == jl[0] and len(tl) == len(jl) == 2 * 2 * 3 * 2 + 1
    for a, b in zip(tl[1:], jl[1:]):
        va = [float(v) if v else np.nan for v in a.split(",")]
        vb = [float(v) if v else np.nan for v in b.split(",")]
        np.testing.assert_allclose(va, vb, rtol=1e-5, atol=1e-6)
    table = th.to_dataframe()
    assert table.columns == ["epoch", "encoder", "decoder", "train_loss", "train_accuracy",
                             "val_loss", "val_accuracy"]
    assert table["epoch"].dtype == np.int64 and np.isnan(table["val_loss"][0])


@pytest.mark.parametrize("n_classes", [2, 3])
def test_stage_metrics_and_binary_rates_match_jax(rng, n_classes):
    """The metric matrices of 3 stages x 2 decoders (confusion counts for
    two classes only) and the rates from them."""
    from healnet_tpu.train.multimodn_trainer import _stage_metrics as jmetrics
    from healnet_tpu.train.multimodn_trainer import compute_binary_rates as jrates
    from healnet_tpu_torch.train.multimodn_trainer import _stage_metrics, compute_binary_rates

    stages = [[rng.normal(size=(6, n_classes)).astype(np.float32) for _ in range(2)]
              for _ in range(3)]
    y = np.array([0, 1, 1, 0, 1, 1])
    targets = np.eye(n_classes, dtype=np.float32)[y]
    mask = np.array([1, 1, 1, 1, 0, 1], np.float32)
    want = jmetrics([[jnp.asarray(s) for s in row] for row in stages], jnp.asarray(targets),
                    jnp.asarray(mask))
    got = _stage_metrics([[_t(s) for s in row] for row in stages], _t(targets), _t(mask))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6,
                                   err_msg=key)
    counts = {k: np.asarray(want[k]) for k in ("tp", "tn", "fp", "fn")}
    for key, value in jrates(counts).items():
        np.testing.assert_array_equal(compute_binary_rates(counts)[key], value)


# ------------------------------------------------------------------ pipeline

PIPELINE_FOLDS = [("fcnn", ["omic", "slides"], "false"), ("mcat", ["omic", "slides"], "true"),
                  ("mcat", ["omic"], "false"), ("mcat", ["slides"], "true"),
                  ("mm_prognosis", ["omic", "slides"], "true"),
                  ("motcat", ["omic", "slides"], "true"),
                  ("multimodn", ["omic", "slides"], "true"),
                  ("multimodn", ["omic", "slides"], "false")]
WANT_CLASS = {("mcat", 2): "MCAT", ("mcat", "omic"): "SNN", ("mcat", "slides"): "MILAttentionNet",
              "fcnn": "RegularizedFCNN", "mm_prognosis": "MMPrognosis", "motcat": "MOTCAT",
              "multimodn": "MultiModNModule"}


@pytest.mark.parametrize("model,sources,device_cache", PIPELINE_FOLDS,
                         ids=lambda v: v if isinstance(v, str) else "+".join(v))
def test_pipeline_fold_trains_each_baseline(cohort, capsys, model, sources, device_cache):
    """A fold of one epoch for each model of ``VALID_MODELS``' baselines on
    the CPU (with the arena and fused epochs, or streamed batches): the
    factory's class, finite metrics; ``quantize_arena`` is ignored, as in
    JAX, and MultiModN trains with ``aux_loss``."""
    name = f"b_{model}_{'_'.join(sources)}_{device_cache}"
    config = Config(str(write_config(cohort, name, epochs=1, device_cache=device_cache))).read()
    config["model"], config["sources"] = model, sources
    config["data"]["quantize_arena"] = device_cache == "true"
    if model == "fcnn":
        # its early-fusion vector is as wide as the batch's bag width, and
        # its input layer fixed: one width for every batch (as in JAX)
        config["train_loop"]["bucket_boundaries"] = None
    config["model_params"] = Config(str(cohort / f"{name}_hp.yml")).read()["brca"]
    pipe = Pipeline(config, device="cpu")
    summary = pipe.main()
    trainer = pipe._trainer
    key = (model, 2 if len(sources) == 2 else sources[0]) if model == "mcat" else model
    assert type(trainer.module).__name__ == WANT_CLASS[key]
    assert trainer.aux_loss == (model == "multimodn")
    assert trainer.fused_epochs == pipe._dataset.device_cache == (device_cache == "true")
    if device_cache == "true":
        assert isinstance(trainer._arena, torch.Tensor)  # not quantized
        assert "data.quantize_arena ignored" in capsys.readouterr().out
    res = pipe.fold_results[0]
    for k in ("train_loss", "val_loss", "test_loss"):
        assert np.isfinite(res[k]), k
    assert set(summary) >= {"mean_test_c_index", "best_fold"}


@pytest.mark.parametrize("device_cache", ["true", "false"])
def test_multimodn_spmd_fold_matches_mesh_free(cohort, device_cache):
    """A MultiModN fold with ``spmd: true`` in one process (a mesh of one
    device) keeps the model's own loss: the same losses and c-indices, bit
    for bit, as the fold without a mesh."""
    def run(spmd):
        name = f"mmn_spmd_{spmd}_{device_cache}"
        config = Config(str(write_config(cohort, name, epochs=1,
                                         device_cache=device_cache))).read()
        config["model"], config["spmd"] = "multimodn", spmd
        config["model_params"] = Config(str(cohort / f"{name}_hp.yml")).read()["brca"]
        pipe = Pipeline(config, device="cpu")
        return pipe, pipe.main()

    plain_pipe, plain = run(False)
    pipe, summary = run(True)
    assert pipe._trainer.mesh is not None and pipe._trainer.aux_loss
    for k in ("train_loss", "val_loss", "test_loss"):
        assert pipe.fold_results[0][k] == plain_pipe.fold_results[0][k], k
    for metric in ("mean_train_c_index", "mean_val_c_index", "mean_test_c_index"):
        assert summary[metric] == plain[metric], metric


@pytest.mark.parametrize("cls", ["FCNN", "RegularizedFCNN", "MCAT", "MILAttentionNet", "SNN",
                                 "MMPrognosis", "MOTCAT", "MultiModNModule", "MultiModNTrainer"])
def test_entry_points_need_a_gpu_or_cpu_request(cls):
    """Every baseline model and MultiModN's trainer default to the card and
    raise without one unless ``device="cpu"`` is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    omic, wsi = _inputs(np.random.default_rng(0))
    shapes = [omic.shape[1:], wsi.shape[1:]]
    kw = {"FCNN": dict(hidden_sizes=[8], output_size=4),
          "RegularizedFCNN": dict(output_dim=4)}.get(cls, {})
    if cls in ("MultiModNModule", "MultiModNTrainer"):
        encoders = [tb.MLPEncoder(16, (8,), input_shape=shapes[0])]
        decoders = [tb.ClassDecoder(4, state_size=16)]
        if cls == "MultiModNTrainer":
            module = tb.MultiModNModule(16, encoders, decoders, **CPU)
            build = lambda **d: MultiModNTrainer(module, n_classes=4, **d)  # noqa: E731
        else:
            build = lambda **d: tb.MultiModNModule(16, encoders, decoders, **d)  # noqa: E731
    else:
        build = lambda **d: getattr(tb, cls)(**kw, input_shapes=shapes, **d)  # noqa: E731
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
    build(**CPU)
