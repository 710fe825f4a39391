"""PyTorch port of the training step against the JAX package on CPU.

The same numpy inputs and the same Flax weights (converted by
``compat.flax_params``) go through both packages, with dropout off unless a
test says otherwise. Tolerances: model parameter gradients at float32 to
1e-4 relative / 1e-6 absolute (sums of many products in another order);
losses and schedules to float32 rounding (1e-6); the 3-step trajectory as
stated in its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from healnet_tpu.models.healnet import HealNetModule as JaxHealNet
from healnet_tpu.train import losses as jlosses
from healnet_tpu.train import schedule as jschedule
from healnet_tpu.train.loop import SurvivalTrainer as JaxTrainer
from healnet_tpu.train.loop import iterate_batches as jax_iterate_batches
from healnet_tpu.utils import train_utils as jutils
from healnet_tpu_torch.compat.flax_params import state_dict_from_flax
from healnet_tpu_torch.models.healnet import HealNetModule as TorchHealNet
from healnet_tpu_torch.train import losses as tlosses
from healnet_tpu_torch.train import schedule as tschedule
from healnet_tpu_torch.train.loop import SurvivalTrainer, iterate_batches
from healnet_tpu_torch.utils import train_utils as tutils

# topologies of bench.py's rows, channels and tokens cut down
TOPOLOGIES = {
    "brca": dict(depth=2, l_c=17, l_d=126, x_heads=1, cross_dim_head=63, l_heads=8,
                 latent_dim_head=20, self_per_cross_attn=0),
    "kirp": dict(depth=5, l_c=17, l_d=62, x_heads=1, cross_dim_head=27, l_heads=8,
                 latent_dim_head=113, self_per_cross_attn=0),
    "tied": dict(depth=3, l_c=9, l_d=16, x_heads=2, cross_dim_head=6, l_heads=2,
                 latent_dim_head=4, self_per_cross_attn=1, weight_tie_layers=True, snn=False),
    "trimodal": dict(depth=2, l_c=17, l_d=126, x_heads=1, cross_dim_head=63, l_heads=8,
                     latent_dim_head=20, self_per_cross_attn=0, n_modalities=3,
                     channel_dims=(40, 32, 24), num_spatial_axes=(1, 1, 1)),
}
COMMON = dict(n_modalities=2, channel_dims=(40, 32), num_spatial_axes=(1, 1), out_dims=4,
              num_freq_bands=2, max_freq=2.0)
B, TOKENS = 4, 24


def _inputs(rng, b=B, n=2):
    """The omic vector and the WSI bag; a third modality (16 x 24) for n=3."""
    x = [rng.normal(size=(b, 1, 40)).astype(np.float32),
         rng.normal(size=(b, TOKENS, 32)).astype(np.float32)]
    if n == 3:
        x.append(rng.normal(size=(b, 16, 24)).astype(np.float32))
    return x


def _pair(rng, topo, **kw):
    cfg = {**COMMON, **TOPOLOGIES[topo], **kw}
    jmod = JaxHealNet(**cfg, projection_impl="xla")
    x = _inputs(rng, n=cfg["n_modalities"])
    params = jmod.init(jax.random.PRNGKey(0), tuple(map(jnp.asarray, x)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tmod = TorchHealNet(**cfg, device="cpu")
    tmod.load_state_dict(state_dict_from_flax(params))
    return jmod, params, tmod


def _batch(rng, b=B, pad=0):
    mask = np.ones(b, np.float32)
    mask[b - pad:] = 0.0
    return {
        "tensors": tuple(_inputs(rng, b)),
        "y_disc": rng.integers(0, 4, size=b).astype(np.int32),
        "censorship": np.array([0, 1] * (b // 2), np.float32),
        "event_time": rng.uniform(1, 100, size=b).astype(np.float32),
        "sample_mask": mask,
    }


# ------------------------------------------------------------ model grads


@pytest.mark.parametrize("gated", [False, True], ids=["plain", "presence_and_masks"])
@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_model_param_grads_match_jax(rng, topo, gated):
    jmod, params, tmod = _pair(rng, topo)
    n = tmod.n_modalities
    x = _inputs(rng, n=n)
    weight = rng.normal(size=(B, 4)).astype(np.float32)
    presence = mask = None
    if gated:
        presence = np.ones((B, n), np.float32)
        presence[1, 1] = presence[2, 0] = 0.0
        mask = rng.uniform(size=(B, TOKENS)) > 0.3
        mask[3] = False  # a sample whose whole bag is masked
    masks = None if mask is None else (None, mask) + (None,) * (n - 2)

    def jloss(p):
        logits = jmod.apply(
            {"params": p}, tuple(map(jnp.asarray, x)),
            presence=None if presence is None else jnp.asarray(presence),
            kv_masks=None if masks is None else tuple(
                None if m is None else jnp.asarray(m) for m in masks),
        )
        return jnp.sum(logits * jnp.asarray(weight))

    ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(params)))
    tmod.train()
    logits = tmod(
        [torch.from_numpy(a) for a in x],
        presence=None if presence is None else torch.from_numpy(presence),
        kv_masks=None if masks is None else [
            None if m is None else torch.from_numpy(m) for m in masks],
    )
    torch.sum(logits * torch.from_numpy(weight)).backward()
    got = dict(tmod.named_parameters())
    assert set(got) == set(ref)
    for name, want in ref.items():
        assert got[name].grad is not None, name
        np.testing.assert_allclose(got[name].grad.numpy(), want.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


# ------------------------------------------------------------------ losses


def _loss_inputs(rng, b=6, bins=4):
    logits = rng.normal(size=(b, bins)).astype(np.float32) * 2
    y = rng.integers(0, bins, size=b).astype(np.int32)
    c = rng.integers(0, 2, size=b).astype(np.float32)
    t = rng.uniform(1, 50, size=b).astype(np.float32)
    sw = np.array([1, 1, 1, 1, 0, 0], np.float32)[:b]
    cw = rng.uniform(0.5, 2.0, size=bins).astype(np.float32)
    return logits, y, c, t, sw, cw


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "sample_and_class_weights"])
def test_losses_match_jax(rng, weighted):
    logits, y, c, t, sw, cw = _loss_inputs(rng)
    if not weighted:
        sw = cw = None
    J = lambda a: None if a is None else jnp.asarray(a)
    T = lambda a: None if a is None else torch.from_numpy(a)
    jh, js, jr = jlosses.hazards_survival_risk(J(logits))
    th, ts, tr = tlosses.hazards_survival_risk(T(logits))
    pairs = {
        "nll": (jlosses.nll_loss(jh, js, J(y), J(c), weights=J(cw), sample_weights=J(sw)),
                tlosses.nll_loss(th, ts, T(y), T(c), weights=T(cw), sample_weights=T(sw))),
        "nll_survival_none": (jlosses.nll_loss(jh, None, J(y), J(c), alpha=0.2),
                              tlosses.nll_loss(th, None, T(y), T(c), alpha=0.2)),
        "nll_from_logits": (jlosses.nll_loss_from_logits(J(logits), J(y), J(c), alpha=0.3),
                            tlosses.nll_loss_from_logits(T(logits), T(y), T(c), alpha=0.3)),
        "nll_from_logits_sum": (
            jlosses.nll_loss_from_logits(J(logits), J(y), J(c), reduction="sum"),
            tlosses.nll_loss_from_logits(T(logits), T(y), T(c), reduction="sum")),
        "ce": (jlosses.ce_loss(jh, js, J(y), J(c), sample_weights=J(sw)),
               tlosses.ce_loss(th, ts, T(y), T(c), sample_weights=T(sw))),
        "ce_class": (jlosses.CrossEntropySurvLoss()(jh, js, J(y), J(c)),
                     tlosses.CrossEntropySurvLoss()(th, ts, T(y), T(c))),
        "cox": (jlosses.cox_ph_loss(jr, J(t), J(c), sample_weights=J(sw)),
                tlosses.cox_ph_loss(tr, T(t), T(c), sample_weights=T(sw))),
        "cox_class": (jlosses.CoxPHSurvLoss()(jh, js, J(c), event_time=J(t), sample_weights=J(sw)),
                      tlosses.CoxPHSurvLoss()(th, ts, T(c), event_time=T(t), sample_weights=T(sw))),
        "cox_class_no_time": (jlosses.CoxPHSurvLoss()(jh, js, J(c)),
                              tlosses.CoxPHSurvLoss()(th, ts, T(c))),
    }
    batch_j = {"y_disc": J(y), "censorship": J(c), "event_time": J(t), "sample_mask": J(sw)}
    batch_t = {"y_disc": T(y), "censorship": T(c), "event_time": T(t), "sample_mask": T(sw)}
    for loss_type in ("nll", "ce_survival", "cox"):
        jl, jrisk = jlosses.survival_loss(J(logits), batch_j, loss_type, class_weights=J(cw))
        tl, trisk = tlosses.survival_loss(T(logits), batch_t, loss_type, class_weights=T(cw))
        pairs[f"survival_loss_{loss_type}"] = (jl, tl)
        np.testing.assert_allclose(trisk.numpy(), np.asarray(jrisk), rtol=1e-6, atol=1e-6)
    for name, (ref, got) in pairs.items():
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6, atol=1e-6, err_msg=name)


def test_loss_gradients_match_jax(rng):
    logits, y, c, t, sw, cw = _loss_inputs(rng)
    batch_j = {"y_disc": jnp.asarray(y), "censorship": jnp.asarray(c),
               "event_time": jnp.asarray(t), "sample_mask": jnp.asarray(sw)}
    batch_t = {k: torch.tensor(np.asarray(v)) for k, v in batch_j.items()}
    for loss_type in ("nll", "ce_survival", "cox"):
        ref = jax.grad(lambda lg: jlosses.survival_loss(
            lg, batch_j, loss_type, class_weights=jnp.asarray(cw))[0])(jnp.asarray(logits))
        tl = torch.from_numpy(logits).requires_grad_()
        tlosses.survival_loss(tl, batch_t, loss_type,
                              class_weights=torch.from_numpy(cw))[0].backward()
        np.testing.assert_allclose(tl.grad.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7,
                                   err_msg=loss_type)


# ---------------------------------------------------------------- schedule

FRACS = [0.0, 0.01, 0.1, 0.29, 0.3, 0.31, 0.5, 0.77, 0.99, 1.0, 1.5, -0.2]


# float32 cos of the two libraries may differ in its last bit; at the end of
# the decay the lr is a difference of two numbers near max_lr, so that bit
# shows as an absolute error of ~1e-7 of max_lr
LR_ATOL = 1e-6 * 8e-3


def test_onecycle_curves_match_jax():
    for pct in (0.3, 0.25):
        for frac in FRACS:
            np.testing.assert_allclose(
                float(tschedule.onecycle_lr_at(frac, 8e-3, pct_start=pct)),
                float(jschedule.onecycle_lr_at(frac, 8e-3, pct_start=pct)),
                rtol=1e-6, atol=LR_ATOL)
            np.testing.assert_allclose(
                float(tschedule.onecycle_beta1_at(frac, pct_start=pct)),
                float(jschedule.onecycle_beta1_at(frac, pct_start=pct)), rtol=1e-6)


@pytest.mark.parametrize("cycle_momentum", [True, False])
def test_progress_hyperparams_match_jax(cycle_momentum):
    jopt = jschedule.make_progress_optimizer(cycle_momentum, flatten=False)
    jstate = jopt.init({"w": jnp.zeros(3)})
    p = torch.nn.Parameter(torch.zeros(3))
    topt = tschedule.make_optimizer([p], cycle_momentum)
    for horizon in (1, 3, 5, 40, 1000):
        for count in (0, 1, 2, 4, 13, 39, 40, 41):
            js = jschedule.progress_hyperparams(
                jstate._replace(count=jnp.asarray(count, jnp.int32)), float(horizon), 8e-3,
                cycle_momentum=cycle_momentum)
            topt.state[p] = {"step": torch.tensor(float(count))} if count else {}
            tschedule.progress_hyperparams(topt, horizon, 8e-3, cycle_momentum=cycle_momentum)
            group = topt.param_groups[0]
            np.testing.assert_allclose(group["lr"], float(js.hyperparams["learning_rate"]),
                                       rtol=1e-6, atol=LR_ATOL, err_msg=f"{horizon} {count}")
            np.testing.assert_allclose(group["betas"][0], float(js.hyperparams["b1"]),
                                       rtol=1e-6, err_msg=f"{horizon} {count}")


def test_torch_adam_equals_optax_adam(rng):
    """optax's Adam under injected lr / b1 (eps outside the sqrt, bias
    correction with the current b1) against torch.optim.Adam, 6 steps with
    the schedule moving both."""
    w0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=(5, 7)).astype(np.float32) * s for s in (1, 0.1, 3, 1e-3, 1, 2)]
    jopt = jschedule.make_progress_optimizer(True, flatten=False)
    jparams = {"w": jnp.asarray(w0)}
    jstate = jopt.init(jparams)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    topt = tschedule.make_optimizer([p], True)
    for g in grads:
        jstate = jschedule.progress_hyperparams(jstate, 10.0, 8e-3)
        upd, jstate = jopt.update({"w": jnp.asarray(g)}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tschedule.progress_hyperparams(topt, 10.0, 8e-3)
        p.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams["w"]),
                                   rtol=1e-6, atol=1e-7)


def test_weight_decay_option():
    p = torch.nn.Parameter(torch.ones(2))
    assert tschedule.make_optimizer([p], weight_decay="None").param_groups[0]["weight_decay"] == 0
    assert tschedule.make_optimizer([p], weight_decay="1e-4").param_groups[0]["weight_decay"] == 1e-4
    assert tschedule.make_optimizer([p], False).param_groups[0]["betas"] == (0.9, 0.999)


# ------------------------------------------------------------ train utils


def test_l1_norm_matches_jax_per_leaf(rng):
    leaves = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": np.zeros(5, np.float32),  # zero-initialised biases
              "c": rng.normal(size=(7,)).astype(np.float32)}
    ref_value = float(jutils.l1_norm(leaves, flat=False))
    ref_grad = jax.grad(lambda p: jutils.l1_norm(p, flat=False))(leaves)
    for flat in (True, False):
        params = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in leaves.items()}
        value = tutils.l1_norm(params, flat=flat)
        np.testing.assert_allclose(float(value.detach()), ref_value, rtol=1e-6)
        value.backward()
        for k in leaves:  # d|x|/dx at 0 is +1 in JAX, and in the port
            np.testing.assert_array_equal(params[k].grad.numpy(), np.asarray(ref_grad[k]))
    # mixed dtypes: the flat sum is promoted, never narrowed
    mixed = [torch.full((3,), 0.1, dtype=torch.float64), torch.ones(2)]
    assert tutils.l1_norm(mixed).dtype == torch.float64
    np.testing.assert_allclose(float(tutils.l1_norm(mixed)), 2.3, rtol=1e-12)
    assert tutils.count_parameters(params) == jutils.count_parameters(leaves) == 24
    assert float(tutils.calc_reg_loss(params, 0.5, "fcnn")) == 0.0
    assert float(tutils.calc_reg_loss(params, 0.5, "mcat", ["omic"])) == 0.0
    np.testing.assert_allclose(float(tutils.calc_reg_loss(params, 0.5, "healnet")),
                               0.5 * ref_value, rtol=1e-6)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_early_stopping_matches_jax(mode):
    metrics = [3.0, 2.0, 2.5, 1.0, 1.5, 1.2, 1.1, 4.0]
    jstop, tstop = jutils.EarlyStopping(patience=3, mode=mode), tutils.EarlyStopping(3, mode=mode)
    w = torch.zeros(2)
    for i, m in enumerate(metrics):
        w += 1.0
        js = jstop.step(m, {"w": jnp.asarray(w.numpy())})
        ts = tstop.step(m, {"w": w})
        assert (js, jstop.counter, jstop.best_metric) == (ts, tstop.counter, tstop.best_metric)
        best_step = float(np.asarray(jstop.best_params["w"])[0])
        assert float(tstop.load_best_weights()["w"][0]) == best_step  # a copy, not w itself
    assert tutils.EarlyStopping().load_best_weights("fallback") == "fallback"


# ------------------------------------------------------------- trainer


def test_iterate_batches_matches_jax(rng):
    data = {
        "tensors": tuple(_inputs(rng, 7)),
        "y_disc": rng.integers(0, 4, size=7), "censorship": rng.integers(0, 2, size=7),
        "event_time": rng.uniform(size=7), "presence": np.ones((7, 2)),
        "kv_masks": (None, rng.uniform(size=(7, TOKENS)) > 0.5),
    }
    for shuffle in (False, True):
        ref = list(jax_iterate_batches(data, 3, shuffle, np.random.default_rng(5)))
        got = list(iterate_batches(data, 3, shuffle, np.random.default_rng(5)))
        assert len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            assert set(g) == set(r)
            for key in ("y_disc", "censorship", "event_time", "sample_mask", "presence"):
                np.testing.assert_array_equal(g[key], r[key])
                assert g[key].dtype == r[key].dtype
            for a, b in zip(g["tensors"] + g["kv_masks"][1:], r["tensors"] + r["kv_masks"][1:]):
                np.testing.assert_array_equal(a, b)


def test_three_step_trajectory_matches_jax_trainer(rng):
    """Three train steps of the port's trainer against the JAX trainer's
    compiled step, from the same weights, dropout off, NLL/16 + L1, with a
    padded batch row and class weights.

    Tolerance: Adam divides each gradient by its own magnitude, so a
    gradient at the level of float32 noise could flip an update's sign.
    max_lr 1e-3 (steps of ~4e-5) and an L1 term (whose gradient, 1e-4 per
    element, outweighs the noise) keep every update well defined; the
    parameters then agree to 1e-6 relative / 1e-7 absolute.
    """
    jmod, params, tmod = _pair(rng, "brca")
    kw = dict(l1=1e-4, max_lr=1e-3, gc_compat=16, class_weights=np.array([1, 2, 1, 3], np.float32))
    jtr = JaxTrainer(jmod, **kw)
    jtr._build_steps()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jtr._opt.init(jparams)
    ttr = SurvivalTrainer(tmod, **kw, device="cpu")
    batches = [_batch(rng, pad=p) for p in (0, 1, 0)]
    for step, batch in enumerate(batches):
        jb = jax.tree_util.tree_map(jnp.asarray, batch)
        jparams, jstate, jloss, jrisk, jstats = jtr._train_step(
            jparams, jstate, jb, jax.random.PRNGKey(step), None, jtr.class_weights,
            jnp.float32(50.0))
        tloss, trisk, tstats = ttr.train_step(batch, horizon=50)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
        np.testing.assert_allclose(trisk.numpy(), np.asarray(jrisk), rtol=1e-5, atol=1e-6)
        assert set(tstats) == set(jstats)
        for k in jstats:
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), rtol=1e-4, err_msg=k)
        ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
        for name, p in tmod.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {step + 1} {name}")
    loss, risk, logits = ttr.eval_step(batches[0])
    jl, jr, jlg = jtr._eval_step(jparams, jax.tree_util.tree_map(jnp.asarray, batches[0]),
                                 None, jtr.class_weights)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlg), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)


def _dropout_trainer(seed, accum_steps=1, rates=(0.3, 0.4)):
    cfg = {**COMMON, **TOPOLOGIES["tied"]}
    module = TorchHealNet(**cfg, attn_dropout=rates[0], ff_dropout=rates[1],
                          attention_impl="flash", device="cpu",
                          generator=torch.Generator().manual_seed(0))
    return SurvivalTrainer(module, l1=1e-5, seed=seed, accum_steps=accum_steps, device="cpu")


def test_dropout_step_is_deterministic_per_seed():
    batch = _batch(np.random.default_rng(3))
    runs = []
    for seed in (11, 11, 12):
        trainer = _dropout_trainer(seed)
        losses = [float(trainer.train_step(batch, horizon=10)[0]) for _ in range(2)]
        runs.append((losses, [p.detach().clone() for p in trainer.module.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert runs[0][0] != runs[2][0]  # another seed draws other masks
    eval_trainer = _dropout_trainer(11)
    first, second = eval_trainer.eval_step(batch), eval_trainer.eval_step(batch)
    assert torch.equal(first[2], second[2])  # no dropout in evaluation


def test_model_dropout_from_one_generator():
    """One CPU generator draws both the FF masks and the attention seeds."""
    module = _dropout_trainer(0).module.train()
    x = [torch.from_numpy(a) for a in _inputs(np.random.default_rng(6))]
    draw = lambda seed: module(x, generator=torch.Generator().manual_seed(seed))
    assert torch.equal(draw(3), draw(3))
    assert not torch.equal(draw(3), draw(4))
    with pytest.raises(ValueError, match="generator"):
        module(x)
    assert torch.equal(module.eval()(x), module(x))  # evaluation draws nothing


def test_accum_steps_average_micro_batch_gradients():
    batch = _batch(np.random.default_rng(4))
    trainers = [_dropout_trainer(0, a, rates=(0.0, 0.0)) for a in (1, 2)]
    out = [t.train_step(batch, horizon=10) for t in trainers]
    np.testing.assert_allclose(float(out[0][0]), float(out[1][0]), rtol=1e-6)
    torch.testing.assert_close(out[0][1], out[1][1])
    for (name, a), (_, b) in zip(trainers[0].module.named_parameters(),
                                 trainers[1].module.named_parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-7, msg=name)
