"""The port's fused epochs, tensor dropout seeds and device schedule on the
CPU, against the port's stepwise path and the JAX package.

On the CPU a fused epoch runs the captured step's body eagerly from the same
static buffers the card captures, so these tests hold what the graph
replays: the bucket grouping, the one upload a bucket, the step counter,
the seed tables and the per-step outputs. Tolerances: a fused run and a
stepwise run of the port make the same calls in the same order and agree
to 1e-6 (they are bit-equal here); the port against JAX at float32 as
``tests/test_torch_port_fit.py`` holds its fold (losses 1e-5 relative,
c-indices 1e-5, where a swapped pair of ~40 moves one by 2.5e-2); the
schedules to 1e-6 relative, as ``tests/test_torch_port_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from healnet_tpu.models.healnet import HealNetModule as JaxHealNet
from healnet_tpu.train import schedule as jschedule
from healnet_tpu.train.loop import SurvivalTrainer as JaxTrainer
from healnet_tpu_torch.compat.flax_params import state_dict_from_flax
from healnet_tpu_torch.models.healnet import HealNetModule
from healnet_tpu_torch.ops.attention import multihead_attention
from healnet_tpu_torch.ops.flash_attention import (
    FlashAttentionFunction,
    flash_backward_plain,
    flash_cross_attention,
    flash_lse_plain,
)
from healnet_tpu_torch.train import fused as tfused
from healnet_tpu_torch.train import schedule as tschedule
from healnet_tpu_torch.train.checkpoint import Checkpointer
from healnet_tpu_torch.train.loop import SurvivalTrainer

CFG = dict(n_modalities=2, channel_dims=(40, 32), num_spatial_axes=(1, 1), out_dims=4,
           depth=2, l_c=17, l_d=30, x_heads=1, cross_dim_head=15, l_heads=2,
           latent_dim_head=8, self_per_cross_attn=0, num_freq_bands=2, max_freq=2.0)
WIDTH = 12
TRAIN = dict(batch_size=4, epochs=2, l1=1e-4, max_lr=1e-3, gc_compat=16, seed=5,
             early_stopping=False)


def _arena_data(rng, n, width=WIDTH, lengths=None):
    """Arena-indexed survival data: omic vectors, bags of 3-``width``
    patches packed back to back with ``width`` zero rows after them."""
    if lengths is None:
        lengths = rng.integers(3, width + 1, size=n)
    lengths = np.asarray(lengths, np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int32)
    arena = np.concatenate([rng.normal(size=(int(lengths.sum()), 32)),
                            np.zeros((width, 32))]).astype(np.float32)
    data = {
        "tensors": (rng.normal(size=(n, 1, 40)).astype(np.float32),),
        "kv_masks": (None, np.arange(width)[None, :] < lengths[:, None]),
        "patch_offsets": offsets, "patch_lengths": lengths,
        "y_disc": rng.integers(0, 4, size=n),
        "censorship": (rng.uniform(size=n) < 0.4).astype(np.float32),
        "event_time": rng.uniform(1, 100, size=n).astype(np.float32),
    }
    return data, arena


def _module(dropout=True, state=None):
    rates = dict(attn_dropout=0.2, ff_dropout=0.3) if dropout else {}
    module = HealNetModule(**CFG, **rates, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    if state is not None:
        module.load_state_dict(state)
    return module


def _trainer(arena, fused, dropout=True, **kw):
    return SurvivalTrainer(_module(dropout), **{**TRAIN, **kw}, device="cpu",
                           feature_arena=arena, fused_epochs=fused)


def _same_weights(a, b, rtol=1e-6, atol=0.0):
    for (name, x), y in zip(a.module.named_parameters(), b.module.parameters()):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


class BucketedSource:
    """A streaming arena source whose batches come in two bucket widths
    (bags of at most 6 and of at most WIDTH patches), shuffled across
    buckets, each batch padded to its bucket's width."""

    def __init__(self, data, widths=(6, WIDTH)):
        self.data, self.widths = data, widths
        self.lengths = data["patch_lengths"]

    def __len__(self):
        return len(self.lengths)

    def _buckets(self, idx, batch_size):
        out = []
        for lo, hi in zip((0,) + self.widths[:-1], self.widths):
            sel = [i for i in idx if lo < self.lengths[i] <= hi]
            out += [(hi, sel[s:s + batch_size]) for s in range(0, len(sel), batch_size)]
        return out

    def count_batches(self, indices, batch_size, boundaries):
        return len(self._buckets(np.arange(len(self)), batch_size))

    def iter_batches(self, batch_size, shuffle=False, rng=None, bucket_boundaries=None):
        idx = np.arange(len(self))
        if shuffle:
            rng.shuffle(idx)
        groups = self._buckets(list(idx), batch_size)
        order = rng.permutation(len(groups)) if shuffle else range(len(groups))
        for g in order:
            width, sel = groups[g]
            pad = batch_size - len(sel)
            mask = np.ones(batch_size, np.float32)
            mask[batch_size - pad:] = 0.0
            sel = np.asarray(sel + [sel[-1]] * pad)
            d = self.data
            yield {"tensors": (d["tensors"][0][sel],),
                   "kv_masks": (None, d["kv_masks"][1][sel][:, :width]),
                   "patch_offsets": d["patch_offsets"][sel],
                   "patch_lengths": d["patch_lengths"][sel],
                   "y_disc": d["y_disc"][sel].astype(np.int32),
                   "censorship": d["censorship"][sel], "event_time": d["event_time"][sel],
                   "sample_mask": mask}


# ------------------------------------------------------- tensor seeds


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_plain_flash_path_tensor_seed_bit_equal_to_int(rng, rate):
    """The plain flash path (CPU forward, its log-sum-exp, the backward's
    formulas, and autograd through the function) with a one-element tensor
    seed gives the masks and outputs of the int seed, bit for bit."""
    b, h, lq, lkv, d = 2, 1, 17, 40, 15
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32))
               for n in (lq, lkv, lkv))
    mask = torch.from_numpy(np.arange(lkv)[None] < np.array([[30], [40]]))
    seed = 0xDEADBEEF
    for as_tensor in (torch.tensor(seed, dtype=torch.int64), torch.tensor([seed - 2**32],
                                                                         dtype=torch.int32)):
        kw = dict(scale=d**-0.5, temperature=0.5, kv_mask=mask, dropout_rate=rate)
        want = flash_cross_attention(q, k, v, **kw, dropout_seed=seed)
        assert torch.equal(flash_cross_attention(q, k, v, **kw, dropout_seed=as_tensor), want)
        want_m, _ = multihead_attention(q, k, v, **kw, dropout_seed=seed)
        got_m, _ = multihead_attention(q, k, v, **kw, dropout_seed=as_tensor)
        assert torch.equal(got_m, want_m)
        eff = d**-0.5 / 0.5
        lse = flash_lse_plain(q, k, mask, eff)
        do = torch.from_numpy(rng.normal(size=(b, h, lq, d)).astype(np.float32))
        delta = torch.ones((b, h, lq))
        for x, y in zip(flash_backward_plain(q, k, v, mask, do, lse, delta, eff, rate, seed),
                        flash_backward_plain(q, k, v, mask, do, lse, delta, eff, rate,
                                             as_tensor)):
            assert torch.equal(x, y)
        grads = []
        for s in (seed, as_tensor):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            FlashAttentionFunction.apply(*leaves, mask, eff, rate, s).sum().backward()
            grads.append([t.grad for t in leaves])
        assert all(torch.equal(x, y) for x, y in zip(*grads))


def test_module_seed_table_equals_drawn_seeds(rng):
    """``forward(seeds=...)`` with the row a seed generator would give
    draws the masks the generator path draws; without a table the draw
    order is unchanged."""
    module = _module().train()
    x = [torch.from_numpy(rng.normal(size=(3, 1, 40)).astype(np.float32)),
         torch.from_numpy(rng.normal(size=(3, WIDTH, 32)).astype(np.float32))]
    calls = module.attention_calls()
    assert calls == CFG["depth"] * CFG["n_modalities"]
    table = torch.randint(0, 2**32, (calls,), generator=torch.Generator().manual_seed(9),
                          dtype=torch.int64)
    drawn = module(x, generator=torch.Generator().manual_seed(1),
                   seed_generator=torch.Generator().manual_seed(9))
    given = module(x, generator=torch.Generator().manual_seed(1), seeds=table)
    assert torch.equal(drawn, given)
    with pytest.raises(ValueError, match="seeds must be"):
        module(x, generator=torch.Generator().manual_seed(1), seeds=table[:-1])


# ------------------------------------------------------------ schedule


@pytest.mark.parametrize("total", [1, 2, 3, 4, 7, 40, 1000])
def test_step_indexed_onecycle_matches_jax(total):
    """The step-indexed schedules (with their short-run floor) at every step
    of the horizon and past it, against JAX's."""
    jlr, jb1 = jschedule.onecycle_lr(8e-3, total), jschedule.onecycle_beta1(total)
    tlr, tb1 = tschedule.onecycle_lr(8e-3, total), tschedule.onecycle_beta1(total)
    steps = list(range(0, max(total, 5) + 3))
    got_lr = tlr(torch.tensor(steps))
    got_b1 = tb1(torch.tensor(steps))
    for i, step in enumerate(steps):
        np.testing.assert_allclose(float(got_lr[i]), float(jlr(step)), rtol=1e-6,
                                   atol=1e-6 * 8e-3, err_msg=f"lr {total} {step}")
        np.testing.assert_allclose(float(got_b1[i]), float(jb1(step)), rtol=1e-6,
                                   err_msg=f"beta1 {total} {step}")
        np.testing.assert_allclose(float(tlr(step)), float(got_lr[i]), rtol=0)


@pytest.mark.parametrize("horizon", [1.0, 3.0, 10.0, 57.0])
def test_device_schedule_equals_host_float_path(horizon):
    """lr and beta1 from a device step count and a device horizon
    (``progress_schedule``, what a captured step computes) equal the host
    path's (the count and horizon as Python floats) at every step."""
    floor = 5.0
    for count in range(0, int(horizon) + 4):
        lr, b1 = tschedule.progress_schedule(torch.tensor(float(count)), torch.tensor(horizon),
                                             8e-3)
        frac = count / max(horizon, floor)
        assert float(lr) == float(tschedule.onecycle_lr_at(frac, 8e-3))
        assert float(b1) == float(tschedule.onecycle_beta1_at(frac))
        lr_f, b1_f = tschedule.progress_schedule(torch.tensor(float(count)), horizon, 8e-3)
        assert float(lr_f) == float(lr) and float(b1_f) == float(b1)


def test_adam_matches_torch_adam_and_loads_its_state(rng):
    """The port's Adam against ``torch.optim.Adam`` under the same lr and
    beta1 (1e-6 relative), and a ``torch.optim.Adam`` state dict loaded
    into it (and its own back into ``torch.optim.Adam``) continues the same
    trajectory."""
    w0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=(5, 7)).astype(np.float32) * s for s in (1, 0.1, 3, 1e-3, 1, 2)]
    ours = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    theirs = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = tschedule.make_optimizer([ours])
    ref = torch.optim.Adam([theirs], lr=0.0, betas=(0.95, 0.999), eps=1e-8)
    for i, g in enumerate(grads):
        tschedule.progress_hyperparams(opt, 10.0, 8e-3)
        for group in ref.param_groups:
            group["lr"], group["betas"] = float(opt.lr), (float(opt.beta1), 0.999)
        ours.grad, theirs.grad = torch.from_numpy(g), torch.from_numpy(g.copy())
        opt.step()
        ref.step()
        np.testing.assert_allclose(ours.detach().numpy(), theirs.detach().numpy(), rtol=1e-6,
                                   atol=1e-7)
        if i == 2:  # swap states through each other's state dicts
            loaded = tschedule.make_optimizer([ours])
            loaded.load_state_dict(ref.state_dict())
            assert tschedule.optimizer_step_count(loaded) == 3
            assert torch.equal(loaded.state[ours]["exp_avg"], ref.state[theirs]["exp_avg"])
            ref = torch.optim.Adam([theirs], lr=0.0, betas=(0.95, 0.999), eps=1e-8)
            ref.load_state_dict(opt.state_dict())
            opt = loaded


# ---------------------------------------------------------- fused epochs


def test_fused_matches_stepwise_one_bucket_with_dropout(rng):
    """One bucket, attention and FF dropout on: the fused fold visits the
    batches in the stepwise order and draws the same seeds and masks, so
    the losses, c-indices and weights agree (1e-6; they are bit-equal)."""
    data, arena = _arena_data(rng, 18)
    got_tr, ref_tr = _trainer(arena, True), _trainer(arena, False)
    assert got_tr.fused_epochs and not ref_tr.fused_epochs
    got, ref = got_tr.fit(data, data, verbose=False), ref_tr.fit(data, data, verbose=False)
    for g, r in zip(got["history"], ref["history"]):
        for key in ("train_loss", "train_c_index", "val_loss", "val_c_index"):
            np.testing.assert_allclose(g[key], r[key], rtol=1e-6, err_msg=key)
    _same_weights(got_tr, ref_tr)
    assert tschedule.optimizer_step_count(got_tr.optimizer) == 2 * 5


def test_fused_buckets_run_contiguously(rng, monkeypatch):
    """Several bucket widths: each epoch's batches are regrouped by width in
    order of first appearance, each bucket's batches keeping their order,
    one upload a bucket, and every batch is one optimizer step."""
    data, arena = _arena_data(rng, 22)
    source = BucketedSource(data)
    uploads = []
    upload = tfused.StepTable.upload

    def recording(table, batches):
        uploads.append([int(b["kv_masks"][-1].shape[1]) for b in batches])
        return upload(table, batches)

    monkeypatch.setattr(tfused.StepTable, "upload", recording)
    trainer = _trainer(arena, True, epochs=1)
    trainer.fit(source, data, verbose=False)
    epoch = list(source.iter_batches(4, True, np.random.default_rng(TRAIN["seed"] + 1 + 977)))
    widths = [b["kv_masks"][-1].shape[1] for b in epoch]
    first_seen = list(dict.fromkeys(widths))
    assert len(first_seen) == 2
    # the train epoch's uploads, then the validation split's (one width)
    assert uploads[:2] == [[w] * widths.count(w) for w in first_seen]
    assert tschedule.optimizer_step_count(trainer.optimizer) == len(epoch)
    assert trainer._steps_per_epoch(source) == len(epoch)
    train_tables = [t for key, t in trainer._tables.items() if key[0] == "train"]
    assert sorted(t.table.shape[0] for t in train_tables) == [8, 8]


def test_fused_bucket_pads_to_the_quantum(rng):
    """A bucket of 3 steps: its table holds 8 slots, 3 run, the optimizer
    advances by 3, and the outputs are those of the stepwise steps."""
    data, arena = _arena_data(rng, 12)
    got_tr, ref_tr = _trainer(arena, True, epochs=1), _trainer(arena, False, epochs=1)
    got, ref = got_tr.fit(data, data, verbose=False), ref_tr.fit(data, data, verbose=False)
    (table,) = [t for key, t in got_tr._tables.items() if key[0] == "train"]
    assert table.steps == tfused.SCAN_QUANTUM == 8 and int(table.counter) == 3
    assert tschedule.optimizer_step_count(got_tr.optimizer) == 3
    assert torch.count_nonzero(table.out[3:]) == 0
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"], rtol=1e-6)
    _same_weights(got_tr, ref_tr)
    assert tfused.padded_steps(1) == tfused.padded_steps(8) == 8
    assert tfused.padded_steps(9) == 16


@pytest.mark.parametrize("loss_type", ["nll", "cox"])
def test_fused_evaluate_matches_stepwise(rng, loss_type):
    """Fused evaluation (one upload and one pass a bucket) against the
    stepwise one on the same weights; ablations stay stepwise, as in JAX."""
    data, arena = _arena_data(rng, 15)
    fused = _trainer(arena, True, loss_type=loss_type, gc_compat=1)
    step = _trainer(arena, False, loss_type=loss_type, gc_compat=1)
    got, ref = fused.evaluate(data), step.evaluate(data)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert any(key[0] == "eval" for key in fused._tables)
    n_tables = len(fused._tables)
    np.testing.assert_allclose(fused.evaluate(data, missing_mode="wsi"),
                               step.evaluate(data, missing_mode="wsi"), rtol=1e-6)
    assert len(fused._tables) == n_tables


def test_fused_epochs_without_an_arena_are_ignored(rng):
    """As in JAX: ``fused_epochs`` acts only with a feature arena."""
    data, _ = _arena_data(rng, 10)
    dense = {"tensors": (data["tensors"][0],
                         rng.normal(size=(10, WIDTH, 32)).astype(np.float32)),
             **{k: data[k] for k in ("y_disc", "censorship", "event_time")}}
    got_tr, ref_tr = _trainer(None, True), _trainer(None, False)
    assert not got_tr.fused_epochs
    got, ref = got_tr.fit(dense, dense, verbose=False), ref_tr.fit(dense, dense, verbose=False)
    assert got["train_loss"] == ref["train_loss"] and not got_tr._tables
    _same_weights(got_tr, ref_tr, rtol=0)


class _Crash(RuntimeError):
    pass


def test_fused_fold_resumes_from_a_checkpoint(rng, tmp_path):
    """A fused fold that dies in epoch 3 and resumes from epoch 2's
    checkpoint ends where an uninterrupted fused fold ends; a stepwise
    fold's checkpoint resumes on the fused path too (one bucket: the same
    order, so the same weights as the stepwise fold)."""
    data, arena = _arena_data(rng, 14)

    class CrashAt3:
        def log(self, metrics, step=None):
            if step == 3:
                raise _Crash

        def watch(self, **kw):
            pass

    def run(name, fused, **kw):
        return _trainer(arena, fused, epochs=3, checkpoint_dir=tmp_path / name, **kw)

    whole = run("whole", True)
    ref = whole.fit(data, data, verbose=False)
    with pytest.raises(_Crash):
        run("crashed", True, tracker=CrashAt3()).fit(data, data, verbose=False)
    assert Checkpointer(tmp_path / "crashed").latest_step() == 2
    resumed = run("crashed", True, resume=True)
    got = resumed.fit(data, data, verbose=False)
    assert [h["epoch"] for h in got["history"]] == [3]
    for key in ("train_loss", "train_c_index", "val_loss", "val_c_index"):
        assert got["history"][0][key] == ref["history"][-1][key], key
    _same_weights(resumed, whole, rtol=0)

    with pytest.raises(_Crash):
        run("stepwise", False, tracker=CrashAt3()).fit(data, data, verbose=False)
    across = run("stepwise", True, resume=True)
    across.fit(data, data, verbose=False)
    stepwise = run("stepwise_whole", False)
    stepwise.fit(data, data, verbose=False)
    _same_weights(across, stepwise)
    assert tschedule.optimizer_step_count(across.optimizer) == 3 * 4


def test_set_fold_drops_the_captured_steps(rng):
    """A new fold's optimizer state is new: the tables stay, their graphs
    go (the next epoch captures anew), and the fold trains as a fresh
    trainer would."""
    data, arena = _arena_data(rng, 9)
    trainer = _trainer(arena, True, epochs=1)
    trainer.fit(data, data, verbose=False)
    for table in trainer._tables.values():
        table.graph = object()  # what a capture on the card leaves
    trainer.set_fold(seed=11)
    assert trainer._tables and all(t.graph is None for t in trainer._tables.values())
    got = trainer.fit(data, data, verbose=False)
    fresh = SurvivalTrainer(_module(), **{**TRAIN, "epochs": 1, "seed": 11}, device="cpu",
                            feature_arena=arena, fused_epochs=True)
    fresh.module.reset_parameters(torch.Generator().manual_seed(11))
    assert got["train_loss"] == fresh.fit(data, data, verbose=False)["train_loss"]


def test_fused_fit_matches_jax_fused_epochs(rng):
    """Port fused against JAX ``fused_epochs=True``, one bucket, dropout 0,
    the same initial weights (``compat.flax_params``): train loss and
    c-index and val c-index of every epoch."""
    data, arena = _arena_data(rng, 16)
    jmod = JaxHealNet(**CFG, projection_impl="xla")
    example = (jnp.asarray(data["tensors"][0][:2]), jnp.zeros((2, WIDTH, 32)))
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0), example)["params"])
    kw = dict(TRAIN, feature_arena=(arena, data["patch_offsets"], data["patch_lengths"]),
              fused_epochs=True, prefetch=0)
    jtr = JaxTrainer(jmod, **kw)
    jtr.params = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jtr.fit(data, data, verbose=False)
    ttr = SurvivalTrainer(_module(False, state_dict_from_flax(params)), **kw, device="cpu")
    got = ttr.fit(data, data, verbose=False)
    assert len(got["history"]) == len(ref["history"]) == 2
    for g, r in zip(got["history"], ref["history"]):
        np.testing.assert_allclose(g["train_loss"], r["train_loss"], rtol=1e-5)
        np.testing.assert_allclose(g["val_loss"], r["val_loss"], rtol=1e-5)
        for key in ("train_c_index", "val_c_index"):
            np.testing.assert_allclose(g[key], r[key], rtol=0, atol=1e-5, err_msg=key)
