"""The port's fold loop (``SurvivalTrainer.fit`` / ``evaluate`` / ``set_fold``),
checkpoints, the c-index, the prefetcher and serving from a checkpoint
directory, against the JAX package on the CPU.

The same numpy splits and the same initial Flax weights (converted by
``compat.flax_params``) go through both trainers with dropout off. Losses
agree at float32 to 1e-5 relative, c-indices to 1e-6 (a swapped pair moves
one of ~40 pairs by 2.5e-2, so they agree exactly or not at all), final
weights to 1e-5 relative / 1e-7 absolute (Adam on small steps with an L1
term, as ``tests/test_torch_port_train.py`` holds its trajectory). A resumed
run is bit-equal to an uninterrupted one.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from healnet_tpu.models.healnet import HealNetModule as JaxHealNet
from healnet_tpu.runtime import concordance_index_native as jax_cindex
from healnet_tpu.train.loop import SurvivalTrainer as JaxTrainer
from healnet_tpu.train.loop import iterate_batches as jax_iterate_batches
from healnet_tpu_torch.compat.flax_params import state_dict_from_flax
from healnet_tpu_torch.etl.prefetch import BackgroundIterator, DevicePrefetcher
from healnet_tpu_torch.models.healnet import HealNetModule
from healnet_tpu_torch.parallel.mesh import make_mesh
from healnet_tpu_torch.serving import Predictor
from healnet_tpu_torch.train import loop as tloop
from healnet_tpu_torch.train import metrics as tmetrics
from healnet_tpu_torch.train.checkpoint import Checkpointer
from healnet_tpu_torch.train.loop import SurvivalTrainer, iterate_batches

CFG = dict(n_modalities=2, channel_dims=(40, 32), num_spatial_axes=(1, 1), out_dims=4,
           depth=2, l_c=17, l_d=30, x_heads=1, cross_dim_head=15, l_heads=2,
           latent_dim_head=8, self_per_cross_attn=0, num_freq_bands=2, max_freq=2.0)
TOKENS = 12
TRAIN = dict(batch_size=4, epochs=3, l1=1e-4, max_lr=1e-3, gc_compat=16, seed=5, patience=2)


def _split(rng, n):
    return {
        "tensors": (rng.normal(size=(n, 1, 40)).astype(np.float32),
                    rng.normal(size=(n, TOKENS, 32)).astype(np.float32)),
        "y_disc": rng.integers(0, 4, size=n),
        "censorship": (rng.uniform(size=n) < 0.4).astype(np.float32),
        "event_time": rng.uniform(1, 100, size=n).astype(np.float32),
    }


def _splits(rng):
    return _split(rng, 10), _split(rng, 7), _split(rng, 6)


def _jax_params(rng):
    jmod = JaxHealNet(**CFG, projection_impl="xla")
    x = _split(rng, 2)["tensors"]
    params = jmod.init(jax.random.PRNGKey(0), tuple(map(jnp.asarray, x)))["params"]
    return jmod, jax.tree_util.tree_map(np.asarray, params)


def _port_module(state=None, **kw):
    module = HealNetModule(**CFG, device="cpu", generator=torch.Generator().manual_seed(0), **kw)
    if state is not None:
        module.load_state_dict(state)
    return module


def _dropout_trainer(tmp_path, name, **kw):
    module = _port_module(attn_dropout=0.2, ff_dropout=0.3)
    return SurvivalTrainer(module, **{**TRAIN, "early_stopping": False, **kw}, device="cpu",
                           checkpoint_dir=tmp_path / name)


# ------------------------------------------------------- fit against JAX


@pytest.mark.parametrize("prefetch", [0, 2])
def test_fit_matches_jax(rng, prefetch):
    train, val, test = _splits(rng)
    jmod, params = _jax_params(rng)
    jtr = JaxTrainer(jmod, **TRAIN, prefetch=prefetch)
    jtr.params = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jtr.fit(train, val, test_data=test, verbose=False)
    ttr = SurvivalTrainer(_port_module(state_dict_from_flax(params)), **TRAIN,
                          prefetch=prefetch, device="cpu")
    got = ttr.fit(train, val, test_data=test, verbose=False)
    assert got["stopped_epoch"] == ref["stopped_epoch"]
    assert len(got["history"]) == len(ref["history"]) == 3
    for g, r in zip(got["history"], ref["history"]):
        assert g["epoch"] == r["epoch"]
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(g[key], r[key], rtol=1e-5, err_msg=key)
        for key in ("train_c_index", "val_c_index"):
            np.testing.assert_allclose(g[key], r[key], rtol=0, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(got["test_loss"], ref["test_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["test_c_index"], ref["test_c_index"], atol=1e-6)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, ref["params"]))
    for name, p in ttr.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("semantics", ["semantic", "reference"])
@pytest.mark.parametrize("mode", [None, "50", "omic", "wsi"])
def test_evaluate_matches_jax(rng, mode, semantics):
    """Every ablation under both semantics: "wsi" under "reference" routes
    the omic tensor through modality 0's tower, "omic" finds the WSI tensor
    does not fit it (every presence zero)."""
    _, val, _ = _splits(rng)
    jmod, params = _jax_params(rng)
    jtr = JaxTrainer(jmod, batch_size=3)
    jtr.params = jax.tree_util.tree_map(jnp.asarray, params)
    ttr = SurvivalTrainer(_port_module(state_dict_from_flax(params)), batch_size=3, device="cpu")
    ref = jtr.evaluate(val, missing_mode=mode, missing_semantics=semantics)
    got = ttr.evaluate(val, missing_mode=mode, missing_semantics=semantics)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-6)


def test_evaluate_cox_weights_by_events_as_jax(rng):
    _, val, _ = _splits(rng)
    jmod, params = _jax_params(rng)
    jtr = JaxTrainer(jmod, batch_size=3, loss_type="cox")
    jtr.params = jax.tree_util.tree_map(jnp.asarray, params)
    ttr = SurvivalTrainer(_port_module(state_dict_from_flax(params)), batch_size=3,
                          loss_type="cox", device="cpu")
    np.testing.assert_allclose(ttr.evaluate(val), jtr.evaluate(val), rtol=1e-5, atol=1e-6)


def test_fit_missing_ablation_and_tracker_match_jax(rng):
    """eval_interval 2 (NaN on skipped epochs), the tracker's log calls and
    the test split's ablations, against JAX."""
    train, val, test = _splits(rng)
    jmod, params = _jax_params(rng)

    class Tracker:
        def __init__(self):
            self.logs, self.watched = [], []

        def log(self, metrics, step=None):
            self.logs.append((dict(metrics), step))

        def watch(self, params=None, grad_stats=None, step=None, prefix=""):
            self.watched.append((sorted(grad_stats), step, prefix))

    kw = dict(TRAIN, eval_interval=2, prefetch=0)
    jtrack, ttrack = Tracker(), Tracker()
    jtr = JaxTrainer(jmod, **kw, tracker=jtrack)
    jtr.params = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jtr.fit(train, val, test_data=test, fold=2, missing_ablation=True, verbose=False)
    ttr = SurvivalTrainer(_port_module(state_dict_from_flax(params)), **kw, tracker=ttrack,
                          device="cpu")
    got = ttr.fit(train, val, test_data=test, fold=2, missing_ablation=True, verbose=False)
    assert np.isnan(got["history"][0]["val_loss"]) and np.isnan(ref["history"][0]["val_loss"])
    np.testing.assert_allclose(got["missing_performance"], ref["missing_performance"], atol=1e-6)
    assert len(ttrack.logs) == len(jtrack.logs) == 4
    for (g, gs), (r, rs) in zip(ttrack.logs, jtrack.logs):
        assert set(g) == set(r) and gs == rs
        for key in g:
            np.testing.assert_allclose(g[key], r[key], rtol=1e-5, atol=1e-6, err_msg=key)
    assert [w[1:] for w in ttrack.watched] == [w[1:] for w in jtrack.watched]
    assert all("global" in w[0] for w in ttrack.watched)


def test_iterate_batches_streaming_source_as_jax():
    class Source:
        def __init__(self):
            self.calls = []

        def iter_batches(self, batch_size, shuffle=False, rng=None, **kw):
            self.calls.append((batch_size, shuffle, kw))
            yield {"n": batch_size}

    ours, theirs = Source(), Source()
    for boundaries in (None, (8, 16)):
        assert list(iterate_batches(ours, 4, True, bucket_boundaries=boundaries)) == \
            list(jax_iterate_batches(theirs, 4, True, bucket_boundaries=boundaries))
    assert ours.calls == theirs.calls == [(4, True, {}),
                                          (4, True, {"bucket_boundaries": (8, 16)})]


def test_steps_per_epoch_from_a_streaming_source():
    class Source:
        def __len__(self):
            return 10

        def iter_batches(self, batch_size, shuffle=False, rng=None, **kw):
            return iter(())

        def count_batches(self, indices, batch_size, boundaries):
            return 7 if boundaries else 3

    trainer = SurvivalTrainer(_port_module(), batch_size=4, device="cpu",
                              bucket_boundaries=[8, 16])
    assert trainer._steps_per_epoch(Source()) == 7
    assert SurvivalTrainer(_port_module(), batch_size=4, device="cpu")._steps_per_epoch(
        {"y_disc": np.zeros(10)}) == 3


# ------------------------------------------------------------ checkpoints


class _Crash(RuntimeError):
    pass


def test_resume_after_a_crash_is_bit_equal(rng, tmp_path):
    """Dropout on: a run that dies in epoch 3 (before its checkpoint) and
    resumes from epoch 2 ends with the same weights, optimizer state and
    epoch-3 metrics as a run that never stopped."""
    train, val, _ = _splits(rng)
    whole = _dropout_trainer(tmp_path, "whole")
    ref = whole.fit(train, val, verbose=False)

    class CrashAt3:
        def log(self, metrics, step=None):
            if step == 3:
                raise _Crash

        def watch(self, **kw):
            pass

    crashed = _dropout_trainer(tmp_path, "crashed", tracker=CrashAt3())
    with pytest.raises(_Crash):
        crashed.fit(train, val, verbose=False)
    assert Checkpointer(tmp_path / "crashed").latest_step() == 2
    resumed = _dropout_trainer(tmp_path, "crashed", resume=True)
    got = resumed.fit(train, val, verbose=False)
    assert [h["epoch"] for h in got["history"]] == [3]
    for key in ("train_loss", "train_c_index", "val_loss", "val_c_index"):
        assert got["history"][0][key] == ref["history"][-1][key], key
    for (name, a), b in zip(resumed.module.state_dict().items(),
                            whole.module.state_dict().values()):
        assert torch.equal(a, b), name
    sa, sb = resumed.optimizer.state_dict(), whole.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, state in sb["state"].items():
        for key, value in state.items():
            assert torch.equal(sa["state"][i][key], value), (i, key)


@pytest.mark.parametrize("keep,left", [(2, [2, 3]), (None, [1, 2, 3]), (1, [3])])
def test_keep_checkpoints_prunes_old_steps(rng, tmp_path, keep, left):
    train, val, _ = _splits(rng)
    trainer = _dropout_trainer(tmp_path, "run", keep_checkpoints=keep)
    trainer.fit(train, val, verbose=False)
    ckpt = Checkpointer(tmp_path / "run")
    assert ckpt._step_numbers() == left and ckpt.latest_step() == 3
    meta = json.loads((tmp_path / "run" / "latest.json").read_text())
    assert meta["step"] == 3 and set(meta["metrics"]) == {"val_loss", "val_c_index"}
    restored = ckpt.restore()
    assert restored["step"] == 3
    assert set(restored["params"]) == set(trainer.module.state_dict())
    assert int(restored["opt_state"]["state"][0]["step"]) == 9  # 3 epochs of 3 steps


def test_already_complete_fold_re_evaluates(rng, tmp_path):
    train, val, _ = _splits(rng)
    first = _dropout_trainer(tmp_path, "run").fit(train, val, verbose=False)
    again = _dropout_trainer(tmp_path, "run", resume=True)
    got = again.fit(train, val, verbose=False)
    assert len(got["history"]) == 1 and got["history"][0]["resumed_complete"]
    assert got["stopped_epoch"] == 3
    assert got["val_loss"] == first["val_loss"]
    assert got["val_c_index"] == first["val_c_index"]


def test_set_fold_resets_weights_and_optimizer(rng, tmp_path):
    """``set_fold`` draws the seed's weights and zeroes the optimizer in
    place: every moment, the count and lr zero, beta1 its initial value,
    in the same tensor objects as before."""
    train, val, _ = _splits(rng)
    trainer = _dropout_trainer(tmp_path, "fold1", epochs=1)
    trainer.fit(train, val, verbose=False)
    opt = trainer.optimizer
    assert opt.state and float(opt.count) > 0
    before = {id(p): dict(state) for p, state in opt.state.items()}
    trainer.set_fold(seed=123, class_weights=np.ones(4), checkpoint_dir=tmp_path / "fold2")
    fresh = HealNetModule(**CFG, attn_dropout=0.2, ff_dropout=0.3, device="cpu",
                          generator=torch.Generator().manual_seed(123))
    for (name, a), b in zip(trainer.module.state_dict().items(),
                            fresh.state_dict().values()):
        assert torch.equal(a, b), name
    assert trainer.optimizer is opt and trainer.seed == 123
    assert {id(p) for p in opt.state} == set(before)
    for p, state in opt.state.items():
        assert all(state[k] is before[id(p)][k] for k in state)
        assert not state["exp_avg"].any() and not state["exp_avg_sq"].any()
    assert float(opt.count) == 0.0 and float(opt.lr) == 0.0
    assert float(opt.beta1) == pytest.approx(0.95)
    assert trainer.checkpoint_dir == tmp_path / "fold2"
    assert torch.equal(trainer.class_weights, torch.ones(4))


def test_checkpointer_ignores_unfinished_saves(tmp_path):
    ckpt = Checkpointer(tmp_path)
    ckpt.save(4, {"w": torch.ones(2)}, metrics={"val_loss": 1.0})
    (tmp_path / "step_00000009.pt.123.tmp").write_bytes(b"partial")
    assert ckpt.latest_step() == 4
    assert torch.equal(ckpt.restore(4)["params"]["w"], torch.ones(2))
    ckpt.save_best({"w": torch.zeros(2)})
    assert torch.equal(ckpt.restore_best()["w"], torch.zeros(2))


# -------------------------------------------------------------- c-index


def _cindex_inputs(rng, kind, n=60):
    event = rng.uniform(size=n) < 0.6
    time = rng.uniform(1, 50, size=n)
    est = rng.normal(size=n)
    if kind == "tied":
        time = np.round(time / 10) * 10
        est = np.round(est)
    elif kind == "censored":
        event[:] = False
    return event, time, est


@pytest.mark.parametrize("kind", ["random", "tied", "censored"])
def test_cindex_native_numpy_and_jax_agree(rng, kind):
    args = _cindex_inputs(rng, kind)
    if kind == "censored":
        for fn in (tmetrics.concordance_index_native, tmetrics.concordance_index_censored,
                   jax_cindex):
            with pytest.raises(ValueError, match="censored"):
                fn(*args)
        return
    want = jax_cindex(*args, tied_tol=1e-8)
    assert tmetrics.concordance_index_native(*args, tied_tol=1e-8) == want
    assert tmetrics.concordance_index_censored(*args, tied_tol=1e-8) == want


def test_cindex_native_library_builds_into_the_ports_directory():
    assert tmetrics.cindex_implementation() == "native"
    path = tmetrics.library_path()
    assert path.exists() and path.parent.parent.name == "build"
    assert "healnet_tpu/" not in str(path.relative_to(path.parents[2]))


# ------------------------------------------------------------- prefetcher


def test_prefetcher_stops_its_thread_when_a_step_raises(rng, monkeypatch):
    train, val, _ = _splits(rng)
    made = []

    class Recorded(DevicePrefetcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(tloop, "DevicePrefetcher", Recorded)
    trainer = SurvivalTrainer(_port_module(), batch_size=2, epochs=1, prefetch=1, device="cpu")

    def failing_step(batch, horizon=None):
        raise _Crash

    monkeypatch.setattr(trainer, "train_step", failing_step)
    with pytest.raises(_Crash):
        trainer.fit(train, val, verbose=False)
    assert len(made) == 1 and not made[0]._src.alive


def test_background_iterator_passes_on_errors_and_closes():
    def items():
        yield 1
        raise _Crash

    it = BackgroundIterator(items(), buffer_size=1)
    assert next(it) == 1
    with pytest.raises(_Crash):
        next(it)
    endless = BackgroundIterator(iter(lambda: 0, 1), buffer_size=2)
    assert next(endless) == 0
    endless.close()
    assert not endless.alive
    placed = list(DevicePrefetcher(iter([{"x": np.ones(2)}] * 3), device="cpu"))
    assert len(placed) == 3 and all(torch.equal(p["x"], torch.ones(2, dtype=torch.float64))
                                    for p in placed)


# ---------------------------------------------------------------- serving


def test_predictor_from_a_checkpoint_directory(rng, tmp_path):
    train, val, _ = _splits(rng)
    trainer = _dropout_trainer(tmp_path, "run", epochs=1)
    trainer.fit(train, val, verbose=False)
    Checkpointer(tmp_path / "run").save_best(trainer.module.state_dict())
    predictor = Predictor(_port_module(), params=tmp_path / "run", batch_size=4, device="cpu")
    got = predictor(list(val["tensors"]))["logits"]
    module = trainer.module.eval()
    with torch.no_grad():
        want = module([torch.from_numpy(t) for t in val["tensors"]]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_entry_points_need_a_gpu_or_cpu_request(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    module = _port_module()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SurvivalTrainer(module)
    Checkpointer(tmp_path).save_best(module.state_dict())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(module, params=tmp_path)


@pytest.mark.parametrize("kw,item", [(dict(mesh=object()), "Mesh"),
                                     (dict(mesh="one device", device="meta"), "not the mesh")])
def test_unported_options_raise(kw, item):
    """Meshes are ported; what the trainer still refuses on one process is a
    mesh that is not a ``Mesh`` and a device other than the mesh's."""
    if kw["mesh"] == "one device":
        kw = dict(kw, mesh=make_mesh(1, device="cpu"))
    with pytest.raises((TypeError, ValueError), match=item):
        SurvivalTrainer(_port_module(), **{"device": "cpu", **kw})
