"""The port's pipeline and CLI (``healnet_tpu_torch.cli.main``), against the
JAX package's on the CPU, on small TCGA-layout trees.

One fold through both CLIs with dropout off and the JAX initial weights
carried into the port (by a monkeypatch of ``Pipeline.make_model`` here,
not by an option of the port): the splits, survival bins, class weights and
batch order are equal bit for bit; the per-epoch losses agree to 1e-5
relative and the c-indices to 1e-6, as ``tests/test_torch_port_fit.py``
holds the fold loop. Two folds give the same splits, bins, class weights
and summary keys. A relaunch resumes, the dataset cache carries across
sweep trials, what is not ported raises, and the CLI runs end to end with
pandas, PyYAML and h5py blocked.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from healnet_tpu.cli import main as jax_cli
from healnet_tpu.train import loop as jax_loop
from healnet_tpu.train.pipeline import Pipeline as JaxPipeline
from healnet_tpu_torch.cli import main as cli
from healnet_tpu_torch.compat.flax_params import state_dict_from_flax
from healnet_tpu_torch.etl import train_val_test_split
from healnet_tpu_torch.train import loop as port_loop
from healnet_tpu_torch.train import pipeline as port_pipeline
from healnet_tpu_torch.train.checkpoint import Checkpointer
from healnet_tpu_torch.train.pipeline import Pipeline
from healnet_tpu_torch.utils import Config, unpickle

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_port_etl import write_tree  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
HYPERPARAMS = """brca:
  output_dims: 4
  class_weights: inverse
  l1: 1.0e-05
  num_freq_bands: 2
  depth: {depth}
  max_freq: 2.0
  num_latents: 8
  latent_dim: 16
  cross_dim_head: 8
  latent_dim_head: 8
  cross_heads: 1
  latent_heads: 2
  attn_dropout: {dropout}
  ff_dropout: {dropout}
  fourier_encode_data: true
  self_per_cross_attn: {self_attn}
  weight_tie_layers: false
  snn: true
"""
# config/dress_rehearsal.yml cut to the tree: f32, bags of 8-48 patches in
# two buckets, the arena (device_cache) and fused epochs on
CONFIG = """tcga_path: {tcga}
log_path: {logs}
hyperparams: {hyperparams}
dataset: brca
model: healnet
run_name: {run_name}
explainer: {explainer}
missing_ablation: false
omic_attention: true
patch_attention: true
n_folds: {folds}
wandb: false
compilation_cache: false
attention_impl: auto
projection_impl: auto
data:
  wsi_level: 2
  max_patches: null
  feature_dtype: float32
  device_cache: {device_cache}
  quantize_arena: false
sources:
  - omic
  - slides
survival:
  loss: nll
  subset: uncensored
train_loop:
  eval_interval: 1
  batch_size: 4
  epochs: {epochs}
  fused_epochs: {device_cache}
  early_stopping: false
  patience: 5
  gc_compat: 16
  bucket_boundaries: [24, 48]
  checkpoint: true
  resume: true
optimizer:
  max_lr: 0.008
  weight_decay: None
precision: fp32
spmd: false
"""


def write_config(root: Path, name: str, folds=1, epochs=2, depth=1, dropout=0.0,
                 device_cache="true", explainer="false", run_name="run", self_attn=0):
    hp = root / f"{name}_hp.yml"
    hp.write_text(HYPERPARAMS.format(depth=depth, dropout=dropout, self_attn=self_attn))
    path = root / f"{name}.yml"
    path.write_text(CONFIG.format(tcga=root / "tcga", logs=root / "logs" / name,
                                  hyperparams=hp, folds=folds, epochs=epochs,
                                  device_cache=device_cache, explainer=explainer,
                                  run_name=run_name))
    return path


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("cohort")
    write_tree(root / "tcga", np.random.default_rng(11), n=40)
    return root


def _metrics(root: Path, name: str, run_name="run"):
    return [json.loads(line)
            for line in open(root / "logs" / name / run_name / "metrics.jsonl")]


class Recorder:
    """What a pipeline run decided: each fold's splits and class weights,
    the dataset's bins, and every batch the fold loop drew."""

    def __init__(self, pipeline_cls, loop_module, monkeypatch):
        self.folds, self.batches, self.y_disc = [], [], None
        load_data = pipeline_cls.load_data
        iterate = loop_module.iterate_batches

        def record_load(pipe, fold=1):
            views = load_data(pipe, fold=fold)
            self.y_disc = np.asarray(pipe._dataset.y_disc)
            self.folds.append(tuple(np.asarray(v.indices) for v in views[:3]) + (views[3],))
            return views

        def record_batches(*a, **kw):
            for batch in iterate(*a, **kw):
                self.batches.append((
                    np.asarray(batch["y_disc"]), np.asarray(batch["sample_mask"]),
                    np.asarray(batch.get("patch_offsets", ())),
                    np.asarray(batch["kv_masks"][-1]),
                    np.asarray([np.asarray(t, np.float64).sum() for t in batch["tensors"]])))
                yield batch

        monkeypatch.setattr(pipeline_cls, "load_data", record_load)
        monkeypatch.setattr(loop_module, "iterate_batches", record_batches)


@pytest.fixture(scope="module")
def jax_fold(cohort):
    """The JAX CLI on one fold, its initial weights and what it decided (the
    batch its ``init_params`` draws to shape the weights left out: the port
    shapes them from the config)."""
    weights = {}
    with pytest.MonkeyPatch.context() as mp:
        rec = Recorder(JaxPipeline, jax_loop, mp)
        init = jax_loop.SurvivalTrainer.init_params

        def keep_init(self, data):
            drawn = len(rec.batches)
            params = init(self, data)
            del rec.batches[drawn:]
            weights["params"] = jax.tree_util.tree_map(np.asarray, params)
            return params

        mp.setattr(jax_loop.SurvivalTrainer, "init_params", keep_init)
        jax_cli.main(["--config_path", str(write_config(cohort, "jax"))])
    return weights["params"], rec


def test_one_fold_through_both_clis(cohort, jax_fold, monkeypatch):
    params, want = jax_fold
    make_model = Pipeline.make_model

    def jax_weights(self, *a, **kw):
        module = make_model(self, *a, **kw)
        module.load_state_dict(state_dict_from_flax(params))
        return module

    monkeypatch.setattr(Pipeline, "make_model", jax_weights)
    got = Recorder(Pipeline, port_loop, monkeypatch)
    summary = cli.main(["--config_path", str(write_config(cohort, "port")), "--device", "cpu"])

    np.testing.assert_array_equal(got.y_disc, want.y_disc)
    assert len(got.folds) == len(want.folds) == 1
    for a, b in zip(got.folds[0], want.folds[0]):
        np.testing.assert_array_equal(a, b)
    assert len(got.batches) == len(want.batches) > 4
    for a, b in zip(got.batches, want.batches):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)

    rows, ref = _metrics(cohort, "port"), _metrics(cohort, "jax")
    assert [sorted(r) for r in rows] == [sorted(r) for r in ref]
    checked = 0
    for r, w in zip(rows, ref):
        for key in r:
            if key.endswith("_loss"):
                np.testing.assert_allclose(r[key], w[key], rtol=1e-5, err_msg=key)
                checked += 1
            elif "c_index" in key:
                np.testing.assert_allclose(r[key], w[key], rtol=0, atol=1e-6, err_msg=key)
                checked += 1
    assert checked >= 10
    assert 0.0 < summary["mean_test_c_index"] < 1.0
    assert json.loads((cohort / "logs" / "port" / "run" / "summary.json").read_text()).keys() \
        == json.loads((cohort / "logs" / "jax" / "run" / "summary.json").read_text()).keys()


@pytest.mark.parametrize("device_cache", ["true", "false"])
def test_two_folds_same_splits_bins_weights_and_keys(cohort, monkeypatch, device_cache):
    """Two folds, each with its own split and trainer seed, in both packages
    (the port reuses one trainer through ``set_fold``)."""
    name = f"two_{device_cache}"
    recs = []
    for pipeline_cls, loop_module, main, extra in (
            (JaxPipeline, jax_loop, jax_cli.main, []),
            (Pipeline, port_loop, cli.main, ["--device", "cpu"])):
        with monkeypatch.context() as mp:
            rec = Recorder(pipeline_cls, loop_module, mp)
            tag = "jax" if main is jax_cli.main else "port"
            main(["--config_path", str(write_config(cohort, f"{name}_{tag}", folds=2, epochs=1,
                                                    device_cache=device_cache))] + extra)
            recs.append(rec)
    want, got = recs
    np.testing.assert_array_equal(got.y_disc, want.y_disc)
    assert len(got.folds) == len(want.folds) == 2
    for fold_got, fold_want in zip(got.folds, want.folds):
        for a, b in zip(fold_got, fold_want):
            np.testing.assert_array_equal(a, b)
    summaries = [json.loads((cohort / "logs" / f"{name}_{t}" / "run" / "summary.json")
                            .read_text()) for t in ("jax", "port")]
    assert summaries[0].keys() == summaries[1].keys()
    assert {"mean_test_c_index", "std_test_c_index", "fold_2_test_c_index"} <= set(summaries[1])


def test_relaunch_resumes_both_folds(cohort, capsys):
    """A second process with the same run_name finds both folds complete
    and re-evaluates their checkpoints: the same test c-indices, bit for bit."""
    path = str(write_config(cohort, "relaunch", folds=2, epochs=2, dropout=0.2))
    argv = ["--config_path", path, "--device", "cpu"]
    first = cli.main(argv)
    summary_path = cohort / "logs" / "relaunch" / "run" / "summary.json"
    before = json.loads(summary_path.read_text())
    second = cli.main(argv)
    after = json.loads(summary_path.read_text())
    assert "already complete" in capsys.readouterr().out
    for key in ("fold_1_test_c_index", "fold_2_test_c_index"):
        assert before[key] == after[key]
    assert first["mean_test_c_index"] == second["mean_test_c_index"]
    for fold in (1, 2):
        assert Checkpointer(cohort / "logs" / "relaunch" / "run" /
                            f"fold_{fold}_checkpoints").latest_step() == 2


def test_explainer_artifacts(cohort):
    path = write_config(cohort, "explain", folds=2, epochs=1, explainer="true")
    pipe = Pipeline(Config(str(path)).read() | {"model_params": Config(
        str(cohort / "explain_hp.yml")).read()["brca"]}, device="cpu")
    summary = pipe.main()
    log_dir = Path(pipe.log_dir)
    best = Checkpointer(log_dir / "checkpoints").restore_best()
    assert set(best) == set(pipe._trainer.module.state_dict())
    assert unpickle(log_dir / "config.pkl")["dataset"] == "brca"
    np.testing.assert_array_equal(unpickle(log_dir / "test_data_indices.pkl"),
                                  train_val_test_split(40, seed=summary["best_fold"] + 1)[1])
    assert (log_dir / "brca_omic_overlap.csv.zip").exists()
    assert summary["best_fold"] in (0, 1)
    assert pipe.timings["dataset_s"] > 0 and "arena_upload_s" in pipe.timings
    assert [r["stopped_epoch"] for r in pipe.fold_results] == [1, 1]


def test_dataset_cache_carries_across_sweep_trials(cohort, monkeypatch, tmp_path):
    monkeypatch.setitem(port_pipeline._DATASET_CACHE, "key", None)
    built, placed = [], []
    tcga, place = port_pipeline.TCGADataset, port_pipeline.place_arena
    monkeypatch.setattr(port_pipeline, "TCGADataset", lambda *a, **kw: built.append(1) or
                        tcga(*a, **kw))
    monkeypatch.setattr(port_pipeline, "place_arena", lambda *a: placed.append(1) or place(*a))
    sweep = tmp_path / "sweep.yaml"
    sweep.write_text("method: grid\nmetric:\n  name: mean_test_c_index\n  goal: maximize\n"
                     "parameters:\n  model_params.l1:\n    values: [1.0e-05, 1.0e-04]\n"
                     "  train_loop.epochs:\n    value: 1\n")
    best = cli.main(["--config_path", str(write_config(cohort, "sweep")), "--mode", "sweep",
                     "--sweep_config", str(sweep), "--device", "cpu"])
    assert len(built) == 1 and len(placed) == 1
    assert best["params"]["model_params.l1"] in (1e-05, 1e-04)
    rows = (cohort / "logs" / "sweep" / "sweep_results.csv").read_text().splitlines()
    assert len(rows) == 3 and rows[0].startswith("param.model_params.l1,")
    assert (cohort / "logs" / "sweep" / "run_trial2" / "summary.json").exists()


@pytest.mark.parametrize("key", ["spmd", "data.shard_arena"])
def test_multi_device_not_ported_yet(cohort, key):
    """``spmd`` and ``data.shard_arena`` are ported. In one process ``spmd``
    trains on a mesh of one device (with ``data.shard_arena`` on an arena of
    one shard): the same fold, bit for bit, as without them.
    ``data.shard_arena`` alone takes no mesh and shards nothing, as in JAX.
    Worlds of several processes: ``tests/test_torch_port_parallel.py``."""
    def run(*keys):
        name = "_".join([key.replace(".", "_"), *[k.replace(".", "_") for k in keys]])
        config = Config(str(write_config(cohort, "multi", epochs=1, run_name=name))).read()
        config["model_params"] = Config(str(cohort / "multi_hp.yml")).read()["brca"]
        for k in keys:
            section, _, leaf = k.rpartition(".")
            (config[section] if section else config)[leaf] = True
        pipe = Pipeline(config, device="cpu")
        return pipe, pipe.main()

    _, plain = run()
    keys = ("spmd", "data.shard_arena") if key == "spmd" else (key,)
    pipe, summary = run(*keys)
    assert (pipe.mesh is not None) == (key == "spmd")
    if key == "spmd":
        assert pipe.mesh.size == 1 and pipe._trainer.mesh is pipe.mesh
        assert type(pipe._trainer._arena).__name__ == "ShardedArena"
    for metric in ("mean_train_c_index", "mean_val_c_index", "mean_test_c_index"):
        assert summary[metric] == plain[metric], metric


def test_cli_needs_a_gpu_or_device_cpu(cohort):
    argv = ["--config_path", str(write_config(cohort, "nogpu"))]
    if torch.cuda.is_available():
        pytest.skip("this test checks the refusal on a machine without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    assert not (cohort / "logs" / "nogpu").exists()


BLOCKED = ("pandas", "yaml", "h5py", "jax", "flax", "optax", "healnet_tpu")


def test_cli_runs_without_pandas_yaml_or_h5py(cohort):
    """``python -m healnet_tpu_torch.cli.main`` in a fresh process with
    pandas, PyYAML, h5py and the JAX stack blocked (an import of any of
    them raises ImportError), as on the machine with the GPU."""
    path = write_config(cohort, "blocked", folds=1, epochs=1, depth=2, dropout=0.1,
                        self_attn=1)
    code = ("import runpy, sys\n"
            f"for name in {BLOCKED!r}:\n"
            "    sys.modules[name] = None\n"
            "runpy.run_module('healnet_tpu_torch.cli.main', run_name='__main__')\n")
    env = {**os.environ, "PYTHONPATH": f"{REPO}{os.pathsep}{os.environ.get('PYTHONPATH', '')}"}
    proc = subprocess.run(
        [sys.executable, "-c", code, "--config_path", str(path), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads((cohort / "logs" / "blocked" / "run" / "summary.json").read_text())
    assert np.isfinite(summary["fold_1_test_loss"])
