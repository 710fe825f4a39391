"""Training CLI: single runs, sweeps, run plans, regularisation ablations.

Counterpart of ``healnet_tpu/cli/main.py``, with the same modes and flags:

    python -m healnet_tpu_torch.cli.main --config_path config/main.yml \\
        --mode {single_run,sweep,run_plan,reg_ablation} [--dataset brca] \\
        [--device {cuda,cpu}]

- ``single_run``: one Pipeline.main() over n_folds;
- ``sweep``: the local sweep engine over a wandb-schema YAML
  (:mod:`healnet_tpu_torch.train.sweep`), objective = the sweep metric from
  the fold aggregate;
- ``run_plan``: datasets x sources x models with 5 folds, exceptions
  logged and skipped;
- ``reg_ablation``: l1 x snn x datasets.

``--device`` (default ``cuda``) is the one flag the JAX CLI lacks: the port
runs on the GPU and raises without one unless ``--device cpu`` asks for the
CPU (the JAX CLI picks its platform through ``JAX_PLATFORMS``). Configs are
read without PyYAML (:mod:`healnet_tpu_torch.utils.yaml_reader`).
"""

from __future__ import annotations

import argparse
import itertools
import traceback
from pathlib import Path
from typing import Any, Dict

from healnet_tpu_torch.device import resolve_device
from healnet_tpu_torch.train.pipeline import Pipeline
from healnet_tpu_torch.train.sweep import Sweep
from healnet_tpu_torch.utils import Box, Config
from healnet_tpu_torch.utils.yaml_reader import load as load_yaml


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Run the healnet_tpu training pipeline (PyTorch port)"
    )
    parser.add_argument("--config_path", type=str, default="config/main.yml")
    parser.add_argument(
        "--mode",
        type=str,
        default="single_run",
        choices=["single_run", "sweep", "run_plan", "reg_ablation"],
    )
    parser.add_argument(
        "--sweep_config", type=str, default="config/sweep_bayesian.yaml"
    )
    parser.add_argument("--sweep_trials", type=int, default=20)
    parser.add_argument("--dataset", type=str, default=None)
    parser.add_argument(
        "--datasets", nargs="+", default=["blca", "brca", "ucec", "kirp"]
    )
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return parser


def load_config(args) -> Box:
    config = Config(args.config_path).read()
    if args.dataset is not None:
        config["dataset"] = args.dataset
    all_hyperparams = Config(config["hyperparams"]).read()
    if config["dataset"] not in all_hyperparams:
        raise SystemExit(
            f"error: no hyperparameters for dataset '{config['dataset']}' in "
            f"{config['hyperparams']}; available: {sorted(all_hyperparams)}"
        )
    config["model_params"] = all_hyperparams[config["dataset"]]
    return config


def run_single(config: Box, args) -> Dict[str, Any]:
    return Pipeline(config=config, args=args, device=args.device).main()


def run_sweep(config: Box, args) -> Dict[str, Any]:
    sweep = Sweep(load_yaml(args.sweep_config))

    base_name = config.get("run_name")
    trial_no = itertools.count(1)

    def objective(params: Dict[str, Any]) -> Dict[str, Any]:
        # a run name per trial: a shared one would interleave metrics.jsonl,
        # overwrite summaries and, with checkpoint + resume, restore the
        # previous trial's weights from its fold checkpoints
        i = next(trial_no)
        name = f"{base_name}_trial{i}" if base_name else None
        pipeline = Pipeline(config=config, args=args, wandb_name=name, device=args.device)
        return pipeline.main(sweep_overrides=params)

    csv_path = Path(config.get("log_path", "logs")) / "sweep_results.csv"
    best = sweep.run(objective, n_trials=args.sweep_trials, csv_path=str(csv_path))
    print(f"Best trial: {best['params']} -> {best['metrics']}")
    return best


def run_plan(config: Box, args) -> None:
    datasets = [args.dataset] if args.dataset else args.datasets
    grid = list(itertools.product(datasets, [["omic", "slides"]], ["healnet"]))
    for iteration, (dataset, sources, model) in enumerate(grid):
        print(f"Run plan iteration {iteration + 1}/{len(grid)}")
        print(f"Dataset: {dataset}, Sources: {sources}, Model: {model}")
        config["dataset"] = dataset
        config["sources"] = sources
        config["model"] = model
        config["n_folds"] = 5
        try:
            # inside the try: a dataset missing from the hyperparameters is
            # logged and skipped like any other failure of one run
            config["model_params"] = Config(config["hyperparams"]).read()[dataset]
            Pipeline(config=config, args=args, device=args.device).main()
        except Exception as exc:  # the plan goes on with its next run
            print(f"Exception: {exc}")
            traceback.print_exc()
            continue
    print(f"Successfully finished runplan: {grid}")


def run_reg_ablation(config: Box, args) -> None:
    config["sources"] = ["omic", "slides"]
    config["model"] = "healnet"
    config["n_folds"] = 1
    config["train_loop"]["early_stopping"] = False
    config["train_loop"]["epochs"] = 50
    regs = [2.0, 1.0]
    snn_opts = [True, False]
    for dataset in [args.dataset] if args.dataset else args.datasets:
        config["dataset"] = dataset
        hyperparams = Config(config["hyperparams"]).read()[dataset]
        config["model_params"] = hyperparams
        best_reg = float(config["model_params"]["l1"])
        for reg in regs:
            for snn in snn_opts:
                config["model_params"]["l1"] = best_reg / reg
                config["model_params"]["snn"] = snn
                Pipeline(config=config, args=args, device=args.device).main()


def main(argv=None):
    """Run the mode ``argv`` names; returns what it returns (a single run's
    summary, a sweep's best trial, None for the plans)."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # no GPU and no --device cpu: raise before any work
    config = load_config(args)
    if args.mode == "run_plan":
        return run_plan(config, args)
    if args.mode == "reg_ablation":
        return run_reg_ablation(config, args)
    if args.mode == "sweep":
        return run_sweep(config, args)
    return run_single(config, args)


if __name__ == "__main__":
    main()
