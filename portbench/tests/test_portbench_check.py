"""The comparison that decides ``correct``: a sound run passes, the
reference agrees with the port's CPU path, and a run whose timed path is
broken underneath, or the fp8 control in the program's place, fails."""

import functools

import numpy as np
import pytest
import torch

from portbench import check
from portbench.tests.tiny import run_tiny, tiny_files


def test_sound_run_is_correct_and_agrees_with_the_port():
    result = run_tiny()
    assert result["correct"], result["compared"]
    # float32 on the CPU: the port's path and the reference differ by rounding
    assert all(v["value"] < 1e-4 for v in result["compared"].values()), result["compared"]
    assert list(result)[-1] == "compared"
    assert result["metrics"]["train_samples_per_s"]["value"] > 0


def test_bf16_run_is_correct():
    result = run_tiny(precision="bf16")
    assert result["correct"], result["compared"]


@pytest.mark.parametrize("fused", [True, False])
def test_streamed_bags_run_is_correct(fused):
    """A mix whose trainer streams host float16 bags (no arena, as the
    pipeline streams them to a bf16 model) runs and agrees with the
    reference, which reads the same bags."""
    result = run_tiny(precision="bf16", arena="none", fused_epochs=fused)
    assert result["correct"], result["compared"]


def _state_unchanged(monkeypatch):
    from healnet_tpu_torch.train import schedule

    step = schedule.Adam.step

    def frozen(self, closure=None):
        saved = [p.detach().clone() for g in self.param_groups for p in g["params"]]
        step(self, closure)
        with torch.no_grad():
            for p, s in zip((p for g in self.param_groups for p in g["params"]), saved):
                p.copy_(s)

    monkeypatch.setattr(schedule.Adam, "step", frozen)


def _half_batch(monkeypatch):
    from healnet_tpu_torch.train.loop import SurvivalTrainer

    surv = SurvivalTrainer._surv_loss

    def half(self, logits, batch):
        mask = batch["sample_mask"]
        keep = (torch.arange(mask.shape[0], device=mask.device) < mask.shape[0] // 2)
        return surv(self, logits, dict(batch, sample_mask=mask * keep))

    monkeypatch.setattr(SurvivalTrainer, "_surv_loss", half)


def _answer_altered(monkeypatch):
    from healnet_tpu_torch.models.healnet import HealNetModule

    fwd = HealNetModule.forward

    @functools.wraps(fwd)  # the trainer passes the keywords the signature names
    def altered(self, *args, **kwargs):
        out = fwd(self, *args, **kwargs)
        return out + (torch.arange(out.shape[0], device=out.device) == 0)[:, None].to(out.dtype)

    monkeypatch.setattr(HealNetModule, "forward", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result = run_tiny()
    assert not result["correct"], result["compared"]


def test_fp8_control_fails_the_limits():
    """The reference with every product in fp8, put in the program's
    place, fails the cell's limits; the program does not."""
    from portbench.run import build_cell

    _, cfg, mix, limits = tiny_files(precision="bf16")
    cohort, _, _, _, case, prog = build_cell(cfg, mix, 31, torch.device("cpu"))
    run = lambda **kw: check.reference_run(cohort, cfg, mix, case, **kw)
    ref, w = run(), check.host_weights(case.w0)
    assert check.verdict(check.compare(prog, ref, w), limits)[0]
    control = check.compare(run(mm=check.reference_of(cfg).control_mm), ref, w)
    assert not check.verdict(control, limits)[0], control


def test_compare_reads_a_frozen_step_as_one():
    w0 = {"a": np.zeros(3, np.float32), "b": np.ones(2, np.float32)}
    ref = {"loss": [1.0], "val_loss": [1.0], "grad1": {"a": np.ones(3), "b": np.ones(2)},
           "params": {"a": np.full(3, 0.1), "b": np.full(2, 1.1)}}
    prog = dict(ref, params=w0)
    assert check.compare(prog, ref, w0)["change"]["value"] == pytest.approx(1.0)
