from healnet_tpu_torch.train.checkpoint import Checkpointer
from healnet_tpu_torch.train.loop import SurvivalTrainer, iterate_batches
from healnet_tpu_torch.train.losses import (
    CoxPHSurvLoss,
    CrossEntropySurvLoss,
    ce_loss,
    cox_ph_loss,
    hazards_survival_risk,
    nll_loss,
    nll_loss_from_logits,
    survival_loss,
)
from healnet_tpu_torch.train.metrics import (
    cindex_implementation,
    concordance_index_censored,
    concordance_index_native,
)
from healnet_tpu_torch.train.schedule import (
    Adam,
    make_optimizer,
    onecycle_beta1,
    onecycle_beta1_at,
    onecycle_lr,
    onecycle_lr_at,
    progress_hyperparams,
    progress_schedule,
)

__all__ = [
    "Adam",
    "Checkpointer",
    "CoxPHSurvLoss",
    "CrossEntropySurvLoss",
    "SurvivalTrainer",
    "ce_loss",
    "cindex_implementation",
    "concordance_index_censored",
    "concordance_index_native",
    "cox_ph_loss",
    "hazards_survival_risk",
    "iterate_batches",
    "make_optimizer",
    "nll_loss",
    "nll_loss_from_logits",
    "onecycle_beta1",
    "onecycle_beta1_at",
    "onecycle_lr",
    "onecycle_lr_at",
    "progress_hyperparams",
    "progress_schedule",
    "survival_loss",
]
