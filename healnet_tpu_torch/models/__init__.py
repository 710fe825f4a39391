from healnet_tpu_torch.models.explainer import Explainer
from healnet_tpu_torch.models.healnet import HealNet, HealNetModule, attention_module_order
from healnet_tpu_torch.models.layers import (
    Attention,
    FeedForward,
    PreNormAttention,
    PreNormFeedForward,
)
# the reference's ``healnet.models`` export surface, as the JAX package's
from healnet_tpu_torch.train.losses import CoxPHSurvLoss, CrossEntropySurvLoss
from healnet_tpu_torch.models.baselines.generic import FCNN

__all__ = [
    "Explainer",
    "HealNet",
    "HealNetModule",
    "attention_module_order",
    "Attention",
    "FeedForward",
    "PreNormAttention",
    "PreNormFeedForward",
    "CoxPHSurvLoss",
    "CrossEntropySurvLoss",
    "FCNN",
]
