from healnet_tpu_torch.models.explainer import Explainer
from healnet_tpu_torch.models.healnet import HealNet, HealNetModule, attention_module_order

__all__ = ["Explainer", "HealNet", "HealNetModule", "attention_module_order"]
