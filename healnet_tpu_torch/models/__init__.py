from healnet_tpu_torch.models.healnet import HealNet, HealNetModule, attention_module_order

__all__ = ["HealNet", "HealNetModule", "attention_module_order"]
