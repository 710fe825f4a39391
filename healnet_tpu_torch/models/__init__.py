from healnet_tpu_torch.models.healnet import HealNetModule

__all__ = ["HealNetModule"]
