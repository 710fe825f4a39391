from healnet_tpu_torch.train.losses import hazards_survival_risk

__all__ = ["hazards_survival_risk"]
