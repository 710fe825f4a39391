from healnet_tpu_torch.utils.train_utils import accepts_kv_masks

__all__ = ["accepts_kv_masks"]
