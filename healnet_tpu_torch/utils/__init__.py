from healnet_tpu_torch.utils.train_utils import (
    EarlyStopping,
    accepts_kv_masks,
    calc_reg_loss,
    count_parameters,
    l1_norm,
)

__all__ = ["EarlyStopping", "accepts_kv_masks", "calc_reg_loss", "count_parameters", "l1_norm"]
