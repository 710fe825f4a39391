from healnet_tpu_torch.utils.boxdict import Box
from healnet_tpu_torch.utils.config import Config, flatten_config, unflatten_config
from healnet_tpu_torch.utils.io import pickle_obj, unpickle
from healnet_tpu_torch.utils.profiling import StepTimer, enable_compilation_cache, trace
from healnet_tpu_torch.utils.tracking import Tracker, wandb_available
from healnet_tpu_torch.utils.train_utils import (
    EarlyStopping,
    accepts_kv_masks,
    calc_reg_loss,
    count_parameters,
    l1_norm,
)

__all__ = [
    "Box",
    "Config",
    "flatten_config",
    "unflatten_config",
    "pickle_obj",
    "unpickle",
    "EarlyStopping",
    "accepts_kv_masks",
    "calc_reg_loss",
    "count_parameters",
    "l1_norm",
    "Tracker",
    "wandb_available",
    "StepTimer",
    "enable_compilation_cache",
    "trace",
]
