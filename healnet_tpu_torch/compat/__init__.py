from healnet_tpu_torch.compat.flax_params import (
    flax_from_state_dict,
    is_flax_tree,
    state_dict_from_flax,
)
from healnet_tpu_torch.compat.torch_import import (
    reference_from_state_dict,
    state_dict_from_reference,
)

__all__ = ["flax_from_state_dict", "is_flax_tree", "reference_from_state_dict",
           "state_dict_from_flax", "state_dict_from_reference"]
