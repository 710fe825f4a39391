from healnet_tpu_torch.compat.flax_params import (
    flax_from_state_dict,
    is_flax_tree,
    state_dict_from_flax,
)

__all__ = ["flax_from_state_dict", "is_flax_tree", "state_dict_from_flax"]
