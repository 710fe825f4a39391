from healnet_tpu_torch.parallel.arena import gather_bag, place_arena

__all__ = ["gather_bag", "place_arena"]
