from healnet_tpu_torch.etl.prefetch import BackgroundIterator, DevicePrefetcher, pin_tree

__all__ = ["BackgroundIterator", "DevicePrefetcher", "pin_tree"]
