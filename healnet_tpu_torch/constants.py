"""Shared constants: the dataset whitelist of the pipeline (counterpart of
``healnet_tpu/constants.py``)."""

VALID_DATASETS = ["blca", "brca", "kirp", "ucec", "hnsc", "paad", "luad", "lusc"]
