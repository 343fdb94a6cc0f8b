"""Pretraining data path: case store, patch sampler, host pipeline, GPU case
cache and on-device augmentation (counterpart of anatomask_tpu/data/)."""
