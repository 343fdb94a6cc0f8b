"""Preprocessed-case files (counterpart of anatomask_tpu/preprocessing/)."""
