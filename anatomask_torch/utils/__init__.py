"""Host helpers (counterpart of anatomask_tpu/utils/)."""
