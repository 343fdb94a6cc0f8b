"""Gaussian sliding-window inference with mirror TTA and fold ensembling."""
