"""Training plumbing: checkpoints."""
