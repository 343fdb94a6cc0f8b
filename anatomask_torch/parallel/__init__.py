"""Data parallelism across processes: one rank a card (torch.distributed)."""
