"""Plans and label handling (host-side, numpy)."""
