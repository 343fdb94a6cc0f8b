"""Dataset directory conventions. The port's own copy of anatomask_tpu/paths.py:
the same ATK_* (and nnUNet_*) variables, so one folder tree serves both
packages. The environment is read at each call."""
import os
from typing import Optional

_VARIABLES = {"raw": ("ATK_raw", "nnUNet_raw"),
              "preprocessed": ("ATK_preprocessed", "nnUNet_preprocessed"),
              "results": ("ATK_results", "nnUNet_results")}


def get(which: str) -> Optional[str]:
    """The folder of 'raw', 'preprocessed' or 'results' data, or None if unset."""
    for name in _VARIABLES[which]:
        if os.environ.get(name):
            return os.environ[name]
    return None


def require(which: str) -> str:
    val = get(which)
    if val is None:
        raise RuntimeError(
            f"Path for '{which}' data is not set. Export ATK_{which} (or nnUNet_{which})."
        )
    return val
