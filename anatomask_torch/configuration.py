"""Host process counts and the anisotropy threshold. The port's own copy of
the part of anatomask_tpu/configuration.py that the PretrainTrainer and the
preprocessing read."""
import os

# Spacing ratio above which an axis is treated as anisotropic (separate-z
# resampling).
ANISO_THRESHOLD = 3


def get_allowed_n_proc_DA() -> int:
    """Number of host processes for data loading. The augmentation itself
    runs on the device; host workers only gather memory-mapped patches."""
    if "ATK_N_PROC_DA" in os.environ:
        return int(os.environ["ATK_N_PROC_DA"])
    if "nnUNet_n_proc_DA" in os.environ:
        return int(os.environ["nnUNet_n_proc_DA"])
    try:
        n = len(os.sched_getaffinity(0))
    except AttributeError:
        n = os.cpu_count() or 8
    return max(1, min(12, n - 2))
