"""Segmentation overlay PNGs.

After nnU-Net's nnunetv2/utilities/overlay_plots.py —
render the largest-foreground slice of a case with the segmentation painted in
per-class colors, for quick qualitative dataset/prediction review.

Counterpart of anatomask_tpu/utils/overlay_plots.py, copied function for
function. Drawing needs matplotlib; where it is missing, `plot_overlay`
writes nothing and returns False, as `training/logger.py` skips its progress
plot.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

_COLORS = np.array([
    [0, 0, 0], [255, 99, 71], [60, 179, 113], [65, 105, 225], [255, 215, 0],
    [186, 85, 211], [0, 206, 209], [255, 140, 0], [220, 20, 60], [124, 252, 0],
], dtype=np.float32)


def select_slice(seg: np.ndarray, axis: int = 0) -> int:
    """Slice index with the most foreground voxels."""
    axes = tuple(i for i in range(seg.ndim) if i != axis)
    fg = (seg > 0).sum(axes)
    return int(np.argmax(fg))


def generate_overlay(image: np.ndarray, seg: np.ndarray, axis: int = 0,
                     overlay_intensity: float = 0.6) -> np.ndarray:
    """image/seg (x, y, z) -> RGB uint8 overlay of the busiest slice."""
    idx = select_slice(seg, axis)
    img2d = np.take(image, idx, axis=axis).astype(np.float32)
    seg2d = np.take(seg, idx, axis=axis).astype(int)
    lo, hi = np.percentile(img2d, (1, 99))
    img2d = np.clip((img2d - lo) / max(hi - lo, 1e-6), 0, 1)
    rgb = np.stack([img2d] * 3, -1) * 255
    colors = _COLORS[np.clip(seg2d, 0, len(_COLORS) - 1)]
    fg = seg2d > 0
    rgb[fg] = (1 - overlay_intensity) * rgb[fg] + overlay_intensity * colors[fg]
    return rgb.astype(np.uint8)


def plot_overlay(image_file: str, seg_file: str, reader_writer, output_file: str,
                 overlay_intensity: float = 0.6) -> bool:
    """Write the case's overlay PNG; False (nothing written) without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    image, _ = reader_writer.read_images([image_file])
    seg, _ = reader_writer.read_seg(seg_file)
    rgb = generate_overlay(image[0], seg[0], axis=0, overlay_intensity=overlay_intensity)
    fig, ax = plt.subplots()
    ax.imshow(rgb)
    ax.axis("off")
    fig.savefig(output_file, bbox_inches="tight", dpi=150)
    plt.close(fig)
    return True


def generate_overlays_for_folder(images_folder: str, segs_folder: str,
                                 output_folder: str, dataset_json: dict,
                                 num_processes: int = 4):
    from anatomask_torch.imageio.registry import determine_reader_writer_from_dataset_json
    os.makedirs(output_folder, exist_ok=True)
    rw = determine_reader_writer_from_dataset_json(dataset_json)()
    ending = dataset_json["file_ending"]
    for f in sorted(os.listdir(segs_folder)):
        if not f.endswith(ending):
            continue
        ident = f[: -len(ending)]
        img = os.path.join(images_folder, f"{ident}_0000{ending}")
        if os.path.isfile(img):
            plot_overlay(img, os.path.join(segs_folder, f), rw,
                         os.path.join(output_folder, ident + ".png"))
