"""Prediction export: logits -> resample to original grid -> segmentation ->
un-crop -> un-transpose -> write. The port's own copy of
anatomask_tpu/inference/export.py (nnU-Net's export_prediction.py:
convert_predicted_logits_to_segmentation_with_correct_shape,
export_prediction_from_logits, resample_and_save for a cascade's next
stage); host numpy.
"""
from __future__ import annotations

import numpy as np

from anatomask_torch.plans.label_handling import LabelManager
from anatomask_torch.plans.plans_handler import ConfigurationManager, PlansManager


def convert_predicted_logits_to_segmentation_with_correct_shape(
    predicted_logits: np.ndarray,
    plans_manager: PlansManager,
    configuration_manager: ConfigurationManager,
    label_manager: LabelManager,
    properties_dict: dict,
    return_probabilities: bool = False,
):
    """predicted_logits: (K, x, y, z) on the resampled/cropped grid (after
    transpose_forward). Returns segmentation (z, y, x original axes) and
    optionally the class probabilities on the original grid."""
    spacing_transposed = [properties_dict["spacing"][i] for i in plans_manager.transpose_forward]
    current_spacing = (
        configuration_manager.spacing
        if len(configuration_manager.spacing) == len(properties_dict["shape_after_cropping_and_before_resampling"])
        else [spacing_transposed[0], *configuration_manager.spacing]
    )
    # resample logits back to the pre-resampling (cropped) grid
    predicted_logits = configuration_manager.resampling_fn_probabilities(
        predicted_logits.astype(np.float32),
        properties_dict["shape_after_cropping_and_before_resampling"],
        current_spacing,
        spacing_transposed,
    )
    probabilities = label_manager.apply_inference_nonlin(predicted_logits)
    del predicted_logits
    segmentation = label_manager.convert_probabilities_to_segmentation(probabilities)

    # paste into the pre-crop grid
    seg_reverted = np.zeros(
        properties_dict["shape_before_cropping"],
        dtype=np.uint8 if len(label_manager.foreground_labels) < 255 else np.uint16,
    )
    slicer = tuple(slice(int(b[0]), int(b[1])) for b in properties_dict["bbox_used_for_cropping"])
    seg_reverted[slicer] = segmentation
    seg_reverted = seg_reverted.transpose(plans_manager.transpose_backward)

    if return_probabilities:
        probabilities = label_manager.revert_cropping_on_probabilities(
            probabilities, properties_dict["bbox_used_for_cropping"],
            properties_dict["shape_before_cropping"],
        )
        probabilities = probabilities.transpose([0, *[i + 1 for i in plans_manager.transpose_backward]])
        return seg_reverted, probabilities
    return seg_reverted


def export_prediction_from_logits(
    predicted_logits: np.ndarray,
    properties_dict: dict,
    configuration_manager: ConfigurationManager,
    plans_manager: PlansManager,
    dataset_json: dict,
    output_file_truncated: str,
    save_probabilities: bool = False,
):
    label_manager = plans_manager.get_label_manager(dataset_json)
    ret = convert_predicted_logits_to_segmentation_with_correct_shape(
        predicted_logits, plans_manager, configuration_manager, label_manager,
        properties_dict, return_probabilities=save_probabilities,
    )
    if save_probabilities:
        segmentation, probabilities = ret
        np.savez_compressed(output_file_truncated + ".npz", probabilities=probabilities)
        from anatomask_torch.preprocessing.preprocessor import save_properties
        save_properties(properties_dict, output_file_truncated)
    else:
        segmentation = ret

    from anatomask_torch.imageio.registry import determine_reader_writer_from_dataset_json
    rw = determine_reader_writer_from_dataset_json(dataset_json)()
    rw.write_seg(segmentation, output_file_truncated + dataset_json["file_ending"], properties_dict)


def resample_and_save(
    predicted_logits: np.ndarray,
    target_shape,
    output_file: str,
    plans_manager: PlansManager,
    configuration_manager: ConfigurationManager,
    properties_dict: dict,
    dataset_json: dict,
):
    """Cascade support: resample softmax of a lowres stage to the next stage's
    grid and store as .npz (reference resample_and_save :109)."""
    spacing_transposed = [properties_dict["spacing"][i] for i in plans_manager.transpose_forward]
    current_spacing = (
        configuration_manager.spacing
        if len(configuration_manager.spacing) == len(target_shape)
        else [spacing_transposed[0], *configuration_manager.spacing]
    )
    target_spacing = current_spacing  # spacing metadata is informative only here
    resampled = configuration_manager.resampling_fn_probabilities(
        predicted_logits.astype(np.float32), target_shape, current_spacing, target_spacing
    )
    label_manager = plans_manager.get_label_manager(dataset_json)
    seg = label_manager.convert_logits_to_segmentation(resampled)
    np.savez_compressed(output_file, seg=seg.astype(np.int8 if seg.max() < 127 else np.int16))
