"""Connected-component postprocessing of predicted segmentations."""
