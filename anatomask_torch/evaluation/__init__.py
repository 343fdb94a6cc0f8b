"""Evaluation of predicted segmentations."""
