"""Inference: the segmentation predictor."""
