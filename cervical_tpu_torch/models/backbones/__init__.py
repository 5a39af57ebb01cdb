"""Segmentation backbones."""
