"""Segmentation models (PyTorch, NCHW)."""
