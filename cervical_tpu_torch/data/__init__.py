"""Datasets, batch loaders and the host-to-card feed."""
