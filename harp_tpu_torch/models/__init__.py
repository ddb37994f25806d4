"""Harp apps on PyTorch: KMeans so far."""
