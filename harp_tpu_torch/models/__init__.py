"""The Harp apps on PyTorch, one module an app."""
