"""The plain references: PyTorch only, nothing of the program."""
