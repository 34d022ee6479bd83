"""The benchmark's plain references: float32 PyTorch and NumPy that import
nothing of the measured program."""
