"""Plain float64 reference of the benchmark: PyTorch only, nothing of the
program under test."""
