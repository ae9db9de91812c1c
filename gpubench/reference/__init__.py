"""Plain PyTorch float32 reference of what the benchmark runs."""
