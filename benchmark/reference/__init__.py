"""Plain PyTorch references of the benchmark's model families."""
