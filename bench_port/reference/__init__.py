"""Plain references of the benchmark's check: NumPy and PyTorch, nothing
of the port."""
