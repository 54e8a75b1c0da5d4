"""Plain PyTorch and NumPy reference of the benchmark: it imports torch and
numpy only, never the program it judges."""
