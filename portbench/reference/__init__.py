"""The benchmark's plain reference: NumPy and plain PyTorch, float64, with
no import of the solver under test, of the JAX package or of JAX."""
