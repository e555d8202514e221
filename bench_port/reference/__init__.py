"""Plain references of the configurations (no JAX, nothing of the program)."""
