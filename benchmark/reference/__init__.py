"""The plain reference the benchmark holds the system to: plain PyTorch, importing nothing of
the system under test, of JAX or of the JAX package."""
