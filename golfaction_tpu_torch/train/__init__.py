"""Training: losses, metrics, the synthetic swing generator and the loops."""
