"""Tensor ops of the port (only what the serving slice reads so far)."""
