"""Tensor ops of the port (what the serving and training slices read so
far)."""
