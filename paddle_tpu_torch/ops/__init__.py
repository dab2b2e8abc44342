"""Tensor ops of the port (what the serving, training and recurrent
slices read so far)."""
