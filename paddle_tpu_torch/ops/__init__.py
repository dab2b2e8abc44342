"""Tensor ops of the port (what the serving, training, recurrent and
convnet slices read so far)."""
