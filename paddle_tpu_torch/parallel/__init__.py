"""The parallel layer of the port (``parallel/sparse.py``'s
single-device half so far)."""
